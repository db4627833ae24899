"""Phase 1 of chip_smoke.py as tests: the limb-split einsums, the
count/join kernel and every statistics channel on the GPU, against
numpy int64, scripts/profiling/cpu_baseline.cpp and the CPU backend.

Marked ``gpu``: run them on a machine with an NVIDIA GPU with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``; elsewhere
they skip.
"""

import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu

ROWS, BANKS = 1 << 20, 8


@pytest.fixture
def gpu():
    try:
        return chip_smoke.gpu_device_report()
    except RuntimeError as e:
        pytest.skip(str(e))


def test_limb_einsums_bit_exact(gpu):
    chip_smoke.check_limb_einsums(np.random.default_rng(0), 1 << 18, 16)


def test_countjoin_matches_cpu_baseline(gpu, tmp_path):
    exe = chip_smoke.build_baseline(str(tmp_path / "cpu_baseline"))
    vals, sid = chip_smoke.kernel_stream(np.random.default_rng(1), ROWS, BANKS)
    chip_smoke.check_countjoin_vs_baseline(vals, sid, BANKS, exe, str(tmp_path))


@pytest.mark.parametrize("hi_bits", [10, 32], ids=["packed", "generic"])
def test_countjoin_gpu_matches_cpu(gpu, hi_bits):
    vals, sid = chip_smoke.kernel_stream(np.random.default_rng(2), ROWS, BANKS)
    chip_smoke.check_countjoin_gpu_vs_cpu(vals, sid, BANKS, hi_bits)
