"""Shared timing for the profiling scripts.

Every result names the device it ran on (JAX's platform, device_kind
and count, plus nvidia-smi's card name and power limit where there is
one); every time is the median of several calls that each end in
``jax.block_until_ready``, after a compiling warm-up call.
"""

import os
import statistics
import subprocess
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

import jax  # noqa: E402

from simka_tpu.utils.metrics import device_report  # noqa: E402


def device_line() -> str:
    d = device_report()
    line = f"{d['platform']} {d['kind']} x{d['count']}"
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "no nvidia-smi"
    return f"{line} | {card}"


def median_seconds(fn, *args, iters: int = 5) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm-up
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
