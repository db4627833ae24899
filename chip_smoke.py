#!/usr/bin/env python3
"""End-to-end check of simka-tpu on NVIDIA GPUs.

Drives the exact pipeline and SimkaMin through their command-line entry
point (``simka_tpu.cli.main``) on synthetic dataset A -- 8 samples x
200,000 reads x 150 bp drawn from a shared genome pool (generated from
--seed), one sample a gzipped paired FASTQ bank -- and holds every
result to a plain reference:

  0. device: platform, memory plan and card; the native parser builds
  1. kernels at real widths: the limb-split einsums against numpy
     int64, count_join_stats against scripts/profiling/cpu_baseline.cpp,
     and the GPU against the CPU backend on every channel
  2. exact pipeline, k=21, -simple-dist -complex-dist -abundance-min 2,
     against the numpy reference (simka_tpu/reference.py) on 3 pairs
  3. exact pipeline, k=31, -abundance-min 0 (generic multi-key sort)
  4. SimkaMin pipeline, k=21, -nb-kmers 100000 on samples 0-4, against
     the numpy sketch and the host distance
  5. phase 2 forced out of core (>= 3 hash ranges): identical CSVs
  6. the gpu-marked tests, in a child process that ends before this
     process first touches JAX

Usage:
    python chip_smoke.py [--seed S]            # phases 0-6, one GPU
    python chip_smoke.py --gpus 4 [--seed S]   # sharded path only

With --gpus 4 only phase 2's pipeline runs, sharded over 4 GPUs and on
1 GPU in one process: identical CSVs, agreement with the reference, and
balanced per-device peak memory.

Every line that carries a number names the card (nvidia-smi name and
power limit). The last line is {"ok": true, "device": {...}}. The
script exits non-zero without that line when JAX finds no GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import glob
import gzip
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
import traceback
import xml.etree.ElementTree as ET

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
BASELINE_SRC = os.path.join(REPO, "scripts", "profiling", "cpu_baseline.cpp")

# dataset A
N_SAMPLES, N_READS, READ_LEN = 8, 200_000, 150
N_GENOMES, GENOME_LEN, PICKS = 16, 2_000_000, 4
GZ_SAMPLE = 7  # written as a gzipped paired FASTQ bank
PAIRS = 3  # sample pairs held to the numpy reference
# phase 1
KERNEL_ROWS, KERNEL_BANKS = 1 << 24, 8
EINSUM_ROWS, EINSUM_BANKS = 1 << 20, 16
# phase 4
MIN_SAMPLES, SKETCH_SIZE, MIN_SEED = 5, 100_000, 100  # CLI -seed default
# phase 5: the sweep must split the hash space at least this often
MIN_RANGES = 3
# --gpus 4: per-device peak memory may differ by at most this factor
PEAK_SPREAD = 1.5


def card_lines() -> list:
    """nvidia-smi's name and power limit of every card, read by a
    child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi lists no GPU")
    return lines


def gpu_device_report() -> dict:
    """Platform, device_kind and count as JAX reports them; refuses
    any backend but the GPU."""
    import jax

    from simka_tpu.utils.metrics import device_report

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"JAX found no GPU (default backend {backend!r})")
    return device_report()


# ---------------------------------------------------------------- kernels


def check_limb_einsums(rng, rows: int, banks: int) -> None:
    """exact_int_matmul and binned_sum against numpy int64, with the
    first two 8192-row panels at every limb's maximum."""
    import jax

    from simka_tpu.ops.intmatmul import (
        BLOCK_ROWS,
        binned_sum,
        exact_int_matmul,
    )

    full = 2 * BLOCK_ROWS
    for a_bits, b_bits in ((32, 1), (16, 16)):
        a = rng.integers(0, 1 << a_bits, size=(rows, banks), dtype=np.int64)
        b = rng.integers(0, 1 << b_bits, size=(rows, banks), dtype=np.int64)
        a[:full] = (1 << a_bits) - 1
        b[:full] = (1 << b_bits) - 1
        f = jax.jit(functools.partial(
            exact_int_matmul, a_bits=a_bits, b_bits=b_bits))
        got = np.asarray(f(a, b))
        want = a.T @ b
        if not np.array_equal(got, want):
            raise AssertionError(
                f"exact_int_matmul a_bits={a_bits} b_bits={b_bits}: "
                f"{int((got != want).sum())} entries differ")

    n_bins = banks * (banks - 1) // 2
    values = rng.integers(0, 1 << 33, size=rows, dtype=np.int64)
    values[:full] = (1 << 33) - 1
    bins = rng.integers(0, n_bins + 1, size=rows).astype(np.int32)
    bins[:full] = 0
    got = np.asarray(jax.jit(functools.partial(
        binned_sum, n_bins=n_bins, bits=33))(values, bins))
    want = np.zeros(n_bins, np.int64)
    keep = bins < n_bins
    np.add.at(want, bins[keep], values[keep])
    if not np.array_equal(got, want):
        raise AssertionError("binned_sum differs from numpy int64")


def kernel_stream(rng, rows: int, banks: int):
    """bench.py's instance stream: ~2x k-mer multiplicity per sample,
    values that fit the packed k <= 26 key."""
    vals = rng.integers(0, rows // 2, size=rows, dtype=np.uint64)
    sid = rng.integers(0, banks, size=rows).astype(np.int32)
    return vals, sid


def _split(vals):
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def build_baseline(exe: str) -> str:
    """Compile scripts/profiling/cpu_baseline.cpp (git-ignored binary)."""
    if not (os.path.exists(exe)
            and os.path.getmtime(exe) >= os.path.getmtime(BASELINE_SRC)):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-pthread", BASELINE_SRC,
             "-o", exe],
            check=True, capture_output=True, timeout=300,
        )
    return exe


def check_countjoin_vs_baseline(vals, sid, banks: int, exe: str, work: str):
    """The packed-key count_join_stats against the C++ baseline, bit
    for bit on every default channel."""
    from simka_tpu.ops.countjoin import count_join_stats

    path = os.path.join(work, "stream.bin")
    with open(path, "wb") as f:
        f.write(np.int64(len(vals)).tobytes())
        f.write(np.int32(banks).tobytes())
        f.write(vals.tobytes())
        f.write(sid.astype(np.uint8).tobytes())
    out = subprocess.run(
        [exe, "0", "0", "1", path],
        check=True, capture_output=True, timeout=600, text=True,
    ).stdout.splitlines()
    os.remove(path)
    want = json.loads(out[0])
    hi, lo = _split(vals)
    js = count_join_stats(hi, lo, sid, np.int32(1), np.int64(10**9),
                          n_banks=banks, hi_bits=10)
    bad = [k for k in ("nb_distinct", "nb_shared")
           if int(getattr(js, k)) != want[k]]
    for name in ("shared_distinct", "shared_kmers_ab", "shared_kmers_ba",
                 "bray_numerator"):
        have = np.asarray(getattr(js, name)).astype(np.int64)
        if not np.array_equal(
                have, np.asarray(want[name], np.int64).reshape(banks, banks)):
            bad.append(name)
    if bad:
        raise AssertionError(f"count_join_stats vs cpu_baseline: {bad}")


FLOAT_FIELDS = ("chord_ninj", "kullback_leibler")


def check_countjoin_gpu_vs_cpu(vals, sid, banks: int, hi_bits: int):
    """count_join_stats with every channel on the GPU and on the CPU
    backend: integer channels equal, float channels within 1e-6."""
    import jax

    from simka_tpu.ops.countjoin import count_join_stats

    hi, lo = _split(vals)
    f = functools.partial(count_join_stats, n_banks=banks, simple=True,
                          complex_=True, hi_bits=hi_bits)
    args = (hi, lo, sid, np.int32(2), np.int64(10**9))
    gpu = jax.device_get(f(*args))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = jax.device_get(f(*args))
    bad = []
    for name in gpu._fields:
        g, c = np.asarray(getattr(gpu, name)), np.asarray(getattr(cpu, name))
        if name in FLOAT_FIELDS:
            if not np.allclose(g, c, rtol=1e-6, atol=0.0):
                bad.append(name)
        elif not np.array_equal(g, c):
            bad.append(name)
    if bad:
        raise AssertionError(
            f"count_join_stats hi_bits={hi_bits} GPU vs CPU: {bad}")


# ---------------------------------------------------------------- dataset


def write_dataset_a(work: str, seed: int, n_samples: int, n_reads: int):
    """Write dataset A under ``work``; return the reads per sample."""
    from scripts.synthetic50 import make_genomes, make_reads

    rng = np.random.default_rng(seed)
    genomes = make_genomes(rng, N_GENOMES, GENOME_LEN)
    reads, lines = [], []
    for s in range(n_samples):
        picks = rng.choice(N_GENOMES, size=PICKS, replace=False)
        weights = rng.dirichlet(np.ones(PICKS))
        r = make_reads(rng, genomes, picks, n_reads, READ_LEN, weights)
        reads.append(r)
        if s == GZ_SAMPLE:
            half = n_reads // 2
            names = [f"S{s}_1.fastq.gz", f"S{s}_2.fastq.gz"]
            for name, part in zip(names, (r[:half], r[half:])):
                with gzip.open(os.path.join(work, name), "wb",
                               compresslevel=1) as f:
                    f.write(_records(part, fastq=True))
            lines.append(f"S{s}: {names[0]} ; {names[1]}")
        else:
            with open(os.path.join(work, f"S{s}.fasta"), "wb") as f:
                f.write(_records(r, fastq=False))
            lines.append(f"S{s}: S{s}.fasta")
    with open(os.path.join(work, "input.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(work, "input_min.txt"), "w") as f:
        f.write("\n".join(lines[:MIN_SAMPLES]) + "\n")
    return reads


def _records(reads: np.ndarray, fastq: bool) -> bytes:
    """FASTA or FASTQ records of fixed-length reads, assembled as one
    byte matrix (no per-read Python loop)."""
    n, length = reads.shape
    head = b"@r\n" if fastq else b">r\n"
    tail = b"\n+\n" + b"I" * length + b"\n" if fastq else b"\n"
    rec = np.empty((n, len(head) + length + len(tail)), np.uint8)
    rec[:, : len(head)] = np.frombuffer(head, np.uint8)
    rec[:, len(head): len(head) + length] = reads
    rec[:, len(head) + length:] = np.frombuffer(tail, np.uint8)
    return rec.tobytes()


# ---------------------------------------------------------------- pipeline


def csv_bytes(out_dir: str) -> dict:
    """Decompressed CSV bytes per matrix (gzip headers carry mtimes)."""
    out = {}
    for p in sorted(glob.glob(os.path.join(out_dir, "*.csv.gz"))):
        with gzip.open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def run_cli(argv: list):
    """simka_tpu.cli.main(argv); returns the SimkaStatistics the run
    computed (observed, not altered) and the run's metrics."""
    from simka_tpu.cli import main
    from simka_tpu.core import pipeline

    seen = []
    real = pipeline.compute_all_matrices

    def observe(stats):
        seen.append(stats)
        return real(stats)

    pipeline.compute_all_matrices = observe
    try:
        rc = main(argv)
    finally:
        pipeline.compute_all_matrices = real
    if rc != 0 or len(seen) != 1:
        raise RuntimeError(f"cli.main({argv}) returned {rc} after "
                           f"{len(seen)} statistics")
    out = argv[argv.index("-out") + 1]
    with open(os.path.join(out, "simka_metrics.json")) as f:
        metrics = json.load(f)
    return seen[0], metrics


class Smoke:
    """The phases, sized by the module constants."""

    def __init__(self, seed: int, card: str, work: str = WORK):
        self.seed, self.card, self.work = seed, card, work
        self.reference_ks = (21, 31)
        self.failed = []
        self.compile_s = 0.0
        self.reads = None
        self._counts = {}
        self._csv2 = None
        # the numpy reference runs in worker processes (never on JAX)
        # while the device phases run
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=min(6, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
        )
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.compile_s += secs

    def say(self, msg: str) -> None:
        print(with_card(msg, self.card), flush=True)

    def phase(self, label: str, fn) -> None:
        """Run one phase; its standard output (the pipelines' own
        lines included) is printed after it, each line with the card."""
        c0, t0 = self.compile_s, time.perf_counter()
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                fn()
            status = "ok"
        except Exception:  # report, keep going, fail at the end
            traceback.print_exc()
            self.failed.append(label)
            status = "FAILED"
        for line in out.getvalue().splitlines():
            self.say(line)
        self.say(f"[{label}] {status}: wall {time.perf_counter() - t0:.6f} s,"
                 f" compile {self.compile_s - c0:.6f} s")

    # ---- reference --------------------------------------------------

    def submit_reference(self, ks) -> None:
        """Start the numpy spectra the phases will compare with."""
        from simka_tpu import reference as ref

        samples = sorted({s for pair in self.pairs() for s in pair})
        for k in ks:
            for s in samples:
                self._counts[(s, k)] = self.pool.submit(
                    ref.sample_counts, self.reads[s], k)

    def counts(self, s: int, k: int):
        return self._counts[(s, k)].result()

    def pairs(self):
        """PAIRS seeded sample pairs (i < j); one holds the gzipped
        paired FASTQ bank."""
        rng = np.random.default_rng(self.seed + 2)
        out = {(int(rng.integers(GZ_SAMPLE)), GZ_SAMPLE)}
        while len(out) < PAIRS:
            i, j = sorted(int(x) for x in rng.choice(N_SAMPLES, 2,
                                                     replace=False))
            out.add((i, j))
        return sorted(out)

    def check_against_reference(self, stats, k: int, amin: int) -> None:
        from simka_tpu import reference as ref

        bad = []
        for i, j in self.pairs():
            a = ref.solid_kmers(*self.counts(i, k), amin)
            b = ref.solid_kmers(*self.counts(j, k), amin)
            for s, sk in ((i, a), (j, b)):
                bad += [f"bank {s} {m}" for m in ref.compare_stats(
                    ref.pipeline_bank_totals(stats, s),
                    ref.bank_totals(sk[1]))]
            bad += [f"pair {i},{j} {m}" for m in ref.compare_stats(
                ref.pipeline_pair_stats(stats, i, j), ref.pair_stats(a, b))]
        if bad:
            raise AssertionError("pipeline vs numpy reference: "
                                 + "; ".join(bad))
        self.say(f"  pairs {self.pairs()} and their banks equal the numpy "
                 f"reference (k={k}, abundance-min {amin})")

    # ---- phases -----------------------------------------------------

    def device(self) -> None:
        import jax

        from simka_tpu.core.budget import (
            hbm_budget_bytes,
            instance_rows_budget,
        )
        from simka_tpu.io import native

        rep = gpu_device_report()
        limit = jax.devices()[0].memory_stats()["bytes_limit"]
        self.say(f"  {rep['platform']} {rep['kind']} x {rep['count']}: "
                 f"bytes_limit {limit}, plan {hbm_budget_bytes()} bytes = "
                 f"{instance_rows_budget(2)} instance rows at k<=31")
        if not native.available():
            raise RuntimeError("the native FASTX parser did not build")

    def dataset(self) -> None:
        os.makedirs(self.work, exist_ok=True)
        self.reads = write_dataset_a(self.work, self.seed, N_SAMPLES,
                                     N_READS)
        windows = sum(r.shape[0] * (r.shape[1] - 20) for r in self.reads)
        self.say(f"  dataset A: {N_SAMPLES} samples x {N_READS} "
                 f"reads x {READ_LEN} bp, {windows} k=21 windows")
        self.submit_reference(self.reference_ks)

    def kernels(self) -> None:
        rng = np.random.default_rng(self.seed + 1)
        check_limb_einsums(rng, EINSUM_ROWS, EINSUM_BANKS)
        self.say(f"  limb einsums: {EINSUM_ROWS} rows x "
                 f"{EINSUM_BANKS} banks bit-exact against numpy int64")
        vals, sid = kernel_stream(rng, KERNEL_ROWS, KERNEL_BANKS)
        exe = build_baseline(os.path.splitext(BASELINE_SRC)[0])
        check_countjoin_vs_baseline(vals, sid, KERNEL_BANKS, exe, self.work)
        self.say(f"  count_join_stats E={KERNEL_ROWS} N={KERNEL_BANKS} "
                 f"packed key: default channels equal cpu_baseline.cpp")
        for hi_bits in (10, 32):
            check_countjoin_gpu_vs_cpu(vals, sid, KERNEL_BANKS, hi_bits)
        self.say("  count_join_stats simple+complex, packed and generic "
                 "keys: GPU equals CPU (floats within 1e-6)")

    def exact(self, k: int, amin: int, out: str, extra=()) -> dict:
        stats, metrics = run_cli(
            ["-in", os.path.join(self.work, "input.txt"), "-out", out,
             "-kmer-size", str(k), "-abundance-min", str(amin),
             "-simple-dist", "-complex-dist", "-verbose", "0", *extra])
        counters = metrics["counters"]
        self.say(f"  route {counters['route']}, stages {metrics['stages']}, "
                 f"device {metrics['device']}")
        self.check_against_reference(stats, k, amin)
        return counters

    def exact_k21(self) -> None:
        import jax

        from simka_tpu.core.budget import hbm_budget_bytes

        out = os.path.join(self.work, "out_k21")
        counters = self.exact(21, 2, out)
        if counters["route"] != "in_memory":
            raise AssertionError("dataset A left the in-memory route")
        peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
        self.say(f"  peak_bytes_in_use {peak} against the plan "
                 f"{hbm_budget_bytes()} bytes")
        self._csv2 = csv_bytes(out)

    def exact_k31(self) -> None:
        self.exact(31, 0, os.path.join(self.work, "out_k31"))

    def simkamin(self) -> None:
        from simka_tpu import reference as ref
        from simka_tpu.minhash import pipeline as mp
        from simka_tpu.minhash import sketch as msk
        from simka_tpu.minhash.distance import (
            MATRIX_NAMES,
            compute_distance_block,
        )
        from simka_tpu.minhash.sketch_file import SketchFile

        out = os.path.join(self.work, "out_min")
        bails, resident = [], []
        real_bail, real_run = msk._bail, mp._run_min_device_resident

        def bail(reason):
            bails.append(reason)
            real_bail(reason)

        def run(*a, **kw):
            r = real_run(*a, **kw)
            resident.append(r is not None)
            return r

        sketch0 = self.pool.submit(
            ref.bottom_sketch, self.reads[0], 21, SKETCH_SIZE, MIN_SEED)
        msk._bail, mp._run_min_device_resident = bail, run
        try:
            from simka_tpu.cli import main

            rc = main(["min", "pipeline", "-in",
                       os.path.join(self.work, "input_min.txt"), "-out", out,
                       "-kmer-size", "21",
                       "-nb-kmers", str(SKETCH_SIZE)])
        finally:
            msk._bail, mp._run_min_device_resident = real_bail, real_run
        if rc != 0:
            raise RuntimeError(f"min pipeline returned {rc}")
        if bails or resident != [True]:
            raise AssertionError(
                f"SimkaMin left its batched device path: {bails}")
        sf = SketchFile(os.path.join(out, "sketch", "sketch.bin"))
        h, c = sf.read_slot(0)
        wh, wc = sketch0.result()
        if not (np.array_equal(h, wh) and np.array_equal(c, wc)):
            raise AssertionError("sample 0's sketch differs from numpy")
        n = sf.header().nb_datasets
        sketches = [sf.read_slot(i) for i in range(n)]
        for name, want in zip(MATRIX_NAMES,
                              compute_distance_block(sketches, sketches,
                                                     True)):
            got = np.fromfile(os.path.join(out, "distance", name + ".bin"),
                              np.float32).reshape(n, n)
            if not np.array_equal(got, want):
                raise AssertionError(f"{name} differs from the host path")
        self.say(f"  {n} sketches of {len(h)} hashes; sample 0's sketch "
                 f"equals numpy murmur, both matrices equal the host path")

    def out_of_core(self) -> None:
        from simka_tpu.core.budget import (
            JOIN_WORKING_SET_FACTOR,
            estimate_total_instances,
        )
        from simka_tpu.io.dsl import parse_input_file

        if self._csv2 is None:
            raise RuntimeError("phase 2 produced no CSVs to compare")
        est = estimate_total_instances(
            parse_input_file(os.path.join(self.work, "input.txt")))
        # a plan of half the estimated stream forces the sweep route
        mb = est * 12 * JOIN_WORKING_SET_FACTOR / 2 / 1e6
        os.environ["SIMKA_TPU_HBM_MB"] = repr(mb)
        try:
            out = os.path.join(self.work, "out_ooc")
            counters = self.exact(21, 2, out)
        finally:
            del os.environ["SIMKA_TPU_HBM_MB"]
        ranges = counters.get("sweep_ranges", 0)
        self.say(f"  SIMKA_TPU_HBM_MB={mb}: {ranges} hash ranges, "
                 f"spill tier {counters.get('spill_tier')}")
        if ranges < MIN_RANGES:
            raise AssertionError(f"sweep took {ranges} < {MIN_RANGES} ranges")
        if csv_bytes(out) != self._csv2:
            raise AssertionError("out-of-core CSVs differ from phase 2's")

    def sharded(self, n_gpus: int) -> None:
        import jax

        if len(jax.devices()) < n_gpus:
            raise RuntimeError(f"{len(jax.devices())} GPUs, need {n_gpus}")
        out_n = os.path.join(self.work, f"out_{n_gpus}gpu")
        self.exact(21, 2, out_n, extra=("-n-shards", str(n_gpus)))
        peaks = [d.memory_stats()["peak_bytes_in_use"]
                 for d in jax.devices()[:n_gpus]]
        self.say(f"  per-device peak_bytes_in_use {peaks}")
        out_1 = os.path.join(self.work, "out_1gpu")
        self.exact(21, 2, out_1, extra=("-n-shards", "1"))
        if csv_bytes(out_n) != csv_bytes(out_1):
            raise AssertionError(f"{n_gpus}-GPU and 1-GPU CSVs differ")
        self.say(f"  {n_gpus}-GPU and 1-GPU CSVs are byte-identical")
        if max(peaks) > PEAK_SPREAD * min(peaks):
            raise AssertionError(f"unbalanced device memory: {peaks}")


def with_card(line: str, card: str) -> str:
    return line if line.endswith(card) else f"{line} | {card}"


def run_gpu_tests(work: str, card: str) -> bool:
    """Phase 6: `pytest -m gpu` in a child process; every gpu test
    must run (none skipped) and pass."""
    xml = os.path.join(work, "gpu_tests.xml")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", f"--junitxml={xml}"],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cuda,cpu"),
        capture_output=True, text=True, timeout=900,
    )
    for line in r.stdout[-3000:].splitlines():
        if line.strip():
            print(with_card(line, card))
    print(r.stderr[-2000:], file=sys.stderr, flush=True)
    ok = r.returncode == 0
    detail = f"rc {r.returncode}"
    if os.path.exists(xml):
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n = {a: int(suite.get(a, 0))
             for a in ("tests", "failures", "errors", "skipped")}
        ok = ok and n["tests"] > 0 and n["skipped"] == 0
        detail += f", {n}"
    else:
        ok = False
    print(f"[phase 6 gpu-marked tests] {'ok' if ok else 'FAILED'}: wall "
          f"{time.perf_counter() - t0:.6f} s, {detail} | {card}", flush=True)
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpus", type=int, default=1, choices=(1, 4))
    args = p.parse_args(argv)

    # a CUDA backend that fails to start is an error, not a CPU run
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    lines = card_lines()
    card = lines[0] if len(set(lines)) == 1 else " / ".join(lines)
    print(f"card: {' | '.join(lines)}", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    smoke = None
    try:
        # before this process touches JAX: two processes must never
        # hold the card at once
        tests_ok = args.gpus != 1 or run_gpu_tests(WORK, card)

        import simka_tpu  # noqa: F401  (x64, compile cache)

        report = gpu_device_report()
        smoke = Smoke(args.seed, card)
        smoke.phase("phase 0 device", smoke.device)
        if args.gpus == 1:
            smoke.phase("setup dataset A", smoke.dataset)
            smoke.phase("phase 1 kernels", smoke.kernels)
            smoke.phase("phase 2 exact k=21", smoke.exact_k21)
            smoke.phase("phase 3 exact k=31", smoke.exact_k31)
            smoke.phase("phase 4 SimkaMin", smoke.simkamin)
            smoke.phase("phase 5 out-of-core", smoke.out_of_core)
        else:
            smoke.reference_ks = (21,)
            smoke.phase("setup dataset A", smoke.dataset)
            smoke.phase(f"sharded exact k=21 on {args.gpus} GPUs",
                        functools.partial(smoke.sharded, args.gpus))
        failed = smoke.failed + ([] if tests_ok else ["phase 6"])
    finally:
        if smoke is not None:
            smoke.pool.shutdown(cancel_futures=True)
        shutil.rmtree(WORK, ignore_errors=True)
    if failed:
        print(f"FAILED: {failed} | {card}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
