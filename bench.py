"""Headline benchmark: k-mers counted+joined per second per chip.

Measures the fused sort -> count -> join -> distance-stats program
(the entirety of the reference's simkaCount+simkaMerge hot loops,
SURVEY.md §3.2-3.3) on a synthetic canonical k-mer instance stream
with metagenome-like multiplicity (~2x coverage, 8 samples).

Output contract (driver parses stdout): the kernel JSON line
{"metric", "value", "unit", "vs_baseline"} is printed and FLUSHED the
moment the kernel measurement finishes.  The end-to-end FASTA->matrices
pass then runs under a hard wall-clock budget (default 240 s,
SIMKA_TPU_BENCH_E2E_BUDGET_S to change, 0 to skip); if it completes it
prints a second JSON line REPEATING the kernel fields plus the e2e
fields, so whichever line is parsed carries the headline value.  If the
budget expires (a stuck C call cannot be interrupted by signals) a
watchdog thread exits the process with status 1 -- the finished lines
are already on stdout.  A section that raises prints its traceback,
the remaining sections still run, and the process exits with status 1.

Every timed iteration fetches a scalar derived from the full output,
so the timing covers the whole program.

vs_baseline compares against CPU simka's order-of-magnitude throughput
on a multicore node (~10M k-mers/s; the repo publishes no absolute
numbers -- SURVEY.md §6 -- so this anchor is recorded here explicitly).
"""

import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback

import numpy as np


CPU_SIMKA_BASELINE_KMERS_PER_SEC = 10_000_000.0


def measure_cpu_baseline():
    """Measure the multicore C++ count+merge baseline on THIS host
    (scripts/profiling/cpu_baseline.cpp; verified statistic-exact vs
    ops.countjoin in tests/test_cpu_baseline.py). Returns a dict with
    the measured kmers/s and thread count, or {} when the toolchain
    is unavailable (vs_baseline then falls back to the literature
    anchor, labeled as such)."""
    import subprocess

    src = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "scripts", "profiling", "cpu_baseline.cpp",
    )
    exe = src[:-4]
    try:
        if not (
            os.path.exists(exe)
            and os.path.getmtime(exe) >= os.path.getmtime(src)
        ):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-pthread", src,
                 "-o", exe],
                check=True, capture_output=True, timeout=180,
            )
        out = subprocess.run(
            [exe, "24", "8", "3"],
            check=True, capture_output=True, timeout=600, text=True,
        ).stdout
        d = json.loads(out.splitlines()[-1])
        return {
            "cpu_baseline_kmers_per_sec": d["cpu_kmers_per_sec"],
            "cpu_baseline_threads": d["threads"],
        }
    except (OSError, subprocess.SubprocessError, ValueError, KeyError):
        return {}


def run_kernel_bench():
    import functools

    import jax
    import jax.numpy as jnp

    from simka_tpu.ops.countjoin import count_join_stats

    n_banks = 8
    E = 1 << 24  # 16.7M k-mer instances
    rng = np.random.default_rng(0)
    # ~2x coverage: every k-mer appears ~2x within a sample on average
    space = E // 2
    vals = rng.integers(0, space, size=E, dtype=np.uint64)
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    sid = jnp.asarray(rng.integers(0, n_banks, size=E).astype(np.int32))

    # hi_bits=10 models the default k=21 (42-bit kmers): the packed
    # u64-key fast path is what real k<=26 runs take
    f = functools.partial(count_join_stats, n_banks=n_banks, hi_bits=10)

    @jax.jit
    def step(hi, lo, sid):
        js = f(hi, lo, sid, jnp.int32(1), jnp.int64(10**9))
        return (
            js.nb_distinct
            + js.shared_distinct[0, 1]
            + js.bray_numerator[0, 1]
            + js.shared_kmers_ab[0, 1]
        ).astype(jnp.float32)

    float(np.asarray(step(hi, lo, sid)))  # compile + warmup

    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        float(np.asarray(step(hi, lo, sid)))
    dt = (time.perf_counter() - t0) / iters

    rate = E / dt
    # vs_baseline divides by a MEASURED number when the host baseline
    # builds; the 10M literature anchor is reported alongside,
    # explicitly labeled
    cpu = measure_cpu_baseline()
    base = cpu.get(
        "cpu_baseline_kmers_per_sec", CPU_SIMKA_BASELINE_KMERS_PER_SEC
    )
    return {
        "metric": "kmers_counted_joined_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "kmers/s",
        "vs_baseline": round(rate / base, 3),
        "vs_baseline_kind": (
            "measured_host_cpp" if cpu else "literature_anchor"
        ),
        "vs_anchor_10M": round(
            rate / CPU_SIMKA_BASELINE_KMERS_PER_SEC, 3
        ),
        **cpu,
    }


def run_minhash_bench():
    """SimkaMin sketch throughput: k-mer instances hashed+sketched /s.

    Measures the device murmur64 + bottom-s selection program
    (reference hot loop: src/simkaMin/SimkaMinCount.hpp:217-267).
    """
    import jax
    import jax.numpy as jnp

    from simka_tpu.minhash.device import device_sketch_update

    E = 1 << 24
    s = 100_000
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << 42, size=E, dtype=np.uint64)
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    @jax.jit
    def step(hi, lo):
        h, c = device_sketch_update(hi, lo, seed=100, sketch_size=s)
        return (h[0] + c[0]).astype(jnp.float32)

    float(np.asarray(step(hi, lo)))  # compile + warmup
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        float(np.asarray(step(hi, lo)))
    dt = (time.perf_counter() - t0) / iters
    return {"simkamin_sketch_kmers_per_sec": round(E / dt, 1)}


def bench_end_to_end(deadline):
    """FASTA -> all distance matrices wall-clock (reads/s, kmers/s).

    Measures the WHOLE product path -- native ingest, device k-mer
    extraction, fused count+join, host distance formulas, csv.gz --
    on a synthetic 4-sample metagenome (100k reads x 100 bp each).
    The first run warms the XLA compile cache; a second steady-state
    run is timed only if the deadline allows.
    """
    from simka_tpu.config import SimkaConfig
    from simka_tpu.core.pipeline import run_simka

    n_samples, n_reads, read_len, k = 4, 100_000, 100, 21
    rng = np.random.default_rng(7)
    tmp = tempfile.mkdtemp(prefix="simka_bench_")
    try:
        lines = []
        bases = np.frombuffer(b"ACGT", np.uint8)
        for s in range(n_samples):
            path = os.path.join(tmp, f"S{s}.fasta")
            codes = rng.integers(0, 4, size=(n_reads, read_len))
            seqs = bases[codes]
            with open(path, "wb") as f:
                for i in range(n_reads):
                    f.write(b">r%d\n" % i)
                    f.write(seqs[i].tobytes())
                    f.write(b"\n")
            lines.append(f"S{s}: {path}")
        input_txt = os.path.join(tmp, "input.txt")
        with open(input_txt, "w") as f:
            f.write("\n".join(lines) + "\n")

        def once(tag):
            out = os.path.join(tmp, f"out_{tag}")
            t0 = time.perf_counter()
            run_simka(
                SimkaConfig(
                    input_filename=input_txt,
                    output_dir=out,
                    kmer_size=k,
                    abundance_min=2,
                    verbose=False,
                    n_shards=1,
                )
            )
            dt = time.perf_counter() - t0
            with open(os.path.join(out, "simka_metrics.json")) as f:
                m = json.load(f)
            stages = {
                f"e2e_{key}": v
                for key, v in m["counters"].items()
                if key.startswith("stage_")
            }
            return dt, stages

        dt, stages = once("warm")
        warm_only = True
        # a steady-state rerun costs ~dt (everything is compile-cached);
        # only take it if it fits comfortably before the watchdog fires
        if time.monotonic() + 1.5 * dt < deadline:
            dt, stages = once("timed")
            warm_only = False
        total_reads = n_samples * n_reads
        total_kmers = total_reads * (read_len - k + 1)
        return {
            "e2e_wall_s": round(dt, 2),
            "e2e_reads_per_sec": round(total_reads / dt, 1),
            "e2e_kmers_per_sec": round(total_kmers / dt, 1),
            "e2e_warm_only": warm_only,
            # ingest/join stage breakdown: parse+pack (native C),
            # host-to-device copy, extraction dispatch, and the
            # blocking join+stats materialization
            **stages,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_wide_n():
    """N=100 exact-pipeline scale demonstration (the reference tiles at
    100 datasets, simkaMin.py:158): N x N
    distance-matrix wall-clock through the real product path,
    exercising the singleton-prune split join (auto-on at N >= 33)."""
    from simka_tpu.config import SimkaConfig
    from simka_tpu.core.pipeline import run_simka

    n_samples, n_reads, read_len, k = 100, 4_000, 100, 21
    rng = np.random.default_rng(11)
    tmp = tempfile.mkdtemp(prefix="simka_bench_n100_")
    try:
        bases = np.frombuffer(b"ACGT", np.uint8)
        # ~30% of reads drawn from a shared pool so samples overlap
        shared = bases[rng.integers(0, 4, size=(n_reads, read_len))]
        lines = []
        for s in range(n_samples):
            path = os.path.join(tmp, f"S{s}.fasta")
            own = bases[
                rng.integers(0, 4, size=(n_reads, read_len))
            ]
            pick = rng.random(n_reads) < 0.3
            seqs = np.where(pick[:, None], shared, own)
            with open(path, "wb") as f:
                for i in range(n_reads):
                    f.write(b">r%d\n" % i)
                    f.write(seqs[i].tobytes())
                    f.write(b"\n")
            lines.append(f"S{s}: {path}")
        input_txt = os.path.join(tmp, "input.txt")
        with open(input_txt, "w") as f:
            f.write("\n".join(lines) + "\n")

        def once(tag):
            t0 = time.perf_counter()
            run_simka(
                SimkaConfig(
                    input_filename=input_txt,
                    output_dir=os.path.join(tmp, f"out_{tag}"),
                    kmer_size=k,
                    abundance_min=1,
                    verbose=False,
                    n_shards=1,
                )
            )
            return time.perf_counter() - t0

        warm = once("warm")  # compiles the N=100 split-join programs
        dt = once("timed")
        total_reads = n_samples * n_reads
        total_kmers = total_reads * (read_len - k + 1)
        return {
            "nxn_n_samples": n_samples,
            "nxn_wall_s": round(dt, 2),
            "nxn_warm_wall_s": round(warm, 2),
            "nxn_kmers_per_sec": round(total_kmers / dt, 1),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_min_wide_n():
    """SimkaMin N=100 pipeline (sketch -> distance -> export): the
    reference's headline wide-N mode (simkaMin/README.md: ~10x
    cheaper than exact simka).

    sketch_size=10k on ~320k-window samples (~3% ratio): SimkaMin's
    design point is sketch << sample (the reference defaults 100k-1M
    sketches for multi-GB samples)."""
    from simka_tpu.minhash.pipeline import run_simka_min

    n_samples, n_reads, read_len = 100, 4_000, 100
    rng = np.random.default_rng(11)
    tmp = tempfile.mkdtemp(prefix="simka_bench_minn_")
    try:
        bases = np.frombuffer(b"ACGT", np.uint8)
        shared = bases[rng.integers(0, 4, size=(n_reads, read_len))]
        lines = []
        for s in range(n_samples):
            path = os.path.join(tmp, f"S{s}.fasta")
            own = bases[rng.integers(0, 4, size=(n_reads, read_len))]
            pick = rng.random(n_reads) < 0.3
            seqs = np.where(pick[:, None], shared, own)
            with open(path, "wb") as f:
                for i in range(n_reads):
                    f.write(b">r%d\n" % i)
                    f.write(seqs[i].tobytes())
                    f.write(b"\n")
            lines.append(f"S{s}: {path}")
        input_txt = os.path.join(tmp, "input.txt")
        with open(input_txt, "w") as f:
            f.write("\n".join(lines) + "\n")

        def once(tag):
            t0 = time.perf_counter()
            run_simka_min(
                input_txt,
                os.path.join(tmp, f"out_{tag}"),
                kmer_size=21,
                sketch_size=10_000,
                verbose=False,
            )
            return time.perf_counter() - t0

        warm = once("warm")
        dt = once("timed")
        return {
            "min_nxn_n_samples": n_samples,
            "min_nxn_wall_s": round(dt, 2),
            "min_nxn_warm_wall_s": round(warm, 2),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_out_of_core(deadline):
    """At-scale proof: N=100 samples whose instance stream exceeds
    the REAL device memory plan (no
    test-forced tiny budgets). The exact pipeline must take the
    hash-range sweep (core/sweep.py) end-to-end on the device --
    wall-clock, range count and stage breakdown recorded -- and
    SimkaMin runs the SAME data in one device-resident pass: the
    regime where sketching's economics actually exist (exact pays
    spill + multi-range joins; min stays O(s) per sample)."""
    from simka_tpu.config import SimkaConfig
    from simka_tpu.core.budget import instance_rows_budget
    from simka_tpu.core.pipeline import run_simka

    budget = instance_rows_budget(2, 1)
    n_samples, read_len, k = 100, 100, 21
    # ~1.5x the device plan in k-mer instances, capped just under
    # the batched-sketch limit so min stays on its one-pass path
    target_inst = min(int(1.5 * budget), int(0.93 * (1 << 27)))
    n_reads = max(
        target_inst // (n_samples * (read_len - k + 1)), 1000
    )
    total_instances = n_samples * n_reads * (read_len - k + 1)
    # rough wall estimate (1.2M instances/s, a conservative bound);
    # skip rather than lose the line to the watchdog
    if time.monotonic() + total_instances / 1.2e6 > deadline:
        return {
            "ooc_skipped": "deadline",
            "ooc_planned_instances": total_instances,
        }
    rng = np.random.default_rng(13)
    tmp = tempfile.mkdtemp(prefix="simka_bench_ooc_")
    try:
        bases = np.frombuffer(b"ACGT", np.uint8)
        shared = bases[rng.integers(0, 4, size=(4096, read_len))]
        lines = []
        hdr = np.frombuffer(b">r\n", np.uint8)
        for s in range(n_samples):
            path = os.path.join(tmp, f"S{s}.fasta")
            own = bases[
                rng.integers(0, 4, size=(n_reads, read_len))
            ]
            pick = rng.random(n_reads) < 0.3
            rows = np.where(
                pick[:, None],
                shared[rng.integers(0, len(shared), n_reads)],
                own,
            )
            # block FASTA assembly (no per-read Python loop at this
            # scale): [n_reads, 3 + read_len + 1] byte matrix
            rec = np.empty((n_reads, len(hdr) + read_len + 1), np.uint8)
            rec[:, : len(hdr)] = hdr
            rec[:, len(hdr) : len(hdr) + read_len] = rows
            rec[:, -1] = ord("\n")
            with open(path, "wb") as f:
                f.write(rec.tobytes())
            lines.append(f"S{s}: {path}")
        input_txt = os.path.join(tmp, "input.txt")
        with open(input_txt, "w") as f:
            f.write("\n".join(lines) + "\n")

        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        run_simka(
            SimkaConfig(
                input_filename=input_txt,
                output_dir=out,
                kmer_size=k,
                abundance_min=1,
                verbose=False,
                n_shards=1,
            )
        )
        dt = time.perf_counter() - t0
        res = {
            "ooc_n_samples": n_samples,
            "ooc_instances": total_instances,
            "ooc_device_plan_rows": budget,
            "ooc_wall_s": round(dt, 2),
            "ooc_kmers_per_sec": round(total_instances / dt, 1),
        }
        with open(os.path.join(out, "simka_metrics.json")) as f:
            m = json.load(f)
        res["ooc_sweep_ranges"] = m["counters"].get("sweep_ranges", 0)
        for kk, v in m["stages"].items():
            res[f"ooc_stage_{kk}_s"] = round(v, 2)

        # SimkaMin on the SAME over-plan data: one device-resident
        # pass (s=10k ~ 0.8% of per-sample windows)
        if time.monotonic() + 1.2 * dt < deadline:
            from simka_tpu.minhash.pipeline import run_simka_min

            t0 = time.perf_counter()
            run_simka_min(
                input_txt,
                os.path.join(tmp, "out_min"),
                kmer_size=k,
                sketch_size=10_000,
                verbose=False,
            )
            dt_min = time.perf_counter() - t0
            res["ooc_min_wall_s"] = round(dt_min, 2)
            res["ooc_min_vs_exact"] = round(dt_min / dt, 3)
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    kernel = run_kernel_bench()
    print(json.dumps(kernel), flush=True)

    budget = float(os.environ.get("SIMKA_TPU_BENCH_E2E_BUDGET_S", "240"))
    if budget <= 0:
        return 0
    deadline = time.monotonic() + budget

    def _bail():
        # hard exit: a compile stuck in a C call ignores signals and
        # thread exceptions; the finished lines are already flushed
        print(f"bench: watchdog expired after {budget} s",
              file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(1)

    watchdog = threading.Timer(budget, _bail)
    watchdog.daemon = True
    watchdog.start()

    def release_device():
        # free the previous section's arrays and cached executables
        import gc

        import jax

        gc.collect()
        jax.clear_caches()
        gc.collect()

    # each completed section prints a CUMULATIVE line immediately, so
    # a watchdog exit never loses finished measurements (the last
    # parseable line carries everything measured)
    sections = [
        ("simkamin", run_minhash_bench),
        ("e2e", lambda: bench_end_to_end(deadline - 5.0)),
        ("nxn", bench_wide_n),
        ("min_nxn", bench_min_wide_n),
        ("ooc", lambda: bench_out_of_core(deadline - 5.0)),
    ]
    extra, failed = {}, []
    for i, (name, section) in enumerate(sections):
        if i:
            release_device()
        try:
            extra.update(section())
        except Exception:  # report, run the rest, exit non-zero
            traceback.print_exc()
            failed.append(name)
        print(json.dumps({**kernel, **extra}), flush=True)
    watchdog.cancel()
    if failed:
        print(f"bench: failed sections {failed}", file=sys.stderr,
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
