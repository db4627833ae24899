"""Command-line interface.

`simka-tpu` mirrors the reference `simka` tool's flags
(/root/reference/src/core/Simka.cpp:25-120); `simka-tpu min ...`
mirrors the `simkaMinCore` subcommands (src/simkaMin/SimkaMin.cpp:87-107).

Run as: python -m simka_tpu.cli [min] <args>
"""

from __future__ import annotations

import argparse
import sys

from simka_tpu.config import SimkaConfig


def build_simka_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simka-tpu",
        description=(
            "Comparative metagenomics on JAX: k-mer spectra and "
            "ecological distance matrices between N samples"
        ),
    )
    p.add_argument("-in", dest="input", required=True, help="input file of samples (one per line: id: f1,f2;f3...)")
    p.add_argument("-out", dest="out", default="./simka_results", help="output directory for distance matrices")
    p.add_argument("-out-tmp", dest="out_tmp", default=None, help="temporary directory (checkpoints)")
    p.add_argument("-keep-tmp", action="store_true", help="keep temporary files")
    p.add_argument("-kmer-size", type=int, default=21, help="size of a kmer")
    p.add_argument("-abundance-min", type=int, default=2, help="min abundance a kmer needs to be considered")
    p.add_argument("-abundance-max", type=int, default=999999999, help="max abundance a kmer can have")
    p.add_argument("-kmer-shannon-index", type=float, default=0.0, help="minimal Shannon index a kmer should have")
    p.add_argument("-max-reads", type=int, default=-1, help="max reads per sample (-1 all, 0 auto)")
    p.add_argument("-min-read-size", type=int, default=0, help="minimal read size")
    p.add_argument("-read-shannon-index", type=float, default=0.0, help="minimal read Shannon index")
    p.add_argument("-simple-dist", action="store_true", help="compute all simple distances (Chord, Hellinger...)")
    p.add_argument("-complex-dist", action="store_true", help="compute all complex distances (Jensen-Shannon...)")
    p.add_argument("-nb-cores", type=int, default=0, help="accepted for compatibility (XLA manages cores)")
    p.add_argument("-max-memory", type=int, default=5000, help="max memory (MB); joins beyond this budget sweep the k-mer hash space out-of-core")
    p.add_argument("-sweep-ranges", type=int, default=0, help="force N sequential out-of-core hash ranges (0 = auto by -max-memory)")
    p.add_argument("-verbose", type=int, default=1, help="verbosity")
    p.add_argument("-n-shards", type=int, default=0, help="k-mer-space shards (0 = all local devices)")
    p.add_argument("-data-info", action="store_true", help="compute (and display) input information only")
    # multi-host (the reference's cluster mode, replacing qsub job
    # templates + shared-FS sentinels with jax.distributed)
    p.add_argument("-coordinator", default=None, help="coordinator address host:port for multi-host runs")
    p.add_argument("-num-hosts", type=int, default=None, help="number of hosts in the multi-host run")
    p.add_argument("-host-id", type=int, default=None, help="this host's process id (0-based)")
    # reference cluster-mode flags, accepted for CLI compatibility;
    # their role (job submission over a shared FS) is replaced by the
    # -coordinator multi-host mode
    for flag in ("-count-cmd", "-merge-cmd", "-count-file", "-merge-file"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    p.add_argument("-max-count", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("-max-merge", type=int, default=0, help=argparse.SUPPRESS)
    return p


def simka_main(argv) -> int:
    args = build_simka_parser().parse_args(argv)
    if args.count_cmd or args.merge_cmd or args.count_file or args.merge_file:
        print(
            "[simka-tpu] note: the reference's cluster job flags are "
            "accepted but inert; use -coordinator/-num-hosts/-host-id "
            "for multi-host runs (jax.distributed)",
            flush=True,
        )
    config = SimkaConfig(
        input_filename=args.input,
        output_dir=args.out,
        output_tmp_dir=args.out_tmp,
        kmer_size=args.kmer_size,
        abundance_min=args.abundance_min,
        abundance_max=args.abundance_max,
        min_kmer_shannon_index=args.kmer_shannon_index,
        max_reads=args.max_reads,
        min_read_size=args.min_read_size,
        min_read_shannon_index=args.read_shannon_index,
        simple_dist=args.simple_dist,
        complex_dist=args.complex_dist,
        nb_cores=args.nb_cores,
        max_memory_mb=args.max_memory,
        keep_tmp=args.keep_tmp,
        verbose=bool(args.verbose),
        n_shards=args.n_shards,
        sweep_ranges=args.sweep_ranges,
    )
    if args.data_info:
        from simka_tpu.core.pipeline import run_data_info

        run_data_info(config)
        return 0

    if args.coordinator:
        from simka_tpu.parallel.multihost import (
            init_distributed,
            run_simka_multihost,
        )

        init_distributed(args.coordinator, args.num_hosts, args.host_id)
        run_simka_multihost(config)
        return 0

    from simka_tpu.core.pipeline import run_simka

    run_simka(config)
    return 0


def log_device() -> None:
    """One stderr line naming the backend this run executes on."""
    from simka_tpu.utils.metrics import device_report

    d = device_report()
    print(
        f"[simka-tpu] backend {d['platform']}: {d['count']} x "
        f"{d['kind']}",
        file=sys.stderr,
        flush=True,
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        log_device()
        if argv and argv[0] == "min":
            from simka_tpu.minhash.cli import min_main

            return min_main(argv[1:])
        return simka_main(argv)
    except (FileNotFoundError, ValueError) as e:
        print(f"simka-tpu: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
