"""Command-line interface of the port: ``lime-tpu-torch``.

The stage and end-to-end subcommands of ``lime-tpu`` (``lime_tpu/cli.py``)
with the same arguments and options, plus ``--device``::

    lime-tpu-torch cluster-lcp FASTA NUM_READS NUM_GENOMES [ALPHA] [THREADS]
    lime-tpu-torch cluster-bwt FASTA READ_LEN [BETA] [THREADS] --device cuda
    lime-tpu-torch classify N RES1..RESN NUM_READS NUM_GENOMES OUT \\
        LINEAGE TAX_RANK [THREADS] --device cuda
    lime-tpu-torch run-paired 1F 1RC 2F 2RC out.csv NUM_READS NUM_GENOMES \\
        LineageFile.csv READ_LEN [THREADS] [--fused] --device cuda

``run-paired`` / ``run-single`` run the staged stages (writing the
``.clrs`` / ``.res`` checkpoints) unless ``--fused`` asks for the serving
path; ``--executor host`` runs ``lime_tpu``'s host stages.
"""

from __future__ import annotations

import argparse
import logging
import sys

from lime_tpu.cli import _add_common, _config_from


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; a missing card is an "
                        "error, not a CPU fallback)")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s %(message)s")
    ap = argparse.ArgumentParser(prog="lime-tpu-torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("cluster-lcp", help="step 1: detect alpha-clusters")
    p.add_argument("fasta")
    p.add_argument("num_reads", type=int)
    p.add_argument("num_genomes", type=int)
    p.add_argument("alpha", type=int, nargs="?", default=16)
    p.add_argument("threads", type=int, nargs="?", default=1)
    _add_common(p)
    _add_device(p)

    p = sub.add_parser("cluster-bwt", help="step 2: score clusters")
    p.add_argument("fasta")
    p.add_argument("read_len", type=int)
    p.add_argument("beta", type=float, nargs="?", default=0.25)
    p.add_argument("threads", type=int, nargs="?", default=1)
    _add_common(p, scoring=True)
    _add_device(p)

    p = sub.add_parser("classify", help="step 3: assign reads to taxa")
    p.add_argument("num_files", type=int, choices=[2, 4])
    p.add_argument("res_and_rest", nargs="+",
                   help="res1..resN numReads numGenomes out lineage "
                        "taxRank threads")
    _add_common(p, classify=True)
    p.add_argument("--text", action="store_true")
    _add_device(p)

    for name in ("run-paired", "run-single"):
        p = sub.add_parser(name, help=f"end-to-end {name[4:]} pipeline")
        n = 2 if name == "run-single" else 4
        p.add_argument("collections", nargs=n,
                       help="1F 1RC 2F 2RC" if n == 4 else "F RC")
        p.add_argument("output")
        p.add_argument("num_reads", type=int)
        p.add_argument("num_genomes", type=int)
        p.add_argument("lineage")
        p.add_argument("read_len", type=int)
        p.add_argument("threads", type=int, nargs="?", default=1)
        p.add_argument("--alpha", type=int, default=16)
        p.add_argument("--beta", type=float, default=0.25)
        p.add_argument("--tax-rank", type=int, default=1)
        p.add_argument("--keep-results", action="store_true")
        p.add_argument("--fused", action="store_true",
                       help="one-pass serving path (no .clrs/.res "
                            "artifacts)")
        p.add_argument("--dense-threshold", type=int, default=None,
                       help="genome positions a cluster needs to stay on "
                            "the banded engine (default: auto)")
        p.add_argument("--mxu-dense-min", type=int, default=None,
                       help="genome-position threshold for the dense "
                            "matmul path (default 16)")
        _add_common(p, scoring=True, classify=True)
        _add_device(p)
    args = ap.parse_args(argv)
    return _dispatch(args)


def _dispatch(args) -> int:
    from lime_tpu.pipeline import cluster_lcp

    from .pipeline import classify, cluster_bwt, run_paired, run_single

    if args.cmd == "cluster-lcp":
        cfg = _config_from(args).replace(alpha=args.alpha)
        meta = cluster_lcp(args.fasta, args.num_reads, args.num_genomes, cfg)
        print(f"Clustering process with alpha={cfg.alpha} completed.\n"
              f"Total number of clusters: {meta.n_clusters}.\n"
              f"Maximum cluster size: {meta.max_len}.")
        return 0

    if args.cmd == "cluster-bwt":
        cfg = _config_from(args).replace(beta=args.beta)
        cluster_bwt(args.fasta, args.read_len, cfg, device=args.device)
        print(f"Cluster analysis completed with beta={cfg.beta}.")
        return 0

    if args.cmd == "classify":
        rest = args.res_and_rest
        n = args.num_files
        if len(rest) not in (n + 5, n + 6):  # threads arg is optional
            raise SystemExit("usage: classify N res1..resN numReads "
                             "numGenomes out lineage taxRank [threads]")
        num_reads, num_genomes = int(rest[n]), int(rest[n + 1])
        out, lineage, tax_rank = rest[n + 2], rest[n + 3], int(rest[n + 4])
        cfg = _config_from(args).replace(tax_rank=tax_rank)
        s = classify(rest[:n], num_reads, num_genomes, out, lineage, cfg,
                     device=args.device)
        print(f"Classification process at level {tax_rank} completed.\n"
              f"Number of successfully classified reads: "
              f"{s.classified}/{s.num_reads};\n"
              f"\tClassified at higher taxonomic ranks: {s.higher}.\n"
              f"\tAmbiguously classified reads: {s.ambiguous}.\n"
              f"\tNot classified reads: {s.unclassified}.")
        return 0

    cfg = _config_from(args).replace(
        alpha=args.alpha, beta=args.beta, tax_rank=args.tax_rank)
    fn = run_paired if args.cmd == "run-paired" else run_single
    s = fn(args.collections, args.output, args.num_reads, args.num_genomes,
           args.lineage, args.read_len, cfg, keep_results=args.keep_results,
           device=args.device)
    print(f"C={s.classified} H={s.higher} A={s.ambiguous} "
          f"U={s.unclassified} / {s.num_reads}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
