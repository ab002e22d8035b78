"""Command-line interface of the port: ``lime-tpu-torch``.

``run-paired`` and ``run-single`` take ``lime-tpu``'s positional
arguments (``lime_tpu/cli.py``) plus ``--device`` and run the fused
serving path on that device::

    lime-tpu-torch run-paired 1F 1RC 2F 2RC out.csv NUM_READS NUM_GENOMES \\
        LineageFile.csv READ_LEN [THREADS] --device cuda
"""

from __future__ import annotations

import argparse
import logging
import sys

from lime_tpu.config import LimeConfig


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s %(message)s")
    ap = argparse.ArgumentParser(prog="lime-tpu-torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
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
        p.add_argument("--no-ebwt", action="store_true",
                       help="document-only scoring (reference EBWT=0)")
        p.add_argument("--wide-sim", action="store_true",
                       help="u32 similarity counters for reads > 255bp "
                            "(reference dataTypeNumSim=1)")
        p.add_argument("--higher", action="store_true",
                       help="ascend lineage on ambiguity (reference "
                            "HIGHER=1)")
        p.add_argument("--mxu-dense-min", type=int, default=None,
                       help="genome-position threshold for the dense "
                            "matmul path (default 16)")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; a missing card "
                            "is an error, not a CPU fallback)")
    args = ap.parse_args(argv)

    from .pipeline import run_paired, run_single

    cfg = LimeConfig(alpha=args.alpha, beta=args.beta,
                     tax_rank=args.tax_rank, use_ebwt=not args.no_ebwt,
                     assign_higher=args.higher, wide_sim=args.wide_sim,
                     threads=args.threads, fused=True,
                     mxu_dense_min=args.mxu_dense_min)
    fn = run_paired if args.cmd == "run-paired" else run_single
    s = fn(args.collections, args.output, args.num_reads, args.num_genomes,
           args.lineage, args.read_len, cfg, device=args.device)
    print(f"C={s.classified} H={s.higher} A={s.ambiguous} "
          f"U={s.unclassified} / {s.num_reads}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
