"""slim_learn: estimate a SLIM model from a ratings file.

CLI parity with src/programs/slim_learn.c + cmdline_learn.c: same flags,
defaults (l1r=l2r=1.0, optTol=1e-7, niters=10000, algo=cd, simtype=cos) and
positional ``train-file [model-file]`` with default model name
``slim.model`` (cmdline_learn.c:260-263).
"""

from __future__ import annotations

import sys

from ..api import learn
from ..config import SlimConfig
from ..io.readers import read_matrix, write_matrix
from .common import add_common_matrix_flags, banner, errexit_main, \
    make_parser, normalise_argv, setup_logging


def main(argv=None):
    parser = make_parser("slim_learn", "Estimate a SLIM model.")
    add_common_matrix_flags(parser)
    parser.add_argument("--l1r", type=float, default=1.0)
    parser.add_argument("--l2r", type=float, default=1.0)
    parser.add_argument("--optTol", type=float, default=1e-7)
    parser.add_argument("--niters", type=int, default=10000)
    parser.add_argument("--nnbrs", type=int, default=0)
    parser.add_argument("--simtype", default="cos",
                        choices=["cos", "jac", "dotp"])
    parser.add_argument("--algo", default="cd", choices=["cd", "admm"])
    parser.add_argument("--ordered", action="store_true")
    parser.add_argument("--nthreads", type=int, default=0)
    parser.add_argument("--ipmdlfile", default=None,
                        help="model file used to warm-start")
    parser.add_argument("--blocksize", type=int,
                        default=SlimConfig.block_size,
                        help="item columns per device batch")
    parser.add_argument("--dist", default="none",
                        choices=["none", "replicated", "blockwise",
                                 "sharded_g"],
                        help="distributed learn over all visible devices "
                             "(see docs/MANUAL.md §7)")
    parser.add_argument("trnfile")
    parser.add_argument("mdlfile", nargs="?", default="slim.model")
    args = parser.parse_args(normalise_argv(sys.argv[1:] if argv is None
                                            else argv))
    setup_logging(args.dbglvl)
    banner()

    tmat = read_matrix(args.trnfile, fmt=args.ifmt)
    print(f"  trnfile: {args.trnfile}, nrows: {tmat.nrows}, "
          f"ncols: {tmat.ncols}, nnz: {tmat.nnz}")
    print(f"  l1r: {args.l1r:.2e}, l2r: {args.l2r:.2e}, "
          f"binarize: {'Yes' if args.binarize else 'No'}")
    print(f"  solver: {args.algo}, optTol: {args.optTol:.2e}, "
          f"niters: {args.niters}")
    print(f"  mdlfile: {args.mdlfile}")
    print(f"  simtype: {args.simtype}, nnbrs: {args.nnbrs}")
    print("\nEstimating model...")

    if args.binarize:
        tmat = tmat.binarize()

    imodel = None
    if args.ipmdlfile:
        imodel = read_matrix(args.ipmdlfile, fmt="csr")
        tmat_chk = tmat.infer_ncols()
        if imodel.nrows != tmat_chk.ncols:
            raise SystemExit(
                f"warm-start model rows ({imodel.nrows}) != train ncols "
                f"({tmat_chk.ncols})")

    cfg = SlimConfig(
        l1r=args.l1r, l2r=args.l2r, optTol=args.optTol, maxniters=args.niters,
        nnbrs=args.nnbrs, simtype=args.simtype, algo=args.algo,
        ordered=int(args.ordered), dbglvl=args.dbglvl,
        nthreads=args.nthreads, block_size=args.blocksize)
    if args.dist != "none":
        import time as _time

        from ..parallel.dist import (distributed_learn,
                                     distributed_learn_blockwise,
                                     distributed_learn_sharded_g)
        from ..parallel.mesh import make_mesh

        fn = {"replicated": distributed_learn,
              "blockwise": distributed_learn_blockwise,
              "sharded_g": distributed_learn_sharded_g}[args.dist]
        t0 = _time.perf_counter()
        model, stats = fn(tmat, cfg, make_mesh(), imodel=imodel)
        stats.setdefault("learn_s", _time.perf_counter() - t0)
    else:
        model, stats = learn(tmat, cfg, imodel=imodel)

    if args.mdlfile:
        write_matrix(model, args.mdlfile, fmt=args.ifmt
                     if args.ifmt != "csrnv" else "csr")
    print(f"\nmodel nnz: {model.nnz}  loss: {stats.get('loss', 0):.5e}  "
          f"learn: {stats['learn_s']:.2f}s")
    print("\nDone.")
    print("-" * 66)
    return 0


if __name__ == "__main__":
    sys.exit(errexit_main(main)())
