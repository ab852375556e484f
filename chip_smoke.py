#!/usr/bin/env python3
"""Smoke run of SLIM learn and serve on one NVIDIA GPU at ML-20M shape.

    python3 chip_smoke.py              # one card: every phase below
    python3 chip_smoke.py --cards 4    # four cards: the distributed learns only

Phases (one process owns the card; data is synthetic, made from --seed):

1. device  -- JAX's backend must be the GPU; prints the card, the device
   count and ``nvidia-smi``'s name and power limit.
2. gram    -- ``compute_gram`` on the device for the ML-20M-shaped log
   (138,493 x 27,278, ~19.7M nonzeros, binary); >= 256 random columns
   compared exactly with scipy's A^T A[:, S] on the host.
3. learn   -- ``slim_tpu.api.learn`` over every item column (reference
   defaults l1r = l2r = 1, optTol 1e-7, maxniters 10000), cold and warm.
4. kernel  -- one head and one tail block of the frequency-relabelled
   problem at width 28,672, solved by the GPU sweep (``impl="triton"``)
   and by the plain XLA sweep at Precision.HIGHEST from the same G and x0:
   per-column objective within 1e-5 relative, max |dx| <= 1e-4.
5. native  -- the 50,000 x 10,000 compact-path workload: ``api.learn``
   against the native C++ solver, objective within 1e-5 relative, model
   nnz within 0.1%.
6. serve   -- top-10 for every ML-20M user on the device dense path
   (pinned with ``W_dev=``) against the native top-10: scores within the
   scoring precision at every rank, ids equal except between scores that
   tie within it.
7. cli     -- ``slim_learn.main`` and ``slim_predict.main`` in-process on the
   50k x 10k matrix written as ijv.

With ``--cards 4``: ``distributed_learn`` and ``distributed_learn_blockwise``
on a 4-card mesh against a one-card ``api.learn`` of the same ML-20M matrix.

Any failed phase exits non-zero.  On success the last line is the JSON
object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(HERE, "build", "chip_smoke")

L1R = L2R = 1.0
OPT_TOL = 1e-7
MAXNITERS = 10000
OBJ_RTOL = 1e-5          # objective agreement, relative
NNZ_RTOL = 1e-3          # model nnz agreement, relative
KERNEL_DX_ATOL = 1e-4    # max |x_kernel - x_xla| at real width
GRAM_CHECK_COLS = 256


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def default_cfg(**kw):
    from slim_tpu.config import SlimConfig

    return SlimConfig(l1r=L1R, l2r=L2R, optTol=OPT_TOL, maxniters=MAXNITERS,
                      **kw)


# --------------------------------------------------------------------- #
def phase_device(expect_count: int | None = None) -> dict:
    import jax

    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu'")
    devs = jax.devices()
    if expect_count is not None:
        check(len(devs) >= expect_count,
              f"need {expect_count} GPUs, JAX sees {len(devs)}")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[device] {info['kind']} x{info['count']} "
        f"(platform {info['platform']}, jax {jax.__version__})")
    return info


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def phase_gram(train, npad: int, ncheck: int = GRAM_CHECK_COLS,
               seed: int = 0) -> dict:
    """Device Gram, timed cold and warm; ``ncheck`` random columns must
    equal the host's A^T A[:, S] exactly (binary data: integer counts)."""
    import jax

    from slim_tpu.ops.gram import compute_gram, gram_fits_device

    check(gram_fits_device(npad), f"dense G at npad {npad} does not fit")
    G, t_cold = timed(lambda: jax.block_until_ready(
        compute_gram(train, "device", pad_to=npad)))
    del G
    G, t_warm = timed(lambda: jax.block_until_ready(
        compute_gram(train, "device", pad_to=npad)))
    n = train.ncols
    rng = np.random.default_rng(seed)
    S = np.sort(rng.choice(n, min(ncheck, n), replace=False))
    got = np.asarray(G[:, S])
    del G
    A = train.to_scipy().tocsc().astype(np.float64)
    want = (A.T @ A[:, S]).toarray()
    check(np.array_equal(got[:n], want), "device Gram columns differ from "
          f"host A^T A (max |diff| {np.abs(got[:n] - want).max():.3g})")
    check(not got[n:].any(), "device Gram padding rows are not zero")
    log(f"[gram] npad {npad}: device {t_warm:.3f}s warm, {t_cold:.3f}s cold; "
        f"{S.size} columns exact")
    return {"gram_s": t_warm, "gram_cold_s": t_cold}


def phase_learn(train, cfg) -> tuple:
    """api.learn over every column, cold then warm."""
    from slim_tpu.api import learn

    (_, _), t_cold = timed(learn, train, cfg)
    (model, stats), t_warm = timed(learn, train, cfg)
    n = train.ncols
    check(np.isfinite(stats["loss"]) and stats["loss"] > 0,
          f"objective {stats['loss']}")
    check(model.nnz > 0, "empty model")
    check(model.nrows == n and model.ncols == n, "model shape")
    vals = model.values()
    check(bool(np.all(np.isfinite(vals)) and np.all(vals > 0)),
          "model values must be finite and positive")
    info = {"learn_s": t_warm, "learn_cold_s": t_cold,
            "compile_s": max(t_cold - t_warm, 0.0),
            "cols_per_s": n / t_warm, "objective": stats["loss"],
            "model_nnz": model.nnz, "sweeps": stats.get("sweeps"),
            "block_size": stats.get("block_size")}
    log(f"[learn] {n} columns: warm {t_warm:.2f}s ({n / t_warm:.1f} cols/s), "
        f"cold {t_cold:.2f}s (compile ~{info['compile_s']:.1f}s); "
        f"objective {stats['loss']:.9e}, model nnz {model.nnz}, "
        f"sweeps {stats.get('sweeps')}, block {stats.get('block_size')}")
    return model, stats, info


def relabelled_gram(train, npad: int):
    """Device G in frequency-rank space (the solver's own relabelling)."""
    import jax.numpy as jnp

    from slim_tpu.ops.gram import compute_gram

    n = train.ncols
    p = np.argsort(-train.col_nnz(), kind="stable").astype(np.int32)
    p_pad = jnp.asarray(np.concatenate([p, np.arange(n, npad,
                                                     dtype=np.int32)]))
    G = compute_gram(train, "device", pad_to=npad)
    return jnp.take(jnp.take(G, p_pad, axis=0), p_pad, axis=1), p


def phase_kernel(train, npad: int, B: int, cfg, seed: int = 0) -> dict:
    """Head and tail block solved by the GPU sweep and the plain XLA
    sweep from the same G and x0 (zeros)."""
    import jax
    import jax.numpy as jnp

    from slim_tpu.ops.cd_kernel import HIGHEST, cd_solve_block_ids, sweep_impl

    impl, prec = sweep_impl()
    n = train.ncols
    Gp, p = relabelled_gram(train, npad)
    caps_all = np.minimum(50 * train.col_nnz()[p], cfg.maxniters)
    out = {}
    for name, r0 in (("head", 0), ("tail", n - B)):
        j = np.arange(r0, r0 + B, dtype=np.int32)
        caps = jnp.asarray(caps_all[j].astype(np.int32))
        args = (Gp, jnp.asarray(j), caps, jnp.zeros((B, npad), jnp.float32),
                n, float(cfg.l1r), float(cfg.l2r), float(cfg.optTol),
                seed + r0)
        res = {}
        for im, pr in ((impl, prec), ("xla", HIGHEST)):
            fn = lambda im=im, pr=pr: jax.block_until_ready(
                cd_solve_block_ids(*args, shuffle=cfg.shuffle, impl=im,
                                   precision=pr))
            fn()                                   # compile
            res[im], t = timed(fn)
            res[im] = [np.asarray(a) for a in res[im]] + [t]
        xk, nk, _, _, ok_, tk = res[impl]
        xx, nx, _, _, ox, tx = res["xla"]
        obj_rel = float(np.max(np.abs(ok_ - ox) / np.maximum(np.abs(ox),
                                                             1e-30)))
        dx = float(np.max(np.abs(xk - xx)))
        log(f"[kernel] {name} block ({B}, {npad}): {impl} {tk:.3f}s "
            f"({int(nk.max())} sweeps) vs xla {tx:.3f}s ({int(nx.max())} "
            f"sweeps); max rel objective diff {obj_rel:.3e}, max |dx| "
            f"{dx:.3e}")
        check(np.all(np.isfinite(xk)), f"{name}: non-finite solution")
        check(obj_rel <= OBJ_RTOL, f"{name}: objective differs by "
              f"{obj_rel:.3e} > {OBJ_RTOL}")
        check(dx <= KERNEL_DX_ATOL, f"{name}: |dx| {dx:.3e} > "
              f"{KERNEL_DX_ATOL}")
        out[name] = {"obj_rel": obj_rel, "max_dx": dx, "impl_s": tk,
                     "xla_s": tx}
    return out


def phase_native(train, cfg, nnz_rtol: float = NNZ_RTOL) -> tuple:
    """api.learn against the native C++ CD solver on the same matrix."""
    from slim_tpu import native
    from slim_tpu.api import learn

    check(native.available(), "native library unavailable (g++ build)")
    learn(train, cfg)                              # compile
    (model, stats), t_dev = timed(learn, train, cfg)
    (nmodel, _, nobj), t_nat = timed(
        native.cd_learn, train, l1r=cfg.l1r, l2r=cfg.l2r, optTol=cfg.optTol,
        maxniters=cfg.maxniters, nthreads=0)
    obj_rel = rel(stats["loss"], nobj)
    nnz_rel = rel(model.nnz, nmodel.nnz)
    log(f"[native] {train.nrows}x{train.ncols} nnz {train.nnz}: device "
        f"{t_dev:.2f}s (block {stats.get('block_size')}) objective "
        f"{stats['loss']:.9e} nnz {model.nnz}; "
        f"native {t_nat:.2f}s ({os.cpu_count()} cores) objective "
        f"{nobj:.9e} nnz {nmodel.nnz}; rel diff objective {obj_rel:.3e}, "
        f"nnz {nnz_rel:.3e}")
    check(obj_rel <= OBJ_RTOL, f"objective differs by {obj_rel:.3e}")
    check(nnz_rel <= nnz_rtol, f"model nnz differs by {nnz_rel:.3e}")
    return model, {"device_learn_s": t_dev, "native_learn_s": t_nat,
                   "obj_rel": obj_rel, "nnz_rel": nnz_rel}


def exact_scores(hist, model, users, items) -> np.ndarray:
    """float64 score of (user, item) pairs: history row . model column."""
    H = hist.to_scipy().astype(np.float64)
    Wt = model.to_scipy().T.tocsr().astype(np.float64)
    if len(users) == 0:
        return np.zeros(0)
    return np.asarray(H[users].multiply(Wt[items]).sum(axis=1)).ravel()


def compare_topn(dev, nat, hist, model, rtol: float) -> dict:
    """Device vs native top-N: equal counts; at every rank the scores
    within ``rtol``; ids equal except where the two ids' exact scores tie
    within ``rtol``."""
    ids_d, sc_d, cnt_d = dev
    ids_n, sc_n, cnt_n = nat
    check(np.array_equal(cnt_d, cnt_n), "recommendation counts differ for "
          f"{int((cnt_d != cnt_n).sum())} users")
    k = ids_d.shape[1]
    valid = np.arange(k)[None, :] < cnt_n[:, None]
    err = np.abs(sc_d - sc_n) / np.maximum(np.abs(sc_n), 1e-30)
    max_err = float(np.max(np.where(valid, err, 0.0))) if valid.any() else 0.
    check(max_err <= rtol, f"scores differ by {max_err:.3e} > {rtol:.3e}")
    u, r = np.nonzero(valid & (ids_d != ids_n))
    s_d = exact_scores(hist, model, u, ids_d[u, r])
    s_n = exact_scores(hist, model, u, ids_n[u, r])
    tie = np.abs(s_d - s_n) <= rtol * np.maximum(np.abs(s_n), 1e-30)
    check(bool(tie.all()), f"{int((~tie).sum())} ranks hold different ids "
          f"whose scores do not tie within {rtol:.3e}")
    return {"max_score_rel": max_err, "id_swaps_within_ties": int(u.size)}


def phase_serve(train, model, nrcmds: int = 10) -> dict:
    """Top-N for every user on the device dense path vs native."""
    import jax

    from slim_tpu import native
    from slim_tpu.predict import (SCORE_RTOL_DEFAULT, _BF16_SCORE_NPAD,
                                  _bucket, densify_model, predict_topn)

    npad = _bucket(train.ncols)
    W, t_w = timed(lambda: jax.block_until_ready(densify_model(model, npad)))
    predict_topn(model, train, nrcmds=nrcmds, W_dev=W)      # compile
    dev, t_dev = timed(predict_topn, model, train, nrcmds=nrcmds, W_dev=W)
    nat, t_nat = timed(native.predict_topn, model, train, nrcmds=nrcmds)
    rtol = SCORE_RTOL_DEFAULT if npad > _BF16_SCORE_NPAD else 1e-5
    cmp = compare_topn(dev, nat, train, model, rtol)
    nu = train.nrows
    log(f"[serve] {nu} users top-{nrcmds}: device {t_dev:.3f}s "
        f"({nu / t_dev:.0f} users/s; dense W build {t_w:.2f}s), native "
        f"{t_nat:.3f}s ({nu / t_nat:.0f} users/s); max score rel diff "
        f"{cmp['max_score_rel']:.3e} (tol {rtol:.3e}), "
        f"{cmp['id_swaps_within_ties']} id swaps within ties")
    return dict(cmp, users_per_s=nu / t_dev, native_users_per_s=nu / t_nat,
                serve_s=t_dev)


def phase_cli(train, ref_nnz: int, workdir: str = WORKDIR,
              nnz_rtol: float = NNZ_RTOL) -> dict:
    """The two CLIs in-process on ``train`` written as ijv."""
    from slim_tpu.cli import slim_learn, slim_predict
    from slim_tpu.io.readers import read_matrix, write_matrix

    os.makedirs(workdir, exist_ok=True)
    trn = os.path.join(workdir, "train.ijv")
    mdl = os.path.join(workdir, "model.ijv")
    rec = os.path.join(workdir, "recs.txt")
    write_matrix(train, trn, fmt="ijv")
    rc, t_learn = timed(slim_learn.main, ["-ifmt=ijv", trn, mdl])
    check(rc == 0, f"slim_learn returned {rc}")
    model = read_matrix(mdl, fmt="ijv")
    nnz_rel = rel(model.nnz, ref_nnz)
    check(nnz_rel <= nnz_rtol, f"CLI model nnz {model.nnz} vs {ref_nnz}")
    rc, t_pred = timed(slim_predict.main, ["-ifmt=ijv", "--outfile", rec,
                                           mdl, trn])
    check(rc == 0, f"slim_predict returned {rc}")
    with open(rec) as fh:
        nlines = sum(1 for _ in fh)
    check(nlines == train.nrows, f"{nlines} recommendation lines for "
          f"{train.nrows} users")
    log(f"[cli] slim_learn {t_learn:.2f}s (model nnz {model.nnz}), "
        f"slim_predict {t_pred:.2f}s ({nlines} users)")
    return {"cli_learn_s": t_learn, "cli_predict_s": t_pred}


def _peak_bytes(dev):
    """Peak device memory in GB (None where the backend keeps no stats)."""
    stats = dev.memory_stats()
    return None if stats is None else \
        round(stats.get("peak_bytes_in_use", 0) / 2**30, 3)


def phase_cards(train, cfg, ncards: int) -> dict:
    """The distributed learns on an ncards mesh vs one-card api.learn.
    Each learn runs once, so its time includes its compilation.  The
    blockwise mode's per-superblock progress goes to stderr."""
    import logging

    from slim_tpu.api import learn

    logging.getLogger("slim_tpu").setLevel(logging.INFO)
    from slim_tpu.parallel.dist import (distributed_learn,
                                        distributed_learn_blockwise)
    from slim_tpu.parallel.mesh import make_mesh

    (model1, stats1), t1 = timed(learn, train, cfg)
    log(f"[cards] one card: {t1:.2f}s (cold) objective "
        f"{stats1['loss']:.9e} nnz {model1.nnz}")
    mesh = make_mesh(ncards)
    devs = list(mesh.devices.flat)
    check(len({d.id for d in devs}) == ncards, "mesh devices not distinct")
    out = {"one_card_s": t1}
    for name, fn in (("replicated", distributed_learn),
                     ("blockwise", distributed_learn_blockwise)):
        (model, stats), t = timed(fn, train, cfg, mesh)
        obj_rel = rel(stats["loss"], stats1["loss"])
        nnz_rel = rel(model.nnz, model1.nnz)
        where = stats.get("blocks_by_device")
        peak = [_peak_bytes(d) for d in devs]
        log(f"[cards] {name} on {mesh.shape}: {t:.2f}s (cold) objective "
            f"{stats['loss']:.9e} nnz {model.nnz}; rel diff objective "
            f"{obj_rel:.3e}, nnz {nnz_rel:.3e}; blocks by device {where}; "
            f"peak GB by device {peak}")
        check(obj_rel <= OBJ_RTOL, f"{name}: objective differs by "
              f"{obj_rel:.3e}")
        check(nnz_rel <= NNZ_RTOL, f"{name}: nnz differs by {nnz_rel:.3e}")
        if where is not None:
            check(len(where) == ncards and min(where.values()) > 0,
                  f"{name}: column blocks ran on {where}, not on all "
                  f"{ncards} cards")
        check(all(b is None or b > 0 for b in peak),
              f"{name}: a card held no memory")
        out[name] = {"s": t, "obj_rel": obj_rel, "nnz_rel": nnz_rel,
                     "blocks_by_device": where}
    return out


# --------------------------------------------------------------------- #
def run(args) -> dict:
    from slim_tpu.datagen import synth_ml20m, synth_zipf
    from slim_tpu.solvers.cd import bucket_npad
    from slim_tpu.utils import enable_compilation_cache

    info = phase_device(args.cards if args.cards > 1 else None)
    smi = nvidia_smi()
    enable_compilation_cache()
    cfg = default_cfg()

    train, t_gen = timed(synth_ml20m, seed=args.seed)
    train = train.infer_ncols()
    npad = bucket_npad(train.ncols)
    log(f"[data] ML-20M shape {train.nrows}x{train.ncols} nnz {train.nnz} "
        f"(npad {npad}; generated in {t_gen:.1f}s)")

    if args.cards > 1:
        phase_cards(train, cfg, args.cards)
    else:
        phase_gram(train, npad, seed=args.seed)
        model, stats, _ = phase_learn(train, cfg)
        phase_kernel(train, npad, stats["block_size"], cfg, seed=args.seed)
        phase_serve(train, model)
        del model
        mid = synth_zipf(50_000, 10_000, 2_000_000, 1.25, seed=args.seed)
        model_mid, _ = phase_native(mid, cfg)
        phase_cli(mid, model_mid.nnz)
    log(smi)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the distributed learns on 4 cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import logging

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    t0 = time.perf_counter()
    try:
        info = run(args)
    except Exception as e:  # any phase failure ends the run without "ok"
        import traceback

        traceback.print_exc()
        log(f"FAILED after {time.perf_counter() - t0:.1f}s: "
            f"{type(e).__name__}: {e}")
        return 1
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
