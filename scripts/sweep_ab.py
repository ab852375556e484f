"""Time the CD block-solve forms against each other on one GPU.

    python scripts/sweep_ab.py [--blocks 512,1024] [--forms ...]
    python scripts/sweep_ab.py --learn [--workload ml20m|mid] [--blocks ...]

Forms (ops/cd_kernel._cd_core ``impl`` and ``precision``); every form
visits the per-sweep list of active chunks:
  xla       the in-chunk loop as 128 dependent XLA steps (gs_chunk_xla),
            the sweep products at Precision.HIGHEST
  triton    the in-chunk loop in the Pallas Triton kernel, products at
            Precision.HIGHEST
  triton_x3 triton with the products at TF32_TF32_F32_X3 (what the solver
            runs on the GPU)

Measures, on the ML-20M-shaped workload (datagen.synth_ml20m) relabelled by
item frequency: the time per sweep of each form at (B, 28672) on the head
block (every column live: caps = 3 sweeps, optTol = 0), and the head
block's full solve against the plain form (objective and |dx|).  Then the
same per-sweep timing at the compact union widths of the 50k x 10k workload.
``--learn`` instead times end-to-end ``api.learn`` per form and block size
on ML-20M or (``--workload mid``) the 50,000 x 10,000 compact-path log:
the first learn (compile included) and a second, warm one.  Only the forms
the solver can run take part (``xla`` and ``triton_x3``: the learn's
precision follows the platform, ops/cd_kernel.sweep_impl).  Results go to
stdout and chiprun_out/sweep_ab.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "chiprun_out", "sweep_ab.json")
FORMS = ("triton", "triton_x3", "xla")
LEARN_KERNEL = {"triton_x3": "triton", "xla": "xla"}


def log(msg):
    print(msg, flush=True)


def form_args(form):
    """(impl, precision) of a form."""
    from slim_tpu.ops.cd_kernel import HIGHEST, TF32_X3

    return {"xla": ("xla", HIGHEST), "triton": ("triton", HIGHEST),
            "triton_x3": ("triton", TF32_X3)}[form]


def relabelled(train, npad):
    import jax.numpy as jnp

    from slim_tpu.ops.gram import compute_gram

    n = train.ncols
    p = np.argsort(-train.col_nnz(), kind="stable").astype(np.int32)
    p_pad = jnp.asarray(np.concatenate([p, np.arange(n, npad,
                                                     dtype=np.int32)]))
    G = compute_gram(train, "device", pad_to=npad)
    return jnp.take(jnp.take(G, p_pad, axis=0), p_pad, axis=1), p


def solve(G, j, caps, n, form, optTol):
    import jax
    import jax.numpy as jnp

    from slim_tpu.ops.cd_kernel import cd_solve_block_ids

    impl, precision = form_args(form)
    B, npad = len(j), G.shape[0]
    x0 = jnp.zeros((B, npad), jnp.float32)
    return jax.block_until_ready(cd_solve_block_ids(
        G, jnp.asarray(j), jnp.asarray(caps), x0, n, 1.0, 1.0, optTol, 0,
        shuffle=True, impl=impl, precision=precision))


def per_sweep(G, j, n, form, nsweeps=3, reps=2):
    """Seconds per sweep with every column live for ``nsweeps`` sweeps."""
    caps = np.full(len(j), nsweeps, np.int32)
    t0 = time.perf_counter()
    solve(G, j, caps, n, form, 0.0)
    t_first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        solve(G, j, caps, n, form, 0.0)
        best = min(best, time.perf_counter() - t0)
    return best / nsweeps, t_first


def learn_ab(train, forms, blocks, res, dump):
    """End-to-end api.learn per (form, block size) on one workload."""
    from slim_tpu.api import learn
    from slim_tpu.config import SlimConfig

    for form in forms:
        if form not in LEARN_KERNEL:
            raise SystemExit(f"--learn takes the forms {list(LEARN_KERNEL)}")
        for B in blocks:
            cfg = SlimConfig(kernel=LEARN_KERNEL[form], block_size=B)
            t0 = time.perf_counter()
            learn(train, cfg)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, st = learn(train, cfg)
            t = time.perf_counter() - t0
            log(f"[learn] {form} B={B}: {t:.2f}s (first {t_first:.2f}s) "
                f"objective {st['loss']:.9e} sweeps {st.get('sweeps')}")
            res["learn"].append({"form": form, "B": B, "s": t,
                                 "first_s": t_first, "loss": st["loss"],
                                 "sweeps": st.get("sweeps")})
            dump()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", default="512,1024")
    ap.add_argument("--forms", help="default: every form the mode takes")
    ap.add_argument("--parity-block", type=int, default=256)
    ap.add_argument("--learn", action="store_true")
    ap.add_argument("--workload", default="ml20m", choices=("ml20m", "mid"))
    args = ap.parse_args()
    import jax

    from slim_tpu.datagen import synth_ml20m, synth_zipf
    from slim_tpu.solvers.cd import bucket_npad
    from slim_tpu.utils import enable_compilation_cache

    assert jax.default_backend() == "gpu", "needs the GPU"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"card: {smi}; jax {jax.__version__}")
    enable_compilation_cache()
    forms = (args.forms.split(",") if args.forms
             else list(LEARN_KERNEL if args.learn else FORMS))
    blocks = [int(b) for b in args.blocks.split(",")]
    res = {"card": smi, "per_sweep": [], "parity": [], "learn": []}

    def dump():
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        with open(OUT, "w") as fh:
            json.dump(res, fh, indent=1)

    def mid_log():
        return synth_zipf(50_000, 10_000, 2_000_000, 1.25).infer_ncols()

    if args.learn:
        train = (mid_log() if args.workload == "mid"
                 else synth_ml20m().infer_ncols())
        learn_ab(train, forms, blocks, res, dump)
        log(json.dumps(res))
        return
    train = synth_ml20m().infer_ncols()
    n = train.ncols
    npad = bucket_npad(n)
    G, p = relabelled(train, npad)
    caps_all = np.minimum(50 * train.col_nnz()[p], 10000).astype(np.int32)
    for B in blocks:
        j = np.arange(B, dtype=np.int32)
        for form in forms:
            try:
                t, t_first = per_sweep(G, j, n, form)
            except Exception as e:  # record a form that fails to compile
                log(f"[sweep] {form} B={B}: FAILED {type(e).__name__}: "
                    f"{str(e)[:300]}")
                res["per_sweep"].append({"form": form, "B": B, "width": npad,
                                         "error": str(e)[:300]})
                continue
            log(f"[sweep] {form} B={B} width={npad}: {t * 1e3:.2f} ms/sweep "
                f"(first call {t_first:.1f}s)")
            res["per_sweep"].append({"form": form, "B": B, "width": npad,
                                     "ms_per_sweep": t * 1e3,
                                     "first_call_s": t_first})
            dump()
    # full solve of the head block: each form vs the plain one
    B = args.parity_block
    j = np.arange(B, dtype=np.int32)
    ref = None
    for form in ["xla"] + [f for f in forms if f != "xla"]:
        solve(G, j, caps_all[j], n, form, 1e-7)
        t0 = time.perf_counter()
        out = [np.asarray(a) for a in solve(G, j, caps_all[j], n, form,
                                            1e-7)]
        t = time.perf_counter() - t0
        if ref is None:
            ref = out
        obj_rel = float(np.max(np.abs(out[4] - ref[4])
                               / np.maximum(np.abs(ref[4]), 1e-30)))
        dx = float(np.max(np.abs(out[0] - ref[0])))
        log(f"[solve] {form} head B={B}: {t:.2f}s, {int(out[1].max())} "
            f"sweeps; vs xla: obj rel {obj_rel:.3e}, max|dx| {dx:.3e}")
        res["parity"].append({"form": form, "B": B, "s": t,
                              "sweeps": int(out[1].max()),
                              "obj_rel": obj_rel, "max_dx": dx})
        dump()
    del G

    mid = mid_log()
    npad_m = bucket_npad(mid.ncols)
    Gm, pm = relabelled(mid, npad_m)
    from slim_tpu.ops.cd_kernel import block_union_flags, compact_union_ids

    Bm = blocks[0]
    nb = (mid.ncols + Bm - 1) // Bm
    _, cnt = compact_union_ids(block_union_flags(Gm, nb, Bm, 1.0))
    widths = sorted({min(bucket_npad(max(int(c), 1)), npad_m)
                     for c in np.asarray(cnt)})
    log(f"[mid] 50k x 10k union widths at B={Bm}: {widths}")
    for K in widths:
        Gk = Gm[:K, :K]
        jk = np.arange(Bm, dtype=np.int32)
        for form in forms:
            t, _ = per_sweep(Gk, jk, min(mid.ncols, K), form)
            log(f"[sweep] {form} B={Bm} width={K}: {t * 1e3:.2f} ms/sweep")
            res["per_sweep"].append({"form": form, "B": Bm, "width": K,
                                     "ms_per_sweep": t * 1e3})
        dump()
    del Gm

    log(json.dumps(res))


if __name__ == "__main__":
    main()
