"""chip_smoke.py: its phases on tiny shapes (CPU), and its refusal to
report success anywhere but on a GPU."""

import functools
import json

import numpy as np
import pytest

import chip_smoke
from conftest import random_csr


def test_refuses_ok_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def _tiny(seed=0):
    from slim_tpu.datagen import synth_zipf

    return synth_zipf(400, 300, 6000, 1.25, seed=seed).infer_ncols()


def test_phase_gram_and_learn_tiny():
    from slim_tpu.solvers.cd import bucket_npad

    train = _tiny()
    npad = bucket_npad(train.ncols)
    info = chip_smoke.phase_gram(train, npad, ncheck=64)
    assert info["gram_s"] > 0
    model, stats, info = chip_smoke.phase_learn(
        train, chip_smoke.default_cfg(block_size=64))
    assert info["model_nnz"] == model.nnz > 0


def test_phase_kernel_tiny_triton_interpret(monkeypatch):
    """Head and tail block through the Triton sweep (interpret mode)
    against the plain XLA sweep."""
    import jax

    from slim_tpu.ops import cd_kernel
    from slim_tpu.ops.cd_triton import gs_chunk
    from slim_tpu.solvers.cd import bucket_npad

    monkeypatch.setattr(cd_kernel, "sweep_impl", lambda *a: cd_kernel.Sweep(
        "triton", cd_kernel.HIGHEST))
    monkeypatch.setattr(cd_kernel, "gs_chunk",
                        functools.partial(gs_chunk, interpret=True))
    jax.clear_caches()
    train = _tiny(1)
    out = chip_smoke.phase_kernel(train, bucket_npad(train.ncols), 16,
                                  chip_smoke.default_cfg())
    assert set(out) == {"head", "tail"}
    assert all(v["obj_rel"] <= 1e-5 for v in out.values())


def test_phase_native_serve_cli_tiny(tmp_path):
    from slim_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    train = _tiny(2)
    cfg = chip_smoke.default_cfg(block_size=64)
    # a few hundred model entries: one entry near the 1e-7 cut is 0.3%
    model, info = chip_smoke.phase_native(train, cfg, nnz_rtol=1e-2)
    assert info["obj_rel"] <= 1e-5
    serve = chip_smoke.phase_serve(train, model)
    assert serve["users_per_s"] > 0
    cli = chip_smoke.phase_cli(train, model.nnz, workdir=str(tmp_path),
                               nnz_rtol=1e-2)
    assert cli["cli_learn_s"] > 0


def test_compare_topn_tie_rule():
    """Ids may differ only where the two ids' exact scores tie within the
    tolerance; a real rank difference fails."""
    from slim_tpu.types import CSR

    # one user with history {0}; model row 0 scores items 1, 2 equally
    hist = CSR.from_ijv(np.array([0]), np.array([0]),
                        np.ones(1, np.float32), 1, 4)
    model = CSR.from_ijv(np.array([0, 0, 0]), np.array([1, 2, 3]),
                         np.array([0.5, 0.5, 0.25], np.float32), 4, 4)
    nat = (np.array([[1, 2, 3]]), np.array([[.5, .5, .25]], np.float32),
           np.array([3]))
    swapped = (np.array([[2, 1, 3]]), nat[1], nat[2])
    out = chip_smoke.compare_topn(swapped, nat, hist, model, 1e-5)
    assert out["id_swaps_within_ties"] == 2
    wrong = (np.array([[1, 3, 2]]), nat[1], nat[2])
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.compare_topn(wrong, nat, hist, model, 1e-5)


def test_phase_cards_four_virtual_devices():
    """The --cards path on 4 virtual CPU devices: both distributed learns
    match the one-device learn and the replicated mode spreads its column
    blocks over all four devices."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    train = random_csr(None, 300, 200, density=0.05, seed=4).binarize()
    out = chip_smoke.phase_cards(train.infer_ncols(),
                                 chip_smoke.default_cfg(block_size=16), 4)
    assert len(out["replicated"]["blocks_by_device"]) == 4
    assert out["blockwise"]["obj_rel"] <= 1e-5
