"""Multi-process jax.distributed exercise.

Spawns 2 OS processes (coordinator + worker) with 2 virtual CPU devices
each; ``parallel.mesh.init_distributed`` wires them into one 4-device
global mesh, and ``distributed_learn`` runs with its collectives actually
crossing the process boundary -- the multi-host code path of SURVEY §4
that single-process virtual meshes cannot reach.  The objective is
asserted against the single-process solver on the same data.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(mode: str, nproc: int = 2, timeout: int = 300):
    port = _free_port()
    env = dict(os.environ)
    # the workers are plain CPU processes regardless of the host platform
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), str(nproc), str(port), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(nproc)]
    results, errs = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
        for line in out.splitlines():
            if line.startswith("RESULT "):
                results.append(json.loads(line[len("RESULT "):]))
    assert all(p.returncode == 0 for p in procs), \
        f"worker failed:\n{errs}"
    assert len(results) == nproc, f"missing RESULT lines:\n{errs}"
    return results


def _single_process_reference():
    sys.path.insert(0, HERE)
    import _mp_worker  # side-effect-free import (env writes are __main__-only)

    from slim_tpu.api import learn
    from slim_tpu.config import SlimConfig

    train = _mp_worker.toy_train()
    _, stats = learn(train, SlimConfig(l1r=1.0, l2r=1.0, shuffle=False))
    return float(stats["loss"]), int(stats["nnz"])


@pytest.mark.parametrize("mode", ["replicated", "blockwise", "sharded_g"])
def test_two_process_distributed_learn_matches_single(mode):
    results = _run_workers(mode)
    assert all(r["process_count"] == 2 and r["ndev"] == 4 for r in results)
    # both controllers see the same replicated result
    assert results[0]["nnz"] == results[1]["nnz"]
    np.testing.assert_allclose(results[0]["loss"], results[1]["loss"],
                               rtol=1e-6)
    assert results[0]["pred_ids_sum"] == results[1]["pred_ids_sum"]
    assert results[0]["pred_counts_sum"] == results[1]["pred_counts_sum"]
    assert results[0]["pred_counts_sum"] > 0
    ref_loss, ref_nnz = _single_process_reference()
    np.testing.assert_allclose(results[0]["loss"], ref_loss, rtol=1e-5)
    assert abs(results[0]["nnz"] - ref_nnz) <= max(3, ref_nnz * 0.01)
