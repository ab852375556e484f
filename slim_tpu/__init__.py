"""slim_tpu: a Sparse LInear Methods (SLIM) top-N recommendation framework
for JAX accelerators.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of KarypisLab/SLIM
(Ning & Karypis, ICDM 2011): learns an item-item sparse coefficient matrix W
by solving, independently per item column, an elastic-net-regularised
nonnegative least-squares problem, then recommends top-N items by sparse
score accumulation.

Quick start::

    from slim_tpu import SLIM, SLIMatrix, SlimConfig
    trn = SLIMatrix(train_csr)           # scipy csr / triplets / DataFrame
    model = SLIM()
    model.train({'l1r': 1.0, 'l2r': 1.0}, trn)
    topn = model.predict(trn, nrcmds=10)

Functional API: ``learn``, ``get_topn``, ``mselect_grid`` and the io/eval
modules mirror the reference C API (include/slim.h:79-167).
"""

from .config import (
    SlimConfig,
    SLIM_OK,
    SLIM_ERROR,
    SLIM_DBG_INFO,
    SLIM_DBG_TIME,
    SLIM_DBG_PROGRESS,
)
from .types import CSR
from .api import SLIM, SLIMatrix, learn, get_topn, read_model, write_model
from .eval import determine_head_tail, evaluate_topn, EvalResult
from .mselect import mselect_grid, mselect_pairs
from .predict import predict_topn, predict_topn_1vsk
from . import io

__version__ = "0.1.0"

__all__ = [
    "SlimConfig", "CSR", "SLIM", "SLIMatrix", "learn", "get_topn",
    "read_model", "write_model", "determine_head_tail", "evaluate_topn",
    "EvalResult", "mselect_grid", "mselect_pairs", "predict_topn",
    "predict_topn_1vsk", "io", "SLIM_OK", "SLIM_ERROR", "SLIM_DBG_INFO",
    "SLIM_DBG_TIME", "SLIM_DBG_PROGRESS", "__version__",
]
