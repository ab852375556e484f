"""Device-mesh helpers.

The reference's only parallel axis is an OpenMP loop over item columns
(estimate.c:371-403).  The device layout uses a 2-D mesh:

* ``dp``  -- user-row sharding for the Gram matmul (partial Grams are
  psum-reduced over this axis: the collective replaces the reference's
  shared-memory access to the full matrix);
* ``mp``  -- item-column sharding for the solves.  Solves are
  embarrassingly parallel, so after the Gram psum the column work is
  sharded over the *flattened* (dp, mp) grid: every device solves a
  distinct block of columns, none idles as a pure replica.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh
import numpy as np


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Pick (dp, mp) with dp as close to sqrt as divides n_devices."""
    dp = int(np.floor(np.sqrt(n_devices)))
    while dp > 1 and n_devices % dp:
        dp -= 1
    return dp, n_devices // dp


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialise the multi-host runtime (jax.distributed).

    The replacement for the reference's nonexistent distributed story (it
    is shared-memory OpenMP only, SURVEY.md §2): after this,
    ``jax.devices()`` spans all hosts and ``make_mesh`` lays the (dp, mp)
    grid over every device; XLA compiles the Gram psum into the
    interconnect's collectives.  No-op when already initialised
    or when running single-process.
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except (RuntimeError, ValueError):
        pass  # already initialised / single-process


def make_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None,
              axis_names=("dp", "mp")) -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if shape is None:
        shape = default_mesh_shape(n)
    dp, mp = shape
    assert dp * mp == n, f"mesh shape {shape} != {n} devices"
    grid = np.asarray(devs[:n]).reshape(dp, mp)
    return Mesh(grid, axis_names)
