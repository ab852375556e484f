"""Configuration for slim_tpu.

One dataclass replaces the reference's two-layer option plumbing (fixed-size
``ioptions[40]``/``doptions[40]`` arrays indexed by ``slim_options_et``,
include/slim.h:214-230, with ``-1 = use default`` GETOPTION semantics,
src/libslim/macros.h:14-15).  The knob names and defaults match the C API
defaults (src/libslim/api.c:42-52): l1r=l2r=1.0, optTol=1e-7,
maxniters=10000, simtype=cos, algo=cd.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# return codes (parity with include/slim.h:171-178)
SLIM_OK = 1
SLIM_ERROR_INPUT = -2
SLIM_ERROR_MEMORY = -3
SLIM_ERROR = -4

# debug levels (parity with include/slim.h:233-239)
SLIM_DBG_INFO = 1
SLIM_DBG_TIME = 2
SLIM_DBG_PROGRESS = 4
SLIM_DBG_PROGRESS2 = 16
SLIM_DBG_MEMORY = 2048

SIMTYPES = ("cos", "jac", "dotp")
ALGOS = ("admm", "cd")
MTYPES = ("slim", "fslim", "oslim", "ofslim")


@dataclasses.dataclass
class SlimConfig:
    """Training configuration.

    Device execution knobs (block_size, solver_dtype, gram, kernel) have no
    reference counterpart; ``nthreads`` is kept for API compatibility but
    only controls host-side threads.
    """

    # regularisation / optimisation (reference api.c:42-52 defaults)
    l1r: float = 1.0
    l2r: float = 1.0
    optTol: float = 1e-7
    maxniters: int = 10000
    algo: str = "cd"            # "cd" | "admm"

    # FSLIM
    nnbrs: int = 0              # >0 selects FSLIM
    simtype: str = "cos"        # "cos" | "jac" | "dotp"

    # vestigial in the reference (ordered is plumbed but never consumed,
    # SURVEY.md §5; kept for mtype naming parity)
    ordered: int = 0

    # misc
    nrcmds: int = 10
    dbglvl: int = 0
    nthreads: int = 0           # 0 = all host cores (host-side work only)
    seed: int = 0               # base PRNG seed for CD coordinate shuffling

    # --- device execution knobs (new; no reference counterpart) ---
    block_size: int = 512       # item columns solved per device batch
                                # (the compact path takes B/2, B or 2B
                                # from the union widths, at most
                                # cd_kernel.MAX_BLOCK)
    solver_dtype: str = "float32"
    gram: str = "auto"          # "auto" | "device" | "host"
    kernel: str = "auto"        # "auto" | "triton" | "xla" (auto: by
                                # platform, ops/cd_kernel.sweep_impl)
    compact_threshold: int = 4096  # npad above which blocks solve in the
                                # compacted union-active-set space (keeps
                                # per-sweep cost O(K_active²) instead of
                                # O(npad²) on huge item catalogues)
    checkpoint_dir: str = ""    # "" = off; else resumable per-block-group
                                # solve state (column solves are idempotent,
                                # so restart = re-solve missing groups only)
    profile_dir: str = ""       # "" = off; else jax.profiler trace output
    shuffle: bool = True        # shuffled coordinate order per sweep (cd.c:115)
    donate_gram: bool = False

    def __post_init__(self):
        self.validate()

    # ------------------------------------------------------------------ #
    @property
    def mtype(self) -> str:
        """Model-type resolution (reference api.c:54-60)."""
        if self.nnbrs > 0 and self.ordered == 0:
            return "fslim"
        if self.nnbrs > 0 and self.ordered == 1:
            return "ofslim"
        if self.nnbrs == 0 and self.ordered == 1:
            return "oslim"
        return "slim"

    def validate(self) -> None:
        if self.l1r < 0 or self.l2r < 0:
            raise ValueError("l1r/l2r must be non-negative")
        if self.optTol < 0:
            raise ValueError("optTol must be non-negative")
        if self.maxniters < 0:
            raise ValueError("maxniters must be non-negative")
        if self.nnbrs < 0:
            raise ValueError("nnbrs must be non-negative")
        if self.simtype not in SIMTYPES:
            raise ValueError(f"simtype must be one of {SIMTYPES}")
        if self.algo not in ALGOS:
            raise ValueError(f"algo must be one of {ALGOS}")
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")

    @staticmethod
    def from_dict(params: Optional[dict] = None, **kw) -> "SlimConfig":
        """Build from a loose dict, accepting the reference Python package's
        key names (core.py:46-198); unknown keys raise."""
        params = dict(params or {})
        params.update(kw)
        if "niters" in params:  # python-package name for maxniters
            params["maxniters"] = params.pop("niters")
        elif "maxniters" not in params:
            # the reference python package defaults niters to 50 in the
            # dict/obj API (core.py:87,165) -- much lower than the C CLI's
            # 10000 -- so the dict entry point must match it
            params["maxniters"] = 50
        fields = {f.name for f in dataclasses.fields(SlimConfig)}
        unknown = set(params) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return SlimConfig(**params)

    def replace(self, **kw) -> "SlimConfig":
        return dataclasses.replace(self, **kw)


def dbg(cfg_or_lvl, bit: int) -> bool:
    """IFSET equivalent (reference macros.h)."""
    lvl = cfg_or_lvl.dbglvl if isinstance(cfg_or_lvl, SlimConfig) else int(cfg_or_lvl)
    return bool(lvl & bit)
