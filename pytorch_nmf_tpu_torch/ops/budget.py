"""Device-memory-aware byte budgets (counterpart of
:mod:`pytorch_nmf_tpu.ops.budget`).

The sparse fit's entry decisions (densify the target, build the dual-ELL
layout) are gated on byte budgets: a fraction of the target's card
(``torch.cuda.mem_get_info``'s total), a fixed constant for a CPU target,
and an environment override before either.
"""

import os

import torch

__all__ = ["budget_bytes"]


def budget_bytes(env_var: str, default_bytes: int, fraction: float,
                 device=None) -> int:
    """``env_var``'s value when set, else ``fraction`` of the memory of the
    CUDA ``device``, else ``default_bytes``."""
    env = os.environ.get(env_var, "")
    if env:
        return int(env)
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1] * fraction)
    return default_bytes
