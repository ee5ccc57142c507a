"""Device-memory-aware byte budgets (counterpart of
:mod:`pytorch_nmf_tpu.ops.budget`).

The sparse fit's entry decisions (densify the target, build the dual-ELL
layout) are gated on byte budgets: a fraction of the target's card
(``torch.cuda.mem_get_info``'s total), a fixed constant for a CPU target,
and an environment override before either.
"""

import os

import torch

__all__ = ["device_bytes_limit", "budget_bytes"]


def device_bytes_limit(device=None):
    """The total memory in bytes of the CUDA ``device`` (the current card
    when ``None``, if there is one), from ``torch.cuda.mem_get_info``;
    ``None`` for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def budget_bytes(env_var: str, default_bytes: int, fraction: float,
                 device=None) -> int:
    """``env_var``'s value when set, else ``fraction`` of the memory of the
    CUDA ``device`` (:func:`device_bytes_limit`), else ``default_bytes``."""
    env = os.environ.get(env_var, "")
    if env:
        return int(env)
    limit = None if device is None else device_bytes_limit(device)
    return int(limit * fraction) if limit else default_bytes
