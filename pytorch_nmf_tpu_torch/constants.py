"""Global numerical constants (counterpart of ``pytorch_nmf_tpu.constants``).

``eps`` is the float32 machine epsilon, the guard against division by zero
and ``log(0)`` throughout the library (reference ``torchnmf/constants.py:3``).
"""

import torch

eps: float = float(torch.finfo(torch.float32).eps)

__all__ = ["eps"]
