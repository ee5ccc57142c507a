"""pytorch_nmf_tpu_torch — the PyTorch/CUDA port of ``pytorch_nmf_tpu``.

Same module layout and names as the JAX package; dense ``NMF.fit`` runs on
any PyTorch device, and on an NVIDIA Hopper GPU its β ≠ 2 multiplicative
updates and loss run in hand-written CUDA kernels (``csrc/fused_mu.cu``,
built with ``nvcc`` at first use).  This package never imports JAX.
"""

from . import metrics, models, nmf, ops, utils  # noqa: F401

name = "pytorch_nmf_tpu_torch"
__version__ = "1.0.0"
