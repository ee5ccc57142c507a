"""pytorch_nmf_tpu_torch — the PyTorch/CUDA port of ``pytorch_nmf_tpu``.

Same module layout and names as the JAX package.  Dense ``NMF.fit`` (dense
or sparse COO targets), the deconvolutional ``NMFD``/``NMF2D``/``NMF3D.fit``,
the PLCA family's EM ``PLCA``/``SIPLCA``/``SIPLCA2``/``SIPLCA3.fit``, Hoyer
``sparse_fit``, the functional and batched API (:mod:`.functional`, with
``streaming_nmf_fit`` for a target in host memory) and the
``BetaMu``/``SparsityProj`` optimizers (:mod:`.trainer`) run on any PyTorch
device; on an NVIDIA Hopper GPU their heavy contractions run
in hand-written CUDA kernels (``csrc/fused_mu.cu`` for dense β ≠ 2 and the
streaming blocks, ``csrc/fused_deconv.cu`` for the deconv family, the
SIPLCA E-step and the deconv models' Hoyer fit), built
with ``nvcc`` at first use.  A deconv fit times its engines above a size
threshold and keeps the fastest (:mod:`.ops.autotune`): on the card the
kernels and the hybrid of ``wgrad`` and the streamed fold; the unfold
GEMMs, the β=2 autocorrelation and FFT engines and the generic engine are
pinned there, and candidates on the CPU.  :mod:`.utils` holds
checkpointed fits that resume (either package's directories),
``torch.profiler`` helpers and ``LossHistory``; :mod:`.parallel` the
sharded fits on ``torch.distributed`` (NCCL across cards, gloo on the CPU).
This package never imports JAX.
"""

from . import (functional, metrics, models, nmf, ops, parallel, plca,  # noqa: F401
               trainer, utils)
from .ops.sparse import sparse_from_dense  # noqa: F401

name = "pytorch_nmf_tpu_torch"
__version__ = "1.0.0"
