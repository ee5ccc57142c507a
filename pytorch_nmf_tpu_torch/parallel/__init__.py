"""Multi-GPU fits on ``torch.distributed`` (counterpart of
:mod:`pytorch_nmf_tpu.parallel`): one process per rank, a
:class:`~torch.distributed.device_mesh.DeviceMesh` (:func:`make_mesh`),
DTensors at the boundary (:func:`shard_target`), plain local tensors and
explicit collectives (:mod:`.comm`) inside the loops.

* :func:`sharded_nmf_fit`, :func:`sharded_plca_fit`: samples over a
  ``data`` dimension (and features over ``model``), all-reduced numerators;
  B1/B2 per rank at β ≠ 2;
* :func:`sharded_sparse_nmf_fit`: row-sharded dual-ELL sparse targets;
* :func:`sharded_nmfd_fit`, :func:`sharded_nmf2d_fit`,
  :func:`sharded_nmf3d_fit` and :func:`sharded_siplca_fit`,
  :func:`sharded_siplca2_fit`, :func:`sharded_siplca3_fit`: the trailing
  axis over a ``seq`` dimension with a halo exchange, B3/B4 per rank.

NCCL across cards; gloo on the CPU, and for several ranks sharing one card
(:mod:`.comm` stages the halo exchanges' card tensors through pinned host
memory for it).
"""

from . import comm, distributed  # noqa: F401
from .halo import (left_halo, sharded_nmf2d_fit, sharded_nmf3d_fit,  # noqa: F401
                   sharded_nmfd_fit, sharded_siplca2_fit, sharded_siplca3_fit,
                   sharded_siplca_fit)
from .mesh import make_hybrid_mesh, make_mesh  # noqa: F401
from .sharded import shard_target, sharded_nmf_fit, sharded_plca_fit  # noqa: F401
from .sharded_sparse import sharded_sparse_nmf_fit  # noqa: F401

__all__ = [
    "distributed",
    "left_halo",
    "make_hybrid_mesh",
    "make_mesh",
    "shard_target",
    "sharded_nmf2d_fit",
    "sharded_nmf3d_fit",
    "sharded_nmf_fit",
    "sharded_nmfd_fit",
    "sharded_plca_fit",
    "sharded_siplca2_fit",
    "sharded_siplca3_fit",
    "sharded_siplca_fit",
    "sharded_sparse_nmf_fit",
]
