"""Mesh construction (counterpart of :mod:`pytorch_nmf_tpu.parallel.mesh`):
a ``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks of the default process group, one rank per mesh position.
A mesh dimension's process group is ``mesh.get_group(name)``."""

from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "make_hybrid_mesh"]


def make_mesh(axes: Dict[str, int], device_type: str = "cuda") -> DeviceMesh:
    """A :class:`DeviceMesh` of ``{axis_name: size}`` over ranks ``0 ..
    prod(sizes) - 1`` of the default process group, row-major::

        mesh = make_mesh({"data": 2, "model": 2})   # 4 ranks

    ``device_type`` is ``"cuda"`` (the ranks' cards, NCCL or gloo) or
    ``"cpu"`` (gloo).  Every rank of the world calls it; a rank outside a
    smaller mesh gets a mesh whose ``get_coordinate()`` is ``None`` and
    must not call a sharded fit with it.  Raises ``ValueError`` when the
    mesh needs more ranks than the world has (JAX's ``make_mesh`` raises
    when it needs more devices than there are)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.distributed.initialize first")
    names = tuple(axes)
    sizes = tuple(int(axes[n]) for n in names)
    n_needed = 1
    for s in sizes:
        n_needed *= s
    world = dist.get_world_size()
    if n_needed > world:
        raise ValueError(
            f"mesh {axes} needs {n_needed} ranks, only {world} available")
    return DeviceMesh(device_type, torch.arange(n_needed).reshape(sizes),
                      mesh_dim_names=names)


def make_hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int],
                     device_type: str = "cuda") -> DeviceMesh:
    """One mesh whose dimensions run over ``dcn_axes`` (between hosts)
    first, then ``ici_axes`` (within a host): put the sample axis in
    ``dcn_axes`` so only the small numerator all-reduces cross hosts.
    PyTorch exposes no slice topology, so this is the JAX package's flat
    path (``mesh.py:76-81``): ranks are laid out row-major, and a launcher
    that numbers a host's ranks consecutively puts each ``ici_axes`` block
    on one host."""
    merged = dict(dcn_axes)
    merged.update(ici_axes)
    return make_mesh(merged, device_type)
