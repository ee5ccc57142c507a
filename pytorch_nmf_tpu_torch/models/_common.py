"""Shared helpers for the model layer (shape inference, init, validation);
counterpart of :mod:`pytorch_nmf_tpu.models._common`."""

import contextlib
import os
import sys
import warnings
from collections.abc import Iterable as Iterabc
from typing import Optional

import numpy as np
import torch

__all__ = [
    "is_tensor_like",
    "resolve_device",
    "to_param",
    "host_tensor",
    "target_dtype",
    "target_like",
    "rand_abs_normal",
    "assert_nonneg",
    "validate_target",
    "is_dtensor",
    "sharding_spec",
    "trailing_seq_axis",
    "row_axes",
    "gather_whole",
    "simply_placed",
    "partial_over",
    "place_like",
    "load_placed",
    "fit_declined",
    "validate_sharded",
    "set_factors",
    "single",
    "pair",
    "triple",
]


def is_tensor_like(x) -> bool:
    """True for array-valued inputs (tensors, numpy arrays, anything with
    ``shape`` and ``ndim``), False for shape tuples and lists."""
    return hasattr(x, "shape") and hasattr(x, "ndim")


def resolve_device(device=None,
                   generator: Optional[torch.Generator] = None) -> torch.device:
    """The device a model lives on: ``device``, the card (``"cuda"``) when
    ``None``.  Raises ``ValueError`` for a ``generator`` on another device,
    and ``RuntimeError`` for the card where there is none: the port never
    falls back to the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if generator is not None:
        gen = generator.device
        if gen.type != device.type or (
                device.index is not None and gen.index != device.index):
            raise ValueError(f"the generator is on {gen}, the model on {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return device


def to_param(x, device=None) -> torch.Tensor:
    """Factor values as a tensor on ``device`` (:func:`resolve_device`: the
    card when ``None``): float64 stays float64 (the generic engine then runs
    in double precision, as the reference honors the input dtype,
    ``torchnmf/nmf.py:215``); every other dtype becomes float32.  Always a
    copy: fitting the model never writes into the caller's array."""
    x = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x))
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.detach().to(device=resolve_device(device), dtype=dtype, copy=True)


_F64_WARNING = (
    "float64 target cast to float32, the dtype of the model's factors. To "
    "fit in double precision, give the model float64 factors (W= and H= "
    "float64 arrays or tensors)."
)


def host_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, an array through numpy.  A
    numpy array of ``ml_dtypes.bfloat16`` (what ``np.asarray`` gives for a
    JAX bfloat16 array) is read through its 16-bit pattern, which torch
    shares with its own bfloat16."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def target_dtype(dtype: torch.dtype, factor_dtype: torch.dtype) -> torch.dtype:
    """The dtype a dense target of ``dtype`` is held in by a fit whose
    factors are ``factor_dtype`` (the JAX package's ``to_f32``): bfloat16
    against float32 factors stays bfloat16, a capacity knob that halves the
    target's memory (the factors, the accumulators and every result stay
    float32); every other dtype becomes the factors'."""
    if dtype == torch.bfloat16 and factor_dtype == torch.float32:
        return torch.bfloat16
    return factor_dtype


def target_like(V, *factors) -> torch.Tensor:
    """``V`` (a dense or sparse COO tensor anywhere, or a numpy array) on
    the factors' device in the dtype the fit holds it in
    (:func:`target_dtype`; a sparse ``V`` in the factors' dtype, float32
    for a float32 model, as the JAX package's sparse targets).  A float64
    ``V`` cast to float32 factors raises a ``UserWarning``, as the JAX
    package's downcast does.  The factors must share one device and one
    dtype (``ValueError`` otherwise).

    A dense ``V`` comes back contiguous, or, when it had to be copied to
    the card as a 2-D float32 or bfloat16 matrix, as a view of storage whose
    rows are padded to 16 bytes (:func:`~..ops.fused_mu.aligned_copy`):
    the kernels read it as it is, and the fit holds one copy of ``V``."""
    p = factors[0]
    for q in factors[1:]:
        if q.device != p.device or q.dtype != p.dtype:
            raise ValueError(
                f"the factors are {p.dtype} on {p.device} and {q.dtype} on "
                f"{q.device}: a fit runs in one dtype, on one device")
    V = host_tensor(V)
    if V.dtype == torch.float64 and p.dtype == torch.float32:
        warnings.warn(_F64_WARNING, UserWarning, stacklevel=3)
    if V.layout != torch.strided:
        return V.to(p.device, p.dtype)
    dtype = target_dtype(V.dtype, p.dtype)
    if V.device == p.device and V.dtype == dtype:
        # the caller's own tensor; a 2-D one with unit column stride keeps
        # its rows, which the kernels pad once per fit if they must
        # (fused_mu.aligned_rows)
        if V.ndim == 2 and V.stride(1) == 1 and V.stride(0) >= V.shape[1]:
            return V
        return V.contiguous()
    if V.ndim == 2 and p.device.type == "cuda" and \
            dtype in (torch.float32, torch.bfloat16):
        from ..ops.fused_mu import aligned_copy

        return aligned_copy(V, p.device, dtype)
    return V.to(p.device, dtype).contiguous()


def rand_abs_normal(shape, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """|N(0,1)| init, the reference's ``torch.randn(*size).abs()``
    (nmf.py:221,234), drawn from ``generator`` on ``device``
    (:func:`resolve_device`: the card when ``None``)."""
    device = resolve_device(device, generator)
    return torch.randn(tuple(shape), generator=generator, device=device).abs()


def assert_nonneg(x: torch.Tensor, name: str) -> None:
    if not bool(torch.all(x >= 0)):
        raise ValueError(f"Tensor {name} should be non-negative.")


def validate_target(V: torch.Tensor, beta: float) -> None:
    """Input guards of the β-divergence solvers (reference nmf.py:329-336):
    non-negativity, and the divergence error for β ≤ 0 with zeros.  One
    ``min`` reduction and one scalar read; ``PNT_SKIP_VALIDATE=1`` skips
    them (pre-validated pipelines)."""
    if os.environ.get("PNT_SKIP_VALIDATE", "") == "1":
        return
    m = float(_target_min(V)) if V.numel() else 0.0
    if m < 0:
        raise ValueError("Target should be non-negative.")
    if beta <= 0 and m == 0:
        raise ValueError(_BETA_ZERO_MSG)


def _target_min(V: torch.Tensor) -> torch.Tensor:
    """``V.min()`` with no copy of a strided ``V``: on the card ``min()``
    makes a contiguous copy of a view (a target whose rows are padded,
    :func:`target_like`), so such a ``V`` is reduced a row block at a time
    (:func:`~..ops.recon.row_blocks`)."""
    if V.is_contiguous() or V.ndim < 2:
        return V.min()
    from ..ops.recon import row_blocks

    return torch.stack([V[..., rows, :].min() for rows in row_blocks(V)]).min()


_BETA_ZERO_MSG = (
    "When beta <= 0 and V contains zeros, the training process may "
    "diverge. Please add small values to V, or use a positive beta "
    "value."
)


# --------------------------------------------------------------------------
# DTensor targets: the layout rules of the model API's route to the sharded
# and halo fits (the JAX package's spec checks on a NamedSharding), and the
# declined path for every other DTensor target
# --------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (read without
    importing DTensor's module where nothing has: then there is none)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def sharding_spec(V) -> Optional[tuple]:
    """The JAX ``PartitionSpec`` of a DTensor ``V``: for each tensor axis the
    name of the mesh dimension that shards it, or ``None`` (a mesh dimension
    named ``a`` with ``Shard(d)`` is JAX's ``spec[d] == "a"``).  ``None``
    instead of a spec where ``V`` is not a DTensor or no sharded fit takes
    its layout: a ``Partial`` placement (or any other than ``Shard`` and
    ``Replicate``), one tensor axis sharded over two mesh dimensions (JAX's
    tuple spec), a mesh without dimension names (the fits take axis
    names), or a mesh of one rank (JAX's ``len(V.devices()) > 1`` test)."""
    if not is_dtensor(V):
        return None
    from torch.distributed.tensor import Replicate, Shard

    mesh = V.device_mesh
    names = mesh.mesh_dim_names
    if not names or mesh.size() < 2:
        return None
    spec = [None] * V.ndim
    for name, p in zip(names, V.placements):
        if type(p) is Shard:
            d = p.dim % V.ndim
            if spec[d] is not None:
                return None
            spec[d] = name
        elif not isinstance(p, Replicate):
            return None
    return tuple(spec)


def _axis_size(V, name: str) -> int:
    mesh = V.device_mesh
    return mesh.size(mesh.mesh_dim_names.index(name))


def trailing_seq_axis(V) -> Optional[str]:
    """The mesh dimension's name when ``V`` is halo-routable (counterpart of
    :func:`pytorch_nmf_tpu.models._common.trailing_seq_axis`): exactly one
    mesh dimension shards ``V``'s last axis, it has at least 2 ranks,
    nothing else is sharded, and ``V`` is not float64 (the halo fits
    accumulate in float32).  ``None`` declines."""
    spec = sharding_spec(V)
    if spec is None or V.dtype == torch.float64:
        return None
    axis = spec[-1]
    if axis is None or any(s is not None for s in spec[:-1]):
        return None
    return axis if _axis_size(V, axis) >= 2 else None


def row_axes(V, columns: bool = True) -> Optional[tuple]:
    """``(data_axis, model_axis)`` of a 2-D DTensor ``V`` the sample-sharded
    fits take (the JAX package's ``P(data[, model])`` checks,
    ``models/nmf.py:451-458``, ``models/plca.py:341-360``): its rows sharded
    over one named mesh dimension, its columns not sharded or, with
    ``columns``, sharded over another (``model_axis`` is ``None`` when they
    are not), and ``V`` not float64 (the sharded fits hold float32 or
    bfloat16 blocks).  ``None`` declines."""
    spec = sharding_spec(V)
    if spec is None or V.ndim != 2 or V.dtype == torch.float64:
        return None
    data, model = spec
    if data is None or (model is not None and not columns):
        return None
    return data, model


def gather_whole(x):
    """``x`` whole on this rank: a DTensor gathered from its ranks' blocks
    (:func:`~..parallel.sharded.full_array`; the local tensor itself where
    no mesh dimension of more than one rank shards it; DTensor's own
    ``full_tensor`` for a ``Partial`` placement or an axis sharded twice,
    which on gloo takes CPU tensors only), anything else as it is.  Every
    rank of ``x``'s mesh calls it.

    Where ``x`` requires grad (a factor of a fit on a DTensor target) and
    grad mode is on, the gather is differentiable (:class:`_Gathered`):
    the whole gradient comes back as ``x``'s own block, a DTensor placed
    as ``x``."""
    if not is_dtensor(x):
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _Gathered.apply(x)
    return _gather(x)


def simply_placed(x) -> bool:
    """Whether the DTensor ``x`` is placed as the fits place their blocks:
    every placement ``Shard`` or ``Replicate``, no tensor axis sharded over
    two mesh dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    dims = [p.dim % x.ndim for p in x.placements if type(p) is Shard]
    return len(set(dims)) == len(dims) and all(
        type(p) is Shard or isinstance(p, Replicate) for p in x.placements)


def _gather(x):
    from ..parallel.sharded import full_array

    if simply_placed(x):
        return full_array(x)
    with torch.no_grad():
        return x.full_tensor().detach()


# the Comms over which a gradient reaching a gathered factor is partial
# (innermost last): inside ``partial_over``
_PARTIAL = []


@contextlib.contextmanager
def partial_over(comms):
    """Inside, a gradient that reaches a DTensor factor through its gather
    (:class:`_Gathered`) is each rank's part of the whole one, and is summed
    over ``comms`` before it is cut to the factor's block: ``BetaMu``'s raw
    pair on a DTensor target, each rank's from its own block of the
    target (``ops/trainer_core.py::mu_raw_pair``).  The list is global,
    not per thread: the autograd engine runs a card's backward on a thread
    of its own."""
    _PARTIAL.append(list(comms))
    try:
        yield
    finally:
        _PARTIAL.pop()


class _Gathered(torch.autograd.Function):
    """:func:`gather_whole` of a DTensor ``x``; the backward cuts the whole
    gradient to ``x``'s block (:func:`place_like`), after summing it over
    the Comms of :func:`partial_over` where that is open."""

    @staticmethod
    def forward(ctx, x):
        ctx.like = x.detach()
        whole = _gather(ctx.like)
        local = ctx.like.to_local()
        if whole.untyped_storage().data_ptr() == \
                local.untyped_storage().data_ptr():
            whole = whole.clone()  # a one-rank mesh: not the local tensor
        return whole

    @staticmethod
    def backward(ctx, g):
        comms = _PARTIAL[-1] if _PARTIAL else ()
        if comms:
            g = g.contiguous().clone()
            for c in comms:
                c.all_reduce(g)
        return place_like(g, ctx.like)


def place_like(value, p):
    """``value`` (a tensor of the DTensor ``p``'s global shape, or an
    array) placed as ``p`` is: this rank's block
    (:func:`~..parallel.sharded.local_block`'s cut) as a DTensor on ``p``'s
    mesh with ``p``'s placements, in ``p``'s dtype, on its device.  A
    DTensor ``value`` placed otherwise is gathered whole first.  Every rank
    of ``p``'s mesh calls it; ``p`` is placed as the fits place factors
    (:func:`simply_placed`, ``ValueError`` otherwise)."""
    from ..parallel.sharded import _block, as_dtensor

    mesh, pls = p.device_mesh, list(p.placements)
    if not simply_placed(p):
        raise ValueError(f"a factor placed {pls}: a value goes into factors "
                         "sharded or replicated over each mesh dimension")
    if is_dtensor(value):
        if value.device_mesh == mesh and list(value.placements) == pls:
            return value.to(p.dtype)
        value = _gather(value.detach())
    value = host_tensor(value)
    if tuple(value.shape) != tuple(p.shape):
        raise ValueError(f"a value of shape {tuple(value.shape)} for a "
                         f"factor of shape {tuple(p.shape)}")
    value = value.to(device=p.to_local().device, dtype=p.dtype)
    return as_dtensor(_block(value, mesh, pls).contiguous(), mesh, pls,
                      p.shape)


def load_placed(module: torch.nn.Module, state_dict, prefix: str) -> None:
    """Before ``module`` loads its own entries of ``state_dict`` (its
    ``_load_from_state_dict``): each value for a parameter that holds a
    DTensor is placed as that parameter (:func:`place_like`), so that
    ``load_state_dict`` copies a whole tensor (a checkpoint's) into the
    DTensor factors of a fit on a DTensor target, block by block."""
    for name, p in module.named_parameters(recurse=False):
        key = prefix + name
        if is_dtensor(p) and key in state_dict:
            state_dict[key] = place_like(state_dict[key], p)


def _replicated(x: torch.Tensor, mesh):
    """``x`` (whole, the same on every rank) as a DTensor on ``mesh``,
    ``Replicate()`` on every mesh dimension."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def fit_declined(fit, V, factors, verbose: bool):
    """The declined path of a fit on a DTensor target (or on DTensor
    factors): every rank gathers ``V`` and the DTensor factors whole
    (:func:`gather_whole`) and runs ``fit(V, *factors, verbose)``, the
    model's single-card fit, on its own device (``V``'s: the factors move
    there) with the same engine and kernels as a plain-tensor fit there;
    rank 0 of ``V``'s mesh alone reports.  Where ``V`` is a DTensor the
    fitted factors come back as DTensors on its mesh, ``Replicate()`` on
    every dimension; otherwise as plain tensors.  It costs what GSPMD
    spreads: every rank holds the whole ``V`` and runs the whole fit."""
    mesh = V.device_mesh if is_dtensor(V) else None
    V = gather_whole(V)
    factors = [gather_whole(f) for f in factors]
    if mesh is not None:
        factors = [f.to(V.device) for f in factors]
        verbose = verbose and all(c == 0 for c in mesh.get_coordinate())
    out = fit(V, *factors, verbose)
    if mesh is None:
        return out
    n = len(factors)
    return tuple(_replicated(x, mesh) for x in out[:n]) + tuple(out[n:])


def set_factors(model: torch.nn.Module, **values) -> None:
    """A fit's values into ``model``'s parameters of those names: in place
    where parameter and value are plain tensors; otherwise (a DTensor on
    either side) a new ``nn.Parameter`` holds the value, its
    ``requires_grad`` kept."""
    with torch.no_grad():
        for name, value in values.items():
            p = getattr(model, name)
            if is_dtensor(value) or is_dtensor(p):
                setattr(model, name, torch.nn.Parameter(
                    value, requires_grad=p.requires_grad))
            else:
                p.copy_(value)


def validate_sharded(V, beta: float) -> None:
    """:func:`validate_target` of a DTensor ``V`` over its ranks: each checks
    its own block (one ``min`` reduction), and one all-reduce a mesh
    dimension sums the ranks' findings (:class:`~..parallel.comm.Comm`), so
    all of them raise, or none; one host read.  ``PNT_SKIP_VALIDATE=1``
    skips it."""
    if os.environ.get("PNT_SKIP_VALIDATE", "") == "1":
        return
    from ..parallel.comm import comm_for

    with torch.no_grad():
        local = V.to_local()
        m = _target_min(local) if local.numel() else None
        found = torch.zeros(2, dtype=torch.float32, device=local.device)
        if m is not None:  # (negative, zero where β ≤ 0 diverges)
            found[0] = (m < 0).float()
            found[1] = ((m == 0) & (beta <= 0)).float()
        mesh = V.device_mesh
        for name in mesh.mesh_dim_names:
            comm_for(mesh, name).all_reduce(found)
        negative, zero = (bool(x) for x in found.tolist())
    if negative:
        raise ValueError("Target should be non-negative.")
    if zero:
        raise ValueError(_BETA_ZERO_MSG)


def _ntuple(n: int):
    """``x`` as an ``n``-tuple: an iterable must have ``n`` items, a scalar
    is repeated (the reference's kernel-size parsing)."""
    def parse(x):
        if isinstance(x, Iterabc):
            t = tuple(x)
            if len(t) != n:
                raise ValueError(f"expected {n} values, got {t}")
            return t
        return (x,) * n

    return parse


single = _ntuple(1)
pair = _ntuple(2)
triple = _ntuple(3)
