"""Shared helpers for the model layer (shape inference, init, validation);
counterpart of :mod:`pytorch_nmf_tpu.models._common`."""

import os
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
