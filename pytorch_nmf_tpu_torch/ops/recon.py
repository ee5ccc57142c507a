r"""Reconstruction primitives (counterpart of :mod:`pytorch_nmf_tpu.ops.recon`).

* ``linear`` — :math:`H W^\top` (the reference's ``F.linear``, nmf.py:693).
* ``deconv1d/2d/3d`` — full-padded correlation with the kernel flipped,
  i.e. true convolution: the reference's own
  ``F.convNd(H, W.flip(spatial), padding=k-1)`` (nmf.py:779,864,941).
* ``scaled_kernel`` — ``W * Z`` over the rank axis, the PLCA family's
  kernel (reference plca.py:372,449,524,604).

Shapes follow the reference:
  1-D: ``H (N, R, L)``, ``W (C, R, T)``         → ``(N, C, L + T - 1)``
  2-D: ``H (N, R, L, M)``, ``W (C, R, kh, kw)`` → ``(N, C, L+kh-1, M+kw-1)``
  3-D: analogous with three spatial dims.

The deconvolutions serve ``forward()`` and the float64 generic engine; the
float32 fits reconstruct through :mod:`.fast_nmfd`.  A float32 convolution on
CUDA follows ``torch.backends.cudnn.allow_tf32``, which PyTorch sets by default.
"""

import torch
import torch.nn.functional as F

__all__ = ["acc_type", "matmul", "row_blocks", "target_mm", "target_tmm",
           "linear", "deconv1d", "deconv2d", "deconv3d", "scaled_kernel"]

# the float32 transient of one row block of a bfloat16 target
_BLOCK_BYTES = 16 * 1024**2


def acc_type(*xs) -> torch.dtype:
    """Accumulation dtype: float32, except when an operand is float64 —
    double-precision inputs must not be truncated (reference
    ``torchnmf/nmf.py:215`` honors the input dtype)."""
    for x in xs:
        if x.dtype == torch.float64:
            return torch.float64
    return torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' promoted dtype, as ``jnp.matmul``
    promotes (a bfloat16 target against float32: float32, exactly)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def row_blocks(V: torch.Tensor):
    """Slices of ``V``'s rows (its axis -2) whose float32 copy takes at
    most 16 MiB (at least one row each), in order."""
    M = V.shape[-2]
    per_row = 4 * (V.numel() // max(M, 1))
    step = max(1, _BLOCK_BYTES // max(per_row, 1))
    return [slice(r, min(r + step, M)) for r in range(0, M, step)]


def target_mm(V: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``V @ X`` for a target ``V (..., M, K)``: one product when the dtypes
    agree; a bfloat16 ``V`` against float32 ``X`` in row blocks
    (:func:`row_blocks`), each upcast to float32, so that no float32 copy
    of the whole target is made."""
    if V.dtype == X.dtype:
        return V @ X
    blocks = row_blocks(V)
    if len(blocks) == 1:
        return matmul(V, X)
    dt = torch.promote_types(V.dtype, X.dtype)
    X = X.to(dt)
    out = torch.empty(torch.broadcast_shapes(V.shape[:-2], X.shape[:-2])
                      + (V.shape[-2], X.shape[-1]), dtype=dt, device=V.device)
    for rows in blocks:
        out[..., rows, :] = V[..., rows, :].to(dt) @ X
    return out


def target_tmm(V: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``V.mT @ X`` for a target ``V (..., M, K)`` and ``X (..., M, R)``,
    as :func:`target_mm`: a bfloat16 ``V`` is upcast a row block at a
    time and the blocks' products summed in order."""
    if V.dtype == X.dtype:
        return V.mT @ X
    blocks = row_blocks(V)
    if len(blocks) == 1:
        return matmul(V.mT, X)
    dt = torch.promote_types(V.dtype, X.dtype)
    X = X.to(dt)
    out = None
    for rows in blocks:
        part = V[..., rows, :].to(dt).mT @ X[..., rows, :]
        out = part if out is None else out.add_(part)
    return out


def linear(H: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``H @ W.T`` accumulated in :func:`acc_type`
    (reference ``F.linear``, nmf.py:693); on a leading batch axis of
    problems, one batched GEMM."""
    dt = acc_type(H, W)
    return H.to(dt) @ W.to(dt).mT


def _deconv(H: torch.Tensor, W: torch.Tensor, spatial_ndim: int) -> torch.Tensor:
    dt = acc_type(H, W)
    conv = (F.conv1d, F.conv2d, F.conv3d)[spatial_ndim - 1]
    spatial = tuple(range(2, 2 + spatial_ndim))
    return conv(H.to(dt), W.to(dt).flip(spatial),
                padding=tuple(k - 1 for k in W.shape[2:]))


def deconv1d(H: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """1-D full convolution ``(N, R, L) × (C, R, T) → (N, C, L + T - 1)``."""
    return _deconv(H, W, 1)


def deconv2d(H: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """2-D full convolution."""
    return _deconv(H, W, 2)


def deconv3d(H: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """3-D full convolution."""
    return _deconv(H, W, 3)


def scaled_kernel(W: torch.Tensor, Z: torch.Tensor, spatial_ndim: int) -> torch.Tensor:
    """``W (C, R, *spatial)`` scaled by ``Z (R,)`` on its rank axis; with
    ``spatial_ndim=0`` the dense PLCA's ``W (K, R) * Z``."""
    return W * Z.reshape((1, -1) + (1,) * spatial_ndim)
