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

__all__ = ["acc_type", "linear", "deconv1d", "deconv2d", "deconv3d",
           "scaled_kernel"]


def acc_type(*xs) -> torch.dtype:
    """Accumulation dtype: float32, except when an operand is float64 —
    double-precision inputs must not be truncated (reference
    ``torchnmf/nmf.py:215`` honors the input dtype)."""
    for x in xs:
        if x.dtype == torch.float64:
            return torch.float64
    return torch.float32


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
