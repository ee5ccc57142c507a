r"""PLCA models: ``BaseComponent``, ``PLCA``, ``SIPLCA``, ``SIPLCA2`` and
``SIPLCA3`` (counterpart of :mod:`pytorch_nmf_tpu.models.plca`).

Probabilistic Latent Component Analysis factors a normalized non-negative
tensor as a mixture of per-component marginals with a latent prior ``Z``.
Its fit is EM: the E-step is one backward pass of the reconstruction with
cotangent ``V/(WZH+eps)``, the M-step renormalizes the unnormalized
posterior marginals (reference plca.py:250-289), with optional Dirichlet
MAP priors.

The classes are ``torch.nn.Module``\ s holding ``nn.Parameter``\ s ``W``,
``H`` and ``Z``; construction normalizes every factor to a probability
distribution over its non-rank axes (reference plca.py:94-127), and ``Z``
is uniform when only ``rank`` is given.  ``requires_grad`` records the
``trainable_*`` flags.  The factors live on the card unless the
constructor is given ``device="cpu"``.

On a float32 target the SIPLCA family's E-step differentiates the
kernel-adjoint deconvolution (:func:`~..ops.autotune.resolve_plca_recon3`):
``dH`` runs B3 (``hgrad``) and ``dW`` B4 (``wgrad``) on the card.
"""

from collections.abc import Iterable as Iterabc
from typing import Iterable, Optional, Tuple, Union

import torch
from torch import nn

from ..ops import autotune as _autotune
from ..ops import recon as _recon
from ..ops import solver as _solver
from ..ops.fast_plca import resolve_plca_em_engine
from ..ops.solver import _plca_marginal_sum
from ._common import (
    assert_nonneg,
    is_tensor_like,
    pair,
    rand_abs_normal,
    resolve_device,
    single,
    target_like,
    to_param,
    triple,
    validate_target,
)

__all__ = ["BaseComponent", "PLCA", "SIPLCA", "SIPLCA2", "SIPLCA3"]


class BaseComponent(nn.Module):
    r"""Base class for the PLCA modules (reference plca.py:34-304): like the
    NMF base, with a latent prior vector ``Z``; every stored factor is
    normalized to a probability distribution at construction.

    Args:
        rank: size of the hidden dimension; alone, it gives a uniform ``Z``.
        W, H: shape tuples (random |N(0,1)| init) or initial non-negative
            values.
        Z: initial non-negative ``(rank,)`` values.
        trainable_W / trainable_H / trainable_Z: freeze flags for given
            initial values.
        device: the card (``"cuda"``) when ``None``; ``"cpu"`` for the CPU.
        generator: the ``torch.Generator`` random inits are drawn from.
    """

    def __init__(
        self,
        rank: int = None,
        W=None,
        H=None,
        Z=None,
        trainable_W: bool = True,
        trainable_H: bool = True,
        trainable_Z: bool = True,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device, generator)

        def make(x, name, trainable):
            if is_tensor_like(x):
                value = to_param(x, device)
                assert_nonneg(value, name)
                return nn.Parameter(value, requires_grad=trainable)
            if isinstance(x, Iterabc):
                return nn.Parameter(rand_abs_normal(x, generator, device))
            return None

        infer_rank = None
        for name, x, trainable in (("W", W, trainable_W), ("H", H, trainable_H)):
            p = make(x, name, trainable)
            self.register_parameter(name, p)
            if p is not None:
                with torch.no_grad():
                    p.div_(_plca_marginal_sum(p))
                infer_rank = p.shape[1]

        if is_tensor_like(Z):
            z = to_param(Z, device)
            if z.ndim != 1:
                raise ValueError("Z should be one dimensional.")
            assert_nonneg(z, "Z")
            rank = int(z.shape[0])
            Zp = nn.Parameter(z, requires_grad=trainable_Z)
        elif isinstance(rank, int):
            Zp = nn.Parameter(torch.full((rank,), 1.0 / rank, device=device))
        else:
            Zp = None
        self.register_parameter("Z", Zp)
        if Zp is not None:
            with torch.no_grad():
                Zp.div_(Zp.sum())
            infer_rank = Zp.shape[0]

        if infer_rank is None:
            if not rank:
                raise ValueError(
                    "A rank should be given when W, H and Z are not available!")
        else:
            for name in ("Z", "H", "W"):
                p = getattr(self, name)
                if p is not None and p.shape[0 if name == "Z" else 1] != infer_rank:
                    raise ValueError(
                        f"Latent size of {name} does not match with others!")
            if self.W is not None:
                self.out_channels = self.W.shape[0]
                if self.W.ndim > 2:
                    self.kernel_size = tuple(self.W.shape[2:])
            rank = infer_rank
        self.rank = int(rank)

    def extra_repr(self) -> str:
        s = f"{self.rank}"
        if self.W is not None:
            s += f", out_channels={self.out_channels}"
            if hasattr(self, "kernel_size"):
                s += f", kernel_size={self.kernel_size}"
        return s

    def forward(self, H=None, W=None, Z=None, norm: float = None):
        """Reconstruct with the given (or stored) factors, rescaled by
        ``norm`` when given (reference plca.py:153-183)."""
        H = self.H if H is None else H
        W = self.W if W is None else W
        Z = self.Z if Z is None else Z
        if H is None or W is None or Z is None:
            raise ValueError("W, H and Z are needed to reconstruct")
        result = self.reconstruct(H, W, Z)
        return result if norm is None else result * norm

    @staticmethod
    def reconstruct(H, W, Z):
        """The model's forward map; overridden by subclasses."""
        raise NotImplementedError

    @classmethod
    def _em_engine(cls, V):
        """A fused E-step engine factory for this fit, or ``None`` for the
        generic backward pass (:class:`PLCA` overrides it)."""
        return None

    def fit(
        self,
        V,
        tol: float = 1e-4,
        max_iter: int = 200,
        verbose: bool = False,
        W_alpha: Union[float, torch.Tensor] = 1.0,
        H_alpha: Union[float, torch.Tensor] = 1.0,
        Z_alpha: Union[float, torch.Tensor] = 1.0,
    ):
        r"""EM maximizing the posterior log-probability with optional
        Dirichlet priors (reference plca.py:193-304), on the factors'
        device, in their dtype; ``V`` (a tensor anywhere, or a numpy array)
        is moved there (a float64 ``V`` of a float32 model is cast, with a
        ``UserWarning``).

        Returns ``(n_iter, norm)``: the reference's raw loop index, and
        ``V.sum()``, the scale to pass back to :meth:`forward` to
        reconstruct in ``V``'s units."""
        W, H, Z = self.W, self.H, self.Z
        W_new, H_new, Z_new, n_iter, norm = self._fit_em(
            V, W.detach(), H.detach(), Z.detach(), W.requires_grad,
            H.requires_grad, Z.requires_grad, float(tol), int(max_iter),
            bool(verbose), W_alpha, H_alpha, Z_alpha)
        with torch.no_grad():
            W.copy_(W_new)
            H.copy_(H_new)
            Z.copy_(Z_new)
        return int(n_iter), norm

    @classmethod
    def _fit_em(cls, V, W, H, Z, update_W, update_H, update_Z, tol, max_iter,
                verbose, W_alpha, H_alpha, Z_alpha):
        """The EM fit of :meth:`fit` on explicit factors (shared with
        :func:`~pytorch_nmf_tpu_torch.functional.plca_fit`):
        ``(W, H, Z, n_iter, norm)``."""
        V = target_like(V, W, H, Z)
        validate_target(V, 1)
        fit_fn = _solver.get_plca_fit(
            cls._resolve_fit_recon3(V, W, H, Z), tol, max_iter,
            update_W, update_H, update_Z, _solver.alpha_is_active(W_alpha),
            _solver.alpha_is_active(H_alpha), _solver.alpha_is_active(Z_alpha),
            verbose, em_engine=cls._em_engine(V))

        def alpha(a):  # the factors' dtype: float32 for a bfloat16 V
            return torch.as_tensor(a, dtype=W.dtype, device=V.device)

        return fit_fn(V, W, H, Z, alpha(W_alpha), alpha(H_alpha),
                      alpha(Z_alpha))

    @classmethod
    def _resolve_fit_recon3(cls, V, W, H, Z):
        """The EM reconstruction of this fit: ``reconstruct`` (the
        shift-invariant models resolve theirs per fit,
        :func:`~..ops.autotune.resolve_plca_recon3`)."""
        return cls.reconstruct


class PLCA(BaseComponent):
    r"""Probabilistic Latent Component Analysis:
    :math:`P(n, c) \approx \sum_z P(c|z) P(z) P(n|z)`, i.e.
    ``V ≈ H diag(Z) Wᵀ`` (reference plca.py:307-373).  Shapes: ``V (M, K)``,
    ``W (K, R)``, ``H (M, R)``, ``Z (R,)``."""

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None, **kwargs):
        if isinstance(Vshape, Iterabc):
            M, K = Vshape
            rank = rank if rank else K
            kwargs["W"] = (K, rank)
            kwargs["H"] = (M, rank)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W, Z):
        return _recon.linear(H, _recon.scaled_kernel(W, Z, 0))

    @classmethod
    def _em_engine(cls, V):
        # the fused E-step is opt-in (PNT_PLCA_FUSED=1), and only for the
        # dense reconstruction: a subclass with its own keeps the generic
        if cls.reconstruct is not PLCA.reconstruct:
            return None
        return resolve_plca_em_engine(V)


class SIPLCA(BaseComponent):
    r"""Shift-Invariant PLCA, 1-D (Smaragdis & Raj 2007; reference
    plca.py:376-449).  Shapes: ``V (N, C, L)``, ``W (C, R, T)``,
    ``H (N, R, L - T + 1)``, ``Z (R,)``."""

    _spatial_ndim = 1

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None,
                 T: Union[int, Tuple[int]] = 1, **kwargs):
        if isinstance(Vshape, Iterabc):
            (T,) = single(T)
            batch, K, M = Vshape
            rank = rank if rank else K
            kwargs["W"] = (K, rank, T)
            kwargs["H"] = (batch, rank, M - T + 1)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W, Z):
        return _recon.deconv1d(H, _recon.scaled_kernel(W, Z, 1))

    _resolve_fit_recon3 = classmethod(_autotune.resolve_plca_recon3)


class SIPLCA2(BaseComponent):
    r"""Shift-Invariant PLCA across 2 dimensions (reference
    plca.py:452-525)."""

    _spatial_ndim = 2

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None,
                 kernel_size: Union[int, Tuple[int, int]] = 1, **kwargs):
        if isinstance(Vshape, Iterabc):
            kernel_size = pair(kernel_size)
            kh, kw = kernel_size
            batch, channel, K, M = Vshape
            rank = rank if rank else K
            kwargs["W"] = (channel, rank) + kernel_size
            kwargs["H"] = (batch, rank, K - kh + 1, M - kw + 1)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W, Z):
        return _recon.deconv2d(H, _recon.scaled_kernel(W, Z, 2))

    _resolve_fit_recon3 = classmethod(_autotune.resolve_plca_recon3)


class SIPLCA3(BaseComponent):
    r"""Shift-Invariant PLCA across 3 dimensions (reference
    plca.py:528-606)."""

    _spatial_ndim = 3

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None,
                 kernel_size: Union[int, Tuple[int, int, int]] = 1, **kwargs):
        if isinstance(Vshape, Iterabc):
            kernel_size = triple(kernel_size)
            k1, k2, k3 = kernel_size
            batch, channel, N, K, M = Vshape
            rank = rank if rank else K
            kwargs["W"] = (channel, rank) + kernel_size
            kwargs["H"] = (batch, rank, N - k1 + 1, K - k2 + 1, M - k3 + 1)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W, Z):
        return _recon.deconv3d(H, _recon.scaled_kernel(W, Z, 3))

    _resolve_fit_recon3 = classmethod(_autotune.resolve_plca_recon3)
