r"""Frequency-domain MU updaters for 1-D deconvolutional NMF at β = 2
(counterpart of :mod:`pytorch_nmf_tpu.ops.fft_nmfd`), on ``torch.fft``.

At β=2 every MU contraction of NMFD is a convolution or a correlation
along time:

    WH            = H *τ W                          (linear convolution)
    neg_W[c,r,τ]  = Σ_{n,m} H[n,r,m] V[n,c,m+τ]       (correlation)
    pos_W[c,r,τ]  = Σ_{n,m} H[n,r,m] WH[n,c,m+τ]
    neg_H[n,r,m]  = Σ_{c,τ} W[c,r,τ] V[n,c,m+τ]
    pos_H[n,r,m]  = Σ_{c,τ} W[c,r,τ] WH[n,c,m+τ]

Transformed, each is a per-frequency product of ``O(F·R·C)`` operations
(``F ≈ L``) against the patch GEMMs' ``O(L·T·R·C)``.  Only β = 2
qualifies: every other β applies a nonlinearity to WH elementwise.

With ``Nfft ≥ L_out`` every lag read is a linear correlation: the largest
circular index that contributes is ``L_in-1 + T-1 = L_out-1 < Nfft``.

Float32 FFTs round differently from the GEMMs (about 1e-6 relative), so the
engine is opt-in (``PNT_NMFD_FFT=1`` forces it, ``=auto`` makes it an
autotuner candidate).

Memory: the kernel's whole spectrum ``(C, R, F)`` is complex64, 3 GB at
C=1025, R=88, L=5000, so the channel axis is taken in chunks of
``PNT_FFT_CHUNK_MB`` (default 256) of spectrum; that bounds the card's
memory.  The JAX package's second bound, ``_FFT_ELEMS_CAP`` (at most 2^24
elements per FFT call), kept its TPU compiler from stalling; it bounds no
memory and has no counterpart here.
"""

import os

import torch

from ..constants import eps
from ..metrics import beta_div
from .mu import mu_multiplier

__all__ = ["fft_beta2_updater_factory"]


def _nfft(L_out: int) -> int:
    n = 1
    while n < L_out:
        n *= 2
    return n


def _c_chunk(C: int, R: int, F: int) -> int:
    """Channels per chunk: a ``(cb, R, F)`` complex64 kernel spectrum of
    about ``PNT_FFT_CHUNK_MB`` megabytes (with room for one live inverse
    transform)."""
    budget = int(os.environ.get("PNT_FFT_CHUNK_MB", 256)) * 1024**2 // 16
    return min(max(budget // max(R * F, 1), 1), C)


def _wh_spec(Hf, Wf):
    # (N, R, F) x (C, R, F) -> (N, C, F)
    return torch.einsum("nrf,crf->ncf", Hf, Wf)


def _corr_w(Hf, Xf, n: int, T: int):
    """``out[c,r,τ] = Σ_{n,m} H[n,r,m] X[n,c,m+τ]`` for τ ∈ [0, T)."""
    F = torch.einsum("nrf,ncf->crf", Hf.conj(), Xf)
    return torch.fft.irfft(F, n=n, dim=-1)[..., :T]


def fft_beta2_updater_factory(gamma, l1_reg, l2_reg):
    """β=2 NMFD updaters in the frequency domain, in the model layout
    (3-arity).  The channel axis runs in chunks: each chunk transforms its
    ``W`` and ``V`` slices, forms its reconstruction spectrum against the
    shared activation spectrum and either finishes its own ``W`` rows (the
    W update) or adds its share of the channel-summed spectra (the H update,
    transformed back once)."""

    def _chunks(V, W):
        # a bfloat16 V is upcast a channel chunk at a time (the transforms
        # take float32)
        n = _nfft(V.shape[-1])
        cb = _c_chunk(W.shape[0], W.shape[1], n // 2 + 1)
        for c0 in range(0, W.shape[0], cb):
            yield n, W[c0:c0 + cb], V[:, c0:c0 + cb].to(W.dtype)

    def upd_W(V, W, H):
        T = W.shape[-1]
        n = _nfft(V.shape[-1])
        Hf = torch.fft.rfft(H, n=n, dim=-1)
        outs = []
        for _, Wc, Vc in _chunks(V, W):
            Wfc = torch.fft.rfft(Wc, n=n, dim=-1)
            Vfc = torch.fft.rfft(Vc, n=n, dim=-1)
            neg = torch.relu(_corr_w(Hf, Vfc, n, T)) + eps
            pos = torch.relu(_corr_w(Hf, _wh_spec(Hf, Wfc), n, T)) + eps
            outs.append(Wc * mu_multiplier(neg, pos, Wc, gamma, l1_reg, l2_reg))
        return torch.cat(outs)

    def upd_H(V, W, H):
        L_in = H.shape[-1]
        n = _nfft(V.shape[-1])
        Hf = torch.fft.rfft(H, n=n, dim=-1)
        negf = posf = None
        for _, Wc, Vc in _chunks(V, W):
            Wfc = torch.fft.rfft(Wc, n=n, dim=-1)
            Vfc = torch.fft.rfft(Vc, n=n, dim=-1)
            ng = torch.einsum("crf,ncf->nrf", Wfc.conj(), Vfc)
            ps = torch.einsum("crf,ncf->nrf", Wfc.conj(), _wh_spec(Hf, Wfc))
            negf = ng if negf is None else negf + ng
            posf = ps if posf is None else posf + ps
        neg = torch.relu(torch.fft.irfft(negf, n=n, dim=-1)[..., :L_in]) + eps
        pos = torch.relu(torch.fft.irfft(posf, n=n, dim=-1)[..., :L_in]) + eps
        return H * mu_multiplier(neg, pos, H, gamma, l1_reg, l2_reg)

    def loss_terms(V, W, H):
        L_out = V.shape[-1]
        n = _nfft(L_out)
        Hf = torch.fft.rfft(H, n=n, dim=-1)
        total = None
        for _, Wc, Vc in _chunks(V, W):
            WHc = torch.fft.irfft(_wh_spec(Hf, torch.fft.rfft(Wc, n=n, dim=-1)),
                                  n=n, dim=-1)[..., :L_out]
            part = beta_div(WHc, Vc, 2.0)
            total = part if total is None else total + part
        return total

    return upd_W, upd_H, loss_terms
