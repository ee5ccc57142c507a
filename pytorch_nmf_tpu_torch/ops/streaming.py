r"""Streaming NMF fit for a target held in host memory (counterpart of
:mod:`pytorch_nmf_tpu.ops.streaming`).

``V`` stays on the host (a numpy array or an ``np.memmap`` over a file
larger than the card) and passes through the card in row blocks; ``W`` and
``H`` live on the card.  The MU algebra makes this exact, not approximate:
for ``V ≈ H Wᵀ``

* the W numerator and denominator are sums over row blocks of each block's
  contractions (relu/eps applied to the totals, as the in-memory engine
  applies them);
* each row block of H updates on its own, given the new W;
* the β-divergence is a sum over blocks.

So the trajectory equals the in-memory ``NMF.fit``'s to float32 summation
order, with its semantics: W against the old H, H against the new W, the
loss every 10 iterations and the ``(prev - loss) / loss_init < tol`` stop
(torchnmf/nmf.py:297-409).

On a CUDA float32 fit the blocks run the dense fit's kernels: each block's
W-side contractions are one B1 call without the epilogue
(``fused_mu.fused_contractions``, the raw ``(neg, pos)`` accumulators) and
its H update one more (with the β=1 epilogue where the dense fit has it);
the block loss is B2 at β ∉ {1, 2} and the dense fit's closed forms
otherwise.  At β = 2 the blocks take the dense fit's Gram products
(``Vbᵀ Hb``, ``Hbᵀ Hb``), no kernel, as the dense fit does.  Elsewhere the
kernels' plain versions run.

Copies: a reader thread reads the next block from ``V`` into one of two
pinned staging buffers (up to eight threads share a block's copy) while the
card works on the current one; each block
is copied to one of two device buffers on a copy stream of its own, the
compute stream waits on the copy's event, a staging buffer is refilled
only after its copy has finished and a device buffer only after the
compute that read it.  The device buffers' rows are padded to 16 bytes,
so the kernels take them as they are (16-byte aligned rows).

A bfloat16 host target (a torch bfloat16 tensor, or a numpy array of
``ml_dtypes.bfloat16``, which JAX's arrays give) with float32 factors is
staged, copied and read at half width, as the in-memory fit holds it
(``models._common.target_dtype``); numpy moves its blocks as their 16-bit
patterns.  Any other target is read in the factors' dtype.

Cost model: every iteration moves ``V`` host→card twice (once per factor),
so the fit is bound by the host's copies; use it where ``V`` does not fit
the card.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..constants import eps
from ..metrics import beta_div
from . import fused_mu
from .fast_nmf import _beta2_updaters, _fused_updaters
from .mu import gamma_from_beta, kl_pos_W, mu_multiplier
from .recon import target_tmm

__all__ = ["streaming_nmf_fit"]


class _Blocks:
    """Row blocks of the host target ``V`` on ``device``, read one block
    ahead by a worker thread, also across passes (every pass reads the
    blocks in the same order, so the next pass's first block is read while
    this pass's last one is used).  On a CUDA device the blocks come
    through two pinned staging buffers and two device buffers on a copy
    stream (see the module docstring), and a large block is copied into
    its staging buffer by ``FILL_THREADS`` threads at once; elsewhere each
    block is a tensor of its own.  Iterating yields ``(b, Vb)``; ``Vb`` is
    valid until the next block."""

    # one thread copies 5-6 GB/s into pinned memory on the H100 host, eight
    # about 25 (chip_tools/streaming_probe.py); PCIe takes 50
    FILL_THREADS = min(8, os.cpu_count() or 1)
    FILL_SPLIT_BYTES = 16 * 1024**2  # smaller blocks: one thread

    def __init__(self, V, row_block: int, device, dtype):
        """``V``: the host target as numpy reads it (:func:`_host_rows`);
        ``dtype``: the blocks' dtype on the device."""
        self.V, self.row_block, self.device, self.dtype = V, row_block, device, dtype
        M, K = V.shape
        self.n = -(-M // row_block)
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.fill = ThreadPoolExecutor(max_workers=self.FILL_THREADS)
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            rows = min(row_block, M)
            Kp = _padded_width(K, dtype)
            self.stage = [torch.zeros((rows, Kp), dtype=dtype, pin_memory=True)
                          for _ in range(2)]
            self.dev = [torch.zeros((rows, Kp), dtype=dtype, device=device)
                        for _ in range(2)]
            self.copy_stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.used = [torch.cuda.Event() for _ in range(2)]
        self.slot = 0  # the buffer pair the next block goes to
        self.ahead = None  # the read of the next pass's first block

    def _rows(self, b):
        lo = b * self.row_block
        return lo, min(lo + self.row_block, self.V.shape[0])

    def _read(self, b, slot):
        """The worker: block ``b`` into staging buffer ``slot`` (on the
        card) or into a new host tensor."""
        lo, hi = self._rows(b)
        if not self.cuda:
            return _as_dtype(torch.from_numpy(
                np.ascontiguousarray(self.V[lo:hi], dtype=_np_dtype(self.dtype))),
                self.dtype)
        self.copied[slot].synchronize()  # the buffer's last copy is done
        dst = _numpy_bits(self.stage[slot])[:hi - lo, :self.V.shape[1]]
        parts = 1 if dst.nbytes < self.FILL_SPLIT_BYTES else self.FILL_THREADS
        step = -(-(hi - lo) // parts)
        done = [self.fill.submit(np.copyto, dst[i:i + step],
                                 self.V[lo + i:min(lo + i + step, hi)],
                                 casting="unsafe")
                for i in range(0, hi - lo, step)]
        for f in done:
            f.result()
        return slot

    def __iter__(self):
        slot = self.slot
        fut = self.ahead or self.pool.submit(self._read, 0, slot)
        for b in range(self.n):
            got = fut.result()
            nxt = slot ^ 1
            # the next block, or the next pass's first
            fut = self.pool.submit(self._read, (b + 1) % self.n, nxt)
            if not self.cuda:
                yield b, got.to(self.device)
                slot = nxt
                continue
            lo, hi = self._rows(b)
            rows, K = hi - lo, self.V.shape[1]
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(self.used[slot])  # dev[slot] read
                self.dev[slot][:rows].copy_(self.stage[slot][:rows],
                                            non_blocking=True)
                self.copied[slot].record(self.copy_stream)
            compute.wait_event(self.copied[slot])
            yield b, self.dev[slot][:rows, :K]
            self.used[slot].record(compute)
            slot = nxt
        self.slot, self.ahead = slot, fut

    def close(self):
        self.pool.shutdown(wait=True)
        self.fill.shutdown(wait=True)


def _np_dtype(dtype):
    """The numpy dtype a block of ``dtype`` is moved in: bfloat16 as its
    16-bit pattern (``Tensor.numpy()`` refuses bfloat16)."""
    return {torch.float64: np.float64, torch.bfloat16: np.int16}.get(
        dtype, np.float32)


def _numpy_bits(t):
    """A numpy view of the host tensor ``t`` (a bfloat16 one as int16)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _as_dtype(t, dtype):
    """The inverse of :func:`_numpy_bits` on a tensor from numpy."""
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _padded_width(K: int, dtype) -> int:
    """``K`` rounded up to the 16 bytes the kernels copy at once."""
    return K + -K % fused_mu._row_quantum(dtype)


def _host_rows(V, factor_dtype):
    """``(rows, dtype)``: the host target as numpy slices it, and the dtype
    of its blocks on the device (``models._common.target_dtype``).  A
    bfloat16 target (a torch tensor, or a numpy array of
    ``ml_dtypes.bfloat16``) comes as its int16 bit pattern; a torch tensor
    of another dtype as its numpy view; anything else as it is (an
    ``np.memmap`` stays one)."""
    from ..models._common import target_dtype

    if isinstance(V, torch.Tensor):
        V = V.detach().cpu()
        if V.dtype != torch.bfloat16:
            return V.numpy(), factor_dtype
        dtype = target_dtype(torch.bfloat16, factor_dtype)
        return (V.view(torch.int16).numpy() if dtype == torch.bfloat16
                else V.to(factor_dtype).numpy()), dtype
    dt = getattr(V, "dtype", None)
    if dt is not None and np.dtype(dt).name == "bfloat16":
        dtype = target_dtype(torch.bfloat16, factor_dtype)
        return (V.view(np.int16) if dtype == torch.bfloat16
                else V.astype(np.float32)), dtype
    return V, factor_dtype


def streaming_nmf_fit(
    V,
    W,
    H,
    beta: float = 1,
    tol: float = 1e-4,
    max_iter: int = 200,
    l1_reg: float = 0.0,
    l2_reg: float = 0.0,
    row_block: int = 8192,
    update_W: bool = True,
    update_H: bool = True,
):
    """Fit ``V ≈ H Wᵀ`` with a host-resident target read in row blocks.

    ``V``: anything whose row slices numpy can read, an ``np.memmap`` in
    particular, or a CPU tensor; a bfloat16 one (a torch tensor or a numpy
    array of ``ml_dtypes.bfloat16``) is moved and read at half width with
    float32 factors.  ``W`` and ``H`` are copied to the first factor's device
    (the card for a numpy array; a CPU tensor keeps the fit on the CPU),
    float64 kept and every other dtype made float32.  A block must have
    fewer than 2^31 elements (B1 indexes in int32).  Returns ``(W, H,
    n_iter)`` with the in-memory solver's values (to float32 summation
    order) and iteration count."""
    from ..models._common import to_param

    device = W.device if isinstance(W, torch.Tensor) else None
    W = to_param(W, device)
    H = to_param(H, W.device)
    device = W.device
    V, dtype = _host_rows(V, W.dtype)  # dtype: the blocks'
    M, K = V.shape
    if H.shape[0] != M or W.shape[0] != K or H.shape[1] != W.shape[1]:
        raise ValueError(f"V {tuple(V.shape)}, W {tuple(W.shape)} and H "
                         f"{tuple(H.shape)} do not form V ~ H Wᵀ")
    if min(row_block, M) * _padded_width(K, dtype) >= 2**31:
        raise ValueError("a row block must hold fewer than 2^31 elements")
    beta, gamma = float(beta), gamma_from_beta(beta)
    kernels = device.type == "cuda" and W.dtype == torch.float32
    contract = (fused_mu.fused_contractions if kernels
                else fused_mu.plain_contractions)
    if beta == 2:
        _, upd_H = _beta2_updaters(gamma, l1_reg, l2_reg)
    else:
        upd_H = _fused_updaters(beta, gamma, l1_reg, l2_reg, contract,
                                fused_mu.fused_beta_loss)[1]

    def w_contract(Vb, Hb):
        """This block's raw W numerator and denominator."""
        if beta == 2:
            return target_tmm(Vb, Hb), Hb.T @ Hb
        neg, pos = contract(Vb, Hb, W, beta=beta, need_pos=beta != 1,
                            w_side=True)
        return neg, (kl_pos_W(Hb) if beta == 1 else pos)

    def w_update(neg_acc, pos_acc):
        neg = torch.relu(neg_acc) + eps
        if beta == 2:
            pos = torch.relu(W @ pos_acc) + eps
        elif beta == 1:
            pos = pos_acc  # the analytic column sums: no relu/eps
        else:
            pos = torch.relu(pos_acc) + eps
        return W * mu_multiplier(neg, pos, W, gamma, l1_reg, l2_reg)

    def block_loss(Vb, Hb):
        if beta not in (1, 2) and W.dtype == torch.float32:
            return fused_mu.fused_beta_loss(Vb, Hb, W, beta)
        return beta_div(Hb @ W.T, Vb, beta)

    blocks = _Blocks(V, row_block, device, dtype)

    def rows(b):
        return slice(b * row_block, (b + 1) * row_block)

    def total_loss():
        acc = None
        for b, Vb in blocks:
            part = block_loss(Vb, H[rows(b)])
            acc = part if acc is None else acc + part
        return float(torch.sqrt(2.0 * acc))

    try:
        with torch.no_grad():
            loss_init = prev = total_loss()
            n_iter = max_iter
            for it in range(max_iter):
                if update_W:
                    neg_acc = pos_acc = None
                    for b, Vb in blocks:
                        neg_b, pos_b = w_contract(Vb, H[rows(b)])
                        neg_acc = neg_b if neg_acc is None else neg_acc + neg_b
                        pos_acc = pos_b if pos_acc is None else pos_acc + pos_b
                    W = w_update(neg_acc, pos_acc)
                if update_H:
                    for b, Vb in blocks:
                        H[rows(b)] = upd_H(Vb, W, H[rows(b)])
                if it % 10 == 9:
                    loss = total_loss()
                    if (prev - loss) / loss_init < tol:
                        n_iter = it + 1
                        break
                    prev = loss
    finally:
        # on every exit: an error mid-fit must not leak the reader thread
        blocks.close()
    return W, H, n_iter
