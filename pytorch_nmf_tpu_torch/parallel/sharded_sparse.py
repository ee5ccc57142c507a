r"""Row-sharded sparse NMF (counterpart of
:mod:`pytorch_nmf_tpu.parallel.sharded_sparse`).

The non-zeros of ``V (M, K)`` are split by row block over the ``data``
mesh dimension: rank ``d`` holds rows ``[d·M_loc, (d+1)·M_loc)``, with
``M_loc = ceil(M / n)``.  Each rank builds both dual-ELL sides of its rows
(:func:`..ops.sparse._ell_side`) on its device: a row side over its local
rows (column ids global, W being replicated) and a column side over all
``K`` columns whose ids are local row positions into its H block.

* The H update needs only the rank's rows and the replicated W: no
  communication.
* The W update contracts the rank's column side into a partial ``(K, R)``
  numerator; one all-reduce per iteration sums it, with the denominator's
  partial (H's column sums at β=1, ``HᵀH`` at β=2, the positive term's
  gradient otherwise), before the clamps.
* The cadence loss is the exact split form ``V_norm + pos - neg`` from the
  ranks' scalars, all-reduced once.

No kernel runs here: the ELL reductions are plain PyTorch, as the JAX
package leaves them to XLA.
"""

import torch

from ..constants import eps
from ..ops import sparse as _sparse
from ..ops.budget import budget_bytes
from ..ops.mu import gamma_from_beta
from ..ops.solver import _converging_loop
from .comm import comm_for
from .sharded import (_mu_step, as_dtensor, local_block, mesh_device,
                      placements)

__all__ = ["sharded_sparse_nmf_fit"]


def _build_sharded_ell(V, n_dev: int, rank: int, device):
    """Rank ``rank``'s dual-ELL layout of the coalesced 2-D sparse ``V``
    among ``n_dev`` row blocks: ``(row_idx, row_val, row_rem, col_idx,
    col_val, col_rem, n_real, M_loc)``.  Every rank checks the budget on the
    widest block of all (the JAX package's stacked layout pads every block
    to it), so all ranks take the same decision."""
    V = V.coalesce()
    M, K = V.shape
    M_loc = -(-M // n_dev)
    ii, jj = V.indices()
    vals = V.values()
    bounds = torch.searchsorted(ii, torch.arange(1, n_dev + 1) * M_loc)
    starts = torch.cat([bounds.new_zeros(1), bounds[:-1]])
    widest_r = widest_c = 1
    caps = []
    for d in range(n_dev):
        s, e = int(starts[d]), int(bounds[d])
        nnz_d = max(e - s, 1)
        cap_r, cap_c = _sparse._ell_cap(nnz_d, M_loc), _sparse._ell_cap(nnz_d, K)
        caps.append((cap_r, cap_c))
        if e > s:
            widest_r = max(widest_r, min(int(torch.bincount(
                ii[s:e] - d * M_loc, minlength=M_loc).max()), cap_r))
            widest_c = max(widest_c, min(int(torch.bincount(
                jj[s:e], minlength=K).max()), cap_c))
    max_bytes = budget_bytes("PNT_SPARSE_ELL_MAX_BYTES", 4 * 1024**3, 0.25,
                             device)
    per_shard = 8 * (M_loc * widest_r + K * widest_c)
    if per_shard > max_bytes:
        raise ValueError(
            f"sharded dual-ELL layout needs ~{per_shard / 2**30:.1f} GiB per "
            "shard, over the PNT_SPARSE_ELL_MAX_BYTES budget; raise the "
            "budget, add ranks, or lower PNT_SPARSE_ELL_MAX_PAD")
    s, e = int(starts[rank]), int(bounds[rank])
    ii_loc = (ii[s:e] - rank * M_loc).to(device)
    jj_d = jj[s:e].to(device)
    v_d = vals[s:e].to(device=device, dtype=torch.float32)
    cap_r, cap_c = caps[rank]
    row_idx, row_val, row_rem = _sparse._ell_side(ii_loc, jj_d, v_d, M_loc,
                                                  cap_r)
    order = torch.argsort(jj_d, stable=True)
    col_idx, col_val, col_rem = _sparse._ell_side(
        jj_d[order], ii_loc[order], v_d[order], K, cap_c)
    n_real = max(0, min(M - rank * M_loc, M_loc))
    return (row_idx, row_val, row_rem, col_idx, col_val, col_rem, n_real,
            M_loc)


def sharded_sparse_nmf_fit(V, W, H, mesh, beta: float = 1, tol: float = 1e-4,
                           max_iter: int = 200, l1_reg: float = 0.0,
                           l2_reg: float = 0.0, data_axis: str = "data"):
    """Fit ``V ≈ H Wᵀ`` against the sparse ``V (M, K)`` (a
    ``torch.sparse_coo_tensor``, the same on every rank) with its rows
    sharded over ``data_axis``.  ``W (K, R)`` is replicated, ``H (M, R)``
    (full) is split by row block; rows are zero-padded to divide evenly
    (padded rows are MU fixed points and are left out of the loss).
    Returns ``(W, H, n_iter)``: DTensors (``H`` row-sharded, the last
    blocks shorter) and an int, matching the single-card ELL fit to float32
    summation order.  β must be positive (zeros in ``V`` are implicit)."""
    if V.ndim != 2:
        raise ValueError("sharded sparse fit expects a 2-D sparse target")
    beta, tol, max_iter = float(beta), float(tol), int(max_iter)
    l1_reg, l2_reg = float(l1_reg), float(l2_reg)
    gamma = gamma_from_beta(beta)
    M, K = V.shape
    data = comm_for(mesh, data_axis)
    dev = mesh_device(mesh)
    V = V.detach().to("cpu").coalesce()
    (row_idx, row_val, row_rem, col_idx, col_val, col_rem, n_real,
     M_loc) = _build_sharded_ell(V, data.size, data.rank, dev)
    V_norm = _sparse.get_V_norm(V.to(torch.float32), beta).to(dev)
    rows, rep = placements(mesh, {0: data_axis}), placements(mesh, {})
    shapes = (tuple(W.shape), tuple(H.shape))
    w = local_block(W, mesh, rep)
    h_real = local_block(H, mesh, rows)
    h = torch.zeros((M_loc, h_real.shape[1]), dtype=torch.float32, device=dev)
    h[:n_real] = h_real

    def neg_grad(idx, val, rem, self_f, other_f):
        g = _sparse.ell_neg_grad(idx, val, self_f, other_f, beta)
        if rem[2].numel():  # the hybrid's over-cap spill
            g = g + _sparse.coo_rem_neg_grad(rem, self_f, other_f, beta)
        return g

    def loss_of(state):
        w, h = state
        pos = _sparse.nmf_ell_pos_scalar(w, h[:n_real], beta)
        neg = _sparse.ell_neg_scalar(row_idx, row_val, h, w, beta)
        if row_rem[2].numel():
            neg = neg + _sparse.coo_rem_neg_scalar(row_rem, h, w, beta)
        part = (pos - neg).reshape(1)
        data.all_reduce(part)
        return torch.sqrt(2.0 * (V_norm + part[0]))

    def one_iter(state):
        w, h = state
        # the W update (old h): the column side's partial numerator and
        # the denominator's partial, summed over the ranks in one round
        neg = neg_grad(col_idx, col_val, col_rem, w, h)
        if beta == 1:
            pos = torch.sum(h, dim=0, keepdim=True)
        elif beta == 2:
            pos = h.T @ h
        else:
            pos = _sparse.nmf_ell_pos_grad(w, h, beta, want_H=False)
        data.all_reduce(neg, pos)
        if beta == 2:
            pos = w @ pos
        if beta != 1:
            pos = torch.relu(pos) + eps
        w = _mu_step(w, neg, pos, gamma, l1_reg, l2_reg)
        # the H update (new w): the rank's own rows
        neg = neg_grad(row_idx, row_val, row_rem, h, w)
        pos = (torch.sum(w, dim=0, keepdim=True) if beta == 1 else
               torch.relu(_sparse.nmf_ell_pos_grad(w, h, beta, want_H=True))
               + eps)
        return w, _mu_step(h, neg, pos, gamma, l1_reg, l2_reg)

    with torch.no_grad():
        (w, h), k, conv = _converging_loop(one_iter, loss_of, (w, h), tol,
                                           max_iter)
    return (as_dtensor(w, mesh, rep, shapes[0]),
            as_dtensor(h[:n_real].contiguous(), mesh, rows, shapes[1]),
            k * 10 if conv else max_iter)
