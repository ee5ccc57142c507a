r"""Hoyer sparseness projection (counterpart of
:mod:`pytorch_nmf_tpu.ops.projection`).

Projects a vector onto ``{v >= 0 : ||v||_1 = k1, ||v||_2^2 = k2}`` (Hoyer'04,
"Non-negative Matrix Factorization with Sparseness Constraints"; reference
``_proj_func``, torchnmf/nmf.py:21-49).  Each round moves ``v`` along the
active coordinates to the L2 sphere and, if a coordinate went negative,
zeroes it and re-centres the rest, so ``N + 2`` rounds always suffice.

The JAX package vmaps a ``lax.while_loop`` over the rank columns; here the
columns are the rows of one ``(R, N)`` tensor, each with its own ``done``
flag.  A finished row is frozen by the mask, as batched ``while_loop`` does,
and never recomputed: the round is not idempotent in float32.  With frozen
rows an extra round changes nothing, so the host reads ``done.all()`` only
every :data:`CHECK_EVERY` rounds and the result is still exact.  Each read
adds one to ``proj_rows.reads``.

The projection runs in the input's dtype (the JAX package's always in
float32).
"""

import torch

__all__ = ["hoyer_l1_target", "proj_func", "proj_rows", "proj_columns",
           "proj_columns_explicit"]

# rounds between two host reads of ``done.all()``
CHECK_EVERY = 2


def hoyer_l1_target(dim: int, s: float) -> float:
    """L1 norm giving sparseness ``s`` at unit L2 for a ``dim``-vector
    (reference nmf.py:461,470)."""
    return dim**0.5 * (1 - s) + s


def proj_rows(s: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor):
    """Project every row of ``s (R, N)`` to L1 norm ``k1[r]`` and squared L2
    norm ``k2[r]`` (``k1``, ``k2``: ``(R,)``)."""
    R, N = s.shape
    k1 = k1.to(s.dtype)
    k2 = k2.to(s.dtype)
    v = s + ((k1 - s.sum(1)) / N)[:, None]
    zero = torch.zeros_like(s, dtype=torch.bool)
    done = torch.zeros(R, dtype=torch.bool, device=s.device)
    for it in range(N + 2):
        m = k1 / (N - zero.sum(1))
        w = torch.where(zero, v, v - m[:, None])
        a = (w * w).sum(1)
        b = 2.0 * (w * v).sum(1)
        c = (v * v).sum(1) - k2
        alphap = (-b + torch.sqrt(torch.relu(b * b - 4.0 * a * c))) * 0.5 / a
        v_new = v + alphap[:, None] * w
        mask = v_new < 0
        fin = ~mask.any(1)
        zero_fix = zero | mask
        v_fix = torch.relu(v_new)
        v_fix = torch.relu(v_fix + ((k1 - v_fix.sum(1))
                                    / (N - zero_fix.sum(1)))[:, None])
        # rows finished earlier keep their state (batched while_loop)
        upd = (~done)[:, None]
        v = torch.where(upd, torch.where(fin[:, None], v_new, v_fix), v)
        zero = torch.where(upd & ~fin[:, None], zero_fix, zero)
        done = done | fin
        if (it + 1) % CHECK_EVERY == 0 and it + 1 < N + 2:
            proj_rows.reads += 1
            if bool(done.all()):
                break
    return v


proj_rows.reads = 0


def proj_func(s: torch.Tensor, k1, k2) -> torch.Tensor:
    """Project ``s`` (any shape, flattened) to L1 norm ``k1`` and squared L2
    norm ``k2``.  Shape-preserving."""
    k = torch.as_tensor(k1, dtype=s.dtype, device=s.device).reshape(1)
    q = torch.as_tensor(k2, dtype=s.dtype, device=s.device).reshape(1)
    return proj_rows(s.reshape(1, -1), k, q).reshape(s.shape)


def _columns(x: torch.Tensor, axis: int):
    xm = x.movedim(axis, 0)
    return xm, xm.reshape(xm.shape[0], -1)


def proj_columns(x: torch.Tensor, L1_scale: float, axis: int = 1,
                 norms: torch.Tensor = None) -> torch.Tensor:
    """Project every rank column of ``x`` (the slice ``x[:, j]`` along
    ``axis``, flattened) onto L1 norm ``L1_scale·norm_j`` and squared L2
    norm ``norm_j²`` (reference nmf.py:516-521, 564-569; trainer.py:170-177).
    ``norms`` defaults to the slices' own L2 norms; the SparsityProj trainer
    passes the norms of the parameter before its step."""
    xm, cols = _columns(x, axis)
    if norms is None:
        norms = torch.sqrt(torch.sum(cols * cols, dim=1))
    proj = proj_rows(cols, L1_scale * norms, norms * norms)
    return proj.reshape(xm.shape).movedim(0, axis)


def proj_columns_explicit(x: torch.Tensor, k1s, k2s, axis: int = 1):
    """Project every column of ``x`` along ``axis`` onto explicit targets
    ``(k1s[j], k2s[j])``, scalars or ``(R,)`` (the initial projection to
    unit L2, reference nmf.py:463-464,472-473)."""
    xm, cols = _columns(x, axis)
    R = cols.shape[0]

    def per_col(k):
        return torch.as_tensor(k, dtype=x.dtype, device=x.device).expand(R)

    proj = proj_rows(cols, per_col(k1s), per_col(k2s))
    return proj.reshape(xm.shape).movedim(0, axis)
