r"""The composed-model trainers' steps (counterpart of
:mod:`pytorch_nmf_tpu.ops.trainer_core`), as functions over a list of
tensors, with gradients from ``torch.autograd``.

* :func:`betamu_step` — one coordinate-wise multiplicative-update sweep:
  each parameter in turn, against the already-updated ones before it.
* :func:`sparsity_proj_step` — one Hoyer projected-gradient step with the
  backtracking line search.

Their per-parameter pieces (:func:`mu_raw_pair`, :func:`mu_apply`,
:func:`proj_line_search`) are also the optimizers' of
:mod:`pytorch_nmf_tpu_torch.trainer`.  The observables are the reference
trainers' (torchnmf/trainer.py:36-121, 147-190): at β=1 the positive
cotangent is ``ones_like``, ``grad = pos_raw − relu(neg_raw)``, the
regularizers join the denominator, and the update is ``(neg + eps) / (pos +
eps)``.
"""

from typing import Callable, List, Optional, Sequence

import torch

from ..constants import eps
from .mu import gamma_from_beta, get_norm, mu_cotangents
from .projection import hoyer_l1_target, proj_columns
from .solver import _f32

__all__ = ["betamu_step", "sparsity_proj_step"]


def mu_raw_pair(WH: torch.Tensor, x: torch.Tensor, V, beta: float):
    """``(neg_raw, pos_raw)``: the gradients in ``x`` of the reconstruction
    ``WH`` against the β cotangent pair (β=1: ``ones_like`` positive), or
    ``None`` when ``WH`` does not depend on ``x`` (the reference's ``if not
    WH.requires_grad``, trainer.py:75-77)."""
    if not WH.requires_grad:
        return None
    V = torch.as_tensor(V, dtype=WH.dtype, device=WH.device)
    neg_cot, pos_cot = mu_cotangents(V, WH.detach(), beta, kl_pos_ones=True)
    (neg_raw,) = torch.autograd.grad(WH, x, neg_cot, retain_graph=True,
                                     allow_unused=True)
    if neg_raw is None:
        return None
    (pos_raw,) = torch.autograd.grad(WH, x, pos_cot)
    return neg_raw, pos_raw


def mu_apply(p, neg_raw, pos_raw, gamma: float, l1_reg: float, l2_reg: float,
             orthogonal: float):
    """``(p · multiplier, grad)`` from the raw pair: ``grad = pos_raw −
    relu(neg_raw)`` is the β-divergence gradient (reference trainer.py:98);
    l1, l2 and the ``orthogonal`` term ``Σ_rank p − p`` join the
    denominator (trainer.py:100-114)."""
    neg = torch.relu(neg_raw)
    pos = torch.relu(pos_raw)
    grad = pos_raw - neg
    if l1_reg > 0:
        pos = pos + l1_reg
    if l2_reg > 0:
        pos = pos + l2_reg * p
    if orthogonal > 0:
        pos = pos + orthogonal * (torch.sum(p, dim=1, keepdim=True) - p)
    multiplier = (neg + eps) / (pos + eps)
    if gamma != 1:
        multiplier = multiplier**gamma
    return p * multiplier, grad


def betamu_step(
    predict_fn: Callable,
    params: Sequence[torch.Tensor],
    V,
    beta: float = 1,
    l1_reg: float = 0.0,
    l2_reg: float = 0.0,
    orthogonal: float = 0.0,
    trainable: Optional[Sequence[bool]] = None,
):
    """One coordinate-wise MU sweep over ``params`` (non-negative tensors):
    ``predict_fn(params) -> reconstruction``, re-evaluated for each
    parameter with the earlier ones already updated.  ``trainable`` (bools)
    freezes parameters.  Returns ``(new_params, grads)``, ``grads`` the
    β-divergence gradient of each parameter (zeros for a frozen one, and
    for one the reconstruction does not depend on)."""
    gamma = gamma_from_beta(beta)
    leaves = [torch.as_tensor(p).detach() for p in params]
    if trainable is None:
        trainable = [True] * len(leaves)
    grads = []
    for i, p in enumerate(leaves):
        if not trainable[i]:
            grads.append(torch.zeros_like(p))
            continue
        with torch.enable_grad():
            x = p.clone().requires_grad_(True)
            raw = mu_raw_pair(predict_fn(leaves[:i] + [x] + leaves[i + 1:]),
                              x, V, beta)
        if raw is None:  # no dependence: zero gradients, as the JAX vjp gives
            raw = (torch.zeros_like(p), torch.zeros_like(p))
        with torch.no_grad():
            leaves[i], grad = mu_apply(p, *raw, gamma, l1_reg, l2_reg,
                                       orthogonal)
        grads.append(grad)
    return leaves, grads


def proj_line_search(values: List[torch.Tensor], grads, lr: float,
                     sparsity: float, dim: int, max_iter: int, init_loss,
                     evaluate: Callable):
    """The projected-gradient line search (reference trainer.py:166-187):
    step every value by ``lr·grad`` and project its columns along ``dim``
    to Hoyer sparseness ``sparsity`` at the norms it had before the step;
    ``evaluate(new_values) -> loss``.  While the loss is worse than
    ``init_loss``, undo the step onto the projected value and halve
    ``lr``, at most ``max_iter`` attempts; when every attempt failed, the
    last one is undone too and ``lr`` halved once more.  One host read per
    attempt.  Returns ``(values, lr, loss)``, ``lr`` before the growth by
    1.2."""
    def project_all(vals, step):
        return [proj_columns(p - step * g,
                             hoyer_l1_target(p.numel() // p.shape[dim], sparsity),
                             axis=dim, norms=get_norm(p, dim))
                for p, g in zip(vals, grads)]

    new = project_all(values, lr)
    loss = evaluate(new)
    worse = bool(loss > init_loss)
    tries = 1
    while worse and tries < max_iter:
        cur = [p + lr * g for p, g in zip(new, grads)]
        lr *= 0.5
        new = project_all(cur, lr)
        loss = evaluate(new)
        worse = bool(loss > init_loss)
        tries += 1
    if worse:
        new = [p + lr * g for p, g in zip(new, grads)]
        lr *= 0.5
    return new, lr, loss


def sparsity_proj_step(
    loss_fn: Callable,
    params: Sequence[torch.Tensor],
    lr,
    sparsity: float,
    dim: int = 1,
    max_iter: int = 10,
    return_grads: bool = False,
):
    """One Hoyer projected-gradient step with backtracking over ``params``:
    ``loss_fn(params) -> scalar loss``; ``lr`` the current step size, to be
    carried between calls (×0.5 per failed attempt, ×1.2 per step, rounded
    to float32 as the JAX package carries it).  Returns ``(new_params,
    new_lr, loss)``, plus the loss gradients when ``return_grads``."""
    leaves = [torch.as_tensor(p).detach() for p in params]
    with torch.enable_grad():
        xs = [p.clone().requires_grad_(True) for p in leaves]
        init_loss = loss_fn(xs)
        grads = torch.autograd.grad(init_loss, xs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    with torch.no_grad():
        new, lr, loss = proj_line_search(
            leaves, grads, _f32(lr), sparsity, dim, max_iter,
            init_loss.detach(), loss_fn)
    out = (new, _f32(lr * 1.2), loss)
    return out + (grads,) if return_grads else out
