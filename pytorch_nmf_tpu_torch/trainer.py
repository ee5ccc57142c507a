r"""Optimizers for composed non-negative models (counterpart of
:mod:`pytorch_nmf_tpu.trainer`; reference torchnmf/trainer.py).

* :class:`BetaMu` — the coordinate-wise multiplicative updater minimizing the
  β-divergence of any composed model, for example a ``torch.nn.Sequential``
  of the port's ``NMF`` modules: each module's ``forward(H=None)`` takes the
  previous module's output as its ``H``.
* :class:`SparsityProj` — Hoyer sparseness-constrained projected gradient
  with a backtracking line search over a parameter group.

Both are ``torch.optim.Optimizer``\ s over ``nn.Parameter``\ s with
``step(closure)`` and param groups, and run eagerly: the closure is
evaluated again for each parameter (``BetaMu``) or line-search attempt
(``SparsityProj``).  The JAX package also compiles a whole sweep; the port
does not, and accepts its ``jit_compile`` argument only so that callers of
that API run.
"""

from typing import Callable

import torch

from .ops.mu import gamma_from_beta
from .ops.trainer_core import mu_apply, mu_raw_pair, proj_line_search

__all__ = ["BetaMu", "SparsityProj"]


def _run(step: Callable, closure: Callable, steps: int):
    """``steps`` calls of ``step(closure)``; the last one's result, ``None``
    for zero steps."""
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"Invalid steps value: {steps}")
    out = None
    for _ in range(steps):
        out = step(closure)
    return out


class BetaMu(torch.optim.Optimizer):
    r"""Multiplicative updater minimizing the β-divergence of a composed
    non-negative model (reference trainer.py:7-121).

    Args:
        params: parameters or param-group dicts.
        beta: the β-divergence to minimize. Default 1.
        l1_reg / l2_reg / orthogonal: penalties added to the MU denominator
            (reference trainer.py:100-106).
        jit_compile: accepted for the JAX package's signature; ignored.

    ``step(closure)`` takes ``closure() -> (target, predict)``.  It is
    evaluated once per parameter, the others at their current values; a
    parameter the prediction does not depend on is skipped and its ``.grad``
    left alone.  Every updated parameter's ``.grad`` is the true
    β-divergence gradient at its value before the update.
    """

    def __init__(self, params, beta=1, l1_reg=0, l2_reg=0, orthogonal=0,
                 jit_compile=True):
        if not 0.0 <= l1_reg:
            raise ValueError(f"Invalid l1_reg value: {l1_reg}")
        if not 0.0 <= l2_reg:
            raise ValueError(f"Invalid l2_reg value: {l2_reg}")
        if not 0.0 <= orthogonal:
            raise ValueError(f"Invalid orthogonal value: {orthogonal}")
        super().__init__(params, dict(beta=beta, l1_reg=l1_reg, l2_reg=l2_reg,
                                      orthogonal=orthogonal))

    def step(self, closure: Callable):
        """One coordinate-wise MU pass over every parameter."""
        for group in self.param_groups:
            gamma = gamma_from_beta(group["beta"])
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                with torch.enable_grad():
                    V, WH = closure()
                    raw = mu_raw_pair(WH, p, V, group["beta"])
                if raw is None:
                    continue
                with torch.no_grad():
                    new, p.grad = mu_apply(p.detach(), *raw, gamma,
                                           group["l1_reg"], group["l2_reg"],
                                           group["orthogonal"])
                    p.copy_(new)
        return None

    def run(self, closure: Callable, steps: int):
        """``steps`` calls of :meth:`step`; returns ``None``."""
        _run(self.step, closure, steps)
        return None


class SparsityProj(torch.optim.Optimizer):
    r"""Hoyer sparseness-constrained projected gradient (reference
    trainer.py:124-190).

    Args:
        params: parameters to constrain, or param-group dicts.
        sparsity: target Hoyer sparseness in (0, 1).
        dim: the axis indexing the rank columns. Default 1.
        max_iter: closure evaluations per step (the backtracking budget).
        jit_compile: accepted for the JAX package's signature; ignored.

    ``step(closure)`` takes ``closure() -> loss`` and returns the loss of
    the last attempt.  The step size ``group["lr"]`` (1 at first) carries
    across steps.  A parameter the loss does not depend on is left alone.
    """

    def __init__(self, params, sparsity, dim=1, max_iter=10, jit_compile=True):
        if not 0.0 < sparsity < 1.0:
            raise ValueError(f"Invalid sparsity value: {sparsity}")
        super().__init__(params, dict(sparsity=sparsity, lr=1, dim=dim,
                                      max_iter=max_iter))

    def step(self, closure: Callable):
        """One projected-gradient step with backtracking line search."""
        loss = None
        for group in self.param_groups:
            params = [p for p in group["params"] if p.requires_grad]
            with torch.enable_grad():
                init_loss = closure()
                grads = (torch.autograd.grad(init_loss, params,
                                             allow_unused=True)
                         if params and init_loss.requires_grad
                         else [None] * len(params))
            live = [(p, g) for p, g in zip(params, grads) if g is not None]
            if not live:
                loss = init_loss.detach()
                continue
            for p, g in live:
                p.grad = g

            def evaluate(values):
                for (p, _), v in zip(live, values):
                    p.copy_(v)
                return closure()

            with torch.no_grad():
                new, lr, loss = proj_line_search(
                    [p.detach().clone() for p, _ in live],
                    [g for _, g in live], group["lr"], group["sparsity"],
                    group["dim"], group["max_iter"], init_loss.detach(),
                    evaluate)
                for (p, _), v in zip(live, new):
                    p.copy_(v)
            group["lr"] = lr * 1.2
        return loss

    def run(self, closure: Callable, steps: int):
        """``steps`` calls of :meth:`step`; returns the last step's loss
        (``None`` for zero steps)."""
        return _run(self.step, closure, steps)
