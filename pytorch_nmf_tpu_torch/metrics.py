r"""Beta-divergence family and the Hoyer sparseness measure.

PyTorch counterpart of :mod:`pytorch_nmf_tpu.metrics`, with the epsilon
placed exactly as there (and as in the reference ``torchnmf/metrics.py``),
so loss trajectories agree to float32 precision:

* ``kl_div``     — generalized KL (β = 1); eps inside both logs.
* ``euclidean``  — half squared Frobenius distance (β = 2).
* ``is_div``     — Itakura-Saito (β = 0); eps on input and target.
* ``beta_div``   — generic β; eps on the input, and on the target when β < 0.
* ``sparseness`` — Hoyer'04 sparseness.

The first argument is the reconstruction, the second the target.  A
bfloat16 target against a float32 reconstruction follows the JAX package's
promotion: elementwise terms of the target alone stay bfloat16 (as
``jnp`` computes them), products with the reconstruction are float32.
"""

import torch

from .constants import eps
from .ops.recon import matmul

__all__ = ["kl_div", "euclidean", "is_div", "beta_div", "sparseness"]


def kl_div(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    r"""Generalized Kullback-Leibler divergence (β-divergence at β = 1)."""
    t = target.reshape(-1)
    i = input.reshape(-1)
    return (matmul(t, torch.log(t + eps) - torch.log(i + eps)) - t.sum()
            + i.sum())


def euclidean(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    r"""Half squared Euclidean distance (β-divergence at β = 2)."""
    d = input - target
    return 0.5 * torch.sum(d * d)


def is_div(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    r"""Itakura-Saito divergence (β-divergence at β = 0)."""
    t_eps = target + eps
    i_eps = input + eps
    return (
        torch.sum(t_eps / i_eps)
        - torch.sum(torch.log(t_eps))
        + torch.sum(torch.log(i_eps))
        - target.numel()
    )


def beta_div(input: torch.Tensor, target: torch.Tensor, beta: float = 2):
    r"""The β-divergence; the three special values dispatch to the
    closed forms above."""
    if beta == 2:
        return euclidean(input, target)
    elif beta == 1:
        return kl_div(input, target)
    elif beta == 0:
        return is_div(input, target)

    input = input.reshape(-1) + eps
    target = target.reshape(-1)
    if beta < 0:
        target = target + eps
    bm1 = beta - 1

    target_pow = torch.sum(target**beta)
    input_pow = torch.sum(input**beta)
    cross = matmul(target, input**bm1)

    loss = target_pow + bm1 * input_pow - beta * cross
    return loss / (beta * bm1)


def sparseness(x: torch.Tensor) -> torch.Tensor:
    r"""Hoyer'04 sparseness in [0, 1]: 1 is the most sparse."""
    x = x.reshape(-1)
    N = x.numel()
    l1 = torch.sum(torch.abs(x))
    l2 = torch.sqrt(torch.sum(x * x))
    return (N**0.5 - l1 / l2) / (N**0.5 - 1)
