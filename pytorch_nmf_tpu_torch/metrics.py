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

A :class:`~torch.distributed.tensor.DTensor` target (the sharded array the
JAX package's metrics take) against a plain input of its global shape
(what ``model()`` returns after a fit on it) is summed block by block
(:func:`~.parallel.sharded.blockwise_sum`): every rank of the target's
mesh calls the metric, each sums its block of the target against the same
block of the input, one all-reduce of the scalar gives the whole
divergence on every rank, and the input's gradient is whole on every rank.
Two DTensors, and ``sparseness`` of a DTensor, run on DTensor's own ops.
"""

import functools

import torch

from .constants import eps
from .models._common import is_dtensor
from .ops.recon import matmul

__all__ = ["kl_div", "euclidean", "is_div", "beta_div", "sparseness"]


def _on_blocks(metric):
    """``metric``, summed block by block where the target is a DTensor and
    the input is not (the module docstring)."""
    @functools.wraps(metric)
    def wrapped(input, target, *args, **kwargs):
        if is_dtensor(target) and not is_dtensor(input):
            from .parallel.sharded import blockwise_sum

            return blockwise_sum(
                lambda i, t: metric(i, t, *args, **kwargs), input, target)
        return metric(input, target, *args, **kwargs)

    return wrapped


@_on_blocks
def kl_div(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    r"""Generalized Kullback-Leibler divergence (β-divergence at β = 1)."""
    t = target.reshape(-1)
    i = input.reshape(-1)
    return (matmul(t, torch.log(t + eps) - torch.log(i + eps)) - t.sum()
            + i.sum())


@_on_blocks
def euclidean(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    r"""Half squared Euclidean distance (β-divergence at β = 2)."""
    d = input - target
    return 0.5 * torch.sum(d * d)


@_on_blocks
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


@_on_blocks
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
