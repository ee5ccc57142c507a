"""Source-filter decomposition with frozen templates + BetaMu, on the card.

The PyTorch/CUDA port's counterpart of ``examples/source_filter_model.py``
(the reference's examples/speech_decomposition.ipynb pattern): a composed
``torch.nn.Module``, ``V ≈ (excitation NMF output) * (filter NMF output)``,
whose excitation templates are fixed (harmonic combs) and whose activations
and filter bank are learned, trained with the closure-based multiplicative
updater.  The learned factors start from numpy seed 0, the same on the CPU
and the card.  ``BetaMu`` runs PyTorch's own matrix products (cuBLAS on
the card): this path has no kernel of the port.

Run:  python examples/torch_port/source_filter_model.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from pytorch_nmf_tpu_torch.metrics import beta_div  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF  # noqa: E402
from pytorch_nmf_tpu_torch.trainer import BetaMu  # noqa: E402


class SourceFilter(torch.nn.Module):
    """V ≈ (H_e @ W_eᵀ) ⊙ (H_f @ W_fᵀ): excitation times filter.  The
    learned factors ``H_e (n_frames, n_pitches)``, ``W_f (n_freq,
    rank_filter)`` and ``H_f (n_frames, rank_filter)`` are given (numpy)."""

    def __init__(self, W_excitation, H_excitation, W_filter, H_filter,
                 device="cuda"):
        super().__init__()
        self.excitation = NMF(
            W=torch.from_numpy(W_excitation),
            H=torch.from_numpy(H_excitation),
            trainable_W=False,  # frozen harmonic templates
            device=device,
        )
        self.filter = NMF(W=torch.from_numpy(W_filter),
                          H=torch.from_numpy(H_filter), device=device)

    def forward(self, _=None):
        return self.excitation() * self.filter()


def harmonic_templates(n_freq, n_pitches=24):
    W = np.zeros((n_freq, n_pitches), "f")
    for p in range(n_pitches):
        f0 = 4 + 2 * p
        for h in range(1, n_freq // max(f0, 1)):
            if h * f0 < n_freq:
                W[h * f0, p] = 1.0 / h
    return W + 1e-4


def problem(n_freq=128, n_frames=200, rank_filter=8, seed=0):
    """``(target, W_e, H_e, W_f, H_f)``: the target and the model's factors,
    the learned ones ``|N(0, 1)|``, all from numpy seed ``seed``."""
    rng = np.random.RandomState(seed)
    target = rng.rand(n_frames, n_freq).astype("f")
    W_e = harmonic_templates(n_freq)
    H_e = np.abs(rng.randn(n_frames, W_e.shape[1])).astype("f")
    W_f = np.abs(rng.randn(n_freq, rank_filter)).astype("f")
    H_f = np.abs(rng.randn(n_frames, rank_filter)).astype("f")
    return target, W_e, H_e, W_f, H_f


def main(device="cuda"):
    target, *factors = problem()
    model = SourceFilter(*factors, device=device)
    target = torch.from_numpy(target).to(device)
    frozen = model.excitation.W.detach().clone()
    trainer = BetaMu(model.parameters(), beta=1)

    def closure():
        trainer.zero_grad()
        return target, model()

    losses = []
    for step in range(30):
        trainer.step(closure)
        if step % 10 == 9:
            with torch.no_grad():
                losses.append(float(beta_div(model(), target, 1)))
            print(f"step {step + 1}: KL = {losses[-1]:.4f}")

    assert not model.excitation.W.requires_grad
    assert torch.equal(model.excitation.W.detach(), frozen)
    print("frozen excitation templates untouched:",
          tuple(model.excitation.W.shape))
    return {f"kl_step{10 * (i + 1)}": x for i, x in enumerate(losses)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
