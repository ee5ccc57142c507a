"""NMFD demo on a synthetic magnitude spectrogram, on the card.

The PyTorch/CUDA port's counterpart of ``examples/spectrogram_nmfd.py``,
itself the equivalent of the reference's examples/librosa_example.py (which
decomposes a librosa audio spectrogram with a rank-3, T=400 NMFD): here the
spectrogram is synthesized — three spectral templates convolved with sparse
activations plus noise — so the demo runs without audio dependencies, and
the factorization should recover the three components.  The fit starts
from ``|N(0, 1)|`` factors drawn from an explicit numpy seed (the same on
the CPU and the card); on the card its updates run the ``hgrad``/``wgrad``
kernels.

Run:  python examples/torch_port/spectrogram_nmfd.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from pytorch_nmf_tpu_torch.metrics import kl_div  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMFD  # noqa: E402


def synth_spectrogram(n_freq=256, n_frames=860, rank=3, T=40, seed=0):
    rng = np.random.RandomState(seed)
    # smooth spectral kernels with distinct peaks, evolving over T frames
    W = np.zeros((n_freq, rank, T), "f")
    for r in range(rank):
        center = (r + 1) * n_freq // (rank + 1)
        freq_profile = np.exp(-0.5 * ((np.arange(n_freq) - center) / 8.0) ** 2)
        decay = np.exp(-np.arange(T) / (T / 3))
        W[:, r, :] = freq_profile[:, None] * decay[None, :]
    # sparse activations
    H = ((rng.rand(1, rank, n_frames - T + 1) > 0.98)
         * rng.rand(1, rank, n_frames - T + 1)).astype("f")
    V = NMFD.reconstruct(torch.from_numpy(H), torch.from_numpy(W)).numpy()
    V = V + 0.01 * rng.rand(1, n_freq, n_frames).astype("f")
    return V


def init_factors(V_shape, rank, T):
    """``(W0, H0)``: ``|N(0, 1)|`` draws of numpy seed 1."""
    N, C, L = V_shape
    rs = np.random.RandomState(1)
    return (np.abs(rs.randn(C, rank, T)).astype("f"),
            np.abs(rs.randn(N, rank, L - T + 1)).astype("f"))


def main(device="cuda", verbose=True):
    V = synth_spectrogram()
    print(f"spectrogram: {V.shape}; fitting on {device}")

    W0, H0 = init_factors(V.shape, rank=3, T=40)
    model = NMFD(W=torch.from_numpy(W0), H=torch.from_numpy(H0), device=device)
    Vt = torch.from_numpy(V).to(model.W.device)
    n_iter = model.fit(Vt, beta=1, tol=1e-6, max_iter=200, verbose=verbose)
    with torch.no_grad():
        kl = float(kl_div(model(), Vt))

    print(f"converged in {n_iter} iterations")
    print(f"final KL divergence: {kl:.4f}")
    print(f"templates W: {tuple(model.W.shape)}, activations H: "
          f"{tuple(model.H.shape)}")
    return {"kl": kl, "n_iter": n_iter}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
