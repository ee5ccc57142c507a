"""Basic tutorial: the core workflow in five short sections, on the card.

The PyTorch/CUDA port's counterpart of ``examples/basic_tutorial.py``
(the script equivalent of the reference's examples/basic_tutorial.ipynb).
Every model starts from factors drawn from one numpy generator (seed 0),
in the order the sections run, so the CPU and the card start alike.  On
the card the β=1 and β=0 fits run the ``fused_contractions`` kernel, the
β=0 fit's loss the ``fused_beta_loss`` kernel, and the Hoyer section's
projections the ``hoyer_proj`` kernel.

Run:  python examples/torch_port/basic_tutorial.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(device="cuda"):
    from pytorch_nmf_tpu_torch import sparse_from_dense
    from pytorch_nmf_tpu_torch.metrics import beta_div, sparseness
    from pytorch_nmf_tpu_torch.nmf import NMF

    rng = np.random.RandomState(0)

    def inits(M, K, R):
        """``|N(0, 1)|`` factors ``W (K, R)``, ``H (M, R)`` from ``rng``."""
        W = np.abs(rng.randn(K, R)).astype("f")
        return W, np.abs(rng.randn(M, R)).astype("f")

    def model(M, K, R, **kw):
        W, H = inits(M, K, R)
        return NMF(W=torch.from_numpy(W), H=torch.from_numpy(H),
                   device=device, **kw)

    def div(m, V, beta):
        with torch.no_grad():
            return float(beta_div(m(), V, beta))

    out = {}

    # --- 1. factorize a non-negative matrix --------------------------------
    V = torch.from_numpy(rng.rand(100, 50).astype("f")).to(device)
    net = model(*V.shape, 8)
    n_iter = net.fit(V, beta=1)  # KL-divergence multiplicative updates
    out["kl"], out["n_iter"] = div(net, V, 1), n_iter
    print(f"1. NMF converged in {n_iter} iterations; KL = {out['kl']:.3f}")

    # --- 2. different divergences -------------------------------------------
    for beta in [0, 1, 2]:
        m = model(*V.shape, 8)
        m.fit(V + 0.01, beta=beta, max_iter=100)
        out[f"beta{beta}"] = div(m, V + 0.01, beta)
        print(f"2. beta={beta}: final divergence {out[f'beta{beta}']:.3f}")

    # --- 3. fixed templates (supervised decomposition) ----------------------
    templates = net.W.detach().clone()  # reuse learned templates
    _, H = inits(100, 50, 8)
    m = NMF(W=templates, H=torch.from_numpy(H), trainable_W=False,
            device=device)
    m.fit(V, beta=1)
    assert torch.equal(m.W.detach(), templates)
    out["frozen_kl"] = div(m, V, 1)
    print("3. frozen-template fit leaves W untouched")

    # --- 4. sparse targets ---------------------------------------------------
    V_sparse = sparse_from_dense(torch.where(V > 0.9, V, 0))
    m = model(*V.shape, 8)
    m.fit(V_sparse, beta=1)
    out["sparse_kl"] = div(m, V_sparse.to_dense(), 1)
    print(f"4. sparse target ({V_sparse._nnz()} nnz) fit ok")

    # --- 5. sparseness-constrained factors ----------------------------------
    m = model(*V.shape, 8)
    m.sparse_fit(V, beta=2, sW=0.6, max_iter=50)
    out["sparseness"] = float(sparseness(m.W.detach()[:, 0]))
    print(f"5. Hoyer-constrained fit: column sparseness = "
          f"{out['sparseness']:.3f} (target 0.6)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
