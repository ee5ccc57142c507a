"""Where a dense fit's device memory goes, step by step, on the card.

    python chip_tools/memory_probe.py      # from the repository root

For V 65536×4097 (4097 columns, so the copy ``target_like`` makes has
padded rows) in bfloat16 and in float32, both from one host tensor, with
rank-64 factors on the card: the device memory allocated, and the peak
since the previous step, each above what was allocated before V reached
the card, after ``target_like``, ``validate_target``, ``aligned_rows``,
B1 on the W side and on the H side (β=1, the epilogue), the β=1 cadence
loss (``fast_nmf._blocked_loss``), a plain ``V.min()``, and a whole
2-iteration ``NMF.fit`` from the host V.  Prints one line per step with
the card's name and power limit.  Needs one CUDA device.
"""

import os
import sys


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch.models._common import (target_like,
                                                      validate_target)
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import fast_nmf, fused_mu
    from pytorch_nmf_tpu_torch.ops.mu import kl_pos_H, kl_pos_W

    if not torch.cuda.is_available():
        sys.exit("memory_probe: needs a CUDA device")
    card = cs.card_line()
    M, K, R = 65536, 4097, 64
    g = torch.Generator().manual_seed(0)
    Vb = (torch.rand((M, K), generator=g) + 0.01).bfloat16()
    for tag, X in (("bf16", Vb), ("f32", Vb.float())):
        W = torch.rand(K, R, device="cuda") + 0.1
        H = torch.rand(M, R, device="cuda") + 0.1
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def step(what):
            torch.cuda.synchronize()
            print(f"{tag} {what}: allocated "
                  f"{(torch.cuda.memory_allocated() - base) / 1e9:.3f} GB, "
                  f"peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.3f}"
                  f" GB [{card}]", flush=True)
            torch.cuda.reset_peak_memory_stats()

        V = target_like(X, W, H)
        step(f"target_like (row stride {V.stride(0)})")
        validate_target(V, 1)
        step("validate_target")
        step(f"aligned_rows (the same view: {fused_mu.aligned_rows(V) is V})")
        fused_mu.fused_contractions(V, H, W, beta=1.0, need_pos=False,
                                    w_side=True, mu_pos=kl_pos_W(H))
        step("B1 W side")
        fused_mu.fused_contractions(V, H, W, beta=1.0, need_pos=False,
                                    w_side=False,
                                    mu_pos=kl_pos_H(W).reshape(1, -1))
        step("B1 H side")
        fast_nmf._blocked_loss(1)(V, W, H)
        step("blocked beta=1 loss")
        V.min()
        step("a plain V.min() of the strided V")
        del V
        m = NMF(W=W, H=H, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m.fit(X, beta=1, tol=0, max_iter=2)
        step("NMF.fit, 2 iterations from the host V")
        del m


if __name__ == "__main__":
    main()
