"""A quick check of B4 (``wgrad``) and B2 (``fused_beta_loss``) on the card:
each against its plain version, and its time, at the deconv rows and the
dense shapes of ``chip_smoke.py``.

    python chip_tools/b4_b2_check.py        # from the repository root

Prints one line per case: the relative error (``max|kernel - plain| /
max|plain|`` for B4, relative for B2's scalar) and the event-timed kernel
ms (and the plain ms at the NMFD flagship).  Needs one CUDA device.
"""

import os
import sys


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops.mu import kl_pos_W

    torch.backends.cuda.matmul.allow_tf32 = False
    rank8 = cs.DECONV["NMFD"][:4] + (8,)
    for label, shape in (("NMFD", cs.DECONV["NMFD"]), ("R8", rank8),
                         ("NMF2D", cs.DECONV["NMF2D"]),
                         ("NMF3D", cs.DECONV["NMF3D"])):
        op = cs.deconv_operands(F, *shape)
        R, T = op["R"], op["T"]
        kw = dict(lead_pad=op["lead"], geom=op["geom"])
        mu = dict(kw, mu_w2=op["W2"], mu_pos=kl_pos_W(op["H"]).reshape(-1))
        cases = {"one": lambda fn: fn(op["cots"][:1], op["H2"], R, T, **kw),
                 "pair": lambda fn: fn(op["cots"], op["H2"], R, T, **kw),
                 "epi": lambda fn: fn(op["cots"][:1], op["H2"], R, T, **mu)}
        for case, call in cases.items():
            got, ref = call(D.wgrad), call(D.plain_wgrad)
            torch.cuda.synchronize()
            rel = max(float((g - r).abs().max()) / float(r.abs().max())
                      for g, r in zip(got, ref))
            ms = cs.cuda_ms(lambda: call(D.wgrad), reps=10, warmup=1)
            line = f"B4 {label} {case}: rel {rel:.3g} kernel {ms:.4f} ms"
            if label == "NMFD":
                pms = cs.cuda_ms(lambda: call(D.plain_wgrad), reps=5, warmup=1)
                line += f" plain {pms:.4f}"
            print(line, flush=True)
        del op
    for M, K, R in (cs.MAIN_SHAPE, cs.WIDE_SHAPE):
        V, W, H = cs.inputs(M, K, R)
        V = fm.aligned_rows(V)
        for beta in (0.0, 0.5, 1.5):
            got = float(fm.fused_beta_loss(V, H, W, beta))
            ref = float(fm.plain_beta_loss(V, H, W, beta))
            ms = cs.cuda_ms(lambda: fm.fused_beta_loss(V, H, W, beta))
            print(f"B2 {M}x{K} R={R} beta={beta}: rel "
                  f"{abs(got - ref) / abs(ref):.3g} kernel {ms:.4f} ms",
                  flush=True)


if __name__ == "__main__":
    main()
