"""Time B1 and B3 and the dense and NMFD fits of one tree of this repository,
for comparing two commits on one card.

    python chip_tools/ab_time.py LABEL      # from the root of the tree

Unpack the other commit (``git archive``) into a git-ignored directory, copy
this script into it, and run both trees in turns (old, new, new, old) in one
call on one card.  Prints one line ``AB {json}``: per-call times in ms,
event-timed (``*_dev``: the profiler's device time), and fit ms/iteration.
Works on trees whose wrappers take only a contiguous V (``aligned_rows`` is
used where it exists).  Needs one CUDA device.
"""

import json
import os
import sys
import time


def main(label):
    sys.path.insert(0, os.getcwd())  # the tree being timed
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch import nmf as models
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.ops.mu import kl_pos_H, kl_pos_W

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all()
    out = {"tree": label}

    def ev(fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def dev(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in p.key_averages()) / reps / 1e3

    aligned = getattr(fm, "aligned_rows", lambda x: x)
    for M, K, R in (cs.MAIN_SHAPE, cs.WIDE_SHAPE):
        V, W, H = cs.inputs(M, K, R)
        V = aligned(V)  # as the fit pads it, once per fit
        cases = {"b05": dict(beta=0.5, need_pos=True),
                 "b1": dict(beta=1.0, need_pos=False)}
        for side, ws in (("W", True), ("H", False)):
            for c, kw in cases.items():
                if R > 128 and c != "b05":
                    continue
                f = lambda: fm.fused_contractions(V, H, W, w_side=ws, **kw)  # noqa: E731
                out[f"B1_{M}_{R}_{side}_{c}"] = ev(f)
                out[f"B1_{M}_{R}_{side}_{c}_dev"] = dev(f)
            if R <= 128:
                mp = kl_pos_W(H) if ws else kl_pos_H(W).reshape(1, -1)
                out[f"B1_{M}_{R}_{side}_epi"] = ev(
                    lambda: fm.fused_contractions(V, H, W, beta=1.0,
                                                  need_pos=False, w_side=ws,
                                                  mu_pos=mp))
        if R <= 128:
            def both():
                fm.fused_contractions(V, H, W, beta=0.5, need_pos=True, w_side=True)
                fm.fused_contractions(V, H, W, beta=0.5, need_pos=True, w_side=False)

            out["B1_json"], out["B1_json_dev"] = ev(both), dev(both)
        del V, W, H
    rank8 = cs.DECONV["NMFD"][:4] + (8,)
    for label_, shape in (("NMFD", cs.DECONV["NMFD"]), ("NMFD_R8", rank8),
                          ("NMF2D", cs.DECONV["NMF2D"]),
                          ("NMF3D", cs.DECONV["NMF3D"])):
        op = cs.deconv_operands(F, *shape)
        out[f"B3_{label_}"] = ev(
            lambda: D.hgrad(op["cots"][0], op["W2"], op["R"], op["L_h"],
                            geom=op["geom"]), reps=10, warm=1)
        del op

    def fit_ms(model, V, beta, iters):
        # warm-up, through the every-10-iterations loss too: its first call
        # costs tens of ms of one-time set-up
        model.fit(V, beta=beta, tol=0, max_iter=10)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.fit(V, beta=beta, tol=0, max_iter=iters)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

    M, K, R = cs.MAIN_SHAPE
    V, _, _ = cs.inputs(M, K, R)
    for beta in (1, 0.5):
        m = models.NMF((M, K), R, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
        out[f"fit_nmf_b{beta}"] = fit_ms(m, V, beta, 100)
    out["fit_nmfd_b1"] = fit_ms(cs.deconv_model("NMFD", models),
                                cs.deconv_target("NMFD"), 1, 10)
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
