"""Time the kernels and fits of one tree of this repository, for comparing
two commits on one card.

    python chip_tools/ab_time.py LABEL      # from the root of the tree

Unpack the other commit (``git archive``) into a git-ignored directory, copy
this script into it, and run both trees in turns (old, new, new, old) in one
call on one card.  Prints one line ``AB {json}``: per-call times in ms,
event-timed (``*_dev``: the profiler's device time), and fit ms/iteration:

* B1 at 5168×1025 R=88 and 4096² R=256; B2 at both, β=0.5;
* B3 and B4 at the NMFD flagship (1025×5000, R=88, T=400), its rank-8 row
  and the NMF2D and NMF3D rows; B4 with one cotangent, the β=1 epilogue and,
  at the flagship and the NMF3D row, the neg/pos pair;
* the dense fit at β=1 and 0.5, NMFD at β=1 and 0.5, NMF2D and NMF3D at β=1.

Then one line ``PROFILE {json}``: the profiler's device time per iteration
of the NMFD β=1 fit by kernel (the ten largest), their sum and the wall time
of the same iterations.  Works on trees whose wrappers take only a
contiguous V (``aligned_rows`` is used where it exists).  Needs one CUDA
device.
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
        f = lambda: fm.fused_beta_loss(V, H, W, 0.5)  # noqa: E731
        out[f"B2_{M}_{R}"], out[f"B2_{M}_{R}_dev"] = ev(f), dev(f)
        del V, W, H
    rank8 = cs.DECONV["NMFD"][:4] + (8,)
    for label_, shape in (("NMFD", cs.DECONV["NMFD"]), ("NMFD_R8", rank8),
                          ("NMF2D", cs.DECONV["NMF2D"]),
                          ("NMF3D", cs.DECONV["NMF3D"])):
        op = cs.deconv_operands(F, *shape)
        R, T, kw = op["R"], op["T"], dict(lead_pad=op["lead"], geom=op["geom"])
        out[f"B3_{label_}"] = ev(
            lambda: D.hgrad(op["cots"][0], op["W2"], R, op["L_h"],
                            geom=op["geom"]), reps=10, warm=1)
        calls = {
            "one": lambda: D.wgrad(op["cots"][:1], op["H2"], R, T, **kw),
            "epi": lambda: D.wgrad(op["cots"][:1], op["H2"], R, T,
                                   mu_w2=op["W2"],
                                   mu_pos=kl_pos_W(op["H"]).reshape(-1), **kw),
            "pair": lambda: D.wgrad(op["cots"], op["H2"], R, T, **kw),
        }
        for case, f in calls.items():
            if case == "pair" and label_ not in ("NMFD", "NMF3D"):
                continue
            out[f"B4_{label_}_{case}"] = ev(f, reps=10, warm=1)
        out[f"B4_{label_}_one_dev"] = dev(calls["one"], reps=5)
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
    del V
    for name, beta, iters in (("NMFD", 1, 10), ("NMFD", 0.5, 10),
                              ("NMF2D", 1, 20), ("NMF3D", 1, 20)):
        out[f"fit_{name.lower()}_b{beta}"] = fit_ms(
            cs.deconv_model(name, models), cs.deconv_target(name), beta, iters)
    print("AB " + json.dumps(out), flush=True)

    # where an NMFD β=1 iteration spends its device time
    m, V, iters = cs.deconv_model("NMFD", models), cs.deconv_target("NMFD"), 5
    m.fit(V, beta=1, tol=0, max_iter=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        m.fit(V, beta=1, tol=0, max_iter=iters)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / iters
    kernels = sorted(((e.device_time_total / iters / 1e3, e.key[:90])
                      for e in p.key_averages() if e.device_time_total > 0),
                     reverse=True)
    print("PROFILE " + json.dumps({
        "tree": label, "wall_ms_per_iter": wall,
        "device_ms_per_iter": sum(k[0] for k in kernels),
        "top": [[name, ms] for ms, name in kernels[:10]]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
