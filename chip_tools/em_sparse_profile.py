"""Where the PLCA EM and the sparse-fit iterations spend their time on the
card.

    python chip_tools/em_sparse_profile.py [ell]  # from the root of the repo

Prints one line ``PROFILE {json}`` per case: per iteration, the
profiler's device time by kernel (the twelve largest), their sum, and the
event-timed wall time of the same iterations (10 iterations of ``fit`` at
``tol=0``, the cadence loss included), for

* the SIPLCA flagship EM (1×513×3000, R=64, T=200);
* dense PLCA at 5168×1025 R=88, the generic and the fused E-step;
* sparse NMF at β=1, 8192² with 671k non-zeros and 131072×65536 at 0.1%
  (R=64), on the ELL and the gather tier;

then one line ``ELL {json}``: ``ell_neg_grad`` of each side of the
131072×65536 target timed alone (ms, CUDA events) as written (rows
gathered by advanced indexing) and in three other forms of the same sums:
the rows gathered by ``index_select`` (``index_select``), and the
reconstruction at the non-zeros and the numerator as elementwise products
and sums (``mul``) or as ``einsum``; and the
gather of the other factor's rows alone, by advanced indexing, by
``index_select`` and by ``F.embedding``.  With the argument ``ell`` only
this last line is printed.  Needs one CUDA device.
"""

import json
import os
import sys


def main(only_ell=False):
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch.constants import eps
    from pytorch_nmf_tpu_torch.ops import sparse as S
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all()
    card = cs.card_line()

    def profiled(tag, fit, iters=10):
        fit(2)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            start.record()
            fit(iters)
            end.record()
            torch.cuda.synchronize()
        kernels = sorted(((e.device_time_total / iters / 1e3, e.key[:80])
                          for e in p.key_averages() if e.device_time_total > 0),
                         reverse=True)
        print("PROFILE " + json.dumps({
            "case": tag, "card": card,
            "wall_ms_per_iter": start.elapsed_time(end) / iters,
            "device_ms_per_iter": sum(k[0] for k in kernels),
            "top": [[name, ms] for ms, name in kernels[:12]]}), flush=True)

    if not only_ell:
        profile_fits(cs, profiled, np, torch, plca_from_numpy, nmf_from_numpy)
    ell_forms(cs, np, torch, S, eps, card)


def profile_fits(cs, profiled, np, torch, plca_from_numpy, nmf_from_numpy):
    # the SIPLCA flagship
    N, C, S_out, kernel, R = cs.SIPLCA_ROWS["SIPLCA"]
    pr = cs.plca_problem(N, C, S_out, kernel, R)
    V = torch.from_numpy(pr["V"]).cuda()
    m = plca_from_numpy(pr, "cuda")
    profiled("siplca_513x3000_r64_k200", lambda n: m.fit(V, tol=0, max_iter=n))

    # dense PLCA, both E-steps
    M, K, R = cs.MAIN_SHAPE
    rs = np.random.RandomState(cs.SEED)
    pr = {"V": rs.rand(M, K).astype("f"), "W": rs.rand(K, R).astype("f"),
          "H": rs.rand(M, R).astype("f"), "Z": np.full(R, 1.0 / R, "f")}
    V = torch.from_numpy(pr["V"]).cuda()
    for fused in ("0", "1"):
        os.environ["PNT_PLCA_FUSED"] = fused
        m = plca_from_numpy(pr, "cuda")
        profiled(f"plca_{M}x{K}_r{R}_fused{fused}",
                 lambda n: m.fit(V, tol=0, max_iter=n))
    os.environ.pop("PNT_PLCA_FUSED")

    # the sparse tiers at β=1
    rs = np.random.RandomState(cs.SEED)
    M, K, R, nnz = cs.SPARSE_ELL_CASE
    cases = [(f"{M}x{K}_{nnz}nnz", cs.random_coo(M, K, nnz, rs), K, M, R)]
    M, K, R, density = cs.SPARSE_BIG
    cases.append((f"{M}x{K}_0.1pct", cs.random_coo(M, K, int(round(density * M * K)), rs),
                  K, M, R))
    for tag, Vs, K, M, R in cases:
        inits = {"W": rs.rand(K, R).astype("f") + 0.1,
                 "H": rs.rand(M, R).astype("f") + 0.1}
        for tier in ("ell", "gather"):
            cs.set_tier(tier)
            m = nmf_from_numpy(inits, "cuda")
            profiled(f"sparse_{tag}_r{R}_beta1_{tier}",
                     lambda n: m.fit(Vs, beta=1, tol=0, max_iter=n))
    cs.set_tier(None)


def ell_forms(cs, np, torch, S, eps, card):
    """``ell_neg_grad`` alone in four forms of the same sums, and the
    gather alone in three, at 131072×65536."""
    M, K, R, density = cs.SPARSE_BIG
    Vs = cs.random_coo(M, K, int(round(density * M * K)),
                       np.random.RandomState(cs.SEED))
    ell = S.maybe_ell(Vs)
    W = torch.rand(K, R, device="cuda") + 0.1
    H = torch.rand(M, R, device="cuda") + 0.1

    def mul(idx, val, self_f, other_f):
        oth = other_f[idx]
        wh = (oth * self_f[:, None, :]).sum(-1)
        return ((val / (wh + eps))[..., None] * oth).sum(1)

    def ein(idx, val, self_f, other_f):
        oth = other_f[idx]
        wh = torch.einsum("blr,br->bl", oth, self_f)
        return torch.einsum("bl,blr->br", val / (wh + eps), oth)

    def sel(idx, val, self_f, other_f):
        oth = other_f.index_select(0, idx.reshape(-1)).view(*idx.shape, -1)
        wh = torch.bmm(oth, self_f[:, :, None])[..., 0]
        return torch.bmm((val / (wh + eps))[:, None, :], oth)[:, 0]

    out = {"card": card}
    sides = {"rows": (ell.row_idx, ell.row_val, H, W),
             "cols": (ell.col_idx, ell.col_val, W, H)}
    for side, args in sides.items():
        ref = S.ell_neg_grad(*args, 1.0)
        for name, fn in (("as written", lambda *a: S.ell_neg_grad(*a, 1.0)),
                         ("index_select", sel), ("mul", mul),
                         ("einsum", ein)):
            got = fn(*args)
            err = float((got - ref).abs().max() / ref.abs().max())
            out[f"{side} {name}"] = [cs.cuda_ms(lambda: fn(*args), reps=5,
                                                warmup=1), err]
        idx, other_f = args[0], args[3]
        flat = idx.reshape(-1)
        for name, fn in (
                ("indexing", lambda: other_f[idx]),
                ("index_select", lambda: other_f.index_select(0, flat)),
                ("embedding", lambda: torch.nn.functional.embedding(idx, other_f))):
            out[f"{side} gather alone, {name}"] = cs.cuda_ms(fn, reps=5, warmup=1)
    print("ELL " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] == ["ell"])
