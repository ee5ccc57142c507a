#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width, each in phases:

* dense ``NMF.fit`` at the reference benchmark's size (V 5168×1025, rank
  88), on the kernels B1/B2 of ``csrc/fused_mu.cu``;
* the deconvolutional fits ``NMFD.fit`` at the JAX bench's flagship
  (V 1×1025×5000, rank 88, T=400: the reference's librosa example), and
  ``NMF2D.fit`` (1×512×64×64, rank 128, kernel 8×8) and ``NMF3D.fit``
  (1×64×19³, rank 16, kernel 4³) at the bench's rows, on the kernels B3/B4
  (``hgrad``/``wgrad``) of ``csrc/fused_deconv.cu``;
* the PLCA family's EM: ``SIPLCA.fit`` at the bench's row (V 1×513×3000,
  rank 64, T=200), ``SIPLCA2.fit`` (1×64×64×64, rank 16, 8×8) and
  ``SIPLCA3.fit`` (1×64×19³, rank 16, 4³), whose E-step runs B3/B4 as the
  adjoints of the reconstruction; dense ``PLCA.fit`` at 5168×1025 rank 88
  through the generic E-step and the opt-in fused one on B1;
* sparse targets through ``NMF.fit``: the top 2% of 5168×1025 (rank 88;
  the densify tier, on B1 at β ≠ 2), 8192² with 671k non-zeros (rank 64,
  each tier forced), and 131072×65536 at 0.1% (rank 64), past the densify
  budget, where the ELL tier is chosen.

1. prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``pytorch_nmf_tpu_torch/csrc``, one ``nvcc`` per source, in parallel;
2. holds each kernel against its plain PyTorch version on the card: B1/B2
   at 5168×1025 R=88 and 4096×4096 R=256 (rtol 1e-4), B3/B4 at the NMFD
   flagship, its rank-8 row, N=2, and the NMF2D/NMF3D rows
   (``max|kernel - plain| ≤ 1e-4·max|plain|``); and the SIPLCA E-step's
   dH, dW and dZ through the kernels against the plain twin at the SIPLCA
   row, its rank-8 row, N=2, and the SIPLCA2/SIPLCA3 rows (same bound);
   every summand is non-negative, so the only error is summation order;
3. fits V with β ∈ {2, 1, 0, 0.5, 1.5} through ``NMF.fit``, and with β ∈ {1,
   2, 0.5} through ``NMFD.fit`` plus β=1 through ``NMF2D.fit`` and
   ``NMF3D.fit``; fits the SIPLCA family for 20 EM iterations (one B3 and
   one B4 launch each), dense PLCA both ways, and the sparse targets;
   checks the factors and that each path's kernels carried its fits (launch
   counts set to 0 before a path, read after it); then fits through the
   kernels and through the plain versions (dense and NMFD at β = 1 and 0.5,
   NMF2D and NMF3D at β = 1, the SIPLCA family; 100 dense, 20 deconv and EM
   iterations) and compares the final losses (1e-4 relative), as it does the
   sparse tiers' and the two PLCA E-steps';
4. times those fits per iteration and each kernel against its plain
   version and, for B3/B4, the one PyTorch call that computes the same
   function (``F.convNd`` and ``torch.nn.grad.convNd_weight``, cuDNN; the
   port never calls them), with CUDA events; each kernel's bound is the
   larger of its operations at the 3xTF32 rate and its bytes at the HBM
   rate (B4 also for the neg/pos pair: twice the operations); and splits one
   SIPLCA EM iteration's device time (``torch.profiler``) into the
   reconstruction, B3, B4 and the rest.

Any failure raises (exit code ≠ 0).  The second-to-last line of standard
output is a JSON summary of the kernels (``launches`` summed over the
paths, ``launches_by_path`` per path) and the fit times, the last line
``{"ok": true, "device": {...}}``.  Float32 matrix products and
convolutions run in full float32 (TF32 off), so the plain versions and the
library calls are true f32 too.  Needs one CUDA device; exits with an error
without one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
MAIN_SHAPE = (5168, 1025, 88)  # the reference benchmark (torchnmf's BASELINE)
WIDE_SHAPE = (4096, 4096, 256)
RTOL = 1e-4
BETAS = (2, 1, 0, 0.5, 1.5)
# the deconv models at full width, (N, C, S_out, kernel, R), from bench.py
DECONV = {
    "NMFD": (1, 1025, (5000,), (400,), 88),           # bench.py:115-126
    "NMF2D": (1, 512, (64, 64), (8, 8), 128),          # bench.py:145
    "NMF3D": (1, 64, (19, 19, 19), (4, 4, 4), 16),     # bench.py:153
}
DECONV_BETAS = (1, 2, 0.5)
DECONV_ITERS = 20
# the PLCA family at full width, (N, C, S_out, kernel, R), from bench.py
SIPLCA_ROWS = {
    "SIPLCA": (1, 513, (3000,), (200,), 64),           # bench.py:157
    "SIPLCA R=8": (1, 513, (3000,), (200,), 8),         # bench.py:157
    "SIPLCA N=2": (2, 513, (3000,), (200,), 64),
    "SIPLCA2": (1, 64, (64, 64), (8, 8), 16),           # bench.py:161
    "SIPLCA3": (1, 64, (19, 19, 19), (4, 4, 4), 16),    # the NMF3D row, bench.py:153
}
EM_ITERS = 20
PLCA_ITERS = 50  # dense PLCA at MAIN_SHAPE (bench.py:821-853)
# sparse targets: top 2% of MAIN_SHAPE (bench.py:535-540); (M, K, R, nnz)
# (bench.py:112); past the densify budget, (M, K, R, density)
SPARSE_ELL_CASE = (8192, 8192, 64, 671_000)
SPARSE_BIG = (131072, 65536, 64, 0.001)
SPARSE_ITERS = 20
SPARSE_BIG_ITERS = 10
SPARSE_ENV = ("PNT_SPARSE_DENSIFY", "PNT_SPARSE_ELL")
# the H100 SXM's published peaks: f32-accurate products run at
# 3xTF32 on the tensor cores, 495/3 TFLOP/s, against 67 of f32 FMA on the
# CUDA cores; HBM moves 3.35 TB/s
TF32X3_FLOPS = 495e12 / 3
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
REPLACES = {
    "fused_contractions": "pytorch_nmf_tpu/ops/pallas_mu.py:212",
    "fused_beta_loss": "pytorch_nmf_tpu/ops/pallas_mu.py:347",
    "hgrad": "pytorch_nmf_tpu/ops/pallas_deconv.py:392",
    "wgrad": "pytorch_nmf_tpu/ops/pallas_deconv.py:504",
}
SOURCES = {
    "fused_contractions": "pytorch_nmf_tpu_torch/csrc/fused_mu.cu",
    "fused_beta_loss": "pytorch_nmf_tpu_torch/csrc/fused_mu.cu",
    "hgrad": "pytorch_nmf_tpu_torch/csrc/fused_deconv.cu",
    "wgrad": "pytorch_nmf_tpu_torch/csrc/fused_deconv.cu",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    """``(bound_ms, bound_by, cuda_core_ms)``: the least time the card could
    take for ``flops`` f32-accurate operations and ``nbytes`` of traffic
    (each input read once, each output written once), and the operations'
    time at the CUDA cores' f32 peak."""
    ops_ms, bytes_ms = 1e3 * flops / TF32X3_FLOPS, 1e3 * nbytes / HBM_BYTES
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", 1e3 * flops / FP32_FLOPS)


def new_stats():
    return {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": None,
            "plain_ms": None, "library_ms": None, "bound_ms": None,
            "bound_by": None}


def inputs(M, K, R, seed=SEED):
    rs = np.random.RandomState(seed)
    V = np.abs(rs.randn(M, K)).astype("f") + 0.01
    W = np.abs(rs.randn(K, R)).astype("f")
    H = np.abs(rs.randn(M, R)).astype("f")
    return (torch.from_numpy(x).cuda() for x in (V, W, H))


def compare_kernels(fm, kl_pos_W, kl_pos_H):
    """Phase 2: each dense kernel against its plain version; returns
    per-kernel errors, times and bounds (:func:`new_stats`) and prints
    every case.  Neither kernel has a library call that computes its
    function (each is two GEMMs around an elementwise map)."""
    stats = {name: new_stats()
             for name in ("fused_contractions", "fused_beta_loss")}

    def record(name, got, ref):
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.is_cuda, f"{name}: bad output")
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-30)).max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=0)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], float(err.max()))
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        return rel

    def set_times(name, ms, pms, flops, nbytes):
        b_ms, b_by, fp32_ms = bound(flops, nbytes)
        stats[name].update(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
        print(f"{name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {fp32_ms:.4f} at the CUDA cores' "
              f"f32 peak), {100 * b_ms / ms:.1f}% of it", flush=True)

    for M, K, R in (MAIN_SHAPE, WIDE_SHAPE):
        V, W, H = inputs(M, K, R)
        # rows padded to 16 bytes, as the fit does once per fit (fast_nmf)
        V = fm.aligned_rows(V)
        for w_side in (True, False):
            cases = [(b, True, None) for b in (0.0, 0.5, 1.5)] + [
                (1.0, False, None),
                (1.0, False, kl_pos_W(H) if w_side else kl_pos_H(W)),
            ]
            for beta, need_pos, mu_pos in cases:
                kw = dict(beta=beta, need_pos=need_pos, w_side=w_side,
                          mu_pos=mu_pos)
                got = fm.fused_contractions(V, H, W, **kw)
                ref = fm.plain_contractions(V, H, W, **kw)
                rels = [record("fused_contractions", g, r)
                        for g, r in zip(got, ref) if r is not None]
                side = "W" if w_side else "H"
                case = "epilogue" if mu_pos is not None else (
                    "neg+pos" if need_pos else "neg")
                line = (f"B1 {M}x{K} R={R} {side}-side beta={beta} {case}: "
                        f"max rel err {max(rels):.3g}")
                ms = cuda_ms(lambda: fm.fused_contractions(V, H, W, **kw))
                pms = cuda_ms(lambda: fm.plain_contractions(V, H, W, **kw))
                line += f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
                print(line, flush=True)
        for beta in (0.0, 0.5, 1.5):
            rel = record("fused_beta_loss", fm.fused_beta_loss(V, H, W, beta),
                         fm.plain_beta_loss(V, H, W, beta))
            line = f"B2 {M}x{K} R={R} beta={beta}: rel err {rel:.3g}"
            if (M, K, R) == MAIN_SHAPE:
                ms = cuda_ms(lambda: fm.fused_beta_loss(V, H, W, beta))
                pms = cuda_ms(lambda: fm.plain_beta_loss(V, H, W, beta))
                line += f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
                if beta == 0.5:  # the WH product; V, H, W read once
                    set_times("fused_beta_loss", ms, pms, 2 * M * K * R,
                              4 * (M * K + (M + K) * R + 1))
            print(line, flush=True)
        if (M, K, R) == MAIN_SHAPE:
            # the JSON's B1 time: one β=0.5 MU iteration's contractions
            # (W side then H side, numerator and denominator); per side the
            # WH product and two contractions, V, H, W read and two
            # factor-sized outputs written
            def both(fn):
                fn(V, H, W, beta=0.5, need_pos=True, w_side=True)
                fn(V, H, W, beta=0.5, need_pos=True, w_side=False)

            set_times("fused_contractions",
                      cuda_ms(lambda: both(fm.fused_contractions)),
                      cuda_ms(lambda: both(fm.plain_contractions)),
                      2 * 6 * M * K * R,
                      2 * 4 * (M * K + (M + K) * R) + 2 * 4 * 2 * (M + K) * R)
        del V, W, H
    return stats


def deconv_operands(F, N, C, S_out, kernel, R, seed=SEED):
    """One hgrad/wgrad call of the engine at this size, on the card: the
    flat kernel, the flat (or N > 1 stacked) activation and two channels-last
    cotangents of random positive values."""
    rs = np.random.RandomState(seed)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    H = torch.from_numpy(rs.rand(N, R, *S_in).astype("f")).cuda()
    W = torch.from_numpy(rs.rand(C, R, *kernel).astype("f")).cuda()
    cots = cots_m = [
        torch.from_numpy(rs.rand(N, int(np.prod(S_out)), C).astype("f")).cuda()
        for _ in range(2)]
    _, geom, T_geo, L_flat = F._flat_geom((N, C) + tuple(S_out), H.shape)
    if N > 1:
        seg = T_geo - 1 + L_flat
        H2, lead, L_h = F._h_stacked(H, kernel, T_geo), False, N * seg
        cots = [F._cot_stacked(c, seg) for c in cots]
    else:
        H2, lead, L_h = F._h_flat_nd(H, kernel), True, L_flat
        cots = [c[0] for c in cots]
    # the model layouts, for the library calls: cotangents (N, C, *S_out)
    cot_m = cots_m[0].reshape((N,) + tuple(S_out) + (C,)).movedim(-1, 1)
    return dict(H=H, W=W, W2=F._w2(W), H2=H2, cots=cots, R=R, geom=geom,
                T=T_geo, L_h=L_h, lead=lead, cot_m=cot_m.contiguous())


def compare_deconv_kernels(F, D, kl_pos_W):
    """Phase 2, B3/B4: each against its plain version at the deconv path's
    shapes, and timed there beside its plain version and its library call
    (cuDNN, TF32 off; the port never calls these): B3 is the correlation
    ``F.convNd(cot, Wᵀ)``, B4 with one cotangent the weight gradient
    ``torch.nn.grad.convNd_weight(H, W.shape, cot, padding=k-1)`` of the
    reconstruction (its kernel flipped).  Returns per-kernel errors, times
    and bounds at the NMFD flagship (:func:`new_stats`)."""
    stats = {name: new_stats() for name in ("hgrad", "wgrad")}

    def record(name, case, got, ref):
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.is_cuda, f"{name} {case}: bad output")
        check(bool(torch.isfinite(got).all()), f"{name} {case}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= RTOL, f"{name} {case}: max|kernel-plain| / max|plain| = {rel:.3g}")
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        return rel

    N, C, S_out, kernel, R = DECONV["NMFD"]
    cases = [
        ("NMFD", DECONV["NMFD"]),
        ("NMFD R=8", (N, C, S_out, kernel, 8)),  # bench.py:116
        ("NMFD N=2", (2, C, S_out, kernel, R)),
        ("NMF2D", DECONV["NMF2D"]),
        ("NMF3D", DECONV["NMF3D"]),
    ]
    for label, shape in cases:
        op = deconv_operands(F, *shape)
        R_, T, geom, lead = op["R"], op["T"], op["geom"], op["lead"]
        cot, pair, W2, H2 = op["cots"][0], op["cots"], op["W2"], op["H2"]
        kw = dict(lead_pad=lead, geom=geom)
        epi = dict(kw, mu_w2=W2, mu_pos=kl_pos_W(op["H"]).reshape(-1))
        calls = {
            "hgrad": lambda fn: fn(cot, W2, R_, op["L_h"], geom=geom),
            "wgrad beta=1 neg": lambda fn: fn([cot], H2, R_, T, **kw)[0],
            "wgrad beta=1 epilogue": lambda fn: fn([cot], H2, R_, T, **epi)[0],
            "wgrad beta=0.5 neg+pos": lambda fn: fn(pair, H2, R_, T, **kw),
        }
        nd = len(shape[3])
        pad = tuple(k - 1 for k in shape[3])
        conv = getattr(torch.nn.functional, f"conv{nd}d")
        conv_weight = getattr(torch.nn.grad, f"conv{nd}d_weight")
        Wt = op["W"].transpose(0, 1)
        H_m, W_shape, cot_m = op["H"], op["W"].shape, op["cot_m"]
        library = {
            "hgrad": lambda: conv(cot_m, Wt),
            "wgrad beta=1 neg": lambda: conv_weight(H_m, W_shape, cot_m,
                                                    padding=pad),
        }
        Lp, C_ = cot.shape
        K = W2.shape[0] // R_
        wgrad_work = (2 * K * R_ * C_ * Lp,
                      4 * (op["L_h"] * R_ + Lp * C_ + K * R_ * C_))
        work = {  # (operations, bytes) of one call
            "hgrad": (2 * R_ * op["L_h"] * K * C_,
                      4 * (Lp * C_ + K * R_ * C_ + R_ * op["L_h"])),
            "wgrad beta=1 neg": wgrad_work,
            # the pair: twice the operations, two cotangents in, two out
            "wgrad beta=0.5 neg+pos": (2 * wgrad_work[0], 4 * (
                op["L_h"] * R_ + 2 * Lp * C_ + 2 * K * R_ * C_)),
        }
        for case, call in calls.items():
            name = case.split()[0]
            fn, plain = getattr(D, name), getattr(D, f"plain_{name}")
            got, ref = call(fn), call(plain)
            if not isinstance(got, list):
                got, ref = [got], [ref]
            rel = max(record(name, f"{label} {case}", g, r)
                      for g, r in zip(got, ref))
            line = f"B{3 if name == 'hgrad' else 4} {label} {case}: max rel err {rel:.3g}"
            timed = label == "NMFD" or case in library
            if timed:
                ms = cuda_ms(lambda: call(fn), reps=10, warmup=1)
                pms = cuda_ms(lambda: call(plain), reps=10, warmup=1)
                line += f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
            if case in library:
                lms = cuda_ms(library[case], reps=10, warmup=1)
                line += f", library {lms:.4f} ms"
            if timed and case in work:
                b_ms, b_by, fp32_ms = bound(*work[case])
                line += (f", bound {b_ms:.4f} ms ({b_by}; {fp32_ms:.4f} at "
                         f"the CUDA cores' f32 peak), {100 * b_ms / ms:.1f}% "
                         "of it")
            if case in library and label == "NMFD":
                stats[name].update(ms=ms, plain_ms=pms, library_ms=lms,
                                   bound_ms=b_ms, bound_by=b_by)
            print(line, flush=True)
    return stats


def deconv_model(name, models):
    N, C, S_out, kernel, R = DECONV[name]
    kw = {"T": kernel[0]} if name == "NMFD" else {"kernel_size": kernel}
    return getattr(models, name)((N, C) + S_out, R, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED),
                        **kw)


def deconv_target(name):
    N, C, S_out, _, _ = DECONV[name]
    rs = np.random.RandomState(SEED)
    return torch.from_numpy(np.abs(rs.randn(N, C, *S_out)).astype("f")
                            + 0.01).cuda()


def deconv_fits(models, beta_div, fm, D, card):
    """Phase 3, the deconv path: every fit on the kernels B3/B4 and none
    on B1/B2.  Returns the launch counts of the path's run."""
    for fn in (fm.fused_contractions, fm.fused_beta_loss, D.hgrad, D.wgrad):
        fn.launches = 0
    runs = [("NMFD", b) for b in DECONV_BETAS] + [("NMF2D", 1), ("NMF3D", 1)]
    for name, beta in runs:
        V = deconv_target(name)
        m = deconv_model(name, models)
        before = float(beta_div(m().detach(), V, beta))
        n_b3, n_b4 = D.hgrad.launches, D.wgrad.launches
        t0 = time.perf_counter()
        n_iter = m.fit(V, beta=beta, tol=0, max_iter=DECONV_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = float(beta_div(m().detach(), V, beta))
        d_b3, d_b4 = D.hgrad.launches - n_b3, D.wgrad.launches - n_b4
        tag = f"{name} beta={beta}"
        check(m.W.is_cuda and m.H.is_cuda, f"{tag}: factors left the card")
        for p in (m.W, m.H):
            check(bool(torch.isfinite(p).all()), f"{tag}: non-finite factor")
            check(bool((p >= 0).all()), f"{tag}: negative factor")
        check(after < before, f"{tag}: loss {before} -> {after} did not fall")
        check(d_b3 > 0 and d_b4 > 0, f"{tag}: {d_b3} B3 and {d_b4} B4 launches")
        print(f"phase 3: {tag} n_iter={n_iter} loss {before:.6g} -> "
              f"{after:.6g} in {secs:.2f} s; launches B3 {d_b3}, B4 {d_b4} "
              f"[{card}]", flush=True)
        del V, m
    launches = {"fused_contractions": fm.fused_contractions.launches,
                "fused_beta_loss": fm.fused_beta_loss.launches,
                "hgrad": D.hgrad.launches, "wgrad": D.wgrad.launches}
    check(launches["fused_contractions"] == launches["fused_beta_loss"] == 0,
          f"the deconv fits launched B1/B2: {launches}")
    return launches


def time_fits(run_kernel, run_plain, loss_of, iters, tag):
    """Phases 3 and 4: the kernel path against the plain path, each run
    (``run_*() -> factors``) from the same inits, timed in turns (plain,
    kernel, kernel, plain) after a warm-up of each; the final losses
    (``loss_of(*factors)``) must agree within 1e-4 relative.  Returns the
    ms/iteration of each run."""
    run_kernel(), run_plain()  # warm-up
    times = {"kernel": [], "plain": []}
    finals = {}
    for path, fn in (("plain", run_plain), ("kernel", run_kernel),
                     ("kernel", run_kernel), ("plain", run_plain)):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        factors = fn()
        end.record()
        torch.cuda.synchronize()
        times[path].append(start.elapsed_time(end) / iters)
        finals[path] = loss_of(*factors)
    rel = abs(finals["kernel"] - finals["plain"]) / abs(finals["plain"])
    check(rel <= 1e-4, f"{tag}: kernel loss {finals['kernel']} vs "
          f"plain {finals['plain']} (rel {rel:.3g})")
    print(f"phase 3: {tag} {iters} iterations, final loss kernel "
          f"{finals['kernel']:.7g} plain {finals['plain']:.7g} "
          f"(rel {rel:.3g})", flush=True)
    return times


def nmf_runs(m, V, fit_kw, plain_fit):
    """``(run_kernel, run_plain)`` for :func:`time_fits`: ``m.fit`` from
    the model's current factors, and ``plain_fit(V, W, H)`` from the same."""
    W0, H0 = m.W.detach().clone(), m.H.detach().clone()

    def run_kernel():
        m.W.data.copy_(W0)
        m.H.data.copy_(H0)
        m.fit(V, **fit_kw)
        return m.W.detach(), m.H.detach()

    def run_plain():
        W, H, _ = plain_fit(V, W0.clone(), H0.clone())
        return W, H

    return run_kernel, run_plain


def counters(fm, D):
    """The four kernel wrappers, whose ``launches`` count their launches."""
    return {"fused_contractions": fm.fused_contractions,
            "fused_beta_loss": fm.fused_beta_loss,
            "hgrad": D.hgrad, "wgrad": D.wgrad}


def zero(ctr):
    for fn in ctr.values():
        fn.launches = 0


def read(ctr):
    return {name: fn.launches for name, fn in ctr.items()}


def plca_problem(N, C, S_out, kernel, R, seed=SEED):
    """A SIPLCA-family target and inits (numpy ``rand``, uniform Z)."""
    rs = np.random.RandomState(seed)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    return {"V": rs.rand(N, C, *S_out).astype("f"),
            "W": rs.rand(C, R, *kernel).astype("f"),
            "H": rs.rand(N, R, *S_in).astype("f"),
            "Z": np.full(R, 1.0 / R, "f")}


def em_adjoints(recon3, V, W, H, Z, eps):
    """The EM E-step's three gradients: one backward pass of ``recon3``
    with cotangent ``Vn / (WZH + eps)``, on fresh leaves."""
    Vn = V / V.sum()
    leaves = [x.detach().clone().requires_grad_(True) for x in (H, W, Z)]
    WZH = recon3(*leaves)
    return torch.autograd.grad(WZH, leaves, Vn / (WZH.detach() + eps))


def siplca_recon3(F, recon, nd, kernels):
    """``recon3(H, W, Z)``: the kernel-adjoint deconvolution
    (``kernels="kernel"``) or its plain twin of the scaled kernel."""
    deconv = F.kernel_adjoint_deconv if kernels == "kernel" else F.plain_adjoint_deconv
    return lambda H, W, Z: deconv(H, recon.scaled_kernel(W, Z, nd))


def compare_em_adjoints(F, recon, plca_from_numpy, eps, card):
    """Phase 2, the SIPLCA family: the E-step's dH, dW and dZ through the
    kernel Function (B3/B4) against its plain twin at the bench rows,
    ``max|kernel - plain| ≤ 1e-4·max|plain|``, Dirichlet priors off; the
    flagship's E-step timed both ways."""
    for label, (N, C, S_out, kernel, R) in SIPLCA_ROWS.items():
        pr = plca_problem(N, C, S_out, kernel, R)
        m = plca_from_numpy(pr, "cuda")  # normalizes W, H, Z
        V = torch.from_numpy(pr["V"]).cuda()
        args = (V, m.W, m.H, m.Z, eps)
        nd = len(kernel)
        kern = siplca_recon3(F, recon, nd, "kernel")
        plain = siplca_recon3(F, recon, nd, "plain")
        got, ref = em_adjoints(kern, *args), em_adjoints(plain, *args)
        torch.cuda.synchronize()
        rels = []
        for name, g, r in zip(("dH", "dW", "dZ"), got, ref):
            check(g.is_cuda and g.shape == r.shape, f"E-step {label} {name}: bad output")
            check(bool(torch.isfinite(g).all()), f"E-step {label} {name}: non-finite")
            rel = float((g - r).abs().max()) / float(r.abs().max())
            check(rel <= RTOL, f"E-step {label} {name}: max|kernel-plain| / "
                  f"max|plain| = {rel:.3g}")
            rels.append(rel)
        line = (f"E-step {label}: max|kernel-plain|/max|plain| dH {rels[0]:.3g}, "
                f"dW {rels[1]:.3g}, dZ {rels[2]:.3g}")
        if label == "SIPLCA":
            ms = cuda_ms(lambda: em_adjoints(kern, *args), reps=10, warmup=1)
            pms = cuda_ms(lambda: em_adjoints(plain, *args), reps=10, warmup=1)
            line += f"; E-step kernel {ms:.4f} ms, plain {pms:.4f} ms [{card}]"
        print(line, flush=True)
        del V, m, got, ref


def simplex_error(p):
    """max |Σ over the non-rank axes − 1| of a probability factor."""
    x = p.detach()
    axes = tuple(d for d in range(x.ndim) if d != 1) if x.ndim > 1 else (0,)
    return float((x.sum(dim=axes) - 1).abs().max())


def siplca_fits(F, recon, solver, plca_from_numpy, kl_div, ctr, card, fit_ms):
    """Phase 3, the SIPLCA path: SIPLCA/SIPLCA2/SIPLCA3.fit through the
    kernels, 20 EM iterations at ``tol=0``: one B3 and one B4 launch per
    iteration (counts set to 0 before the path, read after it), the loss
    falls, the factors stay finite, on the card and on the simplex; then the
    kernel fit against the plain twin's in turns (final losses within 1e-4
    relative) and a ``torch.profiler`` split of one flagship iteration.
    Returns the path's launch counts."""
    problems = {}
    zero(ctr)
    for name in ("SIPLCA", "SIPLCA2", "SIPLCA3"):
        N, C, S_out, kernel, R = SIPLCA_ROWS[name]
        pr = plca_problem(N, C, S_out, kernel, R)
        m = plca_from_numpy(pr, "cuda")
        V = torch.from_numpy(pr["V"]).cuda()
        plain3 = siplca_recon3(F, recon, len(kernel), "plain")
        norm = V.sum()

        def loss(W, H, Z, plain3=plain3, V=V, norm=norm):
            with torch.no_grad():
                return float(torch.sqrt(2.0 * kl_div(plain3(H, W, Z) * norm, V)))

        init = tuple(p.detach().clone() for p in (m.W, m.H, m.Z))
        before = loss(*init)
        n0 = read(ctr)
        t0 = time.perf_counter()
        n_iter, _ = m.fit(V, tol=0, max_iter=EM_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        d = {k: v - n0[k] for k, v in read(ctr).items()}
        after = loss(m.W, m.H, m.Z)
        check(n_iter == EM_ITERS - 1, f"{name}: n_iter {n_iter}")
        check(d["hgrad"] == d["wgrad"] == EM_ITERS,
              f"{name}: {d['hgrad']} B3 and {d['wgrad']} B4 launches in "
              f"{EM_ITERS} iterations")
        check(after < before, f"{name}: loss {before} -> {after} did not fall")
        for p in (m.W, m.H, m.Z):
            check(p.is_cuda and bool(torch.isfinite(p).all()),
                  f"{name}: a factor is non-finite or left the card")
            check(simplex_error(p) <= 1e-4, f"{name}: a factor left the simplex "
                  f"({simplex_error(p):.3g})")
        print(f"phase 3: {name} n_iter={n_iter} loss {before:.6g} -> {after:.6g} "
              f"in {secs:.2f} s; launches B3 {d['hgrad']}, B4 {d['wgrad']} "
              f"[{card}]", flush=True)
        problems[name] = (m, V, init, plain3, loss)
    launches = read(ctr)
    check(launches["fused_contractions"] == launches["fused_beta_loss"] == 0,
          f"the SIPLCA fits launched B1/B2: {launches}")

    for name, (m, V, init, plain3, loss) in problems.items():
        one = V.new_ones(())
        plain_fit = solver.get_plca_fit(plain3, 0.0, EM_ITERS, True, True, True,
                                        False, False, False)

        def run_kernel(m=m, V=V, init=init):
            for p, x in zip((m.W, m.H, m.Z), init):
                p.data.copy_(x)
            m.fit(V, tol=0, max_iter=EM_ITERS)
            return m.W.detach(), m.H.detach(), m.Z.detach()

        def run_plain(V=V, init=init, plain_fit=plain_fit):
            W, H, Z, _, _ = plain_fit(V, *(x.clone() for x in init), one, one, one)
            return W, H, Z

        times = time_fits(run_kernel, run_plain, loss, EM_ITERS, name)
        N, C, S_out, kernel, R = SIPLCA_ROWS[name]
        shape = "x".join(map(str, (C,) + S_out)) + f"_r{R}_k" + "x".join(
            map(str, kernel))
        fit_ms[f"{name.lower()}_{shape}"] = times
        print(f"phase 4: {name} EM ms/iteration at {shape}: kernel "
              f"{times['kernel']}, plain {times['plain']} [{card}]", flush=True)

    # where one flagship EM iteration spends its device time
    from torch.profiler import ProfilerActivity, profile

    m, V, init, _, _ = problems["SIPLCA"]
    recon3 = type(m)._recon3_resolver(V.device, V.dtype)
    Vn, one = V / V.sum(), V.new_ones(())

    def em():
        return solver._plca_em_iter(recon3, True, True, True, False, False,
                                    False, Vn, init, one, one, one)

    em()
    torch.cuda.synchronize()
    reps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        for _ in range(reps):
            em()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    split = {"reconstruction": 0.0, "B3": 0.0, "B4": 0.0, "B3/B4 split sums": 0.0,
             "rest": 0.0}
    for e in p.key_averages():
        ms = e.device_time_total / reps / 1e3
        key = e.key
        if ms <= 0:
            continue
        if "hgrad" in key:
            split["B3"] += ms
        elif "wgrad" in key:
            split["B4"] += ms
        elif "finish_kernel" in key:
            split["B3/B4 split sums"] += ms
        elif any(s in key.lower() for s in ("gemm", "xmma", "catarraybatchedcopy")):
            split["reconstruction"] += ms
        else:
            split["rest"] += ms
    total = sum(split.values())
    print("phase 4: SIPLCA flagship, one EM iteration's device time (ms; "
          "torch.profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; device {total:.4f}, wall {wall:.4f} [{card}]", flush=True)
    fit_ms["siplca_profile_ms"] = dict(split, device=total, wall=wall)
    return launches


def plca_fits(plca_from_numpy, kl_div, ctr, card, fit_ms):
    """Phase 3, dense PLCA at MAIN_SHAPE: the generic E-step against the
    opt-in fused one (``PNT_PLCA_FUSED=1``, two B1 launches an iteration and
    none without it); final losses within 1e-4 relative, both timed.
    Returns the fused path's launch counts."""
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    pr = {"V": rs.rand(M, K).astype("f"), "W": rs.rand(K, R).astype("f"),
          "H": rs.rand(M, R).astype("f"), "Z": np.full(R, 1.0 / R, "f")}
    V = torch.from_numpy(pr["V"]).cuda()
    m = plca_from_numpy(pr, "cuda")
    init = tuple(p.detach().clone() for p in (m.W, m.H, m.Z))
    norm = V.sum()

    def loss(W, H, Z):
        with torch.no_grad():
            return float(torch.sqrt(2.0 * kl_div(type(m).reconstruct(H, W, Z) * norm, V)))

    def run(fused):
        os.environ["PNT_PLCA_FUSED"] = "1" if fused else "0"
        try:
            for p, x in zip((m.W, m.H, m.Z), init):
                p.data.copy_(x)
            m.fit(V, tol=0, max_iter=PLCA_ITERS)
        finally:
            os.environ.pop("PNT_PLCA_FUSED")
        return m.W.detach().clone(), m.H.detach().clone(), m.Z.detach().clone()

    before = loss(*init)
    zero(ctr)
    factors = run(False)
    check(read(ctr)["fused_contractions"] == 0, "the generic E-step launched B1")
    check(loss(*factors) < before, "dense PLCA (generic): the loss did not fall")
    zero(ctr)
    factors = run(True)
    launches = read(ctr)
    check(launches["fused_contractions"] == 2 * PLCA_ITERS,
          f"fused E-step: {launches['fused_contractions']} B1 launches in "
          f"{PLCA_ITERS} iterations")
    check(loss(*factors) < before, "dense PLCA (fused): the loss did not fall")
    print(f"phase 3: PLCA {M}x{K} R={R} fused E-step: B1 {launches['fused_contractions']}"
          f" launches in {PLCA_ITERS} iterations", flush=True)
    times = time_fits(lambda: run(True), lambda: run(False), loss, PLCA_ITERS,
                      f"PLCA {M}x{K} R={R} (kernel: fused E-step, plain: generic)")
    fit_ms[f"plca_{M}x{K}_r{R}"] = {"fused": times["kernel"],
                                    "generic": times["plain"]}
    print(f"phase 4: PLCA EM ms/iteration at {M}x{K} R={R}: fused E-step "
          f"{times['kernel']}, generic {times['plain']} [{card}]", flush=True)
    return launches


def split_loss(S, V, W, H, beta):
    """The sparse fit's loss ``sqrt(2·(V_norm + pos − neg))``."""
    with torch.no_grad():
        pos, neg = S.nmf_sp_pos_neg(V, H, W, beta)
        return float(torch.sqrt(2.0 * (S.get_V_norm(V, beta) + pos - neg)))


def set_tier(tier):
    for name in SPARSE_ENV:
        os.environ.pop(name, None)
    if tier == "densify":
        os.environ["PNT_SPARSE_DENSIFY"] = "1"
    elif tier == "ell":
        os.environ.update(PNT_SPARSE_DENSIFY="0", PNT_SPARSE_ELL="1")
    elif tier == "gather":
        os.environ.update(PNT_SPARSE_DENSIFY="0", PNT_SPARSE_ELL="0")


def timed_fit(m, V, beta, iters):
    """``(n_iter, ms/iteration)`` of one ``m.fit`` by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    n_iter = m.fit(V, beta=beta, tol=0, max_iter=iters)
    end.record()
    torch.cuda.synchronize()
    return n_iter, start.elapsed_time(end) / iters


def random_coo(M, K, nnz, rs):
    """``nnz`` distinct uniformly placed entries of ``rand + 0.01``, as a
    coalesced sparse tensor on the card (the bench's ``ell_row``)."""
    flat = np.unique(rs.randint(0, M * K, int(nnz * 1.1)).astype(np.int64))
    rs.shuffle(flat)
    flat = np.sort(flat[:nnz])
    idx = torch.from_numpy(np.stack([flat // K, flat % K])).cuda()
    vals = torch.from_numpy(rs.rand(len(flat)).astype("f") + 0.01).cuda()
    return torch.sparse_coo_tensor(idx, vals, (M, K), is_coalesced=True,
                                   check_invariants=False)


def sparse_fits(S, nmf_from_numpy, ctr, card, fit_ms):
    """Phase 3, sparse targets through ``NMF.fit``: top 2% of MAIN_SHAPE at
    β ∈ {1, 0.5, 2} (densify chosen, B1 at β ≠ 2, the loss falls; counts set
    to 0 before, read after); 8192² with 671k non-zeros at β ∈ {1, 1.5}
    forced through each tier (final losses within 1e-4 relative); 131072 ×
    65536 at 0.1% past the densify budget, where ELL is chosen and agrees
    with gather.  Returns the densify path's launch counts."""
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    Vd = rs.rand(M, K).astype("f")
    Vd = np.where(Vd > np.quantile(Vd, 0.98), Vd, 0).astype("f")
    V = S.sparse_from_dense(torch.from_numpy(Vd).cuda())
    inits = {"W": rs.rand(K, R).astype("f") + 0.1, "H": rs.rand(M, R).astype("f") + 0.1}
    set_tier(None)
    check(S.should_densify(V), f"{M}x{K} top 2% is not densified")
    zero(ctr)
    for beta in (1, 0.5, 2):
        m = nmf_from_numpy(inits, "cuda")
        before = split_loss(S, V, m.W, m.H, beta)
        n0 = read(ctr)
        n_iter, ms = timed_fit(m, V, beta, SPARSE_ITERS)
        d = {k: v - n0[k] for k, v in read(ctr).items()}
        after = split_loss(S, V, m.W, m.H, beta)
        check(after < before, f"sparse beta={beta}: loss {before} -> {after}")
        check((d["fused_contractions"] > 0) == (beta != 2) and
              d["fused_beta_loss"] == d["hgrad"] == d["wgrad"] == 0,
              f"sparse beta={beta}: launches {d}")
        check(m.W.is_cuda and bool(torch.isfinite(m.W).all() & torch.isfinite(m.H).all()),
              f"sparse beta={beta}: bad factors")
        fit_ms[f"sparse_{M}x{K}_r{R}_2pct_beta{beta}_densify"] = ms
        print(f"phase 3: sparse {M}x{K} R={R} top 2% ({V._nnz()} non-zeros) "
              f"beta={beta} densify: loss {before:.6g} -> {after:.6g}, B1 "
              f"{d['fused_contractions']}; {ms:.4f} ms/iteration [{card}]",
              flush=True)
    launches = read(ctr)
    del V

    M, K, R, nnz = SPARSE_ELL_CASE
    V = random_coo(M, K, nnz, rs)
    inits = {"W": rs.rand(K, R).astype("f") + 0.1, "H": rs.rand(M, R).astype("f") + 0.1}
    for beta in (1, 1.5):
        finals = {}
        for tier in ("densify", "ell", "gather"):
            set_tier(tier)
            nmf_from_numpy(inits, "cuda").fit(V, beta=beta, tol=0, max_iter=2)
            m = nmf_from_numpy(inits, "cuda")
            _, ms = timed_fit(m, V, beta, SPARSE_ITERS)
            finals[tier] = split_loss(S, V, m.W, m.H, beta)
            fit_ms[f"sparse_{M}x{K}_r{R}_{nnz}nnz_beta{beta}_{tier}"] = ms
            print(f"phase 4: sparse {M}x{K} R={R} {nnz} non-zeros beta={beta} "
                  f"{tier}: {ms:.4f} ms/iteration, final loss "
                  f"{finals[tier]:.7g} [{card}]", flush=True)
        spread = (max(finals.values()) - min(finals.values())) / min(finals.values())
        check(spread <= 1e-4, f"sparse {M}x{K} beta={beta}: tiers disagree {finals}")
        print(f"phase 3: sparse {M}x{K} beta={beta}: the three tiers agree "
              f"(spread {spread:.3g})", flush=True)
    set_tier(None)
    del V

    M, K, R, density = SPARSE_BIG
    V = random_coo(M, K, int(round(density * M * K)), rs)
    inits = {"W": rs.rand(K, R).astype("f") + 0.1, "H": rs.rand(M, R).astype("f") + 0.1}
    check(not S.should_densify(V), f"{M}x{K} would be densified")
    t0 = time.perf_counter()
    ell = S.maybe_ell(V)
    torch.cuda.synchronize()
    check(ell is not None, f"{M}x{K}: no ELL layout")
    print(f"phase 3: sparse {M}x{K} ({V._nnz()} non-zeros): not densified; ELL "
          f"built in {time.perf_counter() - t0:.2f} s, widths {ell.row_idx.shape[1]}"
          f" (rows) and {ell.col_idx.shape[1]} (columns), spills "
          f"{ell.row_rem[2].numel()} and {ell.col_rem[2].numel()} [{card}]",
          flush=True)
    calls = []
    ell_neg_grad = S.ell_neg_grad

    def counted(*args, **kwargs):
        calls.append(1)
        return ell_neg_grad(*args, **kwargs)

    finals = {}
    S.ell_neg_grad = counted
    try:
        for tier in ("ell", "gather"):
            set_tier(None if tier == "ell" else "gather")
            m = nmf_from_numpy(inits, "cuda")
            before = split_loss(S, V, m.W, m.H, 1)
            calls.clear()
            _, ms = timed_fit(m, V, 1, SPARSE_BIG_ITERS)
            check((len(calls) == 2 * SPARSE_BIG_ITERS) == (tier == "ell"),
                  f"{M}x{K} {tier}: {len(calls)} ELL reductions")
            finals[tier] = split_loss(S, V, m.W, m.H, 1)
            check(finals[tier] < before, f"{M}x{K} {tier}: the loss did not fall")
            fit_ms[f"sparse_{M}x{K}_r{R}_0.1pct_beta1_{tier}"] = ms
            print(f"phase 4: sparse {M}x{K} R={R} 0.1% beta=1 {tier}: {ms:.4f} "
                  f"ms/iteration, loss {before:.7g} -> {finals[tier]:.7g} [{card}]",
                  flush=True)
    finally:
        S.ell_neg_grad = ell_neg_grad
        set_tier(None)
    rel = abs(finals["ell"] - finals["gather"]) / finals["gather"]
    check(rel <= 1e-4, f"{M}x{K}: ELL and gather disagree {finals}")
    print(f"phase 3: sparse {M}x{K}: ELL and gather agree (rel {rel:.3g})",
          flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA GPU")
    from pytorch_nmf_tpu_torch import nmf as models
    from pytorch_nmf_tpu_torch.constants import eps
    from pytorch_nmf_tpu_torch.metrics import beta_div, kl_div
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops import recon, solver
    from pytorch_nmf_tpu_torch.ops import sparse as S
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_plain
    from pytorch_nmf_tpu_torch.ops.mu import kl_pos_H, kl_pos_W
    from pytorch_nmf_tpu_torch.ops.solver import get_dense_fit
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is still on")

    # phase 1: the card, the build
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    load_all()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # phase 2: kernels against their plain versions
    stats = compare_kernels(fm, kl_pos_W, kl_pos_H)
    stats.update(compare_deconv_kernels(F, D, kl_pos_W))
    compare_em_adjoints(F, recon, plca_from_numpy, eps, card)
    print("phase 2: kernels agree with their plain versions", flush=True)
    ctr = counters(fm, D)

    # phase 3: the main path, dense NMF.fit at full width
    M, K, R = MAIN_SHAPE
    V, _, _ = inputs(M, K, R)

    def model():
        return NMF((M, K), R, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(SEED))

    zero(ctr)
    for beta in BETAS:
        m = model()
        before = float(beta_div(m().detach(), V, beta))
        n_b1, n_b2 = fm.fused_contractions.launches, fm.fused_beta_loss.launches
        n_iter = m.fit(V, beta=beta, tol=1e-4, max_iter=200)
        torch.cuda.synchronize()
        after = float(beta_div(m().detach(), V, beta))
        d_b1 = fm.fused_contractions.launches - n_b1
        d_b2 = fm.fused_beta_loss.launches - n_b2
        check(m.W.is_cuda and m.H.is_cuda, f"beta={beta}: factors left the card")
        for p in (m.W, m.H):
            check(bool(torch.isfinite(p).all()), f"beta={beta}: non-finite factor")
            check(bool((p >= 0).all()), f"beta={beta}: negative factor")
        check(after < before, f"beta={beta}: loss {before} -> {after} did not fall")
        check((d_b1 > 0) == (beta != 2), f"beta={beta}: {d_b1} B1 launches")
        check((d_b2 > 0) == (beta not in (1, 2)), f"beta={beta}: {d_b2} B2 launches")
        print(f"phase 3: beta={beta} n_iter={n_iter} loss {before:.6g} -> "
              f"{after:.6g}; launches B1 {d_b1}, B2 {d_b2}", flush=True)
    by_path = {"nmf": read(ctr)}
    check(by_path["nmf"]["hgrad"] == by_path["nmf"]["wgrad"] == 0,
          "the dense fits launched B3/B4")

    # phases 3 and 4: kernel path against plain path, 100 iterations each,
    # timed in turns (plain, kernel, kernel, plain)
    fit_ms = {}
    for beta in (1, 0.5):
        plain_fit = get_dense_fit(NMF.reconstruct, float(beta), 0.0, 100, True,
                                  True, 0.0, 0.0, False, nmf_updater_factory_plain)
        times = time_fits(
            *nmf_runs(model(), V, dict(beta=beta, tol=0, max_iter=100), plain_fit),
            lambda W, H: float(beta_div(NMF.reconstruct(H, W), V, beta)),
            100, f"NMF beta={beta}")
        fit_ms[f"nmf_{M}x{K}_r{R}_beta{beta}"] = times
        print(f"phase 4: beta={beta} fit ms/iteration at {M}x{K} R={R}: "
              f"kernel {times['kernel']}, plain {times['plain']} [{card}]",
              flush=True)
    del V, m

    # phase 3, the deconv path: NMFD/NMF2D/NMF3D fits on B3/B4
    by_path["deconv"] = deconv_fits(models, beta_div, fm, D, card)
    for name, beta in (("NMFD", 1), ("NMFD", 0.5), ("NMF2D", 1), ("NMF3D", 1)):
        N, C, S_out, kernel, Rd = DECONV[name]
        V = deconv_target(name)
        m = deconv_model(name, models)
        recon2 = type(m).reconstruct
        plain_fit = get_dense_fit(
            recon2, float(beta), 0.0, DECONV_ITERS, True, True, 0.0, 0.0, False,
            F.deconv_updater_factory_plain(len(kernel)))
        times = time_fits(
            *nmf_runs(m, V, dict(beta=beta, tol=0, max_iter=DECONV_ITERS),
                      plain_fit),
            lambda W, H: float(beta_div(recon2(H, W), V, beta)),
            DECONV_ITERS, f"{name} beta={beta}")
        shape = "x".join(map(str, (C,) + S_out)) + f"_r{Rd}_k" + "x".join(
            map(str, kernel))
        fit_ms[f"{name.lower()}_{shape}_beta{beta}"] = times
        print(f"phase 4: beta={beta} {name} fit ms/iteration at {shape}: "
              f"kernel {times['kernel']}, plain {times['plain']} [{card}]",
              flush=True)
    del V, m

    # phase 3, the PLCA family: SIPLCA/2/3 on B3/B4, dense PLCA's fused
    # E-step on B1; then sparse NMF targets, whose densify tier runs B1
    by_path["siplca"] = siplca_fits(F, recon, solver, plca_from_numpy, kl_div,
                                    ctr, card, fit_ms)
    by_path["plca_fused"] = plca_fits(plca_from_numpy, kl_div, ctr, card, fit_ms)
    by_path["sparse_densify"] = sparse_fits(S, nmf_from_numpy, ctr, card, fit_ms)
    launches = {name: sum(n[name] for n in by_path.values()) for name in REPLACES}
    print(f"phase 3: launches by path {json.dumps(by_path)}", flush=True)

    N, C, S_out, kernel, Rd = DECONV["NMFD"]
    for name, st in stats.items():
        at = (f"{M}x{K} R={R}" if name in ("fused_contractions", "fused_beta_loss")
              else f"{C}x{S_out[0]} R={Rd} T={kernel[0]}")
        lib = "none" if st["library_ms"] is None else f"{st['library_ms']:.4f} ms"
        print(f"phase 4: {name} at {at}: kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, library {lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}) [{card}]",
              flush=True)
    print(f"whole run {time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
    summary = {"kernels": [
        dict({"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": REPLACES[name], "launches": launches[name],
              "launches_by_path": {p: n[name] for p, n in by_path.items()}},
             **stats[name])
        for name in REPLACES
    ], "fit_ms_per_iter": fit_ms}
    print(card_line(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
