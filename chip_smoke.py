#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at full width, each in phases:

* dense ``NMF.fit`` at the reference benchmark's size (V 5168×1025, rank
  88), on the kernels B1/B2 of ``csrc/fused_mu.cu``;
* the deconvolutional fits ``NMFD.fit`` at the JAX bench's flagship
  (V 1×1025×5000, rank 88, T=400: the reference's librosa example), and
  ``NMF2D.fit`` (1×512×64×64, rank 128, kernel 8×8) and ``NMF3D.fit``
  (1×64×19³, rank 16, kernel 4³) at the bench's rows, on the kernels B3/B4
  (``hgrad``/``wgrad``) of ``csrc/fused_deconv.cu``.

1. prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``pytorch_nmf_tpu_torch/csrc``, one ``nvcc`` per source, in parallel;
2. holds each kernel against its plain PyTorch version on the card: B1/B2
   at 5168×1025 R=88 and 4096×4096 R=256 (rtol 1e-4), B3/B4 at the NMFD
   flagship, its rank-8 row, N=2, and the NMF2D/NMF3D rows
   (``max|kernel - plain| ≤ 1e-4·max|plain|``); every summand is
   non-negative, so the only error is summation order;
3. fits V with β ∈ {2, 1, 0, 0.5, 1.5} through ``NMF.fit``, and with β ∈ {1,
   2, 0.5} through ``NMFD.fit`` plus β=1 through ``NMF2D.fit`` and
   ``NMF3D.fit``, checking the factors and that each path's kernels carried
   its fits (launch counts set to 0 before a path, read after it); then fits
   through the kernels and through the plain versions (dense and NMFD at
   β = 1 and 0.5, NMF2D and NMF3D at β = 1; 100 dense, 20 deconv iterations)
   and compares the final losses (1e-4 relative);
4. times those fits per iteration and each kernel against its plain
   version and, for B3/B4, the one PyTorch call that computes the same
   function (``F.convNd`` and ``torch.nn.grad.convNd_weight``, cuDNN; the
   port never calls them), with CUDA events; each kernel's bound is the
   larger of its operations at the 3xTF32 rate and its bytes at the HBM
   rate (B4 also for the neg/pos pair: twice the operations).

Any failure raises (exit code ≠ 0).  The second-to-last line of standard
output is a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``.  Float32 matrix products and
convolutions run in full float32 (TF32 off), so the plain versions and the
library calls are true f32 too.  Needs one CUDA device; exits with an error
without one.
"""

import json
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


def deconv_fits(models, beta_div, fm, D):
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
              f"{after:.6g} in {secs:.2f} s; launches B3 {d_b3}, B4 {d_b4}",
              flush=True)
        del V, m
    launches = {"fused_contractions": fm.fused_contractions.launches,
                "fused_beta_loss": fm.fused_beta_loss.launches,
                "hgrad": D.hgrad.launches, "wgrad": D.wgrad.launches}
    check(launches["fused_contractions"] == launches["fused_beta_loss"] == 0,
          f"the deconv fits launched B1/B2: {launches}")
    return launches


def time_fits(make_kernel_fit, plain_fit, W0, H0, V, loss_of, iters, tag):
    """Phases 3 and 4: the kernel path against the plain path from the same
    inits, timed in turns (plain, kernel, kernel, plain) after a warm-up of
    each; the final losses must agree within 1e-4 relative.  Returns the
    ms/iteration of each run."""
    def run_kernel():
        return make_kernel_fit(W0.clone(), H0.clone())

    def run_plain():
        W, H, _ = plain_fit(V, W0.clone(), H0.clone())
        return W, H

    run_kernel(), run_plain()  # warm-up
    times = {"kernel": [], "plain": []}
    finals = {}
    for path, fn in (("plain", run_plain), ("kernel", run_kernel),
                     ("kernel", run_kernel), ("plain", run_plain)):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        W, H = fn()
        end.record()
        torch.cuda.synchronize()
        times[path].append(start.elapsed_time(end) / iters)
        finals[path] = loss_of(W, H)
    rel = abs(finals["kernel"] - finals["plain"]) / abs(finals["plain"])
    check(rel <= 1e-4, f"{tag}: kernel loss {finals['kernel']} vs "
          f"plain {finals['plain']} (rel {rel:.3g})")
    print(f"phase 3: {tag} {iters} iterations, final loss kernel "
          f"{finals['kernel']:.7g} plain {finals['plain']:.7g} "
          f"(rel {rel:.3g})", flush=True)
    return times


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA GPU")
    from pytorch_nmf_tpu_torch import nmf as models
    from pytorch_nmf_tpu_torch.metrics import beta_div
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_plain
    from pytorch_nmf_tpu_torch.ops.mu import kl_pos_H, kl_pos_W
    from pytorch_nmf_tpu_torch.ops.solver import get_dense_fit

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
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels against their plain versions
    stats = compare_kernels(fm, kl_pos_W, kl_pos_H)
    stats.update(compare_deconv_kernels(F, D, kl_pos_W))
    print("phase 2: kernels agree with their plain versions", flush=True)

    # phase 3: the main path, dense NMF.fit at full width
    M, K, R = MAIN_SHAPE
    V, _, _ = inputs(M, K, R)

    def model():
        return NMF((M, K), R, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(SEED))

    for fn in (fm.fused_contractions, fm.fused_beta_loss, D.hgrad, D.wgrad):
        fn.launches = 0
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
    launches = {"fused_contractions": fm.fused_contractions.launches,
                "fused_beta_loss": fm.fused_beta_loss.launches}
    check(D.hgrad.launches == D.wgrad.launches == 0,
          "the dense fits launched B3/B4")

    # phases 3 and 4: kernel path against plain path, 100 iterations each,
    # timed in turns (plain, kernel, kernel, plain)
    fit_ms = {}
    for beta in (1, 0.5):
        m = model()

        def kernel_fit(W0, H0):
            m.W.data.copy_(W0)
            m.H.data.copy_(H0)
            m.fit(V, beta=beta, tol=0, max_iter=100)
            return m.W.detach(), m.H.detach()

        plain_fit = get_dense_fit(NMF.reconstruct, float(beta), 0.0, 100, True,
                                  True, 0.0, 0.0, False, nmf_updater_factory_plain)
        times = time_fits(
            kernel_fit, plain_fit, m.W.detach().clone(), m.H.detach().clone(),
            V, lambda W, H: float(beta_div(NMF.reconstruct(H, W), V, beta)),
            100, f"NMF beta={beta}")
        fit_ms[f"nmf_{M}x{K}_r{R}_beta{beta}"] = times
        print(f"phase 4: beta={beta} fit ms/iteration at {M}x{K} R={R}: "
              f"kernel {times['kernel']}, plain {times['plain']} [{card}]",
              flush=True)
    del V, m

    # phase 3, the deconv path: NMFD/NMF2D/NMF3D fits on B3/B4
    launches.update({k: v for k, v in deconv_fits(models, beta_div, fm, D).items()
                     if k in ("hgrad", "wgrad")})
    for name, beta in (("NMFD", 1), ("NMFD", 0.5), ("NMF2D", 1), ("NMF3D", 1)):
        N, C, S_out, kernel, Rd = DECONV[name]
        V = deconv_target(name)
        m = deconv_model(name, models)
        recon = type(m).reconstruct

        def kernel_fit(W0, H0):
            m.W.data.copy_(W0)
            m.H.data.copy_(H0)
            m.fit(V, beta=beta, tol=0, max_iter=DECONV_ITERS)
            return m.W.detach(), m.H.detach()

        plain_fit = get_dense_fit(
            recon, float(beta), 0.0, DECONV_ITERS, True, True, 0.0, 0.0, False,
            F.deconv_updater_factory_plain(len(kernel)))
        times = time_fits(
            kernel_fit, plain_fit, m.W.detach().clone(), m.H.detach().clone(),
            V, lambda W, H: float(beta_div(recon(H, W), V, beta)),
            DECONV_ITERS, f"{name} beta={beta}")
        shape = "x".join(map(str, (C,) + S_out)) + f"_r{Rd}_k" + "x".join(
            map(str, kernel))
        fit_ms[f"{name.lower()}_{shape}_beta{beta}"] = times
        print(f"phase 4: beta={beta} {name} fit ms/iteration at {shape}: "
              f"kernel {times['kernel']}, plain {times['plain']} [{card}]",
              flush=True)
    N, C, S_out, kernel, Rd = DECONV["NMFD"]

    for name, st in stats.items():
        at = (f"{M}x{K} R={R}" if name in ("fused_contractions", "fused_beta_loss")
              else f"{C}x{S_out[0]} R={Rd} T={kernel[0]}")
        lib = "none" if st["library_ms"] is None else f"{st['library_ms']:.4f} ms"
        print(f"phase 4: {name} at {at}: kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, library {lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}) [{card}]",
              flush=True)
    print(f"whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    summary = {"kernels": [
        dict({"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": REPLACES[name], "launches": launches[name]},
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
