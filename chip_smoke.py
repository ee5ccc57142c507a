#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, dense ``NMF.fit`` of ``pytorch_nmf_tpu_torch``,
at the reference benchmark's full size (V 5168×1025, rank 88), in phases:

1. prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``pytorch_nmf_tpu_torch/csrc`` with ``nvcc``;
2. holds each kernel against its plain PyTorch version on the card, at
   5168×1025 R=88 and 4096×4096 R=256 (rtol 1e-4: every summand is
   non-negative, so the only error is summation order);
3. fits V with β ∈ {2, 1, 0, 0.5, 1.5} through ``NMF.fit``, checking the
   factors and that the fused kernels carried every β ≠ 2 fit; then fits
   β = 1 and 0.5 for 100 iterations through the kernels and through the
   plain versions and compares the final losses (1e-4 relative);
4. times those fits per iteration and each kernel against its plain
   version, with CUDA events.

Any failure raises (exit code ≠ 0).  The second-to-last line of standard
output is a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``.  Float32 matrix products run in full
float32 (TF32 off), so the plain versions are true f32 too.  Needs one
CUDA device; exits with an error without one.
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
REPLACES = {
    "fused_contractions": "pytorch_nmf_tpu/ops/pallas_mu.py:212",
    "fused_beta_loss": "pytorch_nmf_tpu/ops/pallas_mu.py:347",
}
SOURCE = "pytorch_nmf_tpu_torch/csrc/fused_mu.cu"


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


def inputs(M, K, R, seed=SEED):
    rs = np.random.RandomState(seed)
    V = np.abs(rs.randn(M, K)).astype("f") + 0.01
    W = np.abs(rs.randn(K, R)).astype("f")
    H = np.abs(rs.randn(M, R)).astype("f")
    return (torch.from_numpy(x).cuda() for x in (V, W, H))


def compare_kernels(fm, kl_pos_W, kl_pos_H):
    """Phase 2: each kernel against its plain version; returns per-kernel
    (max_abs_err, max_rel_err, ms, plain_ms) and prints every case."""
    stats = {name: [0.0, 0.0, None, None] for name in REPLACES}

    def record(name, got, ref):
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.is_cuda, f"{name}: bad output")
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-30)).max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=0)
        stats[name][0] = max(stats[name][0], float(err.max()))
        stats[name][1] = max(stats[name][1], rel)
        return rel

    for M, K, R in (MAIN_SHAPE, WIDE_SHAPE):
        V, W, H = inputs(M, K, R)
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
                if (M, K, R) == MAIN_SHAPE:
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
                if beta == 0.5:
                    stats["fused_beta_loss"][2:] = [ms, pms]
            print(line, flush=True)
        if (M, K, R) == MAIN_SHAPE:
            # the JSON's B1 time: one β=0.5 MU iteration's contractions
            # (W side then H side, numerator and denominator)
            def both(fn):
                fn(V, H, W, beta=0.5, need_pos=True, w_side=True)
                fn(V, H, W, beta=0.5, need_pos=True, w_side=False)

            stats["fused_contractions"][2:] = [
                cuda_ms(lambda: both(fm.fused_contractions)),
                cuda_ms(lambda: both(fm.plain_contractions)),
            ]
        del V, W, H
    return stats


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA GPU")
    from pytorch_nmf_tpu_torch.metrics import beta_div
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops._build import load_library
    from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_plain
    from pytorch_nmf_tpu_torch.ops.mu import kl_pos_H, kl_pos_W
    from pytorch_nmf_tpu_torch.ops.solver import get_dense_fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is still on")

    # phase 1: the card, the build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    load_library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels against their plain versions
    stats = compare_kernels(fm, kl_pos_W, kl_pos_H)
    print("phase 2: kernels agree with their plain versions", flush=True)

    # phase 3: the main path, dense NMF.fit at full width
    M, K, R = MAIN_SHAPE
    V, _, _ = inputs(M, K, R)

    def model():
        return NMF((M, K), R, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(SEED))

    fm.fused_contractions.launches = 0
    fm.fused_beta_loss.launches = 0
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

    # phases 3 and 4: kernel path against plain path, 100 iterations each,
    # timed in turns (plain, kernel, kernel, plain)
    fit_ms = {}
    for beta in (1, 0.5):
        m = model()
        W0, H0 = m.W.detach().clone(), m.H.detach().clone()
        plain_fit = get_dense_fit(NMF.reconstruct, float(beta), 0.0, 100, True,
                                  True, 0.0, 0.0, False, nmf_updater_factory_plain)

        def run_kernel():
            m.W.data.copy_(W0)
            m.H.data.copy_(H0)
            m.fit(V, beta=beta, tol=0, max_iter=100)
            return m.W.detach(), m.H.detach()

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
            times[path].append(start.elapsed_time(end) / 100)
            finals[path] = float(beta_div(NMF.reconstruct(H, W), V, beta))
        rel = abs(finals["kernel"] - finals["plain"]) / abs(finals["plain"])
        check(rel <= 1e-4, f"beta={beta}: kernel loss {finals['kernel']} vs "
              f"plain {finals['plain']} (rel {rel:.3g})")
        fit_ms[beta] = times
        print(f"phase 3: beta={beta} 100 iterations, final loss kernel "
              f"{finals['kernel']:.7g} plain {finals['plain']:.7g} "
              f"(rel {rel:.3g})", flush=True)
        print(f"phase 4: beta={beta} fit ms/iteration at {M}x{K} R={R}: "
              f"kernel {times['kernel']}, plain {times['plain']} [{card}]",
              flush=True)

    for name, (abs_err, rel_err, ms, pms) in stats.items():
        print(f"phase 4: {name} at {M}x{K} R={R}: kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms [{card}]", flush=True)
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": stats[name][0], "max_rel_err": stats[name][1],
         "ms": stats[name][2], "plain_ms": stats[name][3]}
        for name in REPLACES
    ], "fit_ms_per_iter": {str(b): t for b, t in fit_ms.items()}}
    print(card_line(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
