"""Where B1 and B3 spend their time: builds of the kernel sources with one
part cut, timed against the whole kernel, and a per-phase cycle count of
one B1 block.

    python chip_tools/variants.py           # from the repository root

Each variant is the source with a few lines replaced (its results are wrong
on purpose; only its time matters), built with the package's own ``nvcc``
flags into ``build/variants/`` and loaded in place of the real library:

* B3 at the NMFD flagship (1025×5000, R=88, T=400): ``full``, ``no_wgmma``
  (no products), ``no_split`` (no hi/lo split of the tiles); and, at ranks 8
  and 16 of the same size and the NMF3D row, ``full`` (the windowed kernel)
  against ``tc_small`` (the tensor-core kernel at every rank);
* B1 at 5168×1025, R=88: ``prof``, the whole kernel with ``clock64()``
  marks, whose block (0, 0, 0) reports the cycles of each phase of its steps
  (wait for the tiles, split, prefetch issue, WH product, cotangents,
  contraction issue); and the profiler's device time per call.

Needs one CUDA device.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path


def _replace_once(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"expected one occurrence of {old!r}")
    return text.replace(old, new)


def _instrument(text, marks):
    """Adds a cycle mark after each anchor: mark i accumulates the cycles
    since the previous mark into dbg_acc[i]."""
    for i, anchor in enumerate(marks):
        text = _replace_once(
            text, anchor, anchor + "\n      { long long c_ = clock64(); "
            f"dbg_acc[{i}] += c_ - dbg_cl; dbg_cl = c_; }}")
    return text


PHASES = ("wait", "split", "prefetch", "WH", "cotangents", "contraction")


def _b1_profile(mu):
    text = _instrument(mu, [
        "      tf32x3::wgmma_wait<0>();  // the last products are done with GS, GO\n"
        "      __syncthreads();",
        "      tc_split(GS, GO, Graw, fs, w8, z0 - rc, zw, GO_SIZE);\n"
        "      __syncthreads();",
        "                  g0 + TBG, n_f, n_g, ldv, h_side);\n      }",
        "      tf32x3::wgmma_commit();\n      tf32x3::wgmma_wait<0>();\n"
        "      tf32x3::fence_operand(s);\n      tf32x3::fence_operand(s1);",
        "      cp[i] = ok ? b : 0.f;\n    }",
        "    tf32x3::wgmma_commit();  // waited for before the next split",
    ])
    text = _replace_once(
        text, "  for (int t = t_begin; t < t_end; ++t) {\n    const int g0 = t * TBG;",
        "  long long dbg_acc[8] = {0}, dbg_cl = clock64();\n"
        "  for (int t = t_begin; t < t_end; ++t) {\n    const int g0 = t * TBG;")
    text = _replace_once(
        text, "  const bool epilogue = mu_pos != nullptr && gridDim.y == 1;",
        "  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&\n"
        "      threadIdx.x == 0)\n"
        "    for (int i = 0; i < 8; ++i) dbg_cycles[i] = dbg_acc[i];\n"
        "  const bool epilogue = mu_pos != nullptr && gridDim.y == 1;")
    text = _replace_once(text, "namespace {\n",
                         "__device__ long long dbg_cycles[8];\nnamespace {\n")
    return _replace_once(
        text, 'extern "C" {\n',
        'extern "C" {\nint pnt_dbg(long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, dbg_cycles, sizeof(dbg_cycles));\n}\n")


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch.ops import _build
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm

    csrc = Path("pytorch_nmf_tpu_torch/csrc")
    header = (csrc / "tf32x3.cuh").read_text()
    deconv = (csrc / "fused_deconv.cu").read_text()
    mu = (csrc / "fused_mu.cu").read_text()
    wgmma_loop = deconv[deconv.index(
        "#pragma unroll\n    for (int ks = 0; ks < HBK / 8; ++ks) {\n"
        "      const int o = 64 * ks;"):deconv.index("    tf32x3::wgmma_commit();")]
    variants = {
        ("fused_deconv", "full"): deconv,
        ("fused_deconv", "no_wgmma"): _replace_once(deconv, wgmma_loop, ""),
        ("fused_deconv", "no_split"): _replace_once(_replace_once(
            deconv, "      tf32x3::split(va[i], a[e], a[HBM * HBK + e]);\n", ""),
            "      tf32x3::split(vw[i], w[e], w[HRN * HBK + e]);\n", ""),
        ("fused_deconv", "tc_small"): _replace_once(
            deconv, "  if (R <= 16) {\n    const int bmr", "  if (false) {\n    const int bmr"),
        ("fused_mu", "prof"): _b1_profile(mu),
    }
    out = Path("build/variants")
    jobs = []
    for (name, v), text in variants.items():
        d = out / f"{name}_{v}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.cu").write_text(text)
        (d / "tf32x3.cuh").write_text(header)
        jobs.append((name, v, d, subprocess.Popen(
            [_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, v, d, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {v} failed to build:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, (argtypes, restype) in _build._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[(name, v)] = lib

    def ms(fn, reps):
        for _ in range(2):
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

    rs = np.random.RandomState(0)
    M, K, R = 5168, 1025, 88
    V = fm.aligned_rows(torch.from_numpy(
        np.abs(rs.randn(M, K)).astype("f") + 0.01).cuda())
    W = torch.from_numpy(np.abs(rs.randn(K, R)).astype("f")).cuda()
    H = torch.from_numpy(np.abs(rs.randn(M, R)).astype("f")).cuda()
    N, C, S_out, kernel, _ = cs.DECONV["NMFD"]
    small = {"R=8": (N, C, S_out, kernel, 8), "R=16": (N, C, S_out, kernel, 16),
             "NMF3D": cs.DECONV["NMF3D"]}
    ops = {"R=88": cs.deconv_operands(F, *cs.DECONV["NMFD"])}
    ops.update({k: cs.deconv_operands(F, *v) for k, v in small.items()})
    for (name, v), lib in libs.items():
        _build._libs[name] = lib
        if name == "fused_deconv":
            for case in ["R=88"] + (list(small) if v in ("full", "tc_small") else []):
                op = ops[case]
                t = ms(lambda: D.hgrad(op["cots"][0], op["W2"], op["R"],
                                       op["L_h"], geom=op["geom"]), 5)
                print(f"B3 {v} {case}: {t:.4f} ms", flush=True)
            continue
        cycles = (ctypes.c_longlong * 8)()
        lib.pnt_dbg.argtypes = [ctypes.c_void_p]
        for beta, w_side in ((0.5, True), (0.5, False), (1.0, True)):
            def call():
                return fm.fused_contractions(V, H, W, beta=beta,
                                             need_pos=beta != 1, w_side=w_side)
            call()
            torch.cuda.synchronize()
            lib.pnt_dbg(ctypes.addressof(cycles))
            phases = ", ".join(f"{p} {c}" for p, c in zip(PHASES, cycles))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            device_ms = sum(e.device_time_total
                            for e in prof.key_averages()) / 10 / 1e3
            print(f"B1 beta={beta} {'W' if w_side else 'H'} side: block 0 "
                  f"cycles {phases}, total {sum(cycles)}; device "
                  f"{device_ms:.4f} ms per call (instrumented)", flush=True)


if __name__ == "__main__":
    main()
