"""Where B1, B3 and B4 spend their time: builds of the kernel sources with
one part cut, timed against the whole kernel, and a per-phase cycle count
of one B1 block.

    python chip_tools/variants.py [--parent DIR] [VARIANT ...]   # from the repository root

With no argument every variant runs; else the named ones (``full`` and
``wfull`` are the whole kernels).

Each variant is the source with a few lines replaced (its results are wrong
on purpose; only its time matters), built with the package's own ``nvcc``
flags into ``build/variants/`` and loaded in place of the real library:

* B3 at the NMFD flagship (1025×5000, R=88, T=400): ``full``, ``no_wgmma``
  (no products), ``no_split`` (no hi/lo split of the tiles);
* B3 at ranks ≤ 16 (the gemm regime, at the reference demo 1×1025×4997 R=3
  T=400, the NMFD rows at ranks 8 and 16, NMF3D, SIPLCA2 and the SIPLCA
  rank-8 row; device time from CUDA-graph replays): ``g_full`` with its
  plan and with the tensor-core kernel forced, and, with ``--parent DIR``
  (a ``git archive`` of an earlier commit), that commit's B3 built from
  its own source and called through its own C interface (``earlier``: at
  the parent of the gemm regime, the f32-FMA windowed kernel); and builds
  with one part cut: ``g_no_wgmma`` (no
  products, and so no A fragments), ``g_no_frag`` (fragments of zeros: no
  shared-memory reads or splits of the cotangent), ``g_no_copy`` (no
  cotangent copies), ``g_no_fold`` (one read an output in place of the
  diagonal sum), ``g_no_wsplit`` (no W2 split pass);
* B4 at the flagship, one cotangent: ``w_prof``, the whole kernel with
  ``clock64()`` marks, whose block (0, 0, 0) reports the cycles of each
  phase of its stages for one lane of each warpgroup; ``wfull``, ``w_no_wgmma`` (no
  products, and so no patch fragments), ``w_no_split`` (no transposing
  hi/lo pass over the cotangent tile), ``w_no_patch`` (no patch copies: half
  the tile traffic from L2), and ``w_no_fence`` (no proxy
  fence before the stage's barrier);
* every kernel with the TF32 split by ``cvt.rna.tf32.f32`` in place of
  integer rounding: ``cvt`` (B3), ``w_cvt`` (B4) and ``mu_cvt`` (B1 and B2,
  against ``mu_full``); with ``w_cvt`` and ``mu_cvt`` both built, their
  outputs are first compared bit for bit with the package's own build;
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
W_PHASES = ("fragments", "wgmma issue and split", "wgmma wait and sum",
            "fence, copy wait and barrier", "copy issue")


def _mark(i):
    return ("      { long long c_ = clock64(); "
            f"dbg_acc[{i}] += c_ - dbg_cl; dbg_cl = c_; }}\n")


def _b4_profile(deconv):
    """B4 with clock64() marks between the phases of each stage; threads 0
    and 128 (one lane of each warpgroup) of block (0, 0, 0) report."""
    text = deconv
    for i, (anchor, before) in enumerate((
            ("      a[ks] = tf32x3::frag_a(p[0], p[8], p[4 * WGS], p[4 * WGS + 8]);\n    }\n", ""),
            ("    tf32x3::wgmma_commit();\n    tf32x3::wgmma_wait<0>();\n",
             "    tf32x3::wgmma_wait<0>();\n"),
            ("      for (int i = 0; i < 4 * NT; ++i) total[t][i] += run[t][i];\n    }\n", ""),
            ("    // every lane is done with raw stage s % 3 and has split stage s+1\n"
             "    __syncthreads();\n", ""),
            ("    if (s + 3 < steps) load(s % 3, l_begin + (s + 3) * WGK);\n  }\n",
             "  }\n"))):
        # the mark goes after the anchor, or before its part `before`
        new = (anchor.replace(before, _mark(i) + before) if before
               else anchor + _mark(i))
        text = _replace_once(text, anchor, new)
    text = _replace_once(
        text, "  for (int s = 0; s < steps; ++s) {\n    // this lane's patch rows",
        "  long long dbg_acc[8] = {0}, dbg_cl = clock64();\n"
        "  for (int s = 0; s < steps; ++s) {\n    // this lane's patch rows")
    text = _replace_once(
        text, "  // The beta=1 epilogue reads",
        "  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&\n"
        "      tid % 128 == 0)\n"
        "    for (int i = 0; i < 8; ++i) dbg_wcycles[tid / 128][i] = dbg_acc[i];\n"
        "  // The beta=1 epilogue reads")
    text = _replace_once(text, "namespace {\n",
                         "__device__ long long dbg_wcycles[2][8];\nnamespace {\n")
    return _replace_once(
        text, 'extern "C" {\n',
        'extern "C" {\nint pnt_dbg(long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, dbg_wcycles, sizeof(dbg_wcycles));\n}\n")


def _b1_profile(mu):
    text = _instrument(mu, [
        "      tf32x3::wgmma_wait<0>();  // the last products are done with GS, GO\n"
        "      __syncthreads();",
        "      tc_split(GS, GO, Graw, fs, w8, z0 - rc, LOSS ? 0 : zw, GO_SIZE);\n"
        "      __syncthreads();",
        "                  g0 + TBG, n_f, n_g, ldv, h_side);\n      }",
        "      tf32x3::wgmma_commit();\n      tf32x3::wgmma_wait<0>();\n"
        "      tf32x3::fence_operand(s);\n      tf32x3::fence_operand(s1);",
        "        cp[i] = ok ? b : 0.f;\n      }",
        "      tf32x3::wgmma_commit();  // waited for before the next split",
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
    w_wgmma = (
        "        tf32x3::wgmma<NT>(run[t], a[ks].hi, tf32x3::desc(bl, 128, 1024),\n"
        "                          ks > 0);\n"
        "        tf32x3::wgmma<NT>(run[t], a[ks].lo, tf32x3::desc(bh, 128, 1024), 1);\n"
        "        tf32x3::wgmma<NT>(run[t], a[ks].hi, tf32x3::desc(bh, 128, 1024), 1);\n")
    w_late_fence = ("      for (int i = 0; i < 4 * NT; ++i) total[t][i] += run[t][i];\n"
                    "    }\n    tf32x3::fence_async_smem();\n")
    variants = {
        ("fused_deconv", "full"): deconv,
        ("fused_deconv", "no_wgmma"): _replace_once(deconv, wgmma_loop, ""),
        ("fused_deconv", "no_split"): _replace_once(_replace_once(
            deconv, "      tf32x3::split(va[i], a[e], a[HBM * HBK + e]);\n", ""),
            "      tf32x3::split(vw[i], w[e], w[HRN * HBK + e]);\n", ""),
        ("fused_deconv", "g_full"): deconv,
        ("fused_deconv", "g_no_wgmma"): _replace_once(deconv, (
            "        tf32x3::wgmma<NT>(acc[t], f[t][ks].hi, tf32x3::desc(bl, 128, 1024),\n"
            "                          (s | ks) != 0);\n"
            "        tf32x3::wgmma<NT>(acc[t], f[t][ks].lo, tf32x3::desc(bh, 128, 1024), 1);\n"
            "        tf32x3::wgmma<NT>(acc[t], f[t][ks].hi, tf32x3::desc(bh, 128, 1024), 1);\n"), ""),
        ("fused_deconv", "g_no_frag"): _replace_once(
            deconv, "f[t][ks] = tf32x3::frag_a(p[0], p[8 * GAS], p[4], p[8 * GAS + 4]);",
            "f[t][ks] = tf32x3::frag_a(0.f, 0.f, 0.f, 0.f);"),
        ("fused_deconv", "g_no_copy"): _replace_once(
            deconv, "      cp_async16(&A[m * GAS + 4 * q], ok ? cot + l * C + c : cot, ok);\n", ""),
        ("fused_deconv", "g_no_fold"): _replace_once(
            deconv, "for (int jj = 0; jj < len; ++jj) v += G[(i + jj * g.s2) * GS + jj * R + r];",
            "v = G[i * GS + r];"),
        ("fused_deconv", "g_no_wsplit"): _replace_once(
            deconv, "    hgrad_split_w_kernel<<<", "    if (false) hgrad_split_w_kernel<<<"),
        ("fused_mu", "prof"): _b1_profile(mu),
        ("fused_deconv", "wfull"): deconv,
        ("fused_deconv", "w_no_wgmma"): _replace_once(deconv, w_wgmma, ""),
        ("fused_deconv", "w_no_split"): _replace_once(
            deconv, "      if (PER * q + i < NE) tf32x3::split(v[i], sb[e], sb[NB * WGK + e]);\n",
            ""),
        ("fused_deconv", "w_no_patch"): _replace_once(
            deconv, "        cp_async16(&P[k * WGS + am], ok ? h2 + (size_t)hr * R + ar : h2, ok);\n",
            ""),
        ("fused_deconv", "w_prof"): _b4_profile(deconv),
        ("fused_deconv", "w_no_fence"): _replace_once(
            deconv, w_late_fence, w_late_fence.replace(
                "    tf32x3::fence_async_smem();\n", "")),
    }
    # the TF32 split by cvt.rna.tf32.f32 in place of integer rounding (the
    # same bits for finite values), for every kernel of a build
    cvt_header = _replace_once(
        header, "  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;\n",
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(a));\n'
        "  return r & 0xffffe000u;\n")
    variants.update({
        ("fused_deconv", "cvt"): deconv, ("fused_deconv", "w_cvt"): deconv,
        ("fused_mu", "mu_full"): mu, ("fused_mu", "mu_cvt"): mu})
    headers = {("fused_deconv", "cvt"): cvt_header,
               ("fused_deconv", "w_cvt"): cvt_header,
               ("fused_mu", "mu_cvt"): cvt_header}
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1])
        del args[i:i + 2]
    chosen = set(args)
    variants = {k: v for k, v in variants.items() if not chosen or k[1] in chosen}
    out = Path("build/variants")
    jobs = []
    if parent is not None:  # the earlier commit's B3, from its own sources
        d = out / "fused_deconv_earlier"
        d.mkdir(parents=True, exist_ok=True)
        for f in ("fused_deconv.cu", "tf32x3.cuh"):
            (d / f).write_text(
                (parent / "pytorch_nmf_tpu_torch/csrc" / f).read_text())
        jobs.append(("fused_deconv", "earlier", d, subprocess.Popen(
            [_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "fused_deconv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for (name, v), text in variants.items():
        d = out / f"{name}_{v}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.cu").write_text(text)
        (d / "tf32x3.cuh").write_text(headers.get((name, v), header))
        jobs.append((name, v, d, subprocess.Popen(
            [_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, v, d, proc in jobs:
        _, err = proc.communicate()
        (d / "lib.log").write_text(err)  # ptxas' report, as the package keeps
        if proc.returncode:
            raise RuntimeError(f"{name} {v} failed to build:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        if v == "earlier":
            earlier_lib = lib
            continue
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
    small = {"demo R=3": (1, C, (4997,), kernel, 3),
             "NMFD R=8": (N, C, S_out, kernel, 8),
             "NMFD R=16": (N, C, S_out, kernel, 16),
             "NMF3D": cs.DECONV["NMF3D"], "SIPLCA2": cs.SIPLCA_ROWS["SIPLCA2"],
             "SIPLCA R=8": cs.SIPLCA_ROWS["SIPLCA R=8"]}
    ops = {"R=88": cs.deconv_operands(F, *cs.DECONV["NMFD"])}
    small_ops = {k: cs.deconv_operands(F, *v) for k, v in small.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def b3(op, plan=None):
        return D.hgrad(op["cots"][0], op["W2"], op["R"], op["L_h"],
                       geom=op["geom"], plan=plan)

    def rel_err(got, op):
        ref = D.plain_hgrad(op["cots"][0], op["W2"], op["R"], op["L_h"],
                            geom=op["geom"])
        torch.cuda.synchronize()
        return float((got - ref).abs().max() / ref.abs().max())

    def b3_earlier(op):
        """B3 of the earlier commit, through its own C interface
        (pnt_hgrad_splits, then pnt_hgrad without a plan)."""
        cot, W2 = fm.aligned_rows(op["cots"][0]), fm.aligned_rows(op["W2"])
        R, L = op["R"], op["L_h"]
        Lp, ldc = cot.shape[0], cot.stride(0)
        K = W2.shape[0] // R
        g = D._geom_args(K, op["geom"])
        splits = earlier_lib.pnt_hgrad_splits(R, L, ldc, K, *g[1:], sms)
        out = torch.empty(R, L, device="cuda")
        part = torch.empty(splits, R, L, device="cuda") if splits > 1 else None
        err = earlier_lib.pnt_hgrad(
            cot.data_ptr(), W2.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), Lp, ldc, R, K, L, *g,
            splits, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the earlier B3 failed: CUDA error {err}")
        return out

    if parent is not None:
        _I, _P = ctypes.c_int, ctypes.c_void_p
        earlier_lib.pnt_hgrad_splits.argtypes = [_I] * 10
        earlier_lib.pnt_hgrad_splits.restype = _I
        earlier_lib.pnt_hgrad.argtypes = [_P] * 4 + [_I] * 12 + [_P]
        earlier_lib.pnt_hgrad.restype = _I
        _build._libs.clear()
        _build.load_all()
        for case, op in small_ops.items():
            rel = rel_err(b3_earlier(op), op)
            t_old = cs.graph_ms(lambda: b3_earlier(op))
            t_new = cs.graph_ms(lambda: b3(op))
            t_old2 = cs.graph_ms(lambda: b3_earlier(op))
            t_new2 = cs.graph_ms(lambda: b3(op))
            print(f"B3 {case}: earlier {t_old:.4f}, {t_old2:.4f} ms (rel err "
                  f"{rel:.3g}); this tree {t_new:.4f}, {t_new2:.4f} ms "
                  "(device, graph replays, in turns)", flush=True)
    def outputs():
        op = ops["R=88"]
        return (*D.wgrad(op["cots"], op["H2"], op["R"], op["T"],
                         lead_pad=op["lead"], geom=op["geom"]),
                D.hgrad(op["cots"][0], op["W2"], op["R"], op["L_h"],
                        geom=op["geom"]),
                *fm.fused_contractions(V, H, W, beta=0.5, need_pos=True,
                                       w_side=True),
                fm.fused_beta_loss(V, H, W, 0.5))

    if ("fused_deconv", "w_cvt") in libs and ("fused_mu", "mu_cvt") in libs:
        # the integer-rounded split against cvt.rna.tf32.f32, bit for bit
        _build._libs.clear()
        _build.load_all()
        ours = outputs()
        _build._libs["fused_deconv"] = libs[("fused_deconv", "w_cvt")]
        _build._libs["fused_mu"] = libs[("fused_mu", "mu_cvt")]
        same = [torch.equal(a, b) for a, b in zip(ours, outputs())]
        print("integer split and cvt.rna.tf32.f32 give the same bits "
              f"(B4 pair, B3, B1 pair, B2): {same}", flush=True)
    for (name, v), lib in libs.items():
        _build._libs[name] = lib
        if name == "fused_deconv" and v.startswith("w"):
            op = ops["R=88"]
            t = ms(lambda: D.wgrad(op["cots"][:1], op["H2"], op["R"], op["T"],
                                   lead_pad=op["lead"], geom=op["geom"]), 5)
            print(f"B4 {v} R=88: {t:.4f} ms", flush=True)
            if v == "w_prof":
                cycles = (ctypes.c_longlong * 16)()
                lib.pnt_dbg.argtypes = [ctypes.c_void_p]
                lib.pnt_dbg(ctypes.addressof(cycles))
                for wg in range(2):
                    c = cycles[8 * wg:8 * wg + len(W_PHASES)]
                    print(f"B4 block 0 warpgroup {wg} cycles: " + ", ".join(
                        f"{p} {x}" for p, x in zip(W_PHASES, c))
                        + f", total {sum(c)}", flush=True)
            continue
        if name == "fused_deconv" and v.startswith("g_"):
            for case, op in small_ops.items():
                t = cs.graph_ms(lambda: b3(op))
                line = f"B3 {v} {case}: {t:.4f} ms"
                if v == "g_full":
                    Lp, Cp = op["cots"][0].shape
                    Cp = -(-Cp // 4) * 4
                    K = op["W2"].shape[0] // op["R"]
                    p = D._hgrad_plan(op["R"], op["L_h"], Cp, K,
                                      D._geom_args(K, op["geom"]), sms)
                    tc = D._tc_plan(op["R"], op["L_h"], Cp, K, sms)
                    line += (f" (rel err {rel_err(b3(op), op):.3g}; {p}); the "
                             f"tc kernel {cs.graph_ms(lambda: b3(op, tc)):.4f} ms")
                print(line + " (device, graph replays)", flush=True)
            continue
        if name == "fused_deconv":
            op = ops["R=88"]
            t = ms(lambda: b3(op), 5)
            print(f"B3 {v} R=88: {t:.4f} ms", flush=True)
            continue
        if v in ("mu_full", "mu_cvt"):
            t1 = ms(lambda: [fm.fused_contractions(V, H, W, beta=0.5, need_pos=True,
                                                   w_side=ws) for ws in (True, False)], 20)
            t2 = ms(lambda: fm.fused_beta_loss(V, H, W, 0.5), 20)
            print(f"B1 {v} W+H beta=0.5: {t1:.4f} ms; B2 {v}: {t2:.4f} ms",
                  flush=True)
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
