"""Where the Hoyer projection kernel (P1, ``csrc/hoyer_proj.cu``) spends its
time: builds of the source with one part cut, timed against the whole
kernel at the repository's projection shapes.

    python chip_tools/p1_variants.py [VARIANT ...]   # from the repository root

With no argument every variant runs; else the named ones.  Each variant is
the source with a few lines replaced (its results are wrong on purpose;
only its time matters), built with the package's own ``nvcc`` flags into
``build/p1_variants/`` and launched through its own C entry point:

* ``full``: the kernel as it is, each column's own rounds; beside it the
  streaming regime (one block a column, every round through HBM) forced at
  every shape;
* ``r0``: no round (the load, the first sums and the store);
* ``r8``: exactly 8 rounds a column, each with both passes (no early stop),
  the reference for the cuts below;
* ``r8_nosum``: the same without the sums (each is one ``__syncthreads``);
* ``r8_nocluster``: the sums without their cluster step (no cluster barrier
  and no reads of the other CTAs' partials);
* ``r8_nocvt``: the products added to double sums without the conversion
  to double (their bits reinterpreted);
* ``r8_two``: a cluster of 16 CTAs of half the values at the NMFD W, two
  CTAs an SM (``__launch_bounds__(1024, 2)``);
* ``threads``: the whole kernel in one CTA a column at THREADS_PER_CTA
  threads, against the plan's count.

Every time is the mean of CUDA-graph replays of 20 launches (device time
with no host gaps), at the shapes of ``chip_smoke.py``'s P1 cases, from
``rand + 0.1`` to sparseness 0.5.  Needs one CUDA device.
"""

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pytorch_nmf_tpu_torch.ops import _build  # noqa: E402
from pytorch_nmf_tpu_torch.ops import projection as P  # noqa: E402

SHAPES = (("dense W", (1025, 88)), ("NMFD W", (1025, 88, 400)),
          ("NMF2D W", (512, 128, 64)))
REPS = 20

_LOOP = "  for (long long r = 0; r < rounds && !fin; ++r) {"
_FIXED = ("  const long long rounds = (long long)N + 2;\n" + _LOOP,
          "  const long long rounds = 8;\n" + _LOOP)
_NONE = ("  const long long rounds = (long long)N + 2;\n" + _LOOP,
         "  const long long rounds = 0;\n" + _LOOP)
_NO_STOP = ("    if (q[0] == 0.0) {\n      fin = true;\n      return;\n    }\n", "")
_NO_SUM = ("__device__ __forceinline__ void column_sum(double* q, Sums& sh, int& slot) {\n",
           "__device__ __forceinline__ void column_sum(double* q, Sums& sh, int& slot) {\n"
           "  __syncthreads();\n  if (q) return;\n")
_NO_CLUSTER = ("    cluster.sync();\n    if (warp == 0) {", "    if (false) {")
_NO_CVT = (("  q[0] += (double)mul(w, w);\n  q[1] += (double)mul(w, v);\n"
            "  q[2] += (double)mul(v, v);\n"),
           ("  q[0] += as_double(mul(w, w));\n  q[1] += as_double(mul(w, v));\n"
            "  q[2] += as_double(mul(v, v));\n"))
_NO_CVT_POS = ("      pos += (double)relu(vn);\n", "      pos += as_double(relu(vn));\n")
_AS_DOUBLE = ("// One term of the round's sums",
              "__device__ __forceinline__ double as_double(float x) {\n"
              "  return __hiloint2double(__float_as_int(x), 0);\n}\n"
              "__device__ __forceinline__ double as_double(double x) { return x; }\n"
              "// One term of the round's sums")
_TWO = ("__global__ void __launch_bounds__(1024)\n    hoyer_proj_resident(",
        "__global__ void __launch_bounds__(1024, 2)\n    hoyer_proj_resident(")

VARIANTS = {
    "full": (),
    "r0": (_NONE,),
    "r8": (_FIXED, _NO_STOP),
    "r8_nosum": (_FIXED, _NO_STOP, _NO_SUM),
    "r8_nocluster": (_FIXED, _NO_STOP, _NO_CLUSTER),
    "r8_nocvt": (_FIXED, _NO_STOP, _AS_DOUBLE, _NO_CVT, _NO_CVT_POS),
    "r8_two": (_FIXED, _NO_STOP, _TWO),
    "threads": (),
}
THREADS_PER_CTA = (64, 128, 256, 512, 1024)


def _replace_once(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"expected one occurrence of {old!r}")
    return text.replace(old, new)


def build(name):
    """Builds variant ``name`` and returns its library, attributes set."""
    text = (ROOT / "pytorch_nmf_tpu_torch/csrc/hoyer_proj.cu").read_text()
    for old, new in VARIANTS[name]:
        text = _replace_once(text, old, new)
    d = ROOT / "build" / "p1_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "hoyer_proj.cu").write_text(text)
    out = subprocess.run(
        [_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(d / "lib.so"),
         str(d / "hoyer_proj.cu")], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{out.stderr}")
    regs = [ln.strip() for ln in out.stderr.splitlines() if "registers" in ln]
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn, (argtypes, restype) in _build._SIGNATURES["hoyer_proj"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    optin = ctypes.c_int(0)
    if lib.pnt_hoyer_proj_setup(ctypes.byref(optin)) != 0:
        raise RuntimeError(f"setup failed on {name}")
    return lib, optin.value, regs


def launcher(lib, x, k1, k2, plan):
    """A function that launches ``lib``'s kernel on the columns of ``x``
    along axis 1 with ``plan``, into one output buffer."""
    R = x.shape[1]
    outer, inner = x.shape[0], math.prod(x.shape[2:])
    v = torch.empty_like(x)
    zero = torch.empty(x.shape, dtype=torch.uint8, device=x.device)

    def run():
        err = lib.pnt_hoyer_proj(
            x.data_ptr(), v.data_ptr(),
            zero.data_ptr() if plan.regime == "stream" else None,
            k1.data_ptr(), k2.data_ptr(), R, outer, inner, 0,
            P.REGIMES.index(plan.regime), plan.threads, plan.cluster,
            plan.slice, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({plan}): CUDA error {err}")
    return run, v


def main(names):
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    rs = np.random.RandomState(0)
    cases = []
    for label, shape in SHAPES:
        x = torch.from_numpy(rs.rand(*shape).astype("f") + 0.1).cuda()
        R = shape[1]
        N = x.numel() // R
        cols = x.movedim(1, 0).reshape(R, N)
        norms = torch.sqrt(torch.sum(cols * cols, dim=1))
        L1 = P.hoyer_l1_target(N, 0.5)
        _, rounds = P.plain_proj_rows(cols, L1 * norms, norms * norms,
                                      return_rounds=True)
        cases.append((label, x, (L1 * norms).contiguous(),
                      (norms * norms).contiguous(), float(rounds.double().mean())))
    for name in names:
        lib, optin, regs = build(name)
        print(f"{name}: {'; '.join(regs)}", flush=True)
        for label, x, k1, k2, rounds in cases:
            N = x.numel() // x.shape[1]
            plan = P._plan(N, 4, optin)
            if name == "threads":
                if plan.regime == "cta":
                    times = []
                    for t in THREADS_PER_CTA:
                        run, _ = launcher(lib, x, k1, k2, plan._replace(threads=t))
                        times.append(f"{t}: {cs.graph_ms(run, REPS):.4f}")
                    print(f"  {label} {tuple(plan)} ms by threads: "
                          f"{', '.join(times)}", flush=True)
                continue
            if name == "r8_two":
                if plan.regime != "cluster":
                    continue
                per_cta = -(-N // 16)
                slice_ = -(-per_cta // 32) * 32
                plan = P.Plan("cluster", 1024, 16, slice_, P._smem_bytes(slice_, 4))
            run, _ = launcher(lib, x, k1, k2, plan)
            line = (f"  {label} {tuple(x.shape)} {tuple(plan)} rounds "
                    f"{rounds:.2f}: {cs.graph_ms(run, REPS):.4f} ms")
            if name == "full":
                srun, _ = launcher(lib, x, k1, k2, P.Plan("stream", 1024, 1, 0, 0))
                line += (f"; streaming {cs.graph_ms(srun, REPS):.4f} ms; again "
                         f"{cs.graph_ms(run, REPS):.4f} ms")
            print(line, flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
