"""The device memory a graphed fit leaves behind, on the card.

    python chip_tools/graph_memory.py                  # from the repository root
    python chip_tools/graph_memory.py --keep-workspaces

Three graphed 40-iteration fits each of dense ``NMF`` 5168×1025 R=88 (β=1,
on B1) and ``SIPLCA`` 1×513×3000 R=64 T=200 (on B3/B4), on one target each
(the first fit a cold miss of the fits' cache, the others hits), then
three ``BetaMu`` optimizers over the 2048² chain (5 steps each, each
optimizer dropped after), from numpy seed 0: the allocated and reserved
MiB before and after each, the peak above the start, the bytes the fits'
cache holds after it (``solver.compiled_cache_info``), and the capture's
host ms, of it the chunk's own host code; then the allocated memory before
and after clearing cuBLAS's workspaces and after
``solver.compiled_cache_clear``, and the reserved memory after
``torch.cuda.empty_cache``.  ``--keep-workspaces`` turns the capture's
dropping of cuBLAS's per-stream workspaces (``ops/graphs.py``) off, to
show what it prevents.  Prints the card's name and power limit.  Needs one
CUDA device.
"""

import gc
import os
import sys
import time


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import graphs, solver
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.trainer import BetaMu
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    if not torch.cuda.is_available():
        sys.exit("graph_memory: needs a CUDA device")
    os.environ["PNT_NMFD_AUTOTUNE"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    clear = torch._C._cuda_clearCublasWorkspaces
    if "--keep-workspaces" in sys.argv[1:]:
        torch._C._cuda_clearCublasWorkspaces = lambda: None
    card = cs.card_line()
    load_all()

    split = {}
    capture = graphs._Graphs._capture

    def timed_capture(self, fn):
        def inner():
            t0 = time.perf_counter()
            fn()
            split["fn"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        g = capture(self, inner)
        split["total"] = time.perf_counter() - t0
        return g

    graphs._Graphs._capture = timed_capture

    def mem():
        torch.cuda.synchronize()
        gc.collect()
        return (torch.cuda.memory_allocated() / 2**20,
                torch.cuda.memory_reserved() / 2**20)

    V, W, H = cs.inputs(*cs.MAIN_SHAPE)
    pr = cs.plca_problem(*cs.SIPLCA_ROWS["SIPLCA"])
    Vs = torch.from_numpy(pr.pop("V")).cuda()
    for label in ("NMF beta=1", "SIPLCA"):
        for rep in range(3):
            if label == "SIPLCA":
                m = plca_from_numpy(pr, "cuda")
                X, kw = Vs, {}
            else:
                m = nmf_from_numpy({"W": W.cpu().numpy(),
                                    "H": H.cpu().numpy()}, "cuda")
                X, kw = V, {"beta": 1}
            a0, r0 = mem()
            torch.cuda.reset_peak_memory_stats()
            m.fit(X, tol=0, max_iter=40, **kw)
            peak = torch.cuda.max_memory_allocated() / 2**20 - a0
            a1, r1 = mem()
            held = solver.compiled_cache_info()["held_bytes"] / 2**20
            print(f"{label} fit {rep}: allocated {a0:.1f} -> {a1:.1f} MiB, "
                  f"reserved {r0:.1f} -> {r1:.1f}, peak above the start "
                  f"{peak:.1f}, the fits' cache holding {held:.1f} after; "
                  f"capture {1e3 * split.pop('total', 0.0):.1f} ms, of it "
                  f"the chunk's host code {1e3 * split.pop('fn', 0.0):.1f} "
                  f"[{card}]", flush=True)
            del m
    (M0, K0), rank, W2, W3 = cs.CHAIN
    target = torch.rand(M0, W3[0], device="cuda")
    for rep in range(3):
        g = torch.Generator("cuda").manual_seed(cs.SEED)
        chain = torch.nn.Sequential(
            NMF((M0, K0), rank=rank, device="cuda", generator=g),
            NMF(W=W2, device="cuda", generator=g),
            NMF(W=W3, device="cuda", generator=g))
        tr = BetaMu(chain.parameters(), 1)
        a0, r0 = mem()
        tr.run(lambda: (target, chain(None)), 5)
        del tr, chain
        a1, r1 = mem()
        print(f"BetaMu optimizer {rep}: allocated {a0:.1f} -> {a1:.1f} MiB, "
              f"reserved {r0:.1f} -> {r1:.1f} [{card}]", flush=True)
    a, r = mem()
    clear()
    b, _ = mem()
    solver.compiled_cache_clear()
    c, _ = mem()
    torch.cuda.empty_cache()
    _, r2 = mem()
    print(f"at the end: allocated {a:.1f} MiB, {b:.1f} after clearing "
          f"cuBLAS's workspaces, {c:.1f} after emptying the fits' cache; "
          f"reserved {r:.1f}, {r2:.1f} after empty_cache [{card}]",
          flush=True)


if __name__ == "__main__":
    main()
