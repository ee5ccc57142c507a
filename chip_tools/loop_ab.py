"""The compiled fits' warm time, device time, idle share, host reads and
held bytes at every cache cell of one tree of this repository, for
comparing two commits on one card (the chunk loop replayed a chunk at a
time against one WHILE node).

    python chip_tools/loop_ab.py LABEL      # from the root of the tree

Unpack the other commit (``git archive``) into a git-ignored directory,
copy this script into it, and run both trees in turns (old, new, new, old)
in one call on one card.  For each of the tree's ``chip_smoke.COMPILED_CELLS``
(numpy seed 0, the cell's target and inits as ``chip_smoke`` makes them)
and ``nmf_fit_batched`` at β=1 over 16 problems of 1025×400 R=16: a cold
fit of 100 iterations at ``tol=0`` through the model's ``fit``, then
three warm fits (cache hits) from the same inits timed with CUDA events,
the cache's held bytes, the replays and host reads of a warm fit, and the
device time an iteration of a warm fit from a ``torch.profiler`` trace
(``chip_smoke.fit_profile``, after a first profiler session on other
work), the idle share against the fastest warm fit.  Prints one line
``AB {json}`` and the card's name and power limit.  Needs one CUDA device.
"""

import json
import os
import sys

ITERS = 100


def main(label):
    sys.path.insert(0, os.getcwd())  # the tree being measured
    import torch

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch.ops import graphs
    from pytorch_nmf_tpu_torch.ops._build import load_all

    if not torch.cuda.is_available():
        sys.exit("loop_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["PNT_NMFD_AUTOTUNE"] = "0"
    load_all()
    ns = cs.namespace()
    solver, G = ns.solver, graphs._Graphs
    out = {"tree": label, "card": cs.card_line(), "cells": {}}
    # a first profiler session in a process has been seen to miss kernels
    # of a WHILE node's body (one chunk of ten): profile something first
    cs.fit_profile(lambda: torch.ones(1, device="cuda").add_(1), 1)

    def measure(name, fit, reset):
        solver.compiled_cache_clear()
        reset()
        fit()  # cold
        torch.cuda.synchronize()
        rec = {"warm_ms_per_iter": []}
        for _ in range(3):
            reset()
            r0, h0 = G.replays, solver._read.reads
            _, ms = cs.events_ms(fit)
            rec["warm_ms_per_iter"].append(ms / ITERS)
            rec["replays"], rec["host_reads"] = (G.replays - r0,
                                                 solver._read.reads - h0)
        rec["held_bytes"] = solver.compiled_cache_info()["held_bytes"]

        def warm():
            reset()
            fit()

        rec["device_ms_per_iter"] = cs.fit_profile(warm, ITERS)
        rec["idle_share"] = 1 - rec["device_ms_per_iter"] / min(
            rec["warm_ms_per_iter"])
        solver.compiled_cache_clear()
        out["cells"][name] = rec
        print(f"{label} {name}: {rec}", flush=True)

    for cell, name, shape, kw in cs.COMPILED_CELLS:
        V, m = cs.compiled_problem(ns, name, shape)
        params = [getattr(m, k) for k in ("W", "H", "Z") if hasattr(m, k)]
        init = [p.detach().clone() for p in params]

        def reset(params=params, init=init):
            for p, x in zip(params, init):
                p.data.copy_(x)

        if name == "PLCA":
            os.environ["PNT_PLCA_FUSED"] = "1"
        try:
            measure(cell, lambda m=m, V=V, kw=kw: m.fit(
                V, tol=0, max_iter=ITERS, **kw), reset)
        finally:
            os.environ.pop("PNT_PLCA_FUSED", None)
        del V, m, params, init

    V, W, H = cs.batched_problem(False)
    measure("batched NMF beta=1", lambda: ns.functional.nmf_fit_batched(
        V, W, H, beta=1, tol=0, max_iter=ITERS), lambda: None)
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
