"""Whether ``torch.distributed.destroy_process_group`` returns after a
compiled sharded fit over NCCL (C12), on one NCCL rank (or one a card with
``--cards``).

    python chip_tools/teardown_probe.py              # from the repository root
    python chip_tools/teardown_probe.py unrepaired repaired
    python chip_tools/teardown_probe.py --cards      # one rank a card (2-4)

Each case runs in processes of its own, killed past ``--timeout`` seconds
(120 by default; a rank still in the call after 90 s prints its Python
stack), and prints each rank's exit code and its last lines:

* ``unrepaired``: a compiled ``sharded_nmf_fit`` (1024×512 a rank, R=16,
  β=1, 50 iterations: chunks 1-2 eager, the capture, one replay) on a
  ``shard_target`` DTensor kept alive, so its entry stays in the fits'
  cache, then ``destroy_process_group`` as PyTorch has it (the function
  taken before the port could wrap it);
* ``repaired``: the same, then ``torch.distributed.destroy_process_group()``
  (the port's wrapper drops the group's entries first);
* ``cleared``: ``compiled_cache_clear()``, then PyTorch's function (the
  harness's workaround before the repair);
* ``eager``: the fit's ``_graph=False`` twin (no graph), then PyTorch's
  function;
* ``graph_kept`` and ``graph_reset``: no fit; a plain CUDA graph that
  captured three ``all_reduce`` calls of the group, replayed once, then
  kept alive (or reset) across PyTorch's function: whether a graph that
  captured the group's kernels alone holds the teardown.

On one rank NCCL's in-place all-reduce launches nothing (the plain graph
captures no node), so nothing of the group is in any graph: the cases
that can hang need two or more cards (``--cards``).

Prints the card's name and power limit.  Needs one CUDA device.
"""

import os
import subprocess
import sys
import time

CASES = ("unrepaired", "repaired", "cleared", "eager", "graph_kept",
         "graph_reset")

RANK = r'''
import faulthandler, sys, time
import numpy as np
import torch
import torch.distributed as dist

# PyTorch's own function, before the port's parallel package can wrap it
original = dist.distributed_c10d.destroy_process_group
sys.path.insert(0, ".")
from pytorch_nmf_tpu_torch.ops import graphs, solver
from pytorch_nmf_tpu_torch.ops._build import load_all
from pytorch_nmf_tpu_torch.parallel import (comm, distributed, make_mesh,
                                            shard_target, sharded_nmf_fit)
from pytorch_nmf_tpu_torch.parallel.sharded import placements

case, rank, world, store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
load_all()
distributed.initialize("file://" + store, world, rank, backend="nccl")
mesh = make_mesh({"data": world})
dev = torch.device("cuda", torch.cuda.current_device())
if case.startswith("graph"):
    c = comm.comm_for(mesh, "data")
    x = torch.ones(4096, device=dev)
    c.all_reduce(x)  # the group's first call, eager
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        g.capture_begin()
        for _ in range(3):
            c.all_reduce(x)
        g.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    g.replay()
    torch.cuda.synchronize()
    print("replayed, x[0] =", float(x[0]), flush=True)
    if case == "graph_reset":
        g.reset()
else:
    rs = np.random.RandomState(8)
    M, K, R = 1024 * world, 512, 16
    V = rs.rand(M, K).astype("f") + 0.01
    W = rs.rand(K, R).astype("f") + 0.1
    H = rs.rand(M, R).astype("f") + 0.1
    c0 = graphs._Graphs.captures
    # a target held across the call: its entry stays cached
    Vd = shard_target(V, mesh, placements(mesh, {0: "data"}))
    out = sharded_nmf_fit(Vd, W, H, mesh, beta=1, tol=0, max_iter=50,
                          _graph=case != "eager")
    torch.cuda.synchronize()
    print("fit n_iter", out[2], "captures", graphs._Graphs.captures - c0,
          "entries", solver.compiled_cache_info()["entries"], flush=True)
    if case == "cleared":
        solver.compiled_cache_clear()
destroy = dist.destroy_process_group if case == "repaired" else original
faulthandler.dump_traceback_later(90, exit=True)
t0 = time.perf_counter()
destroy()
faulthandler.cancel_dump_traceback_later()
print(f"destroy_process_group returned in {time.perf_counter() - t0:.3f} s; "
      f"entries {solver.compiled_cache_info()['entries']}", flush=True)
'''


def run_case(case, world, timeout):
    """``(exit codes, last output lines, seconds)`` of ``case`` on
    ``world`` ranks, each killed past ``timeout`` seconds (exit -9)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK, case, str(r), str(world), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=os.getcwd()) for r in range(world)]
        deadline = time.monotonic() + timeout
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + f"\n[killed past {timeout} s]")
    tails = [" / ".join(o.strip().splitlines()[-6:]) for o in outs]
    return [p.returncode for p in procs], tails, time.perf_counter() - t0


def main():
    import torch

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    timeout = 120
    for a in sys.argv[1:]:
        if a.startswith("--timeout="):
            timeout = int(a.split("=", 1)[1])
    world = min(torch.cuda.device_count(), 4) if "--cards" in sys.argv else 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for case in args or CASES:
        codes, tails, s = run_case(case, world, timeout)
        print(f"{case} ({world} NCCL rank(s)): exit {codes} in {s:.1f} s; "
              + " | ".join(tails) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
