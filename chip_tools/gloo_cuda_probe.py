#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors as they are.

    python3 chip_tools/gloo_cuda_probe.py

For each operation (``all_reduce``, ``all_gather``, ``batch_isend_irecv``,
``all_gather_into_tensor`` and ``DTensor.full_tensor`` of a row-sharded
DTensor on a ``"cuda"`` mesh, which runs the latter) starts 2 gloo ranks that share card 0 and run it once on CUDA tensors with
known values, in a process group of its own (an operation that crashes a
rank cannot take the others with it).  Prints one line per operation:
``ok`` (right values), ``wrong`` (it ran, the values are not the expected
ones) or ``failed`` (it raised, or a rank died or hung), with the error's
last line.  ``pytorch_nmf_tpu_torch/parallel/comm.py`` stages through
pinned host memory what this does not print ``ok`` for and the fits use
(on an H100 with torch 2.11: the send and receive of the halo shifts).
There ``all_gather_into_tensor`` and ``full_tensor`` fail as well, so a
card DTensor of a gloo mesh is gathered through a ``"cpu"`` mesh (as
``tests/_torch_parallel_child.py`` does).  Needs one card.
"""

import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "all_gather", "batch_isend_irecv",
       "all_gather_into_tensor", "full_tensor")
TIMEOUT_S = 120


def _rank(rank, world, store, op, out):
    torch.cuda.set_device(0)
    from datetime import timedelta

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        n = 1 << 20
        x = torch.full((n,), float(rank + 1), device="cuda")
        if op == "all_reduce":
            dist.all_reduce(x)
            good = bool((x == sum(range(1, world + 1))).all())
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            good = all(bool((p == r + 1).all()) for r, p in enumerate(parts))
        elif op == "all_gather_into_tensor":
            out = torch.empty(world * n, device="cuda")
            dist.all_gather_into_tensor(out, x)
            good = all(bool((p == r + 1).all())
                       for r, p in enumerate(out.chunk(world)))
        elif op == "full_tensor":
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import DTensor, Shard

            mesh = init_device_mesh("cuda", (world,))
            full = DTensor.from_local(x, mesh, [Shard(0)]).full_tensor()
            good = all(bool((p == r + 1).all())
                       for r, p in enumerate(full.chunk(world)))
        else:
            recv = torch.zeros_like(x)
            ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
                   dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            good = bool((recv == (rank - 1) % world + 1).all())
        torch.cuda.synchronize()
        msg = "ok" if good else "wrong"
    except Exception as e:  # the probe reports what the operation raised
        msg = "failed: " + traceback.format_exception_only(e)[-1].strip()
    with open(f"{out}.{rank}", "w") as f:
        f.write(msg)
    dist.destroy_process_group()


def probe(op: str) -> str:
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out")
        ctx = mp.start_processes(_rank, (2, os.path.join(d, "store"), op, out),
                                 nprocs=2, join=False, start_method="spawn")
        import time

        deadline = time.monotonic() + TIMEOUT_S
        try:
            # join returns False while any rank still runs
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    return f"failed: hung for {TIMEOUT_S} s"
        except Exception as e:  # a rank that died: report, do not stop
            died = traceback.format_exception_only(e)[-1].strip()
            return f"failed: a rank died ({died})"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        results = []
        for r in range(2):
            path = f"{out}.{r}"
            results.append(open(path).read() if os.path.exists(path)
                           else "failed: no result")
        bad = [m for m in results if m != "ok"]
        return bad[0] if bad else "ok"


def main():
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_probe: no CUDA device")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for op in OPS:
        print(f"gloo {op} on CUDA tensors: {probe(op)}", flush=True)


if __name__ == "__main__":
    main()
