"""Multi-device NMF: data x model mesh with explicit collectives.

The PyTorch/CUDA port's counterpart of ``examples/multi_device_fit.py``.
One process per rank on ``torch.distributed``:

1. the explicit sharded fit (``sharded_nmf_fit``: all-reduced MU
   contractions; the ``fused_contractions`` kernel per rank on the card),
   cross-checked against a single-device fit;
2. the model API on a sharded target: ``NMF.fit`` given a ``DTensor``
   (``shard_target``) routes to the same sharded fit, as the JAX example's
   annotation path does;
3. the row-sharded sparse target (``sharded_sparse_nmf_fit``);
4. the sequence-parallel deconvolution (halo exchange), MU and EM, and
   ``NMFD.fit`` on a target sharded along its trailing axis, which routes
   to the same halo fit.

With an even number of ranks above 2 the mesh is ``data`` × ``model`` (2
wide), else ``data`` alone, as there.

Run, one process per card:
    torchrun --nproc-per-node 4 examples/torch_port/multi_device_fit.py
or on the CPU (gloo):
    torchrun --nproc-per-node 4 examples/torch_port/multi_device_fit.py \
        --device cpu
Run bare, the script starts ``--world`` gloo ranks itself (2 by default;
with ``--device cuda`` they share the card).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)


def run_rank(device="cuda", verbose=True):
    """The example on this rank of the started process group; returns the
    printed numbers."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from pytorch_nmf_tpu_torch import sparse_from_dense
    from pytorch_nmf_tpu_torch.metrics import kl_div
    from pytorch_nmf_tpu_torch.nmf import NMF, NMFD
    from pytorch_nmf_tpu_torch.parallel import (
        make_mesh,
        shard_target,
        sharded_nmf_fit,
        sharded_nmfd_fit,
        sharded_siplca_fit,
        sharded_sparse_nmf_fit,
    )
    from pytorch_nmf_tpu_torch.plca import SIPLCA

    n = dist.get_world_size()
    say = print if verbose and dist.get_rank() == 0 else (lambda *a: None)
    say(f"{n} ranks on {device} ({dist.get_backend()})")

    def meshes(axes):
        """The mesh, and its CPU twin: gloo gathers a card DTensor through
        the CPU (its all-gather takes no card tensor)."""
        return make_mesh(axes, device), make_mesh(axes, "cpu")

    def full(x, cpu_mesh):
        if x.device.type != "cpu" and dist.get_backend() == "gloo":
            x = DTensor.from_local(x.to_local().cpu(), cpu_mesh, x.placements,
                                   shape=x.shape, stride=x.stride())
        return x.full_tensor().cpu()

    if n % 2 == 0 and n > 2:
        mesh, cpu_mesh = meshes({"data": n // 2, "model": 2})
        model_axis = "model"
        rows = [Shard(0), Shard(1)]  # rows over "data", columns over "model"
    else:
        mesh, cpu_mesh = meshes({"data": n})
        model_axis = None
        rows = [Shard(0)]

    rng = np.random.RandomState(0)
    M, K, R = 512, 256, 16
    V = rng.rand(M, K).astype("f")
    W0 = rng.rand(K, R).astype("f") + 0.1
    H0 = rng.rand(M, R).astype("f") + 0.1
    out = {}

    # 1. explicit collectives
    W1, H1, n_iter = sharded_nmf_fit(
        V, W0, H0, mesh, beta=1, tol=1e-4, max_iter=200,
        model_axis=model_axis,
    )
    W1, H1 = full(W1, cpu_mesh), full(H1, cpu_mesh)
    out["n_iter"] = int(n_iter)
    out["kl"] = float(kl_div(NMF.reconstruct(H1, W1), torch.from_numpy(V)))
    say(f"sharded fit: {int(n_iter)} iterations, KL {out['kl']:.4f}")

    # 2. the model API: a DTensor target routes fit() to the sharded fit
    m = NMF(W=torch.from_numpy(W0), H=torch.from_numpy(H0), device=device)
    m.fit(shard_target(V, mesh, rows), 1, 1e-4, 200)
    W2 = full(m.W.detach(), cpu_mesh)  # m.W now holds a DTensor

    # 3. single-device reference
    ref = NMF(W=torch.from_numpy(W0), H=torch.from_numpy(H0), device=device)
    ref.fit(torch.from_numpy(V).to(device), 1, 1e-4, 200)
    W_ref = ref.W.detach().cpu()
    out["max_rel_delta"] = float((W1 - W_ref).abs().max() / W_ref.abs().max())
    out["max_rel_delta_model"] = float((W2 - W_ref).abs().max()
                                       / W_ref.abs().max())
    say("max |Δ|/max|W| explicit vs single:", out["max_rel_delta"])
    say("max |Δ|/max|W| model API vs single:", out["max_rel_delta_model"])

    # 4. distributed SPARSE target: rows sharded, dual-ELL per shard
    dmesh, _ = meshes({"data": n})
    V_sp = sparse_from_dense(np.where(V > 0.9, V, 0).astype("f"))
    _, _, n_sp = sharded_sparse_nmf_fit(
        V_sp, W0, H0, dmesh, beta=1, tol=1e-4, max_iter=200
    )
    out["n_iter_sparse"] = int(n_sp)
    say(f"sharded sparse fit: {int(n_sp)} iterations")

    # 5. sequence-parallel deconvolution (halo exchange) — MU and EM
    seq_mesh, seq_cpu_mesh = meshes({"seq": n})
    N, C, L_out, T = 1, 32, 16 * n, 6
    Vc = rng.rand(N, C, L_out).astype("f")
    Wc = rng.rand(C, R, T).astype("f") + 0.1
    Hc = rng.rand(N, R, L_out - T + 1).astype("f") + 0.1
    Wd, _, n_halo = sharded_nmfd_fit(
        Vc, Wc, Hc, seq_mesh, beta=1, tol=1e-4, max_iter=200
    )
    out["n_iter_halo"] = int(n_halo)
    say(f"halo NMFD fit: {int(n_halo)} iterations")

    # ...or, equivalently, through the model API: a target sharded along
    # its trailing axis routes fit() to the same halo fit (each rank reads
    # its own block of it)
    md = NMFD(W=torch.from_numpy(Wc), H=torch.from_numpy(Hc), device=device)
    md.fit(shard_target(Vc, seq_mesh, [Shard(2)]), 1, 1e-4, 200)
    Wd, Wm = full(Wd, seq_cpu_mesh), full(md.W.detach(), seq_cpu_mesh)
    out["max_rel_delta_halo_route"] = float((Wm - Wd).abs().max()
                                            / Wd.abs().max())
    say("max |Δ|/max|W| model-API halo route vs sharded_nmfd_fit:",
        out["max_rel_delta_halo_route"])

    # the EM fit takes the SIPLCA model's normalized factors
    sip = SIPLCA(W=torch.from_numpy(Wc), H=torch.from_numpy(Hc),
                 Z=torch.ones(R) / R, device="cpu")
    _, _, _, n_em, norm = sharded_siplca_fit(
        Vc, sip.W.detach(), sip.H.detach(), sip.Z.detach(), seq_mesh,
        tol=1e-4, max_iter=200,
    )
    out["n_iter_em"] = int(n_em) + 1
    out["em_norm"] = float(norm)
    say(f"halo SIPLCA EM: {int(n_em) + 1} iterations")
    return out


def _spawned_rank(rank, world, store, device, verbose):
    """A rank started by :func:`main`: gloo through a ``file://`` store;
    rank 0 writes the numbers next to it."""
    import torch.distributed as dist

    from pytorch_nmf_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{store}", world, rank, backend="gloo")
    try:
        out = run_rank(device, verbose)
        if rank == 0:
            with open(store + ".json", "w") as f:
                json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(device="cuda", world=2, verbose=True):
    """Under ``torchrun`` (its environment set): this rank's part, NCCL on
    cards and gloo on the CPU.  Otherwise start ``world`` gloo ranks of
    this script (sharing the card with ``device="cuda"``) and return rank
    0's numbers."""
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        import torch.distributed as dist

        from pytorch_nmf_tpu_torch.parallel import distributed

        distributed.initialize(backend="gloo" if device == "cpu" else None)
        try:
            return run_rank(device, verbose)
        finally:
            dist.destroy_process_group()
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--device", device,
             "--world", str(world), "--rank", str(r), "--store", store]
            + ([] if verbose else ["--quiet"]), cwd=ROOT, env=env)
            for r in range(world)]
        deadline = time.monotonic() + 600.0
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} failed")
        with open(store + ".json") as f:
            return json.load(f)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    ap.add_argument("--world", type=int, default=2,
                    help="ranks to start when run without torchrun")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--quiet", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        _spawned_rank(args.rank, args.world, args.store, args.device,
                      not args.quiet)
    else:
        main(args.device, args.world)
