"""The rank processes of the port's multi-process tests on the CPU.

``run_group(workdir, world, cases, arrays)`` (called by a test module's
fixture) writes the cases and their numpy inputs under ``workdir``, starts
``world`` processes of this file, each a gloo rank initialized through a
``file://`` store in ``workdir`` (no port, so parallel test workers never
race for one), waits for all of them with a timeout and returns each
rank's results.  A rank that fails or hangs fails the group.

Each rank runs every case in order: a case names its mesh (``axes``; a
mesh of fewer ranks than the world leaves the others idle for that case;
``device``, ``"cpu"`` unless ``"cuda"``: the ranks then share card 0),
the fit (``kind``) and its keyword arguments (the inputs named in ``bf16``
go in as bfloat16 tensors); the factors come back whole
(``DTensor.full_tensor``), with ``n_iter``, the kernels' launches and
any counts, on every rank of the mesh.  A halo fit's case may force its
per-shard ``mode`` (through the private fits' ``mode`` argument), set
environment variables (``env``, and ``rank_env`` per rank) and fix what
the mode tuner's timing returns on each rank (``prefer``); the mode each
rank ran comes back as ``mode``, with the tuner's calls on that rank.
The port only: nothing here imports JAX.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_group(workdir, world: int, cases, arrays, timeout: float = 240.0):
    """Run ``cases`` over ``world`` gloo ranks; returns ``[results of rank
    r]``, each ``{case name: {key: array}}``."""
    workdir = Path(workdir)
    (workdir / "cases.json").write_text(json.dumps(cases))
    np.savez(workdir / "inputs.npz", **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(workdir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            logs[r][-4000:] for r in failed if r < len(logs)))
    results = []
    for r in range(world):
        with np.load(workdir / f"out{r}.npz") as f:
            res = {}
            for key in f.files:
                case, name = key.split(":", 1)
                res.setdefault(case, {})[name] = f[key]
            results.append(res)
    return results


# --------------------------------------------------------------------------
# the rank side
# --------------------------------------------------------------------------
def _spies(fused_mu, fused_deconv):
    """Wrap B1 and B4's wrappers to record whether a call ran the β=1
    epilogue, and on which side, and B3's to count its calls; returns the
    record."""
    seen = {"b1_w": 0, "b1_h": 0, "b1_w_epilogue": 0, "b1_h_epilogue": 0,
            "b3": 0, "b4": 0, "b4_epilogue": 0}
    b1, b3, b4 = (fused_mu.fused_contractions, fused_deconv.hgrad,
                  fused_deconv.wgrad)

    def spy_b1(V, H, W, *, w_side, mu_pos=None, **kw):
        side = "b1_w" if w_side else "b1_h"
        seen[side] += 1
        seen[side + "_epilogue"] += mu_pos is not None
        return b1(V, H, W, w_side=w_side, mu_pos=mu_pos, **kw)

    def spy_b4(cots, H2, R, T, mu_w2=None, mu_pos=None, **kw):
        seen["b4"] += 1
        seen["b4_epilogue"] += mu_w2 is not None
        return b4(cots, H2, R, T, mu_w2, mu_pos, **kw)

    def spy_b3(*args, **kw):
        seen["b3"] += 1
        return b3(*args, **kw)

    fused_mu.fused_contractions = spy_b1
    fused_deconv.hgrad = spy_b3
    fused_deconv.wgrad = spy_b4
    return seen, lambda: (setattr(fused_mu, "fused_contractions", b1),
                          setattr(fused_deconv, "hgrad", b3),
                          setattr(fused_deconv, "wgrad", b4))


def _watch_modes(case, rank, halo, autotune):
    """Record the per-shard mode each fit of the case resolved and the
    tuner's calls on this rank; under ``prefer`` the tuner returns this
    rank's preferred mode untimed.  Returns ``(record, undo)``."""
    seen = {"modes": [], "tune_calls": 0}
    resolve, tune = halo._resolve_halo_mode, autotune._tune
    prefer = case.get("prefer", {}).get(str(rank))

    def spy_resolve(*args, **kw):
        mode = resolve(*args, **kw)
        seen["modes"].append(mode)
        return mode

    def fake_tune(key, cands, make_run, device):
        seen["tune_calls"] += 1
        assert prefer in dict(cands), (prefer, cands)
        return prefer

    halo._resolve_halo_mode = spy_resolve
    if prefer is not None:
        autotune._tune = fake_tune
    return seen, lambda: (setattr(halo, "_resolve_halo_mode", resolve),
                          setattr(autotune, "_tune", tune))


def _run_case(case, arrays, mesh, cpu_mesh):
    import torch
    import torch.distributed as dist

    from pytorch_nmf_tpu_torch.ops import autotune, fused_deconv, fused_mu
    from pytorch_nmf_tpu_torch.ops.sparse import sparse_from_dense
    from pytorch_nmf_tpu_torch import parallel as par
    from pytorch_nmf_tpu_torch.parallel import halo

    kind, kw = case["kind"], dict(case.get("kw", {}))
    mode = case.get("mode")

    def a(key):
        x = arrays[f"{case['name']}:{key}"]
        # the inputs the case names under ``bf16`` go in as bfloat16 tensors
        return torch.from_numpy(x).bfloat16() if key in case.get("bf16", ()) \
            else x

    def full(x):
        # a card DTensor is gathered on the CPU: gloo's all_gather into one
        # tensor does not take card tensors
        if x.device.type != "cpu":
            from torch.distributed.tensor import DTensor

            x = DTensor.from_local(x.to_local().cpu(), cpu_mesh, x.placements,
                                   shape=x.shape, stride=x.stride())
        return x.full_tensor().numpy()

    out = {}
    spy = None
    if case.get("spy"):
        spy, undo = _spies(fused_mu, fused_deconv)
    rank = dist.get_rank()
    env = dict(case.get("env", {}), **case.get("rank_env", {}).get(str(rank),
                                                                   {}))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    autotune.clear_cache()
    watch, unwatch = _watch_modes(case, rank, halo, autotune)
    wrappers = (fused_mu.fused_contractions, fused_mu.fused_beta_loss,
                fused_deconv.hgrad, fused_deconv.wgrad)
    before = [getattr(w, "launches", 0) for w in wrappers]
    try:
        if kind == "nmf":
            W, H, n = par.sharded_nmf_fit(a("V"), a("W"), a("H"), mesh, **kw)
            out.update(W=full(W), H=full(H), n_iter=n)
            if case.get("bf16"):  # the dtype each rank keeps its block in
                pls = par.sharded.placements(mesh, {0: "data"})
                out["v_local_bf16"] = par.shard_target(
                    a("V"), mesh, pls).to_local().dtype == torch.bfloat16
        elif kind == "plca":
            W, H, Z, n, norm = par.sharded_plca_fit(
                a("V"), a("W"), a("H"), a("Z"), mesh, **kw)
            out.update(W=full(W), H=full(H), Z=full(Z), n_iter=n, norm=norm)
        elif kind == "sparse":
            V = sparse_from_dense(a("V"))
            W, H, n = par.sharded_sparse_nmf_fit(V, a("W"), a("H"), mesh, **kw)
            out.update(W=full(W), H=full(H), n_iter=n)
        elif kind == "deconv" and mode is not None:
            W, H, n = halo._sharded_deconv_fit(
                a("V"), a("W"), a("H"), mesh, case["nd"], mode=mode, **kw)
            out.update(W=full(W), H=full(H), n_iter=n)
        elif kind == "deconv":
            fit = {1: par.sharded_nmfd_fit, 2: par.sharded_nmf2d_fit,
                   3: par.sharded_nmf3d_fit}[case["nd"]]
            W, H, n = fit(a("V"), a("W"), a("H"), mesh, **kw)
            out.update(W=full(W), H=full(H), n_iter=n)
        elif kind == "siplca":
            if mode is not None:
                W, H, Z, n, norm = halo._sharded_siplca_fit(
                    a("V"), a("W"), a("H"), a("Z"), mesh, case["nd"],
                    mode=mode, **kw)
            else:
                fit = {1: par.sharded_siplca_fit, 2: par.sharded_siplca2_fit,
                       3: par.sharded_siplca3_fit}[case["nd"]]
                W, H, Z, n, norm = fit(a("V"), a("W"), a("H"), a("Z"), mesh,
                                       **kw)
            out.update(W=full(W), H=full(H), Z=full(Z), n_iter=n, norm=norm)
        elif kind == "single":
            out.update(_single(case, a, kw, case.get("device", "cpu")))
        elif kind == "halo_ops":
            out.update(_halo_ops(a, mesh, halo, par, torch, dist))
        elif kind == "halo_strip_ops":
            out.update(_halo_strip_ops(a, mesh, halo, par, torch))
        elif kind == "mesh_error":
            try:
                par.make_mesh({"data": dist.get_world_size() + 1}, "cpu")
            except ValueError as e:
                out["raised"] = np.frombuffer(str(e).encode(), np.uint8)
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    finally:
        unwatch()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if spy is not None:
            undo()
    if spy is not None:
        out.update({k: v for k, v in spy.items()})
    if watch["modes"]:
        out.update(mode=watch["modes"][-1], tune_calls=watch["tune_calls"])
    # the kernels' launches (none on CPU tensors: the plain versions run)
    out["launches"] = [getattr(w, "launches", 0) - b
                       for w, b in zip(wrappers, before)]
    return out


def _single(case, a, kw, device):
    """The port's single-card fit (on ``device``) of the whole problem,
    run by rank 0 alone."""
    import torch

    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    model = case["model"]
    V = torch.from_numpy(a("V")).to(device)
    if model in ("NMF", "NMFD", "NMF2D", "NMF3D"):
        m = nmf_from_numpy({"W": a("W"), "H": a("H")}, device)
        assert type(m).__name__ == model, type(m).__name__
        n = m.fit(V, **kw)
        return {"W": m.W.detach().cpu().numpy(),
                "H": m.H.detach().cpu().numpy(), "n_iter": n}
    m = plca_from_numpy({"W": a("W"), "H": a("H"), "Z": a("Z")}, device)
    assert type(m).__name__ == model, type(m).__name__
    n, norm = m.fit(V, **kw)
    return {"W": m.W.detach().cpu().numpy(), "H": m.H.detach().cpu().numpy(),
            "Z": m.Z.detach().cpu().numpy(), "n_iter": n,
            "norm": float(norm)}


def _halo_ops(a, mesh, halo, par, torch, dist):
    """``left_halo`` and ``halo_adjoint`` of the rank's chunk of ``x`` and
    ``g``; the autograd adjoint; the two inner products summed over the
    ranks."""
    comm = par.comm.comm_for(mesh, "seq")
    x, g = (torch.from_numpy(a(k)) for k in ("x", "g"))
    hw = int(a("halo"))
    L = x.shape[-1] // comm.size
    xl = x[..., comm.rank * L:(comm.rank + 1) * L].contiguous()
    gl = g[..., comm.rank * (L + hw):(comm.rank + 1) * (L + hw)].contiguous()
    xr = xl.clone().requires_grad_(True)
    y = halo.left_halo(xr, hw, mesh, "seq")
    (ag,) = torch.autograd.grad(y, xr, gl)
    adj = halo.halo_adjoint(gl, hw, mesh, "seq")
    ip = torch.stack([torch.sum(y.detach() * gl), torch.sum(xl * adj)])
    comm.all_reduce(ip)
    return {"left": torch.cat(comm.all_gather(y.detach()), -1).numpy(),
            "adjoint": torch.cat(comm.all_gather(adj), -1).numpy(),
            "autograd": torch.cat(comm.all_gather(ag), -1).numpy(),
            "inner": ip.numpy()}


def _halo_strip_ops(a, mesh, halo, par, torch):
    """``halo_recv`` of the rank's chunk of ``x`` and ``halo_adjoint_strip``
    of its chunks of ``gh`` and ``gr``; the autograd adjoint of
    ``halo_recv`` (with a zero ``gh``); the inner products ⟨recv, gr⟩ and
    ⟨x, strip(0, gr)⟩ summed over the ranks."""
    comm = par.comm.comm_for(mesh, "seq")
    hw = int(a("halo"))

    def chunk(key, width):
        v = torch.from_numpy(a(key))
        return v[..., comm.rank * width:(comm.rank + 1) * width].contiguous()

    L = a("x").shape[-1] // comm.size
    xl, gh, gr = chunk("x", L), chunk("gh", L), chunk("gr", hw)
    xr = xl.clone().requires_grad_(True)
    recv = halo.halo_recv(xr, hw, mesh, "seq")
    (ag,) = torch.autograd.grad(recv, xr, gr)
    strip = halo.halo_adjoint_strip(gh, gr, hw, mesh, "seq")
    adj0 = halo.halo_adjoint_strip(torch.zeros_like(gh), gr, hw, mesh, "seq")
    ip = torch.stack([torch.sum(recv.detach() * gr), torch.sum(xl * adj0)])
    comm.all_reduce(ip)
    return {"recv": torch.cat(comm.all_gather(recv.detach()), -1).numpy(),
            "strip": torch.cat(comm.all_gather(strip), -1).numpy(),
            "autograd": torch.cat(comm.all_gather(ag), -1).numpy(),
            "adjoint0": torch.cat(comm.all_gather(adj0), -1).numpy(),
            "inner": ip.numpy()}


def _rank_main(rank: int, world: int, workdir: Path):
    import faulthandler

    import torch

    faulthandler.enable()
    torch.set_num_threads(1)
    from pytorch_nmf_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(f"file://{workdir / 'store'}", world, rank,
                           backend="gloo", timeout_s=120)
    cases = json.loads((workdir / "cases.json").read_text())
    results = {}
    meshes = {}
    with np.load(workdir / "inputs.npz") as f:
        arrays = {k: f[k] for k in f.files}
    for case in cases:
        device = case.get("device", "cpu")
        axes = tuple(case["axes"].items())
        if (axes, device) not in meshes:
            meshes[axes, device] = make_mesh(dict(axes), device)
        mesh = meshes[axes, device]
        if (axes, "cpu") not in meshes:
            meshes[axes, "cpu"] = make_mesh(dict(axes), "cpu")
        if mesh.get_coordinate() is None and case["kind"] != "mesh_error":
            continue
        print(f"rank {rank}: {case['name']}", flush=True)
        for key, val in _run_case(case, arrays, mesh,
                                  meshes[axes, "cpu"]).items():
            results[f"{case['name']}:{key}"] = np.asarray(val)
    np.savez(workdir / f"out{rank}.npz", **results)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
