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
any counts, on every rank of the mesh (``events``: a verbose fit's progress
events on rank 0).  A ``compiled`` case runs ``steps`` on one set of
targets (:func:`_compiled`): fits on full arrays or DTensors (the fit's
own outputs fed back too), in-place writes through ``.data``, one rank's
cache cleared, the process group destroyed and made again.  A halo fit's case may force its
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


def run_group(workdir, world: int, cases, arrays, timeout: float = 240.0,
              backend: str = "gloo"):
    """Run ``cases`` over ``world`` ranks of ``backend`` (``"nccl"``: one
    card a rank); returns ``[results of rank r]``, each ``{case name: {key:
    array}}``."""
    workdir = Path(workdir)
    (workdir / "cases.json").write_text(json.dumps(cases))
    np.savez(workdir / "inputs.npz", **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(workdir), backend],
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
        if x.device_mesh.size() == 1:
            return x.to_local().cpu().numpy()
        # a card DTensor is gathered on the CPU: gloo's all_gather into one
        # tensor does not take card tensors
        if x.device.type != "cpu":
            from torch.distributed.tensor import DTensor

            x = DTensor.from_local(x.to_local().cpu(), cpu_mesh, x.placements,
                                   shape=x.shape, stride=x.stride())
        return x.full_tensor().numpy()

    out = {}
    spy = None
    events = []
    if case.get("events"):
        from pytorch_nmf_tpu_torch.ops import solver

        solver.push_progress_handler(lambda *e: events.append(e))
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
        elif kind == "deconv" and (mode is not None or "_graph" in kw):
            W, H, n = halo._sharded_deconv_fit(
                a("V"), a("W"), a("H"), mesh, case["nd"], mode=mode, **kw)
            out.update(W=full(W), H=full(H), n_iter=n)
        elif kind == "deconv":
            fit = {1: par.sharded_nmfd_fit, 2: par.sharded_nmf2d_fit,
                   3: par.sharded_nmf3d_fit}[case["nd"]]
            W, H, n = fit(a("V"), a("W"), a("H"), mesh, **kw)
            out.update(W=full(W), H=full(H), n_iter=n)
        elif kind == "siplca":
            if mode is not None or "_graph" in kw:
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
        elif kind == "strict_all_reduce":
            out.update(_strict_all_reduce(a, mesh, par, torch, dist))
        elif kind == "compiled":
            out.update(_compiled(case, a, mesh, full))
        elif kind == "route":
            out.update(_route(case, a, mesh, full))
        elif kind == "api":
            out.update(_api(case, a, mesh, full))
        elif kind == "mesh_error":
            try:
                par.make_mesh({"data": dist.get_world_size() + 1}, "cpu")
            except ValueError as e:
                out["raised"] = np.frombuffer(str(e).encode(), np.uint8)
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    finally:
        if case.get("events"):
            from pytorch_nmf_tpu_torch.ops import solver

            solver.pop_progress_handler()
            out["events"] = np.array(events, dtype=np.float64).reshape(-1, 3)
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


def _compiled(case, a, mesh, full):
    """The ``steps`` of a ``compiled`` case on one set of targets (made
    once: ``shard_target`` DTensors of ``V`` and ``H``, or a sparse ``V``):

    * ``{"do": "fit", "out": name, "inputs": "dtensor" | "full" |
      "other", "start": an earlier fit's name (its DTensor outputs fed
      back) or none, "graph": bool}`` (``full`` gathers the start;
      ``other`` is the full array ``V2``, another target of ``V``'s
      shape); its factors, ``n_iter`` (and ``norm``), the loops' host
      reads, the cache's hits, warm and cold misses, the all-reduces' and
      halo shifts' calls and bytes, the graphs' ``(replays, captures)``
      and B3/B4's launches come back as ``{name}_{key}``;
    * ``{"do": "scale"}``: ``V``'s values times 3 through ``.data`` (no
      version counter moves);
    * ``{"do": "clear", "ranks": [...]}``: those ranks empty their cache;
    * ``{"do": "single"}``: a single-card compiled fit of ``V`` (an
      ``NMF`` model at β=1, 30 iterations), its target kept for the rest
      of the case: an entry that holds no group;
    * ``{"do": "subgroup"}``: a process group of every rank made anew
      (``new_group``), a compiled fit on a mesh of it, then that group
      alone destroyed; the entries holding it (``sub_before``, ``sub_after``)
      and those holding another group (``others_before``,
      ``others_after``) come back;
    * ``{"do": "regroup"}``: every rank empties its cache (unless
      ``"clear": False``), destroys the process group, starts a new one
      (on the same backend) and makes the mesh again (the case spans the
      world); the cache's entries and those holding a group before and
      after ``destroy_process_group`` come back (``entries_before``,
      ``group_entries_before``, ``entries_after``,
      ``group_entries_after``).

    The halo fits (``nmfd``, a ``deconv`` of the case's ``nd``, and
    ``siplca``) run through the private fits, in the case's ``mode`` (none:
    resolved).  The case starts on an empty cache.  A step that raises ends
    the case: ``error`` holds its message."""
    import torch
    import torch.distributed as dist

    from pytorch_nmf_tpu_torch import parallel as par
    from pytorch_nmf_tpu_torch.ops import fused_deconv, graphs, solver
    from pytorch_nmf_tpu_torch.ops.sparse import sparse_from_dense
    from pytorch_nmf_tpu_torch.parallel import comm, halo as halo_fits
    from pytorch_nmf_tpu_torch.parallel.sharded import placements

    fit, kw, out = case["fit"], dict(case.get("kw", {})), {}
    model_axis = kw.get("model_axis")
    names = ("W", "H", "Z") if fit in ("plca", "siplca") else ("W", "H")
    halo = fit in ("nmfd", "siplca")
    nd = case.get("nd", 1)

    def targets(mesh):
        # the halo fits' V and H split along their trailing axis
        rows = placements(mesh, {1 + nd: "seq"} if halo else {0: "data"})
        if fit == "sparse":
            V = sparse_from_dense(a("V"))
        else:
            V = par.shard_target(a("V"), mesh, rows if halo else placements(
                mesh, {0: "data", 1: model_axis if fit == "nmf" else None}))
        return V, par.shard_target(a("H"), mesh, rows)

    def run(mesh, V, start, graph):
        # the eager twin alone passes _graph (the halo fits have none)
        fkw = dict(kw) if graph else dict(kw, _graph=False)
        if fit == "nmfd":
            W, H, n = halo_fits._sharded_deconv_fit(
                V, *start, mesh, nd, mode=case.get("mode"), **fkw)
            return {"W": W, "H": H, "n_iter": n}
        if fit == "siplca":
            W, H, Z, n, norm = halo_fits._sharded_siplca_fit(
                V, *start, mesh, nd, mode=case.get("mode"), **fkw)
            return {"W": W, "H": H, "Z": Z, "n_iter": n, "norm": norm}
        if fit == "nmf":
            W, H, n = par.sharded_nmf_fit(V, *start, mesh, **fkw)
            return {"W": W, "H": H, "n_iter": n}
        if fit == "sparse":
            W, H, n = par.sharded_sparse_nmf_fit(V, *start, mesh, **fkw)
            return {"W": W, "H": H, "n_iter": n}
        W, H, Z, n, norm = par.sharded_plca_fit(V, *start, mesh, **fkw)
        return {"W": W, "H": H, "Z": Z, "n_iter": n, "norm": norm}

    def counts():
        info = solver.compiled_cache_info()
        return [solver._read.reads, info["hits"], info["warm_misses"],
                info["cold_misses"], comm.stats.calls["all_reduce"],
                comm.stats.bytes["all_reduce"], comm.stats.calls["halo"],
                comm.stats.bytes["halo"], graphs._Graphs.replays,
                graphs._Graphs.captures, fused_deconv.hgrad.launches,
                fused_deconv.wgrad.launches]

    def holding(groups=None, other=False):
        """The cache's entries that hold a group (of ``groups``; with
        ``other``, one not of them)."""
        return sum(1 for e in list(solver._CACHE.entries.values())
                   if e.groups and (groups is None or bool(
                       e.groups - groups if other else e.groups & groups)))

    solver.compiled_cache_clear()
    Vd, Hd = targets(mesh)
    fits, kept = {}, []
    try:
        for step in case["steps"]:
            do = step["do"]
            if do == "fit":
                prev = fits.get(step.get("start"))
                if step["inputs"] in ("full", "other"):
                    V = (a("V2") if step["inputs"] == "other" else
                         sparse_from_dense(a("V")) if fit == "sparse"
                         else a("V"))
                    start = ([full(prev[k]) for k in names] if prev else
                             [a(k) for k in names])
                else:
                    V = Vd
                    start = ([prev[k] for k in names] if prev else
                             [a("W"), Hd] + ([a("Z")] if "Z" in names else []))
                before = counts()
                got = fits[step["out"]] = run(mesh, V, start,
                                              step.get("graph", True))
                delta = [x - y for x, y in zip(counts(), before)]
                for k, v in got.items():
                    out[f"{step['out']}_{k}"] = full(v) if k in names else v
                for k, v in zip(("reads", "hits", "warm", "cold", "ar_calls",
                                 "ar_bytes", "halo_calls", "halo_bytes"),
                                delta):
                    out[f"{step['out']}_{k}"] = v
                # (replays, captures) and B3/B4 launches
                out[f"{step['out']}_graphs"] = delta[8:10]
                out[f"{step['out']}_launches"] = delta[10:]
            elif do == "scale":
                vals = Vd._values() if fit == "sparse" else Vd.to_local()
                vals.data.mul_(3)
            elif do == "clear":
                if dist.get_rank() in step["ranks"]:
                    solver.compiled_cache_clear()
            elif do == "single":
                from pytorch_nmf_tpu_torch.utils import nmf_from_numpy

                device = case.get("device", "cpu")
                m = nmf_from_numpy({"W": a("W"), "H": a("H")}, device)
                kept.append(torch.from_numpy(a("V")).to(device))
                m.fit(kept[-1], beta=1, tol=0, max_iter=30)
            elif do == "subgroup":
                from torch.distributed.device_mesh import DeviceMesh

                sub = dist.new_group(list(range(dist.get_world_size())))
                sub_mesh = DeviceMesh.from_group(
                    sub, case.get("device", "cpu"),
                    mesh_dim_names=mesh.mesh_dim_names)
                Vs, Hs = targets(sub_mesh)
                kept.append(Vs)  # the entry's target
                run(sub_mesh, Vs, [a("W"), Hs] + (
                    [a("Z")] if "Z" in names else []), True)
                out["sub_before"] = holding({sub})
                out["others_before"] = holding({sub}, other=True)
                dist.destroy_process_group(sub)
                out["sub_after"] = holding({sub})
                out["others_after"] = holding({sub}, other=True)
            elif do == "regroup":
                if step.get("clear", True):
                    solver.compiled_cache_clear()
                world, rank = dist.get_world_size(), dist.get_rank()
                backend = dist.get_backend()
                out["entries_before"] = solver.compiled_cache_info()["entries"]
                out["group_entries_before"] = holding()
                dist.barrier()
                dist.destroy_process_group()
                out["entries_after"] = solver.compiled_cache_info()["entries"]
                out["group_entries_after"] = holding()
                par.distributed.initialize(
                    f"file://{_WORKDIR / ('store-' + case['name'])}", world,
                    rank, backend=backend, timeout_s=120)
                mesh = par.make_mesh(dict(case["axes"]),
                                     case.get("device", "cpu"))
                Vd, Hd = targets(mesh)
                out["regrouped"] = True
                # the collectives' Comm of the mesh made again is on the
                # new group (C10)
                axis = mesh.mesh_dim_names[0]
                out["regroup_comm_new"] = comm.comm_for(
                    mesh, axis).group is mesh.get_group(axis)
    except Exception:  # noqa: BLE001 (reported to the test)
        import traceback

        out["error"] = np.frombuffer(traceback.format_exc().encode(),
                                     np.uint8)
    return out


def _route(case, a, mesh, full):
    """A ``route`` case: the model API on a DTensor target.  The model
    (``model``: a class of ``models``, or ``PLCASub``, a PLCA with its own
    ``reconstruct``) is built from the case's arrays (``dtype``: float64
    factors and V), its ``trainable`` flags set; ``V`` becomes
    ``shard_target(V, mesh, pls)`` with ``pls`` from ``spec`` (the mesh
    dimension sharding each axis of ``V``, or none).  ``call`` says what
    runs on it: ``fit`` (the default), ``sparse_fit``, ``functional`` (the
    functional fit of the model's kind, on the case's arrays), ``raises``
    (``fit``, whose ``ValueError`` comes back as ``raised``), ``twice`` (a
    second ``fit`` on the model's own DTensor factors, on V placed as
    ``spec2`` where the case has it) or ``then_plain``
    (then a ``fit`` on the whole V as a plain tensor).  Back come the
    factors whole, ``n_iter`` (and ``norm``), the explicit fits the route
    called (``calls``: sharded NMF, sharded PLCA, halo MU, halo EM), the
    halo fits' gathers (``gathers``, ``halo.full_array``'s calls, and
    ``v_gathers``, those of a tensor of V's shape), the factors'
    placements, whether each is an ``nn.Parameter`` and its
    ``requires_grad``, and ``model()`` against the forward of a plain model
    holding the same values (``forward_err``).  With ``explicit`` the
    explicit fit the route should call runs too, on the full arrays (the
    model's start) with ``explicit``'s ``fn``, ``args`` after the mesh and
    keywords (``explicit_W`` ...); with ``single`` the
    port's plain single-card fit of the whole problem (``single_W`` ...)."""
    import torch

    from pytorch_nmf_tpu_torch import functional
    from pytorch_nmf_tpu_torch import parallel as par
    from pytorch_nmf_tpu_torch.models import nmf as nmf_models
    from pytorch_nmf_tpu_torch.models import plca as plca_models
    from pytorch_nmf_tpu_torch.parallel import halo, sharded
    from pytorch_nmf_tpu_torch.parallel.sharded import placements

    class PLCASub(plca_models.PLCA):
        @staticmethod
        def reconstruct(H, W, Z):
            return H @ (W * Z).T

    name, kw = case["model"], dict(case.get("kw", {}))
    cls = PLCASub if name == "PLCASub" else getattr(
        nmf_models if "PLCA" not in name else plca_models, name)
    em = issubclass(cls, plca_models.BaseComponent)
    names = ("W", "H", "Z") if em else ("W", "H")
    dtype = case.get("dtype", "float32")
    arr = {k: a(k).astype(dtype) for k in ("V",) + names}
    trainable = case.get("trainable", {})

    def model():
        return cls(**{k: torch.from_numpy(arr[k].copy()) for k in names},
                   **{f"trainable_{k}": v for k, v in trainable.items()},
                   device="cpu")

    spec = case["spec"]
    pls = placements(mesh, dict(enumerate(spec)))
    Vd = par.shard_target(torch.from_numpy(arr["V"]), mesh, pls)

    calls = [0, 0, 0, 0]
    gathered = []
    spied = [(sharded, "sharded_nmf_fit"), (sharded, "sharded_plca_fit"),
             (halo, "_sharded_deconv_fit"), (halo, "_sharded_siplca_fit")]
    originals = [getattr(m, f) for m, f in spied] + [halo.full_array]

    def counting(i, f):
        def spy(*args, **kwargs):
            calls[i] += 1
            return f(*args, **kwargs)
        return spy

    def gather(x):
        gathered.append(tuple(x.shape) == arr["V"].shape)
        return originals[-1](x)

    def fitted(m, out):
        ps = {k: getattr(m, k).detach() for k in names}
        got = {k: full(p) if hasattr(p, "to_local") else p.numpy()
               for k, p in ps.items()}
        if em:
            got.update(n_iter=out[0], norm=float(out[1]))
        else:
            got["n_iter"] = out
        return got

    m = model()
    try:
        for i, (mod, f) in enumerate(spied):
            setattr(mod, f, counting(i, originals[i]))
        halo.full_array = gather
        call = case.get("call", "fit")
        if call == "functional":
            fit = {"NMF": functional.nmf_fit, "NMFD": functional.nmfd_fit,
                   "PLCA": functional.plca_fit}[name]
            start = model()  # the model's start (PLCA's normalized)
            res = fit(Vd, *(getattr(start, k).detach() for k in names), **kw)
            got = {k: full(x) for k, x in zip(names, res)}
            got["n_iter"] = res[len(names)]
            if em:
                got["norm"] = float(res[-1])
            # the model's fit on the same start, bit for bit the same
            mm = model()
            ref = fitted(mm, mm.fit(Vd, **kw))
            for k in names:
                got[f"model_{k}"] = ref[k]
        elif call == "raises":  # the ranks' joint check of V
            try:
                m.fit(Vd, **kw)
                got = {"raised": np.zeros(0, np.uint8)}
            except ValueError as e:
                got = {"raised": np.frombuffer(str(e).encode(), np.uint8)}
        else:
            fit = m.sparse_fit if call == "sparse_fit" else m.fit
            out = fit(Vd, **kw)
            if call == "twice":  # on V again, or V placed as ``spec2``
                V2 = Vd if "spec2" not in case else par.shard_target(
                    torch.from_numpy(arr["V"]), mesh,
                    placements(mesh, dict(enumerate(case["spec2"]))))
                out = m.fit(V2, **kw)
            got = fitted(m, out)
            for k in names:
                p = getattr(m, k)
                got[f"{k}_placements"] = np.frombuffer(repr(
                    list(getattr(p, "placements", []))).encode(), np.uint8)
                got[f"{k}_is_param"] = isinstance(p, torch.nn.Parameter)
                got[f"{k}_requires_grad"] = p.requires_grad
            with torch.no_grad():
                whole = m()
                plain = model()
                for k in names:
                    getattr(plain, k).copy_(torch.from_numpy(got[k]))
                got["forward_err"] = float(
                    (whole - plain()).abs().max() / plain().abs().max())
            got["forward_dtensor"] = hasattr(whole, "to_local")
            if call == "then_plain":
                out = m.fit(torch.from_numpy(arr["V"]), **kw)
                got.update({f"plain_{k}": v for k, v in fitted(m, out).items()
                            if k in names})
                got["plain_dtensor"] = any(hasattr(getattr(m, k), "to_local")
                                           for k in names)
    finally:
        for (mod, f), orig in zip(spied, originals):
            setattr(mod, f, orig)
        halo.full_array = originals[-1]
    got.update(calls=calls, gathers=len(gathered), v_gathers=sum(gathered))
    if case.get("explicit") is not None:
        start = model()  # the start the model's fit had (PLCA's normalized)
        args = [arr["V"]] + [getattr(start, k).detach() for k in names]
        ekw = dict(case["explicit"])
        fn = ekw.pop("fn")
        res = (getattr(halo, fn) if fn.startswith("_") else
               getattr(par, fn))(*args, mesh, *ekw.pop("args", []), **ekw)
        for k, x in zip(names, res):
            got[f"explicit_{k}"] = full(x)
        got["explicit_n_iter"] = res[len(names)]
    if case.get("single"):
        s = model()
        V = torch.from_numpy(arr["V"])
        out = s.sparse_fit(V, **kw) if case.get("call") == "sparse_fit" \
            else s.fit(V, **kw)
        for k, v in fitted(s, out).items():
            got[f"single_{k}"] = v
    return got


def _api(case, a, mesh, full):
    """An ``api`` case: the user API past ``model.fit`` on a DTensor target.
    The model (``model``: a class of ``models``) is built on the CPU from
    the case's arrays; ``V`` becomes ``shard_target(V, mesh, pls)`` with
    ``pls`` from ``spec``.  ``call`` says what runs:

    * ``metrics``: the five metrics (``kl_div``, ``euclidean``,
      ``is_div``, ``beta_div`` at each of ``betas``) of the plain input
      ``X`` against the DTensor ``V``, and each one's gradient in ``X``
      (``values``, ``grads``); of ``X`` as a DTensor placed as ``V``
      (``both``); ``sparseness`` of ``H`` placed as ``V`` (its rows, or
      its trailing axis: ``sparseness``); after a routed fit of ``fit_iters`` iterations
      ``beta_div(model(), V, beta)`` and its gradients in the DTensor
      factors (``fit_value``, ``fit_grad_W`` ...);
    * ``ckpt``: ``checkpointed_fit`` (``checkpointed_plca_fit`` for PLCA)
      of the case's ``kw`` into each ``dirs`` entry ``(directory,
      max_iter)`` in turn, each by a new model from the case's arrays (a
      directory that holds a run resumes it); the factors whole, ``n_iter``
      (and ``norm``) of each, by the entry's index;
    * ``save_load``: a routed fit of ``fit_iters`` iterations, ``save`` to
      ``path``; a second model routed for one iteration, then ``load(path,
      model)`` into its DTensor factors (``load_equal``, placements kept,
      ``requires_grad`` kept), a third the same through
      ``load_state_dict`` of the file's whole values (``state_equal``);
      ``load(path)`` without a model (``mapping_equal``);
    * ``dcp``: the same with ``save_sharded``/``load_sharded`` to the
      directory ``path`` (``load_equal``, ``mapping_equal``; the files the
      directory holds, ``files``), beside a plain tensor in a mapping
      (``plain_equal``);
    * ``betamu`` / ``sparsity``: ``BetaMu`` (at ``beta``) or
      ``SparsityProj`` (``sparsity`` on ``attr`` from the step ``lr``,
      ``max_iter`` 5, its closure ``beta_div(model(), V, 2)``) for
      ``steps`` steps,
      ``jit_compile`` as ``jit``, on the DTensor ``V`` or, with ``target``
      ``"plain"``, the whole V; with ``params`` ``"dtensor"`` after a
      routed fit of ``fit_iters`` iterations (the factors DTensors).  Back
      come the factors whole, their ``.grad`` whole, the last loss and the
      step size;
    * ``teardown``: a compiled ``BetaMu`` step on V placed on a mesh of a
      process group made anew (``new_group``) and one on the case's mesh;
      the entries of each optimizer holding its group before, and after
      ``destroy_process_group`` of the new group (``sub_before``,
      ``sub_after``, ``main_before``, ``main_after``).
    """
    import torch

    from pytorch_nmf_tpu_torch import metrics
    from pytorch_nmf_tpu_torch import parallel as par
    from pytorch_nmf_tpu_torch.models import nmf as nmf_models
    from pytorch_nmf_tpu_torch.models import plca as plca_models
    from pytorch_nmf_tpu_torch.parallel.sharded import placements
    from pytorch_nmf_tpu_torch.trainer import BetaMu, SparsityProj
    from pytorch_nmf_tpu_torch.utils import checkpoint

    name, call = case["model"], case["call"]
    em = "PLCA" in name
    cls = getattr(plca_models if em else nmf_models, name)
    names = ("W", "H", "Z") if em else ("W", "H")
    arr = {k: a(k) for k in ("V",) + names}
    kw = dict(case.get("kw", {}))

    def model():
        return cls(**{k: torch.from_numpy(arr[k].copy()) for k in names},
                   device="cpu")

    pls = placements(mesh, dict(enumerate(case["spec"])))
    Vd = par.shard_target(torch.from_numpy(arr["V"]), mesh, pls)
    V = torch.from_numpy(arr["V"])

    def whole(x):
        x = x.detach()
        return full(x) if hasattr(x, "to_local") else x.numpy()

    def factors(m, tag=""):
        return {tag + k: whole(getattr(m, k)) for k in names}

    def routed(iters):
        m = model()
        m.fit(Vd, **dict(kw, max_iter=iters))
        return m

    out = {}
    if call == "metrics":
        X = torch.from_numpy(a("X"))
        fns = [metrics.kl_div, metrics.euclidean, metrics.is_div] + [
            (lambda i, t, b=b: metrics.beta_div(i, t, b))
            for b in case["betas"]]
        values, grads, both = [], [], []
        Xd = par.shard_target(X, mesh, pls)
        for f in fns:
            x = X.clone().requires_grad_(True)
            v = f(x, Vd)
            (g,) = torch.autograd.grad(v, x)
            values.append(float(v))
            grads.append(g.numpy())
            b = f(Xd, Vd)
            both.append(float(b.full_tensor()))
        Hd = par.shard_target(torch.from_numpy(arr["H"]), mesh, pls)
        out.update(values=values, grads=np.stack(grads), both=both,
                   sparseness=float(metrics.sparseness(Hd).full_tensor()))
        m = routed(case["fit_iters"])
        v = metrics.beta_div(m(), Vd, case["fit_beta"])
        gs = torch.autograd.grad(v, [getattr(m, k) for k in names])
        out["fit_value"] = float(v)
        out.update({f"fit_grad_{k}": whole(g) for k, g in zip(names, gs)})
        out.update(factors(m, "fit_"))
    elif call == "ckpt":
        for i, (directory, max_iter) in enumerate(case["dirs"]):
            m = model()
            if em:
                n, norm = checkpoint.checkpointed_plca_fit(
                    m, Vd, max_iter=max_iter, directory=directory, **kw)
                out[f"{i}_norm"] = float(norm)
            else:
                n = checkpoint.checkpointed_fit(
                    m, Vd, max_iter=max_iter, directory=directory, **kw)
            out[f"{i}_n_iter"] = n
            out.update(factors(m, f"{i}_"))
    elif call in ("save_load", "dcp"):
        save, load = ((checkpoint.save, checkpoint.load) if call ==
                      "save_load" else (checkpoint.save_sharded,
                                        checkpoint.load_sharded))
        m = routed(case["fit_iters"])
        save(case["path"], m)
        out.update(factors(m))
        m2 = routed(1)
        got = load(case["path"], m2)
        out["load_returns_model"] = got is m2
        out["load_equal"] = all(
            list(getattr(m2, k).placements) == list(getattr(m, k).placements)
            and torch.equal(getattr(m2, k).to_local(),
                            getattr(m, k).to_local())
            and getattr(m2, k).requires_grad for k in names)
        mapping = load(case["path"])
        out["mapping_equal"] = all(
            np.array_equal(mapping[k].numpy(), out[k]) for k in names)
        if call == "save_load":
            m3 = routed(1)
            m3.load_state_dict({k: torch.from_numpy(out[k]) for k in names})
            out["state_equal"] = all(
                torch.equal(getattr(m3, k).to_local(),
                            getattr(m, k).to_local())
                and hasattr(getattr(m3, k), "placements") for k in names)
        else:
            import torch.distributed as dist

            dist.barrier()
            out["files"] = np.frombuffer(" ".join(sorted(os.listdir(
                case["path"]))).encode(), np.uint8)
            plain = torch.arange(6.0).reshape(2, 3)
            checkpoint.save_sharded(case["path"] + "_mixed",
                                    {"H": m.H.detach(), "P": plain})
            back = checkpoint.load_sharded(case["path"] + "_mixed")
            out["plain_equal"] = torch.equal(back["P"], plain) and \
                np.array_equal(back["H"].numpy(), out["H"])
    elif call in ("betamu", "sparsity"):
        m = routed(case["fit_iters"]) if case["params"] == "dtensor" \
            else model()
        target = V if case.get("target") == "plain" else Vd
        if call == "betamu":
            tr = BetaMu(m.parameters(), case["beta"], jit_compile=case["jit"])

            def closure():
                return target, m()
        else:
            tr = SparsityProj(
                [{"params": [getattr(m, case["attr"])], "lr": case["lr"]}],
                case["sparsity"], max_iter=5, jit_compile=case["jit"])

            def closure():
                return metrics.beta_div(m(), target, 2)
        loss = None
        for _ in range(case["steps"]):
            loss = tr.step(closure)
        out.update(factors(m))
        for k in names:
            g = getattr(m, k).grad
            if g is not None:
                out[f"grad_{k}"] = whole(g)
        if call == "sparsity":
            out.update(loss=float(loss), lr=float(tr.param_groups[0]["lr"]))
        out["dtensor_params"] = all(hasattr(getattr(m, k), "to_local")
                                    for k in names)
    elif call == "teardown":
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        sub = dist.new_group(list(range(dist.get_world_size())))
        sub_mesh = DeviceMesh.from_group(sub, "cpu",
                                         mesh_dim_names=mesh.mesh_dim_names)
        Vs = par.shard_target(V, sub_mesh, pls)
        ms, mm = model(), model()
        on_sub = BetaMu(ms.parameters(), 1)
        on_sub.step(lambda: (Vs, ms()))
        on_main = BetaMu(mm.parameters(), 1)
        on_main.step(lambda: (Vd, mm()))

        def holding(tr, group):
            return sum(group in e["process_groups"]
                       for e in tr._step_cache.values())

        main = mesh.get_group(mesh.mesh_dim_names[0])
        out.update(sub_before=holding(on_sub, sub),
                   main_before=holding(on_main, main))
        dist.destroy_process_group(sub)
        out.update(sub_after=len(on_sub._step_cache),
                   main_after=holding(on_main, main))
    else:
        raise ValueError(f"unknown api call {call!r}")
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


def _strict_all_reduce(a, mesh, par, torch, dist):
    """``Comm.all_reduce`` of a transposed (not contiguous) ``x``, the
    backend refusing tensors that are not contiguous, as NCCL does (C11):
    the sum, in ``x`` itself (its strides kept)."""
    comm = par.comm.comm_for(mesh, mesh.mesh_dim_names[0])
    x = torch.from_numpy(a("x")).t()
    strides = x.stride()
    orig = dist.all_reduce

    def strict(t, *args, **kw):
        if not t.is_contiguous():
            raise ValueError("Tensors must be contiguous")
        return orig(t, *args, **kw)

    dist.all_reduce = strict
    try:
        comm.all_reduce(x)
    except ValueError as e:
        return {"error": np.frombuffer(repr(e).encode(), np.uint8)}
    finally:
        dist.all_reduce = orig
    return {"sum": x.numpy(), "same_strides": x.stride() == strides}


_WORKDIR = None


def _rank_main(rank: int, world: int, workdir: Path, backend: str = "gloo"):
    import faulthandler

    import torch

    global _WORKDIR
    _WORKDIR = workdir
    faulthandler.enable()
    torch.set_num_threads(1)
    from pytorch_nmf_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(f"file://{workdir / 'store'}", world, rank,
                           backend=backend, timeout_s=120)
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
        if results.get(f"{case['name']}:regrouped") is not None:
            meshes.clear()  # made on the destroyed group
    np.savez(workdir / f"out{rank}.npz", **results)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]),
               *sys.argv[4:5])
