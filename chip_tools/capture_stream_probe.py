"""Whether the compiled sharded fits of ``chip_smoke.py``'s one-rank NCCL
group survive more fits run before them (C15): a capture on the stream a
NCCL communicator also uses crashed at ``capture_end``.

    python chip_tools/capture_stream_probe.py                 # from the root
    python chip_tools/capture_stream_probe.py off routed explicit model
    python chip_tools/capture_stream_probe.py routed --default-pool

Each variant runs ``chip_smoke.par_rank`` over one NCCL rank (every
``PAR_NCCL_ONE`` case: its explicit fit, then its compiled cells,
``par_compiled``) in a process of its own, and prints whether the process
ended well, with each compiled case's name as it starts and the card's
memory then:

* ``off``: no fits before the compiled cells but the explicit ones;
* ``routed``: the model-API phase first (``par_routed``, as the smoke
  runs it);
* ``explicit``: before the compiled cells, each ``PAR_ROUTED`` case's
  explicit fit twice, on the model's start as card tensors, each from an
  empty cache (no capture: 20 iterations or fewer);
* ``model``: the same with ``model.fit`` on a ``shard_target`` DTensor.

``--default-pool`` gives the fits' capture streams from PyTorch's
default-priority pool (``torch.cuda.Stream(device)``), where
``ProcessGroupNCCL`` takes its communicators' streams, as before the
repair; without it they come from the high-priority pool.  A variant name
may end in digits to run it again (``routed1 routed2``).
"""

import os
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _default_pool():
    """Every new stream from the default-priority pool: ``_Graphs`` takes
    its stream as before the repair."""
    class Default(torch.cuda.Stream):
        def __new__(cls, device=None, priority=0, **kw):
            return super().__new__(cls, device, 0, **kw)

    torch.cuda.Stream = Default


def _fits_before(kind, par):
    """Each ``PAR_ROUTED`` case's explicit fit (``explicit``) or model fit on
    a DTensor (``model``), twice, each from an empty cache."""
    from pytorch_nmf_tpu_torch.ops import solver
    from pytorch_nmf_tpu_torch.parallel.sharded import placements
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    for name in cs.PAR_ROUTED:
        case, shape, kw = cs.PAR_CASES[name]
        kw = {k: v for k, v in kw.items() if k != "mode"}
        model_axis = kw.pop("model_axis", None)
        inp = cs.par_inputs(name, 1)
        em = case in ("plca", "siplca")
        names = ("W", "H", "Z") if em else ("W", "H")
        halo = case in ("deconv", "siplca")
        nd = len(shape[4]) if halo else 0
        axes = {"seq" if halo else "data": 1}
        if model_axis:
            axes["model"] = 1
        mesh = par.make_mesh(axes, "cuda")

        def model():
            make = plca_from_numpy if em else nmf_from_numpy
            return make({k: inp[k] for k in names}, "cuda")

        start = [getattr(model(), k).detach() for k in names]
        V = par.shard_target(inp["V"], mesh, placements(
            mesh, {1 + nd: "seq"} if halo else {0: "data", 1: model_axis}))
        for _ in range(2):
            solver.compiled_cache_clear()
            if kind == "model":
                model().fit(V, **kw)
            elif case == "nmf":
                par.sharded_nmf_fit(inp["V"], *start, mesh,
                                    model_axis=model_axis, **kw)
            elif case == "plca":
                par.sharded_plca_fit(inp["V"], *start, mesh, **kw)
            else:
                f = (par.halo._sharded_deconv_fit if case == "deconv"
                     else par.halo._sharded_siplca_fit)
                f(inp["V"], *start, mesh, nd, **kw)
            torch.cuda.synchronize()


def _rank(rank, world, backend, workdir, names, variant, default_pool):
    if default_pool:
        _default_pool()
    kind = variant.rstrip("0123456789")
    if kind != "routed":
        cs.PAR_ROUTED, routed = (), cs.PAR_ROUTED
    compiled, before = cs.par_compiled, []

    def loud(par, name, *args):
        if not before and kind in ("explicit", "model"):
            before.append(1)
            cs.PAR_ROUTED = routed
            _fits_before(kind, par)
            cs.PAR_ROUTED = ()
        free, total = torch.cuda.mem_get_info()
        print(f"{variant}: par_compiled {name}; reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, card free "
              f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB", flush=True)
        return compiled(par, name, *args)

    cs.par_compiled = loud
    cs.par_rank(rank, world, backend, workdir, names)


def main():
    from pytorch_nmf_tpu_torch.ops._build import load_all

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    default_pool = "--default-pool" in sys.argv
    print(cs.card_line(), flush=True)
    load_all()
    workdir = os.path.join(cs.scratch_dir(), "capture_stream_probe")
    os.makedirs(workdir, exist_ok=True)
    for variant in args or ["off", "routed"]:
        for f in os.listdir(workdir):
            if f.startswith("store"):
                os.remove(os.path.join(workdir, f))
        t0 = time.time()
        ctx = mp.start_processes(
            _rank, (1, "nccl", workdir, cs.PAR_NCCL_ONE, variant,
                    default_pool), nprocs=1, join=False, start_method="spawn")
        pool = "default" if default_pool else "high"
        try:
            while not ctx.join(timeout=600):
                pass
            print(f"{variant} ({pool}-priority pool): ended well in "
                  f"{time.time() - t0:.1f} s", flush=True)
        except Exception:
            print(f"{variant} ({pool}-priority pool): FAILED in "
                  f"{time.time() - t0:.1f} s", flush=True)
            traceback.print_exc(limit=1)


if __name__ == "__main__":
    main()
