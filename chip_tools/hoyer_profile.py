"""Where the Hoyer fits spend their time on the card, and how the NMFD
flagship fit with both factors constrained diverges on an unscaled target.

    python chip_tools/hoyer_profile.py  # from the root of the repo

Prints one line ``DENSE {json}``: dense ``NMF.sparse_fit`` at 5168×1025
R=88, ``sW=0.5``, β=2 (the JAX bench's Hoyer row): ms/iteration by CUDA
events after a warm-up fit, the host reads per iteration (line-search
comparisons, projection ``done`` checks), and from ``torch.profiler`` over
5 iterations the device time and the kernel launches per iteration and the
six ops with the most host time.

Then one line ``DIVERGE {json}`` per path (the kernel Function, its plain
twin): the NMFD flagship fit with ``sW=sH=0.5`` on the ``|randn| + 0.01``
target of the MU fits, 5 iterations, with per iteration the loss, each
line search's step in and out and its number of attempts, and whether the
factors are finite.  Needs one CUDA device.
"""

import json
import os
import sys


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch import nmf as models
    from pytorch_nmf_tpu_torch.metrics import beta_div
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import projection as P
    from pytorch_nmf_tpu_torch.ops import solver
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.ops.graphs import _Counted
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy

    if not torch.cuda.is_available():
        sys.exit("hoyer_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_all()
    card = cs.card_line()
    print(card, flush=True)

    def reads():
        return solver._backtrack_project.reads, P.proj_rows.reads

    M, K, R = cs.MAIN_SHAPE
    rs = np.random.RandomState(cs.SEED)
    V = torch.from_numpy(rs.rand(M, K).astype("f") + 1e-3).cuda()
    inits = {"W": rs.rand(K, R).astype("f") + 0.1,
             "H": rs.rand(M, R).astype("f") + 0.1}
    iters = 20
    nmf_from_numpy(inits, "cuda").sparse_fit(V, beta=2, max_iter=2, sW=0.5)
    m = nmf_from_numpy(inits, "cuda")
    r0 = reads()
    _, ms = cs.events_ms(lambda: m.sparse_fit(V, beta=2, max_iter=iters, sW=0.5))
    r1 = reads()
    m = nmf_from_numpy(inits, "cuda")
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        m.sparse_fit(V, beta=2, max_iter=n_prof, sW=0.5)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    # the kernels' own rows (the ops' rows repeat their kernels' time)
    device = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    top = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    print("DENSE " + json.dumps({
        "card": card, "ms_per_iteration": ms / iters,
        "line_search_reads_per_iteration": (r1[0] - r0[0]) / iters,
        "projection_reads_per_iteration": (r1[1] - r0[1]) / iters,
        "profiled_device_ms_per_iteration": device / n_prof,
        "kernel_launches_per_iteration": launches / n_prof,
        "top_host_ops_ms": {e.key: e.self_cpu_time_total / 1e3 / n_prof
                            for e in top}}), flush=True)
    del V, m

    V = cs.deconv_target("NMFD")
    m0 = cs.deconv_model("NMFD", models)
    W0, H0 = m0.W.detach().clone(), m0.H.detach().clone()
    del m0
    Rd = W0.shape[1]
    backtrack, renorm = solver._backtrack_project, solver.renorm

    for path, recon in (("kernel", F.kernel_adjoint_deconv),
                        ("plain", F.plain_adjoint_deconv)):
        rows = []

        def traced(base, loss_of_new, p, grad, ss, L1):
            # the wrapped function counts into the name it is called by
            n0 = traced_backtrack.attempts
            out, ss_out = backtrack.__wrapped__(base, loss_of_new, p, grad,
                                                ss, L1)
            rows.append({"factor": "W" if p.shape == W0.shape else "H",
                         "step_in": float(ss), "step_out": float(ss_out),
                         "attempts": traced_backtrack.attempts - n0,
                         "finite": bool(torch.isfinite(out).all())})
            return out, ss_out

        def traced_renorm(w, h, unit):
            w, h = renorm(w, h, unit)
            rows.append({"loss": float(beta_div(F.plain_adjoint_deconv(h, w), V, 2)),
                         "finite": bool(torch.isfinite(w).all()
                                        and torch.isfinite(h).all())})
            return w, h

        traced_backtrack = _Counted(traced, on_card=("attempts",), reads=0,
                                    attempts=0)
        solver._backtrack_project, solver.renorm = traced_backtrack, traced_renorm
        try:
            solver.get_hoyer_fit(recon, None, 2.0, 5, True, True, 0.5, 0.5,
                                 W0.numel() // Rd, H0.numel() // Rd)(V, W0, H0)
        finally:
            solver._backtrack_project, solver.renorm = backtrack, renorm
        print("DIVERGE " + json.dumps({"card": card, "path": path,
                                       "iterations": rows}), flush=True)


if __name__ == "__main__":
    main()
