"""Which work a graph with CUDA-graph WHILE nodes (``ops/graphs.py``'s
device loops) can be captured with, on the card.

    python chip_tools/while_capture_probe.py          # from the repository root
    python chip_tools/while_capture_probe.py body_conv2d body_autograd

Each case runs in a process of its own (a failed capture may end the
process with a segmentation fault), from numpy seed 8, and prints its exit
code and whether the graphed run equals the eager one:

* ``body_bmm``, ``body_conv``, ``body_vmap_conv``: a device loop whose body
  runs a batched GEMM, three cuDNN convolutions, or the ``torch.func.vmap``
  of a convolution (a cuDNN grouped convolution), captured with own
  warm-ups;
* to name the call that breaks: ``body_conv2d`` and ``body_conv3d`` (the
  NMF2D and NMF3D reconstructions, plain cuDNN convolutions);
  ``body_grouped_conv`` (``F.conv1d`` with ``groups=3``, no ``vmap``: the
  call ``vmap`` makes), ``body_grouped_conv_det`` (the same with cuDNN's
  deterministic algorithms), ``body_grouped_conv_nocudnn`` (the same with
  cuDNN off: PyTorch's own kernels), ``body_grouped_conv_1`` (``groups=1``
  through the same reshaped call);
* the same calls outside the body, in the graph that holds the WHILE node
  (the body a count): ``outside_grouped_conv`` (the grouped convolution
  before the node), ``outside_grouped_conv_after`` (after it),
  ``outside_grouped_conv_nocudnn`` (before it, cuDNN off),
  ``outside_vmap_conv`` (``vmap``'s, before it), ``outside_conv`` (a plain
  cuDNN convolution before it), ``outside_bmm`` (a batched GEMM before
  it);
* the grouped convolution's backward, as the batched Hoyer fit takes its
  gradients: ``outside_vmap_grad_H`` and ``outside_vmap_grad_W``
  (``torch.autograd.grad`` of ``vmap``'s convolution for H, the cuDNN
  grouped backward-data call, or for W, the backward-filter call, before
  the node), ``outside_vmap_grad_W_nocudnn`` (cuDNN off), and
  ``body_vmap_grad_H`` and ``body_vmap_grad_W`` (inside the body);
* several WHILE nodes in one graph, as the batched Hoyer fit's chunk holds
  twenty: ``many_while_vmap_conv`` (four nodes, ``vmap``'s convolution
  before each and in each body), ``many_while_vmap_conv_nocudnn`` (the
  same with cuDNN off), ``many_while_bmm`` (a batched GEMM instead);
* autograd inside a body: ``body_autograd`` (``torch.autograd.grad``
  through the NMFD reconstruction, with autograd's device threads, whose
  allocations do not reach the bodies' pool) and ``body_autograd_st``
  (the backward on the calling thread,
  ``torch.autograd.set_multithreading_enabled(False)``, as
  ``ops/graphs.py`` captures a body);
* ``hoyer_vmap_conv``: the batched Hoyer fit (``get_batched_hoyer_fit``)
  of three NMFD problems (1×12×60, R=3, T=5, ``sW=0.5``, 30 iterations) on
  ``vmap`` of the model's convolution with cuDNN on (the fit turns it off
  itself: this case turns that off), ``hoyer_vmap_conv_off`` as the fit
  runs it, and ``hoyer_conv_loop`` with cuDNN on and the problems'
  convolutions one by one;
* NCCL in a captured graph, through the sharded fits' ``parallel.comm``
  (``Comm.all_reduce``) on a one-rank NCCL group: ``graph_nccl_all_reduce``
  (three all-reduces in a plain graph) and ``body_nccl_all_reduce`` (an
  all-reduce in a WHILE node's body, three runs), each replay against the
  eager run; and ``graph_nccl_all_reduce_cards``,
  ``body_nccl_all_reduce_cards``: the same over one rank a card where the
  machine has two or more (each rank prints its line), with NCCL's graph
  mixing support off as ``parallel.distributed.initialize`` sets it, and
  ``body_nccl_all_reduce_mixing_cards`` with it on
  (``NCCL_GRAPH_MIXING_SUPPORT=1``).  On four H100s the last fails: the
  capture ends in "CUDA error: invalid argument" (NCCL's mixing support
  records event nodes, which a WHILE node's body refuses; on one rank
  NCCL records none); the plain graph passes either way;
* the halo fits' shifts across the cards (``Comm._shift``, one
  ``batch_isend_irecv`` of NCCL's send and receive, the last 64 values to
  the next rank and the first 64 back to the previous one, the ends
  receiving zeros): ``graph_nccl_shift_cards`` (in a plain graph),
  ``body_nccl_shift_cards`` (in a WHILE node's body, three runs),
  ``body_nccl_shift_mixing_cards`` (the same with NCCL's graph mixing
  support on), ``body_nccl_shift_conv_cards`` (the shifts beside a plain
  cuDNN ``F.conv1d`` in the body, as the halo ``conv`` mode runs) and
  ``body_nccl_gather_shift_cards`` (the same frames through one
  ``all_gather_into_tensor``, each rank taking its neighbour's: the
  fallback had send and receive not been capturable).  On four H100s
  every case but the mixing one replays equal to eager (the halo calls
  counted on the card); with mixing on, the capture fails as the
  all-reduce's does;
* the compiled NMFD halo fit itself across the cards (1×64×150 a rank,
  R=16, T=20, ``fused``, 30 iterations, cold): ``fit_nccl_halo_cards``
  against its ``_graph=False`` twin, bit for bit, and
  ``fit_nccl_halo_eager_cards`` (the eager twin alone); a rank still
  running after 75 s prints its Python stack and exits.

Prints the card's name and power limit.  Needs one CUDA device.
"""

import os
import subprocess
import sys

CASE = r'''
import contextlib, sys
import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap
sys.path.insert(0, ".")
from pytorch_nmf_tpu_torch.nmf import NMF2D, NMF3D, NMFD
from pytorch_nmf_tpu_torch.ops import graphs, solver
from pytorch_nmf_tpu_torch.ops._build import load_all

load_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
case, dev = sys.argv[1], torch.device("cuda")

if "nccl" in case:
    # NCCL in a captured graph: rank argv[2] of argv[3] (one card each),
    # through the sharded fits' own Comm; a file store, no port
    from pytorch_nmf_tpu_torch.parallel import comm, distributed, make_mesh

    rank, world, store = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    distributed.initialize("file://" + store, world, rank, backend="nccl")
    dev = torch.device("cuda", torch.cuda.current_device())
    if case.startswith("fit_nccl_halo"):
        # the compiled NMFD halo fit in its fused mode, cold, 30 iterations,
        # against its eager twin; a rank still running after 75 s prints
        # its Python stack and exits
        import faulthandler

        from pytorch_nmf_tpu_torch.parallel import halo

        faulthandler.dump_traceback_later(75, exit=True)
        rs = np.random.RandomState(8)
        C, R, T, L = 64, 16, 20, 150
        V = rs.rand(1, C, L * world).astype("f") + 0.01
        W = rs.rand(C, R, T).astype("f") + 0.1
        H = rs.rand(1, R, L * world - T + 1).astype("f") + 0.1
        mesh = make_mesh({"seq": world})
        kw = dict(beta=1, tol=0, max_iter=30, mode="fused")
        comm.stats.reset()
        outs = [halo._sharded_deconv_fit(V, W, H, mesh, 1, _graph=False, **kw)]
        print(case, "rank", rank, "eager done", flush=True)
        if "eager" not in case:
            outs.append(halo._sharded_deconv_fit(V, W, H, mesh, 1, **kw))
        torch.cuda.synchronize()
        equal = all(torch.equal(a.to_local(), b.to_local()) if hasattr(
            a, "to_local") else a == b for a, b in zip(outs[0], outs[-1]))
        print(case, "rank", rank, "of", world, "equal", equal, "halo calls",
              comm.stats.calls["halo"], flush=True)
        solver.compiled_cache_clear()
        torch.distributed.destroy_process_group()
        sys.exit()
    c = comm.comm_for(make_mesh({"data": world}), "data")
    x0 = (torch.arange(1, 1 + 4096, dtype=torch.float32, device=dev) / 4096
          + rank)
    x, acc = torch.empty_like(x0), torch.empty_like(x0)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    kernel = torch.full((1, 1, 5), 0.2, device=dev)
    kind = "all_reduce" if "all_reduce" in case else "halo"

    def gather_shift(strip, step):
        # the halo shift as one all-gather of every rank's strip, each
        # rank taking its neighbour's (zeros where it has none)
        parts = torch.empty((c.size,) + strip.shape, dtype=strip.dtype,
                            device=strip.device)
        torch.distributed.all_gather_into_tensor(parts, strip.contiguous(),
                                                 group=c.group)
        src = c.rank - step
        return parts[src] if 0 <= src < c.size else torch.zeros_like(strip)

    def body():
        x.mul_(0.5)
        if kind == "all_reduce":
            c.all_reduce(x)
        else:
            # the halo fits' exchange: the last frames to the right, the
            # first ones back to the left
            shift = (gather_shift if "gather" in case else
                     lambda s, step: c._shift(s, step))
            right, left = shift(x[-64:], 1), shift(x[:64], -1)
            x[:64].add_(right)
            x[-64:].add_(left)
            if "conv" in case:  # the conv mode's plain cuDNN convolution
                x.copy_(F.conv1d(x.view(1, 1, -1), kernel, padding=2).view(-1))
        acc.add_(x)
        n.add_(1)
        torch.lt(n, 3, out=flag)

    def work():
        x.copy_(x0)
        acc.zero_()
        n.zero_()
        flag.fill_(True)
        if case.startswith("graph_"):  # no WHILE node: three bodies
            for _ in range(3):
                body()
        else:
            graphs._device_while(flag, body)

    g = graphs._Graphs([work], None, dev, "cannot be captured", conditional=True)
    comm.stats.reset()
    g()
    ref = acc.clone()
    g()  # the second warm-up, synchronizing operations raising
    g.capture()
    calls = comm.stats.calls[kind]
    acc.zero_()
    g()
    g.flush()
    torch.cuda.synchronize()
    print(case, "rank", rank, "of", world, "equal", torch.equal(acc, ref),
          "runs", int(n), f"{kind} calls eager+capture", calls,
          "after the replay", comm.stats.calls[kind])
    g.close()
    torch.distributed.destroy_process_group()
    sys.exit()

rs = np.random.RandomState(8)
V, W, H = (torch.from_numpy(rs.rand(*s).astype("f") + off).to(dev) for s, off in
           zip(((3, 1, 12, 60), (3, 12, 3, 5), (3, 1, 3, 56)), (0.01, 0.1, 0.1)))

if case.startswith(("body", "outside", "many_while")):
    out = torch.zeros(3, 1, 12, 60, device=dev)
    outw = torch.zeros(12, 3, 5, device=dev)
    gH, gW = torch.zeros_like(H), torch.zeros_like(W)
    H2, W2 = (torch.from_numpy(rs.rand(*s).astype("f")).to(dev)
              for s in ((1, 3, 9, 10), (5, 3, 3, 3)))
    H3, W3 = (torch.from_numpy(rs.rand(*s).astype("f")).to(dev)
              for s in ((1, 2, 5, 5, 4), (3, 2, 2, 2, 2)))
    out2, out3 = torch.zeros(1, 5, 11, 12, device=dev), torch.zeros(
        1, 3, 6, 6, 5, device=dev)
    if case == "body_grouped_conv_det":
        torch.backends.cudnn.deterministic = True
    if case.endswith("_nocudnn"):
        torch.backends.cudnn.enabled = False
    n = torch.zeros((), dtype=torch.int32, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)

    def grouped(groups):
        # vmap's conv batching rule: the problems as groups of one call
        x = H.reshape(1, 3 * 3, 56)
        w = W.flip(3).reshape(3 * 12, 3, 5)
        if groups == 1:
            return F.conv1d(x[:, :3], w[:12], padding=4)
        return F.conv1d(x, w, padding=4, groups=3).reshape(3, 1, 12, 60)

    def grad_W():
        with torch.enable_grad():
            w = W[0].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(NMFD.reconstruct(H[0], w), w, V[0])
        return g

    def vmap_grad(side):
        # the gradient of the batch's reconstruction for H or W: cuDNN's
        # grouped backward-data or backward-filter convolution
        with torch.enable_grad():
            h, w = (x.detach().requires_grad_(s == side)
                    for x, s in ((H, "H"), (W, "W")))
            x = h if side == "H" else w
            (g,) = torch.autograd.grad(vmap(NMFD.reconstruct)(h, w), x, V)
        return g

    def body():
        if case == "body_bmm":
            out[:, 0, :, :56].copy_(torch.bmm(W[:, :, :, 0], H[:, 0]))
        elif case == "body_conv":
            out.copy_(torch.stack([NMFD.reconstruct(H[b], W[b]) for b in range(3)]))
        elif case == "body_conv2d":
            out2.copy_(NMF2D.reconstruct(H2, W2))
        elif case == "body_conv3d":
            out3.copy_(NMF3D.reconstruct(H3, W3))
        elif case.startswith("body_grouped_conv"):
            if case == "body_grouped_conv_1":
                out[0, 0].copy_(grouped(1)[0])
            else:
                out.copy_(grouped(3))
        elif case == "body_autograd":
            with torch.autograd.set_multithreading_enabled(True):
                outw.copy_(grad_W())
        elif case == "body_autograd_st":
            with torch.autograd.set_multithreading_enabled(False):
                outw.copy_(grad_W())
        elif case == "body_vmap_conv":
            out.copy_(vmap(NMFD.reconstruct)(H, W))
        elif case == "body_vmap_grad_H":
            gH.copy_(vmap_grad("H"))
        elif case == "body_vmap_grad_W":
            gW.copy_(vmap_grad("W"))
        n.add_(1)
        torch.lt(n, 3, out=flag)

    def outside():
        if case.startswith("outside_grouped_conv"):
            out.copy_(grouped(3))
        elif case == "outside_vmap_conv":
            out.copy_(vmap(NMFD.reconstruct)(H, W))
        elif case == "outside_conv":
            out.copy_(torch.stack([NMFD.reconstruct(H[b], W[b]) for b in range(3)]))
        elif case == "outside_bmm":
            out[:, 0, :, :56].copy_(torch.bmm(W[:, :, :, 0], H[:, 0]))
        elif case == "outside_vmap_grad_H":
            gH.copy_(vmap_grad("H"))
        elif case.startswith("outside_vmap_grad_W"):
            gW.copy_(vmap_grad("W"))

    def work():
        flag.fill_(True)
        n.zero_()
        if case != "outside_grouped_conv_after":
            outside()
        graphs._device_while(flag, body)
        if case == "outside_grouped_conv_after":
            outside()

    if case.startswith("many_while"):
        flags = [torch.ones((), dtype=torch.bool, device=dev) for _ in range(4)]
        counts = [torch.zeros((), dtype=torch.int32, device=dev) for _ in range(4)]

        def product():
            if case == "many_while_bmm":
                return torch.bmm(W[:, :, :, 0], H[:, 0])[:, None]
            return vmap(NMFD.reconstruct)(H, W)[..., :56]

        def work():
            out.zero_()
            n.zero_()
            for f, m in zip(flags, counts):
                f.fill_(True)
                m.zero_()
                out[..., :56].add_(product())

                def node_body(f=f, m=m):
                    out[..., :56].add_(product())
                    m.add_(1)
                    torch.lt(m, 3, out=f)

                graphs._device_while(f, node_body)
                n.add_(m)

    g = graphs._Graphs([work], None, dev, "cannot be captured", conditional=True)
    g()
    ref = [t.clone() for t in (out, outw, out2, out3, gH, gW)]
    for t in (out, outw, out2, out3, gH, gW):
        t.zero_()
    g()
    g.capture()
    g()
    torch.cuda.synchronize()
    print(case, "equal", all(torch.equal(t, r) for t, r in zip(
        (out, outw, out2, out3, gH, gW), ref)),
          "runs", int(n), "finite", bool(out.isfinite().all()))
    g.close()
    sys.exit()

recon = vmap(NMFD.reconstruct)
if case == "hoyer_conv_loop":
    def recon(h, w):
        return torch.stack([NMFD.reconstruct(h[b], w[b]) for b in range(h.shape[0])])
if case != "hoyer_vmap_conv_off":
    solver._without_cudnn = contextlib.nullcontext

def run(graph):
    fit = solver.get_batched_hoyer_fit(recon, 2.0, 30, True, True, 0.5, None, 60, 56,
                                       _graph=graph)
    return fit(V, W, H, _attempts=True)

got, ref = run(True), run(False)
torch.cuda.synchronize()
print(case, "equal", all(torch.equal(a, b) for a, b in zip(got, ref)))
'''

CASES = ("body_bmm", "body_conv", "body_vmap_conv", "body_conv2d",
         "body_conv3d", "body_grouped_conv", "body_grouped_conv_det",
         "body_grouped_conv_nocudnn", "body_grouped_conv_1",
         "outside_grouped_conv", "outside_grouped_conv_after",
         "outside_grouped_conv_nocudnn", "outside_vmap_conv", "outside_conv",
         "outside_bmm", "outside_vmap_grad_H", "outside_vmap_grad_W",
         "outside_vmap_grad_W_nocudnn", "body_vmap_grad_H", "body_vmap_grad_W",
         "many_while_vmap_conv", "many_while_vmap_conv_nocudnn",
         "many_while_bmm", "body_autograd", "body_autograd_st",
         "hoyer_vmap_conv", "hoyer_vmap_conv_off", "hoyer_conv_loop")
NCCL_CASES = ("graph_nccl_all_reduce", "body_nccl_all_reduce",
              "graph_nccl_all_reduce_cards", "body_nccl_all_reduce_cards",
              "body_nccl_all_reduce_mixing_cards", "graph_nccl_shift_cards",
              "body_nccl_shift_cards", "body_nccl_shift_mixing_cards",
              "body_nccl_shift_conv_cards", "body_nccl_gather_shift_cards",
              "fit_nccl_halo_eager_cards", "fit_nccl_halo_cards")
CASES += NCCL_CASES


def nccl_ranks(case, world, env=None, timeout=600):
    """Runs ``case`` as ``world`` NCCL ranks, one process a card (in
    ``env``), each killed past ``timeout`` seconds; returns ``(exit codes,
    outputs, errors)``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", CASE, case, str(r), str(world), store],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.getcwd(), env=env) for r in range(world)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
    return ([p.returncode for p in procs], " | ".join(o.strip() for o, _ in outs),
            "\n".join(e for _, e in outs))


def main():
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for case in sys.argv[1:] or CASES:
        if case in NCCL_CASES:
            world = 1
            if case.endswith("_cards"):
                world = torch.cuda.device_count()
                if world < 2:
                    print(f"{case}: not run: {world} card(s) [{card}]", flush=True)
                    continue
            # parallel.distributed.initialize turns NCCL's graph mixing
            # support off unless the environment sets it: _mixing sets it on
            env = None
            if "_mixing" in case:
                env = dict(os.environ, NCCL_GRAPH_MIXING_SUPPORT="1")
            codes, out, err = nccl_ranks(
                case.removesuffix("_cards").replace("_mixing", ""), world,
                env, timeout=100 if case.startswith("fit_") else 600)
            fatal = err.find("Fatal Python error")
            tail = (err[fatal:fatal + 120] if fatal >= 0 else err[-600:]
                    if any(codes) else "")
            print(f"{case}: exit {codes}; {out} {tail} [{card}]", flush=True)
            continue
        r = subprocess.run([sys.executable, "-c", CASE, case], capture_output=True,
                           text=True, timeout=600, cwd=os.getcwd())
        err = r.stderr.strip()
        fatal = err.find("Fatal Python error")
        tail = err[fatal:fatal + 120] if fatal >= 0 else err[-300:] if r.returncode else ""
        print(f"{case}: exit {r.returncode}; {r.stdout.strip()} {tail} [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
