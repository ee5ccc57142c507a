"""Which work a graph with CUDA-graph WHILE nodes (``ops/graphs.py``'s
device loops) can be captured with, on the card.

    python chip_tools/while_capture_probe.py          # from the repository root

Each case runs in a process of its own (a failed capture may end the
process with a segmentation fault), from numpy seed 8, and prints its exit
code and whether the graphed run equals the eager one:

* ``body_bmm``, ``body_conv``, ``body_vmap_conv``: a device loop whose body
  runs a batched GEMM, three cuDNN convolutions, or the ``torch.func.vmap``
  of a convolution (a cuDNN grouped convolution), captured with own
  warm-ups;
* ``hoyer_vmap_conv``: the batched Hoyer fit (``get_batched_hoyer_fit``)
  of three NMFD problems (1×12×60, R=3, T=5, ``sW=0.5``, 30 iterations) on
  ``vmap`` of the model's convolution with cuDNN on (the fit turns it off
  itself: this case turns that off), ``hoyer_vmap_conv_off`` as the fit
  runs it, and ``hoyer_conv_loop`` with cuDNN on and the problems'
  convolutions one by one.

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
from pytorch_nmf_tpu_torch.nmf import NMFD
from pytorch_nmf_tpu_torch.ops import graphs, solver
from pytorch_nmf_tpu_torch.ops._build import load_all

load_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
case, dev = sys.argv[1], torch.device("cuda")
rs = np.random.RandomState(8)
V, W, H = (torch.from_numpy(rs.rand(*s).astype("f") + off).to(dev) for s, off in
           zip(((3, 1, 12, 60), (3, 12, 3, 5), (3, 1, 3, 56)), (0.01, 0.1, 0.1)))

if case.startswith("body"):
    out = torch.zeros(3, 1, 12, 60, device=dev)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        if case == "body_bmm":
            out[:, 0, :, :56].copy_(torch.bmm(W[:, :, :, 0], H[:, 0]))
        elif case == "body_conv":
            out.copy_(torch.stack([NMFD.reconstruct(H[b], W[b]) for b in range(3)]))
        else:
            out.copy_(vmap(NMFD.reconstruct)(H, W))
        n.add_(1)
        torch.lt(n, 3, out=flag)

    def work():
        flag.fill_(True)
        n.zero_()
        graphs._device_while(flag, body)

    g = graphs._Graphs([work], None, dev, "cannot be captured", conditional=True)
    g()
    ref = out.clone()
    g()
    g.capture()
    g()
    torch.cuda.synchronize()
    print(case, "equal", torch.equal(out, ref), "runs", int(n))
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

CASES = ("body_bmm", "body_conv", "body_vmap_conv", "hoyer_vmap_conv",
         "hoyer_vmap_conv_off", "hoyer_conv_loop")


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for case in CASES:
        r = subprocess.run([sys.executable, "-c", CASE, case], capture_output=True,
                           text=True, timeout=600, cwd=os.getcwd())
        err = r.stderr.strip()
        fatal = err.find("Fatal Python error")
        tail = err[fatal:fatal + 120] if fatal >= 0 else err[-300:] if r.returncode else ""
        print(f"{case}: exit {r.returncode}; {r.stdout.strip()} {tail} [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
