"""The compiled sharded fits over NCCL across the machine's cards (up to
4), from ``chip_smoke.py``'s parallel phase: the NCCL cases of
``PAR_NCCL_ONE`` whose fits are compiled (dense, PLCA, sparse and the halo
fits), one rank a card, each held to the single-card fit of the whole
problem and run cold, warm, on a new (or another) V and eagerly
(``par_compiled``), then the group destroyed and made again under a halo
fit (``par_regroup``); first the probe's NCCL cases across the cards
(``while_capture_probe.py``'s halo shift cases: in a plain graph and in a
WHILE node's body, with NCCL's graph mixing support off and on, and beside
a cuDNN convolution; the mixing case is expected to fail; the all-reduce
cases run by name).

    python chip_tools/sharded_cards.py   # from the repository root, 2-4 cards
    python chip_tools/sharded_cards.py nmfd_b1 siplca2   # those cases alone

Prints the probe's lines and ``chip_smoke.py``'s parallel lines (the card's
name and power limit on each).  Needs two or more CUDA devices.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from chip_tools.while_capture_probe import NCCL_CASES  # noqa: E402

NAMES = tuple(n for n in cs.PAR_NCCL_ONE
              if cs.PAR_CASES[n][0] in cs.PAR_COMPILED_KINDS)

if __name__ == "__main__":
    import torch

    from pytorch_nmf_tpu_torch.ops._build import load_all

    load_all()
    names = tuple(sys.argv[1:]) or NAMES
    if names is NAMES:  # named cases run without the probe
        print(subprocess.run(
            [sys.executable, "chip_tools/while_capture_probe.py"]
            + [c for c in NCCL_CASES if c.endswith("_cards") and "shift" in c
               and "gather" not in c],
            capture_output=True, text=True).stdout, flush=True)
    card = cs.card_line()
    ns = cs.namespace()
    world = min(torch.cuda.device_count(), 4)
    cs.check(world >= 2, f"{world} card(s): nothing to run across cards")
    wd = os.path.join(cs.scratch_dir(), "parallel")
    os.makedirs(wd, exist_ok=True)
    t0 = time.perf_counter()
    cs.spawn_ranks("nccl", world, names, wd)
    print(f"{world} NCCL ranks ran {len(names)} cases in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    single = {}
    for n in names:
        cs.par_check(ns, n, "nccl", world, wd, single, card)
