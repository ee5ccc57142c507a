"""The compiled sharded fits over NCCL across the machine's cards (up to
4), from ``chip_smoke.py``'s parallel phase: the NCCL cases of
``PAR_NCCL_ONE`` whose fits are compiled (dense, PLCA, sparse), one rank a
card, each held to the single-card fit of the whole problem and run cold,
warm, on a new V and eagerly (``par_compiled``); first the probe's NCCL
cases across the cards (``while_capture_probe.py
graph_nccl_all_reduce_cards body_nccl_all_reduce_cards
body_nccl_all_reduce_mixing_cards``: the last is expected to fail).

    python chip_tools/sharded_cards.py   # from the repository root, 2-4 cards

Prints the probe's lines and ``chip_smoke.py``'s parallel lines (the card's
name and power limit on each).  Needs two or more CUDA devices.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

NAMES = tuple(n for n in cs.PAR_NCCL_ONE
              if cs.PAR_CASES[n][0] in cs.PAR_COMPILED_KINDS)

if __name__ == "__main__":
    import torch

    from pytorch_nmf_tpu_torch.ops._build import load_all

    load_all()
    print(subprocess.run(
        [sys.executable, "chip_tools/while_capture_probe.py",
         "graph_nccl_all_reduce_cards", "body_nccl_all_reduce_cards",
         "body_nccl_all_reduce_mixing_cards"], capture_output=True,
        text=True).stdout, flush=True)
    card = cs.card_line()
    ns = cs.namespace()
    world = min(torch.cuda.device_count(), 4)
    cs.check(world >= 2, f"{world} card(s): nothing to run across cards")
    wd = os.path.join(cs.scratch_dir(), "parallel")
    os.makedirs(wd, exist_ok=True)
    t0 = time.perf_counter()
    cs.spawn_ranks("nccl", world, NAMES, wd)
    print(f"{world} NCCL ranks ran {len(NAMES)} cases in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    single = {}
    for n in NAMES:
        cs.par_check(ns, n, "nccl", world, wd, single, card)
