"""Where the streaming fit's time goes, on the card.

    python chip_tools/streaming_probe.py      # from the repository root

Measures, for a 128 MB block (8192×4096 float32): the host-to-card copy
from pinned memory (one ``copy_``, CUDA events) and from pageable memory;
numpy's copy from a host array into pinned memory with 1, 2, 4 and 8
threads; then one pass of ``ops/streaming._Blocks`` over the 1 GiB
65536×4096 target with no compute (the copy pipeline alone) for 1, 4 and
8 fill threads; and the streaming fit's ms/iteration at 65536×4096 (R=64,
β=1) and at 5168×1025 (R=88, β=0.5, 6 blocks) against the in-memory fit,
each with the default ``FILL_SPLIT_BYTES`` and with every block split over
the fill threads, in turns (default, split, split, default).
Prints one line per measurement with the card's name and power limit.
Needs one CUDA device.
"""

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from pytorch_nmf_tpu_torch.functional import streaming_nmf_fit
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import streaming
    from pytorch_nmf_tpu_torch.ops._build import load_all

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    load_all()
    M, K, R, block = cs.STREAM_BIG
    V = np.empty((M, K), np.float32)
    np.random.default_rng(0).random(out=V, dtype=np.float32)
    V += 0.01
    blk = V[:block]
    gb = blk.nbytes / 1e9

    pinned = torch.empty((block, K), pin_memory=True)
    dev = torch.empty((block, K), device="cuda")
    for label, src in (("pinned", pinned), ("pageable", torch.from_numpy(blk))):
        dev.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        _, ms = cs.events_ms(lambda: [dev.copy_(src, non_blocking=True)
                                      for _ in range(5)])
        print(f"host-to-card copy of {gb * 1e3:.0f} MB from {label} memory: "
              f"{5 * gb / (ms / 1e3):.2f} GB/s [{card}]", flush=True)

    dst = pinned.numpy()
    for threads in (1, 2, 4, 8):
        with ThreadPoolExecutor(threads) as pool:
            step = -(-block // threads)
            t0 = time.perf_counter()
            for _ in range(5):
                list(pool.map(lambda i: np.copyto(dst[i:i + step],
                                                  blk[i:i + step]),
                              range(0, block, step)))
            dt = time.perf_counter() - t0
        print(f"host copy into pinned memory, {threads} thread(s): "
              f"{5 * gb / dt:.2f} GB/s [{card}]", flush=True)

    default = streaming._Blocks.FILL_THREADS
    for threads in (1, 4, 8):
        streaming._Blocks.FILL_THREADS = threads
        blocks = streaming._Blocks(V, block, torch.device("cuda"), torch.float32)
        for _ in blocks:  # warm-up pass
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            for _ in blocks:
                pass
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        blocks.close()
        print(f"copy pipeline alone, {threads} fill thread(s): "
              f"{3 * V.nbytes / 1e9 / dt:.2f} GB/s, {1e3 * dt / 3:.1f} ms a "
              f"pass of {V.nbytes / 2**30:.2f} GiB [{card}]", flush=True)
    streaming._Blocks.FILL_THREADS = default
    split = streaming._Blocks.FILL_SPLIT_BYTES

    rs = np.random.RandomState(1)
    for (m, k, r, b, beta, iters, Vh) in (
            (M, K, 64, block, 1, 5, V),
            (5168, 1025, 88, 1024, 0.5, 20,
             np.abs(rs.randn(5168, 1025)).astype("f") + 0.01)):
        W0 = torch.from_numpy(rs.rand(k, r).astype("f") + 0.1).cuda()
        H0 = torch.from_numpy(rs.rand(m, r).astype("f") + 0.1).cuda()
        streaming_nmf_fit(Vh, W0, H0, beta=beta, max_iter=1, row_block=b)

        def timed(split_bytes):
            streaming._Blocks.FILL_SPLIT_BYTES = split_bytes
            return cs.events_ms(lambda: streaming_nmf_fit(
                Vh, W0, H0, beta=beta, tol=float("-inf"), max_iter=iters,
                row_block=b))[1] / iters

        # the default against every block split over the threads, in turns
        turns = [(s_, timed(s_)) for s_ in (split, 0, 0, split)]
        streaming._Blocks.FILL_SPLIT_BYTES = split
        ms = iters * min(t for s_, t in turns if s_ == split)
        Vd = torch.from_numpy(Vh).cuda()
        mod = NMF(W=W0, H=H0, device="cuda")
        mod.fit(Vd, beta=beta, tol=float("-inf"), max_iter=2)
        _, mms = cs.events_ms(lambda: mod.fit(Vd, beta=beta, tol=float("-inf"),
                                              max_iter=iters))
        print(f"streaming fit {m}x{k} R={r} beta={beta} row_block={b}: "
              f"{ms / iters:.2f} ms/iteration; in memory {mms / iters:.3f}; "
              "by turns (split bytes, ms/iteration): "
              + ", ".join(f"({s_}, {t:.2f})" for s_, t in turns)
              + f" [{card}]", flush=True)
        del Vd


if __name__ == "__main__":
    main()
