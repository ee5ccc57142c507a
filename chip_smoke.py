#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width, each in phases:

* dense ``NMF.fit`` at the reference benchmark's size (V 5168×1025, rank
  88), on the kernels B1/B2 of ``csrc/fused_mu.cu``;
* the deconvolutional fits ``NMFD.fit`` at the JAX bench's flagship
  (V 1×1025×5000, rank 88, T=400: the reference's librosa example), and
  ``NMF2D.fit`` (1×512×64×64, rank 128, kernel 8×8) and ``NMF3D.fit``
  (1×64×19³, rank 16, kernel 4³) at the bench's rows, on the kernels B3/B4
  (``hgrad``/``wgrad``) of ``csrc/fused_deconv.cu``;
* the PLCA family's EM: ``SIPLCA.fit`` at the bench's row (V 1×513×3000,
  rank 64, T=200), ``SIPLCA2.fit`` (1×64×64×64, rank 16, 8×8) and
  ``SIPLCA3.fit`` (1×64×19³, rank 16, 4³), whose E-step runs B3/B4 as the
  adjoints of the reconstruction; dense ``PLCA.fit`` at 5168×1025 rank 88
  through the generic E-step and the opt-in fused one on B1;
* sparse targets through ``NMF.fit``: the top 2% of 5168×1025 (rank 88;
  the densify tier, on B1 at β ≠ 2), 8192² with 671k non-zeros (rank 64,
  each tier forced; 100 iterations, the chunk graphed: a cold fit and a
  warm one through ``NMF.fit`` against ``_graph=False``, replays,
  captures, host reads and the device time, densify and ELL bit for bit,
  gather within 1e-4 and the same ``n_iter`` at ``tol=1e-4``), a densify
  fit out of memory (the process's memory fraction below the dense
  target) retried on the ELL tier, graphed, with the card's allocated
  memory back afterwards, and 131072×65536 at 0.1% (rank 64), past the
  densify budget, where the ELL tier is chosen (its reductions counted as
  executions, replays included); the sparse-target Hoyer fit on the top
  2% (``sW=0.5``, 100 iterations) graphed against ``_graph=False``, the
  same attempts, P1 launches one a constrained factor and attempt, no
  line-search host read from the first replay on;
* Hoyer ``sparse_fit`` at β=2: dense ``NMF`` at 5168×1025 rank 88 with
  ``sW=0.5`` (the JAX bench's row; no MU kernel, as there), and ``NMFD`` at
  the flagship with ``sW=0.5`` and with ``sW=sH=0.5``, whose gradients run
  B3 and B4 behind autograd (``kernel_adjoint_deconv``): exactly 2 B3 and 1
  B4 launches an iteration, 1 and 1 with both; every projection is one
  launch of the projection kernel P1 (``csrc/hoyer_proj.cu``), exactly one
  per constrained factor and line-search attempt, with no host read; the
  dense fit's launches, device time and idle share an iteration
  (``torch.profiler``); first nested WHILE nodes (``nested_while``: an
  outer node whose body holds two inner ones, ``F.conv1d`` and a grouped
  convolution in the inner bodies, replayed against eager, the bodies'
  executions counted on the card at each depth); then the compiled Hoyer
  fit, its chunk loop one CUDA-graph WHILE node (``csrc/graph_cond.cu``)
  whose body holds each line search's attempts 2-10 as nested WHILE
  nodes: the dense cell at 100 iterations and the NMFD flagship (``sW``,
  ``sW+sH``) at 30, as cache cells (below): through the model a cold fit
  (chunks 1-2 eager, one capture, one replay), a warm one from other inits
  (one replay, no capture, no host read) and one on a new V (one capture,
  one replay), against ``_graph=False`` (eager), each bit for bit its eager
  twin with the same attempts and launches, no line-search host read from
  the first replay on; ms/iteration every way,
  the replayed chunks' against their device time, the idle shares, the
  WHILE nodes' own kernels, the captures' host ms, attempts an iteration,
  host reads, the peak memory and the cache's held bytes; and
  ``nmf_hoyer_fit_batched`` over 16 problems of 1025×400 rank 16, one
  batched program (one capture a cold fit, none a warm one, each one
  replay of the chunk loop; every projection of the batch one P1 launch;
  each problem's line search its own, all in one nested WHILE node)
  against ``_graph=False`` bit for bit and its 16 eager single fits;
* the functional API: ``nmf_fit`` (5168×1025, β=0.5) and ``nmfd_fit`` (the
  flagship, β=1) equal ``NMF.fit`` and ``NMFD.fit``, launch for launch;
  ``nmf_fit_batched`` (β ∈ {2, 1}) and ``plca_fit_batched`` over 16
  problems of 1025×400 rank 16 at a ``tol`` where they stop at different
  chunks, some in the replay: the chunk loop one CUDA-graph WHILE node,
  a cold fit (chunks 1-2 eager, one capture, one replay), a warm one (a
  cache hit: one replay, no capture) and one on a new V (one capture, one
  replay), each against ``_graph=False`` bit for bit, no host read after
  a replay, the replay against its device time, the warm fit's device
  time and idle share, the MU fits against their single fits; the
  ``BetaMu`` optimizer over the
  bench's chain (``torch.nn.Sequential`` of three ``NMF`` modules, 2048²
  target, 31 steps) and ``SparsityProj`` at 5168×1025 (11 steps, from a
  step of 1/L and of 8/L, where it backtracks), compiled into CUDA graphs
  (the default ``jit_compile=True``) against eager from the same start:
  within 1e-5, one replay a ``BetaMu`` step and no host read in its
  ``run``; one replay a ``SparsityProj`` step (its line search a WHILE
  node) and one host read a ``run``, bit for bit its ``_graph=False``
  twin; a closure that reads the host refused, ms/step both ways and the
  graph pools' reserved memory; and float64 numpy targets, which warn and
  fit in float32;
* the compiled fits, kept across fits (the fits' cache): each cell a cache
  cell.  At dense ``NMF`` 5168×1025 R=88 (β ∈ {0.5, 1, 2}), the reference
  demo's ``NMFD`` (1×1025×4997, R=3, T=400), the NMFD flagship (the
  device-bound control), the NMF2D and NMF3D rows, dense ``PLCA``
  5168×1025 R=88 (fused E-step) and the SIPLCA, SIPLCA2 and SIPLCA3 rows:
  100 iterations at ``tol=0``, the chunk loop one CUDA-graph WHILE node,
  in turns, a cold fit through the model's ``fit`` (chunks 1-2 eager, one
  capture, one replay, 5 host reads), the eager loop (``get_dense_fit`` or
  ``get_plca_fit`` with ``_graph=False``) from the same inits and from
  other inits (a host read a chunk), a warm fit from those (a hit: one
  replay, no capture, one host read) and a fit on a new V of the same
  configuration (one capture, one replay, one host read), each bit for
  bit its eager twin with exactly its B1-B4 launches (a replay's counted
  on the card), and the cache's hits and misses; the replay's
  ms/iteration (CUDA events around it) and its device time; chunk 1's
  time and the captures' host
  time; the peak device memory a fit adds above what was allocated before
  it; the cache's held bytes, by its count and as the card's memory freed
  by ``compiled_cache_clear``; the device time an iteration and the card's
  idle share, warm and eager (``torch.profiler``, 30-iteration fits);
  factors within 1e-6 of eager with the same ``n_iter`` at ``tol=1e-4``;
  and a fit whose updater reads the host refused on the card;
* ``streaming_nmf_fit`` with V in host memory: 5168×1025 (rank 88, β ∈ {1,
  0.5}) in 6 blocks of 1024 rows, exactly 2 B1 launches a block an
  iteration and one B2 a block a loss evaluation at β=0.5, equal to the
  in-memory ``NMF.fit`` within 1e-4; and a 1 GiB 65536×4096 target (rank
  64, β=1, 8 blocks): ms/iteration, the host-to-card rate and the share of
  the copies' time a kernel overlaps (``torch.profiler``);
* ``checkpointed_fit``: NMF 5168×1025 β=0.5 in two sessions (50
  iterations, then 150 more) in segments of 50, one capture for the four
  segments (the cache's hits), and the NMFD flagship at β=1 in segments
  of 10 (one B3 and one B4 an iteration), each equal to the uninterrupted
  fit;
* bfloat16 targets (a capacity knob: V held at half width on the card,
  factors and arithmetic float32): B1 (both sides, β=1 with and without
  the epilogue, β=0.5) and B2 (β=0.5) reading a bfloat16 V at 5168×1025
  R=88 against their plain versions, and timed beside the float32 kernels;
  ``NMF.fit`` with a bfloat16 host V at β ∈ {1, 0.5, 2} within 1e-4 of the
  float32 fit on the rounded V, with its ``n_iter`` and exactly its B1/B2
  launches, every one the bfloat16 instance's; ``nmf_fit``; the peak device
  memory of a β=1 fit at 65536×4097 R=64 on a target on the card (30
  iterations, the third chunk a graph replay) above the cache's held bytes
  (an earlier fit's entry), bfloat16 at most 0.6 of float32's; in float32
  a third configuration capped to fit only without the entries held: out
  of memory, the cache emptied, run once more, bit for bit its eager fit;
  ``streaming_nmf_fit`` with a bfloat16 host V (5168×1025 against the
  in-memory fit, and 65536×4096 in 0.5 GiB beside the float32
  run's rate); the NMFD flagship at β=1 and dense PLCA against their
  float32 fits on the rounded (PLCA: normalized) V;
* the autotuner (``PNT_NMFD_AUTOTUNE=1``; the earlier paths run at ``=0``,
  the static engine whose launches they count): the NMFD flagship at β ∈
  {1, 2}, its rank-8 row at β=2, the NMF2D row at β=1, the SIPLCA row's EM
  reconstruction and the NMFD flagship's Hoyer reconstruction; on the card
  the candidates are the kernel engines (``fused``, ``fused_w``; the EM
  and Hoyer reconstructions ``fused`` alone); their ms/iteration, the
  winner and the first resolution's seconds, the library engines timed
  beside them as yardsticks, every engine's fit within 1e-4 relative loss
  of the kernel engine's with its exact launches, the hybrid ``fused_w``
  on B4 alone (one launch an iteration, no B3), and the autotuned fit
  equal (``torch.equal``) to the winner's forced fit with the winner's
  exact B3/B4 counts;
* the sharded fits of ``pytorch_nmf_tpu_torch.parallel``, first after the
  kernel checks: 2 gloo ranks sharing the card (``spawn``; card tensors
  staged through pinned host memory where gloo cannot take them) run dense
  ``sharded_nmf_fit`` (5168×1025 rank 88 a rank, β ∈ {1, 0.5, 2}, a 2×1
  ``data``×``model`` mesh, an early stop), ``sharded_plca_fit``,
  ``sharded_sparse_nmf_fit`` (8192² rank 64, 671k non-zeros a rank), the
  halo ``sharded_nmfd_fit`` (1×1025×1250 a rank, rank 88, T=400, β ∈ {1, 2};
  rank 8; N=2), ``sharded_nmf2d_fit``, ``sharded_nmf3d_fit`` and
  ``sharded_siplca_fit``/``2`` (the SIPLCA rank-8 row a rank, the flagship
  split), and the halo fits' other per-shard modes, forced: ``fused_w``
  (B4 alone: NMFD β ∈ {1, 0.5}, NMF3D), ``stream`` and ``conv`` (NMFD),
  ``unrolled`` (NMF2D, SIPLCA2), the SIPLCA flagship in ``conv``, and the
  NMFD flagship in the mode its tuner resolves (rank 0 times, both ranks
  run its choice); one NCCL rank runs the dense cases (β ∈ {1, 0.5, 2},
  the 1×1 ``data``×``model`` mesh, the early stop), PLCA, sparse, the NMFD
  flagship (β ∈ {1, 2}, rank 8, N=2, ``fused_w``, ``conv``), NMF2D, NMF3D
  and SIPLCA/SIPLCA2 (the flagship also in ``conv``); NCCL across cards
  runs every case where there are several.  Each
  case agrees with the single-card fit of the whole problem (W, the
  assembled H and the final loss within 1e-4 relative, the same ``n_iter``
  and per-shard mode on every rank), each rank launches exactly the
  kernels its code and mode imply, and the ranks' ms/iteration and their
  collectives' calls, bytes and ms an iteration are printed beside the
  single-card fits of the whole problem and of one rank's block.  Over
  NCCL the sharded fits are compiled (their chunk loop one CUDA-graph
  WHILE node, the all-reduces and halo shifts captured): each NMF, PLCA
  and sparse case also runs 50 iterations (the early stop at its tol)
  cold, warm (on the same ``shard_target`` DTensors: a cache hit) and on a
  new V, each bit for bit its ``_graph=False`` twin on every rank, with 1,
  1 and 1 replays, 1, 0 and 1 captures and 5, 1 and 1 host reads; each
  halo case 30 iterations cold, warm, on another V of the same shape (a
  hit: the entry copies each fit's chunk into its own; its own eager
  twin) and recaptured (the entry dropped, its configuration kept: a
  capture before chunk 1), with 1, 1, 1 and 1 replays, 1, 0, 0 and 1
  captures and 5, 1, 1 and 1 host reads; B1-B4 launches and the
  all-reduces' and shifts' calls and bytes the twin's; it prints warm,
  eager, cold and new-V (other-V) ms/iteration beside the single-card warm
  fit of the same problem (one rank), the entry's held bytes and, for a
  halo fit, the bytes of its chunk of V it keeps (``par_compiled``); a
  ``conv``-mode case first runs two eager fits under cuDNN's default
  algorithms and prints their drift: the largest difference of W and H
  (SIPLCA: Z) between them and, on one rank, of each from the single-card
  fit, relative to the factor's largest value (``par_drift``); then
  the ranks destroy their group with the NMFD case's entry cached and no
  cache clear (C12: the call drops the group's compiled fits itself; a
  call still running after ``TEARDOWN_S`` fails the run), make it again
  and refit the case cold, bit for bit the first (``par_regroup``; one
  NCCL rank here, across cards in ``chip_tools/sharded_cards.py``); every
  rank's last teardown takes no cache clear either;
* the halo fits' mode tuner (``autotune.autotune_halo_mode``) at the NMFD
  flagship's, NMF2D's and NMF3D's per-rank problems: ``fused`` against
  ``fused_w`` over one rank's per-shard step without collectives, the
  winner and the first resolution's seconds, the library modes (``stream``,
  ``unrolled``, ``conv``) timed the same way as yardsticks;
* the example scripts of ``examples/torch_port/``, last: the audio
  separation (synthesized mixture, STFT, NMFD, Wiener masks, ISTFT) at the
  reference demo's width, the NMFD flagship's spectrogram (1×1025×≈5000,
  rank 3, T=400: about 116 s at 22050 Hz, hop 512), 100 iterations at β=1
  through the script's ``separate`` with exactly one B3 and one B4 launch
  an iteration, finite stems, its SI-SNR gain and ms/iteration printed,
  its first 10 iterations on the kernels within 1e-4 relative loss of the
  plain versions'; every script's ``main`` on the card against the same
  script on the CPU from the same numpy inits (within 1e-3 relative; the
  audio separation at the CPU test's size above 8 dB; ``multi_device_fit``
  with 2 gloo ranks sharing the card); the tutorial notebooks
  (``examples/torch_port/*.ipynb``, written on the card by
  ``make_notebooks.py``) executed on the card, each in a process of its
  own (``python3 chip_smoke.py --notebook NAME``), every cell's output the
  committed one (numbers within ``make_notebooks.RTOL``, integers equal,
  the device line this card's name), the basic tutorial on B1, B2 and P1;
  and the Hoyer projection's overflow
  case: NMFD 2×12×40 ``sparse_fit(beta=0.5, sW=0.4)`` finite on B3/B4 (2
  and 1 launches an iteration) and within 1e-4 of the plain twin over its
  first 5 iterations, dense NMF at 5168×1025 rank 88 (``sW=0.5``, β=0.5)
  finite.

1. prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``pytorch_nmf_tpu_torch/csrc``, one ``nvcc`` per source, in parallel;
2. holds each kernel against its plain PyTorch version on the card: B1/B2
   at 5168×1025 R=88 and 4096×4096 R=256, and at the streaming fits'
   blocks (1024 and 48 rows of 1025 in a 1028-float row stride, R=88, β ∈
   {1, 0.5}; 8192×4096 R=64, β=1) (rtol 1e-4), B3/B4 at the NMFD
   flagship, its rank-8 and rank-16 rows, N=2, the NMF2D/NMF3D rows and
   the reference demo's shapes (1×1025×4997, R=3, T=400), each B3 line
   naming its regime (ranks ≤ 16: the small-rank gemm kernel)
   (``max|kernel - plain| ≤ 1e-4·max|plain|``); and the SIPLCA E-step's
   dH, dW and dZ through the kernels against the plain twin at the SIPLCA
   row, its rank-8 row, N=2, and the SIPLCA2/SIPLCA3 rows (same bound);
   every summand is non-negative, so the only error is summation order;
   and the projection kernel P1 against its plain version at W 1025×88,
   the NMFD flagship's W 1025×88×400, NMF2D's W 512×128×64 and columns of
   2^20 values, one case in each of its regimes (one CTA a column, a
   cluster a column, streamed), each printing its regime, cluster, rounds
   and ``cudaOccupancyMaxActiveClusters`` (NaN in the same places, finite
   entries within 1e-5·max|plain|);
3. fits V with β ∈ {2, 1, 0, 0.5, 1.5} through ``NMF.fit``, and with β ∈ {1,
   2, 0.5} through ``NMFD.fit`` plus β=1 through ``NMF2D.fit`` and
   ``NMF3D.fit``; fits the SIPLCA family for 10 EM iterations (one B3 and
   one B4 launch each), dense PLCA both ways, the sparse targets and the
   paths of the slice above;
   checks the factors and that each path's kernels carried its fits (launch
   counts set to 0 before a path, read after it); then fits through the
   kernels and through the plain versions (dense and NMFD at β = 1 and 0.5,
   NMF2D and NMF3D at β = 1, the SIPLCA family; 100 dense, 10 deconv and EM
   iterations) and compares the final losses (1e-4 relative), as it does the
   sparse tiers' and the two PLCA E-steps'; holds the NMFD Hoyer fit's first
   gradients (``1e-4·max|plain|``) and its first 5 iterations' losses (1e-4
   relative) to the plain twin's;
4. times those fits per iteration and each kernel against its plain
   version and, for B3/B4, the one PyTorch call that computes the same
   function (``F.convNd`` and ``torch.nn.grad.convNd_weight``, cuDNN; the
   port never calls them), with CUDA events; each kernel's bound is the
   larger of its operations at the 3xTF32 rate and its bytes at the HBM
   rate (B4 also for the neg/pos pair: twice the operations; P1's the
   larger of its bytes once at the HBM rate and the operations of the
   rounds its columns needed at the f32 rate; P1's own time from CUDA
   graph replays, beside the streaming regime's on the same columns);
   splits one
   SIPLCA EM iteration's and one NMFD Hoyer iteration's device time
   (``torch.profiler``) into the reconstruction, B3, B4 and the rest; and
   prints the Hoyer fits' host reads per iteration (line-search comparisons
   and projection ``done`` checks).

Any failure raises (exit code ≠ 0).  The second-to-last line of standard
output is a JSON summary of the kernels (``launches`` summed over the
paths, ``launches_by_path`` per path; B3's small-rank regime apart as
``hgrad_r_le_16``, its launches those of B3's that ran it, its times at
the reference demo's shape; B1/B2's bfloat16-V instances as
``fused_contractions_bf16`` and ``fused_beta_loss_bf16``, with their
launches in the bfloat16 fits; P1 as ``hoyer_proj``, its launches
counted where launched, which in a graphed optimizer step is at capture;
a graphed fit's launches counted at every replay; B1 and B2 with their
times at 4096×4096 R=256 under ``wide``) and the fit times, the last line
``{"ok": true, "device": {...}}``.  Float32 matrix products and
convolutions run in full float32 (TF32 off), so the plain versions and the
library calls are true f32 too.  Needs one CUDA device; exits with an error
without one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
MAIN_SHAPE = (5168, 1025, 88)  # the reference benchmark (torchnmf's BASELINE)
WIDE_SHAPE = (4096, 4096, 256)
RTOL = 1e-4
BETAS = (2, 1, 0, 0.5, 1.5)
# the deconv models at full width, (N, C, S_out, kernel, R), from bench.py
DECONV = {
    "NMFD": (1, 1025, (5000,), (400,), 88),           # bench.py:115-126
    "NMF2D": (1, 512, (64, 64), (8, 8), 128),          # bench.py:145
    "NMF3D": (1, 64, (19, 19, 19), (4, 4, 4), 16),     # bench.py:153
}
DECONV_BETAS = (1, 2, 0.5)
# B3's small-rank regime (ranks ≤ 16, csrc/fused_deconv.cu's gemm kernel):
# its kernel line, and the case its times are read at, the reference demo's
# B3 (examples/torch_port/audio_separation.py at AUDIO_FULL: 1025 bins ×
# 4997 frames, R=3, T=400)
SMALL_B3 = "hgrad_r_le_16"
DEMO_B3 = "NMFD R=3 (demo)"
DECONV_DEMO = (1, 1025, (4997,), (400,), 3)
DECONV_ITERS = 10
# B3's small-rank regime past the former slab cap: the kernel line, its
# (R, L_in) cases at C = 1025, T = 400 (the cap fell at 41,943 columns at
# R=16, 167,772 at R=8 and 1,118,481 at R=3; 100,000 columns are about 39
# minutes of audio at the demo's hop), the line's times read at the first;
# and an NMFD fit there through the model, its B3 launches all windowed
B3_CAP = "hgrad_r_le_16_past_cap"
B3_CAP_CASES = ((16, 100_000), (8, 200_000), (3, 1_200_000))
B3_CAP_FIT = (1, 1025, (100_399,), (400,), 16)
B3_CAP_FIT_ITERS = 30  # 3 chunks: the third a graph replay
# C8: a kept dense fit after a write its target's version counter misses
# (V.data.mul_), on a card V with unaligned rows (the fused updaters' padded
# copy), against a cold fit of the new values
STALE_ITERS = 50
STALE_BETAS = (1, 0.5)
# the PLCA family at full width, (N, C, S_out, kernel, R), from bench.py
SIPLCA_ROWS = {
    "SIPLCA": (1, 513, (3000,), (200,), 64),           # bench.py:157
    "SIPLCA R=8": (1, 513, (3000,), (200,), 8),         # bench.py:157
    "SIPLCA N=2": (2, 513, (3000,), (200,), 64),
    "SIPLCA2": (1, 64, (64, 64), (8, 8), 16),           # bench.py:161
    "SIPLCA3": (1, 64, (19, 19, 19), (4, 4, 4), 16),    # the NMF3D row, bench.py:153
}
EM_ITERS = 10
PLCA_ITERS = 50  # dense PLCA at MAIN_SHAPE (bench.py:821-853)
# sparse targets: top 2% of MAIN_SHAPE (bench.py:535-540); (M, K, R, nnz)
# (bench.py:112); past the densify budget, (M, K, R, density)
SPARSE_ELL_CASE = (8192, 8192, 64, 671_000)
SPARSE_BIG = (131072, 65536, 64, 0.001)
SPARSE_ITERS = 10
SPARSE_BIG_ITERS = 30  # 3 chunks: the third a replay
SPARSE_ENV = ("PNT_SPARSE_DENSIFY", "PNT_SPARSE_ELL")
SPARSE_COMPILED_ITERS = 100  # the sparse fits graphed against eager
# a forced densify out of memory: the dense target (1 GiB) past the memory
# fraction's headroom, the ELL fit inside it
SPARSE_OOM_CASE = (16384, 16384, 64, 27_000)
SPARSE_OOM_HEADROOM = 384 * 2**20
SPARSE_OOM_ITERS = 30
SPARSE_HOYER_ITERS = 100
DENSE_ITERS = 100  # the β sweep's max_iter (tol=1e-4)
# Hoyer: dense NMF at MAIN_SHAPE (bench.py:711-733) and the NMFD flagship,
# β=2; per-iteration losses compared over the first HOYER_TRACE iterations
HOYER_DENSE_ITERS = 20
HOYER_NMFD_ITERS = 6
HOYER_TRACE = 5
HOYER_CASES = (("sW", dict(sW=0.5), (2, 1)),  # (B3, B4) launches/iteration
               ("sW+sH", dict(sW=0.5, sH=0.5), (1, 1)))
# the Hoyer fit's compiled chunk (the line search a CUDA-graph WHILE node):
# graphed against eager, (label, model, iterations, sparseness), and the
# batched Hoyer fit over BATCH's problems
HOYER_GRAPHED = (("dense NMF sW", "NMF", 100, dict(sW=0.5)),
                 ("NMFD sW", "NMFD", 30, dict(sW=0.5)),
                 ("NMFD sW+sH", "NMFD", 30, dict(sW=0.5, sH=0.5)))
HOYER_BATCH_ITERS = 30
# nested device loops (phase 4's nested_while): problems, channels, length,
# rank and kernel width of its convolutions
NESTED = (3, 64, 500, 8, 20)
FUNC_NMF_ITERS = 50
FUNC_NMFD_ITERS = 10
# the batched fit: 16 short spectrogram excerpts, (B, M, K, R)
BATCH = (16, 1025, 400, 16)
BATCH_ITERS = 50
# the BetaMu chain of bench.py:742-786 against a 2048² target
CHAIN = ((2048, 256), 128, (512, 256), (2048, 512))
BETAMU_STEPS = 30
SPARSITY_STEPS = 10
# SparsityProj's start steps, in units of 1/‖HᵀH‖₂: the first takes one
# attempt a step; from the second the line search backtracks; (label,
# multiple, twins: graphed, _graph=False, jit_compile=False)
SPARSITY_CASES = (("1/L", 1, ("compiled", "reference", "eager")),
                  ("8/L", 8, ("compiled", "reference")))
# streaming: MAIN_SHAPE in blocks of STREAM_ROW_BLOCK rows (6 blocks), and a
# host-resident 1 GiB target, (M, K, R, row_block)
STREAM_ROW_BLOCK = 1024
STREAM_ITERS = 20
STREAM_BETAS = (1, 0.5)
STREAM_BIG = (65536, 4096, 64, 8192)
STREAM_BIG_ITERS = 5
# the B1/B2 shapes the streaming fits give the kernels: (rows, K, R, betas)
STREAM_BLOCK_CASES = ((STREAM_ROW_BLOCK,) + MAIN_SHAPE[1:] + (STREAM_BETAS,),
                      (MAIN_SHAPE[0] % STREAM_ROW_BLOCK,) + MAIN_SHAPE[1:]
                      + (STREAM_BETAS,),
                      (STREAM_BIG[3], STREAM_BIG[1], STREAM_BIG[2], (1,)))
# checkpointed fits: two sessions of CKPT_EVERY dense iterations; the NMFD
# flagship in segments of CKPT_NMFD_EVERY
CKPT_EVERY = 50
CKPT_ITERS = 200  # the dense checkpointed fit: 4 segments, one capture
CKPT_NMFD_ITERS = 20
CKPT_NMFD_EVERY = 10
# the autotuner's cases at PNT_NMFD_AUTOTUNE=1: (label, model, beta, row)
TUNE_ITERS = 10
TUNE_CASES = (("NMFD", "NMFD", 1, (1, 1025, (5000,), (400,), 88)),
              ("NMFD", "NMFD", 2, (1, 1025, (5000,), (400,), 88)),
              ("NMFD R=8", "NMFD", 2, (1, 1025, (5000,), (400,), 8)),
              ("NMF2D", "NMF2D", 1, (1, 512, (64, 64), (8, 8), 128)))
# the H100 SXM's published peaks: f32-accurate products run at
# 3xTF32 on the tensor cores, 495/3 TFLOP/s, against 67 of f32 FMA on the
# CUDA cores; HBM moves 3.35 TB/s
TF32X3_FLOPS = 495e12 / 3
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# the Hoyer projection kernel (P1): the JAX package's projection is a
# lax.while_loop under vmap (no Pallas kernel); checked at the rank columns
# of W in the dense Hoyer fit and SparsityProj (1025×88: one CTA a column),
# of the NMFD flagship's W (1025×88×400: a cluster a column), of NMF2D's W
# (512×128×8×8, near the top of one CTA) and at columns of 2^20 values
# (2048×4×512: streamed, as no path of the repo needs), from rand + 0.1 to
# sparseness 0.5; the kernels' line keeps the NMFD case.  Per value and
# round it does about PROJ_OPS operations: w, its three products and sums
# (7), the step and its tests (5), the fix-up (3)
PROJ_NAME = "hoyer_proj"
PROJ_REPLACES = "pytorch_nmf_tpu/ops/projection.py:26"
PROJ_SOURCE = "pytorch_nmf_tpu_torch/csrc/hoyer_proj.cu"
PROJ_CASES = (("W 1025x88", (1025, 88)), ("NMFD W 1025x88x400", (1025, 88, 400)),
              ("NMF2D W 512x128x64", (512, 128, 64)),
              ("streamed 2048x4x512", (2048, 4, 512)))
PROJ_MAIN = "NMFD W 1025x88x400"
PROJ_OPS = 15
PROJ_RTOL = 1e-5
# the dense Hoyer fit's profile: fits of 1 and 1 + HOYER_PROFILE iterations
HOYER_PROFILE = 3
# compiled against eager optimizer steps: parameters within this of the
# eager twin's (max|Δ|/max|eager|)
COMPILED_RTOL = 1e-5
# the compiled fits: each cell's 10-iteration chunk replayed as a CUDA graph
# from chunk 3 on (the models' default) against the eager loop
# (``_graph=False`` of get_dense_fit and get_plca_fit), from the same
# inits: FIT_ITERS iterations at tol=0 timed in turns, a tol=FIT_TOL fit
# both ways, and FIT_PROFILE_ITERS iterations under torch.profiler both
# ways; factors within FIT_GAP (max|Δ|/max|eager|).  (label, model,
# shape, fit keywords): dense NMF and PLCA (M, K, R), the deconv and SIPLCA
# rows (N, C, S_out, kernel, R); dense PLCA with the fused E-step
# (PNT_PLCA_FUSED=1)
FIT_ITERS = 100
FIT_TOL = 1e-4
FIT_PROFILE_ITERS = 30
FIT_GAP = 1e-6
COMPILED_CELLS = (
    ("NMF beta=0.5", "NMF", MAIN_SHAPE, {"beta": 0.5}),
    ("NMF beta=1", "NMF", MAIN_SHAPE, {"beta": 1.0}),
    ("NMF beta=2", "NMF", MAIN_SHAPE, {"beta": 2.0}),
    ("NMFD demo R=3", "NMFD", DECONV_DEMO, {"beta": 1.0}),
    ("NMFD flagship", "NMFD", DECONV["NMFD"], {"beta": 1.0}),
    ("NMF2D", "NMF2D", DECONV["NMF2D"], {"beta": 1.0}),
    ("NMF3D", "NMF3D", DECONV["NMF3D"], {"beta": 1.0}),
    ("PLCA fused E-step", "PLCA", MAIN_SHAPE, {}),
    ("SIPLCA", "SIPLCA", SIPLCA_ROWS["SIPLCA"], {}),
    ("SIPLCA2", "SIPLCA2", SIPLCA_ROWS["SIPLCA2"], {}),
    ("SIPLCA3", "SIPLCA3", SIPLCA_ROWS["SIPLCA3"], {}),
)
REPLACES = {
    "fused_contractions": "pytorch_nmf_tpu/ops/pallas_mu.py:212",
    "fused_beta_loss": "pytorch_nmf_tpu/ops/pallas_mu.py:347",
    "hgrad": "pytorch_nmf_tpu/ops/pallas_deconv.py:392",
    "wgrad": "pytorch_nmf_tpu/ops/pallas_deconv.py:504",
}
SOURCES = {
    "fused_contractions": "pytorch_nmf_tpu_torch/csrc/fused_mu.cu",
    "fused_beta_loss": "pytorch_nmf_tpu_torch/csrc/fused_mu.cu",
    "hgrad": "pytorch_nmf_tpu_torch/csrc/fused_deconv.cu",
    "wgrad": "pytorch_nmf_tpu_torch/csrc/fused_deconv.cu",
}
# B1/B2's bfloat16-V instances (one template of csrc/fused_mu.cu), the
# JAX kernels they stand for taking V in any float dtype
BF16_KERNELS = {"fused_contractions_bf16": "fused_contractions",
                "fused_beta_loss_bf16": "fused_beta_loss"}
BF16_BETAS = (1, 0.5, 2)
# 4097 columns: rows padded to 4100 floats or 4104 bfloat16 values; V is
# 1.07 GB in float32, 0.54 GB in bfloat16
BF16_CAPACITY = (65536, 4097, 64)
BF16_CAPACITY_ITERS = 30  # 3 chunks: the third a graph replay
BF16_PEAK_RATIO = 0.6
# the examples phase (examples/torch_port/): the audio separation at the
# reference demo's shapes, the NMFD flagship's spectrogram (bench.py:116-122:
# 1025 bins × about 5000 frames, R=3, T=400): about 116 s at 22050 Hz, STFT
# of 2048 samples, hop 512
EXAMPLES = "examples/torch_port"
AUDIO_FULL = dict(sr=22050, duration=116.0, rank=3, T=400, nperseg=2048,
                  noverlap=1536)
AUDIO_ITERS = 100
AUDIO_TRACE = 10
# the CPU test's setting (tests/test_torch_examples.py), gain above 8 dB
AUDIO_SMALL = dict(sr=8000, duration=2.0, rank=3, T=8, nperseg=256,
                   max_iter=200, verbose=False)
AUDIO_MIN_GAIN = 8.0
EXAMPLE_RTOL = 1e-3  # a script's numbers, card against CPU
# the port's tutorial notebooks (examples/torch_port/*.ipynb, written on the
# card by make_notebooks.py), executed here and held to their committed
# outputs within make_notebooks.RTOL (its comment gives the reason)
NOTEBOOKS = ("basic_tutorial", "source_filter_model")
# the Hoyer projection's overflow case: NMFD V 2×12×40, R=3, T=5, every
# array rand + 0.01 (numpy seeds 0 and 1), sparse_fit(beta=0.5, sW=0.4);
# and dense NMF at MAIN_SHAPE, sparse_fit(beta=0.5, sW=0.5), on a target at
# a scale where the fit stays finite (0.01·(rand + 1e-3); from rand + 1e-3
# both packages reach NaN in 2 iterations)
C3_PROBE = ((2, 12, 40), (12, 3, 5), (2, 3, 36))
C3_PROBE_ITERS = 8
C3_DENSE_SCALE = 0.01


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Mean device milliseconds of ``fn()`` from replays of a CUDA graph of
    ``reps`` calls (no host time between the launches)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del g
    return ms


def bound(flops, nbytes):
    """``(bound_ms, bound_by, cuda_core_ms)``: the least time the card could
    take for ``flops`` f32-accurate operations and ``nbytes`` of traffic
    (each input read once, each output written once), and the operations'
    time at the CUDA cores' f32 peak."""
    ops_ms, bytes_ms = 1e3 * flops / TF32X3_FLOPS, 1e3 * nbytes / HBM_BYTES
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", 1e3 * flops / FP32_FLOPS)


def new_stats():
    return {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": None,
            "plain_ms": None, "library_ms": None, "bound_ms": None,
            "bound_by": None}


def inputs(M, K, R, seed=SEED):
    rs = np.random.RandomState(seed)
    V = np.abs(rs.randn(M, K)).astype("f") + 0.01
    W = np.abs(rs.randn(K, R)).astype("f")
    H = np.abs(rs.randn(M, R)).astype("f")
    return (torch.from_numpy(x).cuda() for x in (V, W, H))


def compare_kernels(fm, kl_pos_W, kl_pos_H):
    """Phase 2: each dense kernel against its plain version; returns
    per-kernel errors, times and bounds (:func:`new_stats`) and prints
    every case.  Neither kernel has a library call that computes its
    function (each is two GEMMs around an elementwise map)."""
    stats = {name: new_stats()
             for name in ("fused_contractions", "fused_beta_loss")}

    def record(name, got, ref):
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.is_cuda, f"{name}: bad output")
        err = (got - ref).abs()
        rel = float((err / ref.abs().clamp_min(1e-30)).max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=0)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], float(err.max()))
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        return rel

    def set_times(name, ms, pms, flops, nbytes, wide=None):
        """The kernel's times and bound; at another case than MAIN_SHAPE
        (``wide`` names it) under the kernel's ``"wide"`` key."""
        b_ms, b_by, fp32_ms = bound(flops, nbytes)
        times = dict(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
        if wide is None:
            stats[name].update(times)
        else:
            stats[name]["wide"] = dict(times, case=wide)
        print(f"{name}{'' if wide is None else ' at ' + wide}: kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{fp32_ms:.4f} at the CUDA cores' f32 peak), "
              f"{100 * b_ms / ms:.1f}% of it", flush=True)

    for M, K, R in (MAIN_SHAPE, WIDE_SHAPE):
        V, W, H = inputs(M, K, R)
        # rows padded to 16 bytes, as the fit does once per fit (fast_nmf)
        V = fm.aligned_rows(V)
        for w_side in (True, False):
            cases = [(b, True, None) for b in (0.0, 0.5, 1.5)] + [
                (1.0, False, None),
                (1.0, False, kl_pos_W(H) if w_side else kl_pos_H(W)),
            ]
            for beta, need_pos, mu_pos in cases:
                kw = dict(beta=beta, need_pos=need_pos, w_side=w_side,
                          mu_pos=mu_pos)
                got = fm.fused_contractions(V, H, W, **kw)
                ref = fm.plain_contractions(V, H, W, **kw)
                rels = [record("fused_contractions", g, r)
                        for g, r in zip(got, ref) if r is not None]
                side = "W" if w_side else "H"
                case = "epilogue" if mu_pos is not None else (
                    "neg+pos" if need_pos else "neg")
                line = (f"B1 {M}x{K} R={R} {side}-side beta={beta} {case}: "
                        f"max rel err {max(rels):.3g}")
                ms = cuda_ms(lambda: fm.fused_contractions(V, H, W, **kw))
                pms = cuda_ms(lambda: fm.plain_contractions(V, H, W, **kw))
                line += f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
                print(line, flush=True)
        # at WIDE_SHAPE the times go into the kernel's "wide" entry
        wide = None if (M, K, R) == MAIN_SHAPE else f"{M}x{K} R={R}"
        for beta in (0.0, 0.5, 1.5):
            rel = record("fused_beta_loss", fm.fused_beta_loss(V, H, W, beta),
                         fm.plain_beta_loss(V, H, W, beta))
            line = f"B2 {M}x{K} R={R} beta={beta}: rel err {rel:.3g}"
            if wide is None or beta == 0.5:
                ms = cuda_ms(lambda: fm.fused_beta_loss(V, H, W, beta))
                pms = cuda_ms(lambda: fm.plain_beta_loss(V, H, W, beta))
                line += f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
                if beta == 0.5:  # the WH product; V, H, W read once
                    set_times("fused_beta_loss", ms, pms, 2 * M * K * R,
                              4 * (M * K + (M + K) * R + 1), wide)
            print(line, flush=True)
        # B1's time: one β=0.5 MU iteration's contractions (W side then H
        # side, numerator and denominator); per side the WH product and two
        # contractions, V, H, W read and two factor-sized outputs written
        def both(fn):
            fn(V, H, W, beta=0.5, need_pos=True, w_side=True)
            fn(V, H, W, beta=0.5, need_pos=True, w_side=False)

        set_times("fused_contractions",
                  cuda_ms(lambda: both(fm.fused_contractions)),
                  cuda_ms(lambda: both(fm.plain_contractions)),
                  2 * 6 * M * K * R,
                  2 * 4 * (M * K + (M + K) * R) + 2 * 4 * 2 * (M + K) * R,
                  wide)
        del V, W, H
    # the streaming fit's blocks (ops/streaming.py): views of the device
    # buffers, whose rows are padded to 4 floats (K=1025: a 1028-float row
    # stride), W-side raw accumulators (no epilogue), the H update's calls
    # and B2 per block; a short last block; the 1 GiB target's blocks
    for M, K, R, betas in STREAM_BLOCK_CASES:
        V, W, H = inputs(M, K, R)
        buf = V.new_zeros((M, K + -K % 4))
        buf[:, :K] = V
        V = buf[:, :K]
        for beta in betas:
            cases = [("W", True, None, None)] if beta == 1 else [
                ("W", True, True, None), ("H", False, True, None)]
            if beta == 1:
                cases.append(("H", False, False, kl_pos_H(W)))
            for side, w_side, need_pos, mu_pos in cases:
                kw = dict(beta=beta, need_pos=bool(need_pos), w_side=w_side,
                          mu_pos=mu_pos)
                got = fm.fused_contractions(V, H, W, **kw)
                ref = fm.plain_contractions(V, H, W, **kw)
                rels = [record("fused_contractions", g, r)
                        for g, r in zip(got, ref) if r is not None]
                case = "epilogue" if mu_pos is not None else (
                    "raw neg+pos" if need_pos else "raw neg")
                print(f"B1 streaming block {M}x{K} (row stride {buf.shape[1]}) "
                      f"R={R} {side}-side beta={beta} {case}: max rel err "
                      f"{max(rels):.3g}", flush=True)
            if beta not in (1, 2):
                rel = record("fused_beta_loss",
                             fm.fused_beta_loss(V, H, W, beta),
                             fm.plain_beta_loss(V, H, W, beta))
                print(f"B2 streaming block {M}x{K} (row stride {buf.shape[1]}) "
                      f"R={R} beta={beta}: rel err {rel:.3g}", flush=True)
        del V, W, H, buf
    return stats


def deconv_operands(F, N, C, S_out, kernel, R, seed=SEED):
    """One hgrad/wgrad call of the engine at this size, on the card: the
    flat kernel, the flat (or N > 1 stacked) activation and two channels-last
    cotangents of random positive values."""
    rs = np.random.RandomState(seed)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    H = torch.from_numpy(rs.rand(N, R, *S_in).astype("f")).cuda()
    W = torch.from_numpy(rs.rand(C, R, *kernel).astype("f")).cuda()
    cots = cots_m = [
        torch.from_numpy(rs.rand(N, int(np.prod(S_out)), C).astype("f")).cuda()
        for _ in range(2)]
    _, geom, T_geo, L_flat = F._flat_geom((N, C) + tuple(S_out), H.shape)
    if N > 1:
        seg = T_geo - 1 + L_flat
        H2, lead, L_h = F._h_stacked(H, kernel, T_geo), False, N * seg
        cots = [F._cot_stacked(c, seg) for c in cots]
    else:
        H2, lead, L_h = F._h_flat_nd(H, kernel), True, L_flat
        cots = [c[0] for c in cots]
    # the model layouts, for the library calls: cotangents (N, C, *S_out)
    cot_m = cots_m[0].reshape((N,) + tuple(S_out) + (C,)).movedim(-1, 1)
    return dict(H=H, W=W, W2=F._w2(W), H2=H2, cots=cots, R=R, geom=geom,
                T=T_geo, L_h=L_h, lead=lead, cot_m=cot_m.contiguous())


def compare_deconv_kernels(F, D, kl_pos_W):
    """Phase 2, B3/B4: each against its plain version at the deconv path's
    shapes, and timed there beside its plain version and its library call
    (cuDNN, TF32 off; the port never calls these): B3 is the correlation
    ``F.convNd(cot, Wᵀ)``, B4 with one cotangent the weight gradient
    ``torch.nn.grad.convNd_weight(H, W.shape, cot, padding=k-1)`` of the
    reconstruction (its kernel flipped); then at the halo fits' layouts
    (:func:`compare_halo_kernels`).  Returns per-kernel errors (over every
    case), times and bounds at the NMFD flagship (:func:`new_stats`), and
    B3's small-rank regime apart (``SMALL_B3``: its errors over every case
    of rank ≤ 16, its times at the reference demo's shape)."""
    stats = {name: new_stats() for name in ("hgrad", "wgrad", SMALL_B3)}

    def record(name, case, got, ref, small=False):
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.is_cuda, f"{name} {case}: bad output")
        check(bool(torch.isfinite(got).all()), f"{name} {case}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= RTOL, f"{name} {case}: max|kernel-plain| / max|plain| = {rel:.3g}")
        for st in [stats[name]] + ([stats[SMALL_B3]] if small else []):
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["max_rel_err"] = max(st["max_rel_err"], rel)
        return rel

    N, C, S_out, kernel, R = DECONV["NMFD"]
    cases = [
        ("NMFD", DECONV["NMFD"]),
        ("NMFD R=8", (N, C, S_out, kernel, 8)),  # bench.py:116
        ("NMFD N=2", (2, C, S_out, kernel, R)),
        ("NMF2D", DECONV["NMF2D"]),
        ("NMF3D", DECONV["NMF3D"]),
        (DEMO_B3, DECONV_DEMO),
        ("NMFD R=16", (N, C, S_out, kernel, 16)),
    ]
    for label, shape in cases:
        op = deconv_operands(F, *shape)
        R_, T, geom, lead = op["R"], op["T"], op["geom"], op["lead"]
        cot, pair, W2, H2 = op["cots"][0], op["cots"], op["W2"], op["H2"]
        kw = dict(lead_pad=lead, geom=geom)
        epi = dict(kw, mu_w2=W2, mu_pos=kl_pos_W(op["H"]).reshape(-1))
        calls = {
            "hgrad": lambda fn: fn(cot, W2, R_, op["L_h"], geom=geom),
            "wgrad beta=1 neg": lambda fn: fn([cot], H2, R_, T, **kw)[0],
            "wgrad beta=1 epilogue": lambda fn: fn([cot], H2, R_, T, **epi)[0],
            "wgrad beta=0.5 neg+pos": lambda fn: fn(pair, H2, R_, T, **kw),
        }
        nd = len(shape[3])
        pad = tuple(k - 1 for k in shape[3])
        conv = getattr(torch.nn.functional, f"conv{nd}d")
        conv_weight = getattr(torch.nn.grad, f"conv{nd}d_weight")
        Wt = op["W"].transpose(0, 1)
        H_m, W_shape, cot_m = op["H"], op["W"].shape, op["cot_m"]
        library = {
            "hgrad": lambda: conv(cot_m, Wt),
            "wgrad beta=1 neg": lambda: conv_weight(H_m, W_shape, cot_m,
                                                    padding=pad),
        }
        Lp, C_ = cot.shape
        K = W2.shape[0] // R_
        wgrad_work = (2 * K * R_ * C_ * Lp,
                      4 * (op["L_h"] * R_ + Lp * C_ + K * R_ * C_))
        work = {  # (operations, bytes) of one call
            "hgrad": (2 * R_ * op["L_h"] * K * C_,
                      4 * (Lp * C_ + K * R_ * C_ + R_ * op["L_h"])),
            "wgrad beta=1 neg": wgrad_work,
            # the pair: twice the operations, two cotangents in, two out
            "wgrad beta=0.5 neg+pos": (2 * wgrad_work[0], 4 * (
                op["L_h"] * R_ + 2 * Lp * C_ + 2 * K * R_ * C_)),
        }
        for case, call in calls.items():
            name = case.split()[0]
            fn, plain = getattr(D, name), getattr(D, f"plain_{name}")
            got, ref = call(fn), call(plain)
            if not isinstance(got, list):
                got, ref = [got], [ref]
            small = name == "hgrad" and R_ <= 16
            rel = max(record(name, f"{label} {case}", g, r, small)
                      for g, r in zip(got, ref))
            line = f"B{3 if name == 'hgrad' else 4} {label} {case}: max rel err {rel:.3g}"
            if name == "hgrad":
                line += f", regime {b3_plan(D, op).regime}"
            timed = label == "NMFD" or case in library
            if timed:
                ms = cuda_ms(lambda: call(fn), reps=10, warmup=1)
                pms = cuda_ms(lambda: call(plain), reps=10, warmup=1)
                line += f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
            if case in library:
                lms = cuda_ms(library[case], reps=10, warmup=1)
                line += f", library {lms:.4f} ms"
            if timed and case in work:
                b_ms, b_by, fp32_ms = bound(*work[case])
                line += (f", bound {b_ms:.4f} ms ({b_by}; {fp32_ms:.4f} at "
                         f"the CUDA cores' f32 peak), {100 * b_ms / ms:.1f}% "
                         "of it")
            if case in library and label == "NMFD":
                stats[name].update(ms=ms, plain_ms=pms, library_ms=lms,
                                   bound_ms=b_ms, bound_by=b_by)
            if name == "hgrad" and label == DEMO_B3:
                stats[SMALL_B3].update(ms=ms, plain_ms=pms, library_ms=lms,
                                       bound_ms=b_ms, bound_by=b_by)
            print(line, flush=True)
    compare_halo_kernels(F, D, record)
    return stats


def b3_plan(D, op):
    """B3's launch plan (``fused_deconv._hgrad_plan``) for the operands of
    :func:`deconv_operands`."""
    R, cot = op["R"], op["cots"][0]
    K = op["W2"].shape[0] // R
    return D._hgrad_plan(R, op["L_h"], -(-cot.shape[1] // 4) * 4, K,
                         D._geom_args(K, op["geom"]),
                         torch.cuda.get_device_properties(0).multi_processor_count)


def compare_b3_past_cap(F, D):
    """Phase 2, B3's small-rank regime past the former slab cap
    (:data:`B3_CAP_CASES`): the plan's windows along L_in against the
    plain version (at RTOL), against one launch of the same plan over the
    whole length (bit for bit; its slabs, 320-640 MB, pass the cap on
    purpose), and timed beside the tensor-core kernel the plan fell back
    to before, the plain version, ``F.conv1d`` (cuDNN, TF32 off) and the
    bound.  Returns the line's stats, its times at the first case."""
    st = new_stats()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    T, C = 400, 1025
    for R, L in B3_CAP_CASES:
        rs = np.random.RandomState(SEED)
        Lp = L + T - 1
        cot = torch.from_numpy(rs.rand(Lp, C).astype("f")).cuda()
        W = torch.from_numpy(rs.rand(C, R, T).astype("f")).cuda()
        W2 = F._w2(W)
        p = D._hgrad_plan(R, L, -(-C // 4) * 4, T, D._geom_args(T, None), sms)
        windows = D._hgrad_windows(p, L)
        check(p.regime == "gemm" and len(windows) > 1,
              f"B3 R={R} L_in={L}: plan {p}")
        check(all(p.slabs * R * (b - a) <= D._MAX_SLAB_FLOATS
                  for a, b in windows),
              f"B3 R={R} L_in={L}: slabs over the cap")
        n = (D.hgrad.launches_gemm, D.hgrad.launches_windowed)
        got = D.hgrad(cot, W2, R, L)
        check((D.hgrad.launches_gemm - n[0], D.hgrad.launches_windowed - n[1])
              == (1, 1), f"B3 R={R} L_in={L}: not one windowed gemm launch")
        whole = D.hgrad(cot, W2, R, L, plan=p._replace(window=0))
        ref = D.plain_hgrad(cot, W2, R, L)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"B3 R={R} L_in={L}: non-finite")
        check(torch.equal(got, whole),
              f"B3 R={R} L_in={L}: windows differ from one launch")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= RTOL, f"B3 R={R} L_in={L}: max|kernel-plain| / "
              f"max|plain| = {rel:.3g}")
        tc = D._tc_plan(R, L, -(-C // 4) * 4, T, sms)
        tc_rel = float((D.hgrad(cot, W2, R, L, plan=tc) - ref).abs().max()) / \
            float(ref.abs().max())
        check(tc_rel <= RTOL, f"B3 R={R} L_in={L} tc: rel err {tc_rel:.3g}")
        del whole, ref
        cot_m = cot.T.unsqueeze(0).contiguous()
        Wt = W.transpose(0, 1)
        ms = cuda_ms(lambda: D.hgrad(cot, W2, R, L), reps=10, warmup=1)
        tc_ms = cuda_ms(lambda: D.hgrad(cot, W2, R, L, plan=tc), reps=3,
                        warmup=1)
        pms = cuda_ms(lambda: D.plain_hgrad(cot, W2, R, L), reps=3, warmup=1)
        lms = cuda_ms(lambda: torch.nn.functional.conv1d(cot_m, Wt), reps=2,
                      warmup=1)
        b_ms, b_by, _ = bound(2 * R * L * T * C,
                              4 * (Lp * C + T * R * C + R * L))
        print(f"B3 past the cap, R={R} L_in={L} C={C} T={T}: plan {p}, "
              f"{len(windows)} windows of {p.window} columns; max rel err "
              f"{rel:.3g}, bit for bit one launch; kernel {ms:.4f} ms, the "
              f"tensor-core kernel (the former fallback) {tc_ms:.4f} ms "
              f"({tc_ms / ms:.2f}x), plain {pms:.4f} ms, library "
              f"{lms:.4f} ms (F.conv1d), bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / ms:.1f}% of it", flush=True)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        if st["ms"] is None:
            st.update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                      bound_by=b_by, tc_ms=tc_ms)
        del cot, W, W2, got, cot_m, Wt
        torch.cuda.empty_cache()
    # below the cap: the demo's B3 in windows of 3 blocks, bit for bit
    op = deconv_operands(F, *DECONV_DEMO)
    cot, W2 = op["cots"][0], op["W2"]
    whole = b3_plan(D, op)
    p = whole._replace(window=3 * whole.bm)
    a = D.hgrad(cot, W2, 3, op["L_h"], plan=p)
    b = D.hgrad(cot, W2, 3, op["L_h"], plan=whole)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "B3 demo: windows differ from one launch")
    print(f"B3 demo in {len(D._hgrad_windows(p, op['L_h']))} windows of "
          f"{p.window} columns: bit for bit one launch", flush=True)
    return {B3_CAP: st}


def deconv_long_fit(models, beta_div, D, ctr, card, fit_ms):
    """Phase 3, B3 past the former slab cap through the user's entry
    point: ``NMFD.fit`` at rank 16 on 100,000 activation columns
    (:data:`B3_CAP_FIT`), β=1, :data:`B3_CAP_FIT_ITERS` iterations, every
    B3 launch the gemm regime in windows (one an iteration).  Returns the
    path's launch counts."""
    zero(ctr)
    N, C, S_out, kernel, R = B3_CAP_FIT
    rs = np.random.RandomState(SEED)
    V = torch.from_numpy(np.abs(rs.randn(N, C, *S_out)).astype("f")).cuda()
    m = models.NMFD((N, C) + S_out, R, T=kernel[0], device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED))
    before = float(beta_div(m().detach(), V, 1))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    n_iter = m.fit(V, beta=1, tol=0, max_iter=B3_CAP_FIT_ITERS)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / B3_CAP_FIT_ITERS
    after = float(beta_div(m().detach(), V, 1))
    launches = read(ctr)
    b3 = launches["hgrad"]
    for p in (m.W, m.H):
        check(bool(torch.isfinite(p).all()) and bool((p >= 0).all()),
              "NMFD past the cap: a non-finite or negative factor")
    check(after < before, f"NMFD past the cap: loss {before} -> {after}")
    check(int(b3) == b3.small == b3.windowed == B3_CAP_FIT_ITERS,
          f"NMFD past the cap: B3 {int(b3)}, gemm {b3.small}, windowed "
          f"{b3.windowed}")
    fit_ms["nmfd_past_cap_1025x100399_r16_k400_beta1"] = ms
    print(f"phase 3: NMFD past the cap (1x{C}x{S_out[0]} R={R} T={kernel[0]}, "
          f"beta=1) n_iter={n_iter} loss {before:.6g} -> {after:.6g}, "
          f"{ms:.3f} ms/iteration; launches B3 {int(b3)} (windowed "
          f"{b3.windowed}), B4 {launches['wgrad']} [{card}]", flush=True)
    del V, m
    return launches


def stale_target(ns, ctr, card):
    """Phase 3, C8 on the card: a kept dense fit sees its target's new
    values.  A CUDA float32 V at MAIN_SHAPE passed as it is (4100-byte
    rows: the fused updaters keep a padded copy), fitted, then written
    through ``V.data.mul_(3)`` (no version counter moves: the next fit is
    a hit, one that captures nothing), fitted warm, then cold after
    ``compiled_cache_clear``: the warm fit equals the cold one bit for
    bit.  The cache's held bytes before and after the write's fit."""
    from pytorch_nmf_tpu_torch.ops import graphs

    solver, Graphs = ns.solver, graphs._Graphs
    M, K, R = MAIN_SHAPE
    zero(ctr)
    for beta in STALE_BETAS:
        solver.compiled_cache_clear()
        V, _, _ = inputs(M, K, R)
        check(V.data_ptr() % 16 == 0 and V.stride(0) * 4 % 16,
              "the stale-target V has aligned rows")

        def fit():
            m = ns.NMF((M, K), R, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(SEED))
            m.fit(V, beta=beta, tol=0, max_iter=STALE_ITERS)
            return m.W.detach().clone(), m.H.detach().clone()

        first = fit()
        held = solver.compiled_cache_info()["held_bytes"]
        V.data.mul_(3)
        counts, captures = cache_counts(solver), Graphs.captures
        warm = fit()
        after = cache_counts(solver)
        check(after["hits"] == counts["hits"] + 1
              and Graphs.captures == captures,
              f"C8 beta={beta}: the fit after the write was not a hit "
              f"without a capture ({counts} -> {after})")
        held_warm = solver.compiled_cache_info()["held_bytes"]
        solver.compiled_cache_clear()
        cold = fit()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(warm, cold)),
              f"C8 beta={beta}: the warm fit differs from the cold fit "
              "of the new values")
        check(not torch.equal(warm[0], first[0]),
              f"C8 beta={beta}: the write changed nothing")
        print(f"phase 3: C8 beta={beta} {M}x{K} R={R} unaligned card V, "
              f"{STALE_ITERS} iterations: warm fit after V.data.mul_(3) bit "
              f"for bit the cold fit (a hit, no capture); held bytes "
              f"{held} before, {held_warm} after [{card}]", flush=True)
        del V
    solver.compiled_cache_clear()
    return read(ctr)


def halo_layouts():
    """One rank's B3/B4 layout of each halo fit of PAR_CASES over PAR_WORLD
    ranks (``parallel.halo._Layout``, as the fit builds it), one per
    distinct shape: ``[(case, layout, C)]``."""
    from pytorch_nmf_tpu_torch.parallel import halo

    out, seen = [], set()
    for name, (kind, shape, _) in PAR_CASES.items():
        if kind not in ("deconv", "siplca"):
            continue
        N, C, R, lead_in, kernel, L_loc = shape
        L_out = L_loc * (2 if name.startswith("siplca_flagship")
                         else PAR_WORLD)
        chunk = max(-(-L_out // PAR_WORLD), kernel[-1] - 1)
        key = (N, C, R, lead_in, kernel, chunk)
        if key not in seen:
            seen.add(key)
            out.append((name, halo._Layout(N, R, lead_in, chunk, kernel), C))
    return out


def compare_halo_kernels(F, D, record):
    """Phase 2, B3/B4 at the halo fits' layouts: B4 in VALID mode
    (``lead_pad=False``) on the halo'd activation with its cotangents'
    trailing zeros, one cotangent and the neg/pos pair; B3 on the cotangent
    with ``kx - 1`` leading zeros a row over ``N·La`` rows; N-D in the
    flat-offset mode with the first lead axis unpadded at N=1.  Each against
    its plain version (``record``: at RTOL)."""
    for name, lay, C in halo_layouts():
        rs = np.random.RandomState(SEED)
        hh = torch.from_numpy(rs.rand(lay.N, lay.R, *lay.lead_in,
                                      lay.Xa).astype("f")).cuda()
        W2 = F._w2(torch.from_numpy(
            rs.rand(C, lay.R, *lay.kernel).astype("f")).cuda())
        rows = int(np.prod(lay.lead_out)) * lay.chunk
        cots = [torch.from_numpy(rs.rand(lay.N, rows, C).astype("f")).cuda()
                for _ in range(2)]
        H2, ch = lay.act_w(hh), lay.cot_h(cots[0])
        cw = [lay.cot_w(c) for c in cots]
        kw = dict(lead_pad=False, geom=lay.geom)
        calls = {
            "hgrad": lambda fn: fn(ch, W2, lay.R, lay.N * lay.La,
                                   geom=lay.geom),
            "wgrad one cotangent": lambda fn: fn(cw[:1], H2, lay.R, lay.T,
                                                 **kw)[0],
            "wgrad neg+pos": lambda fn: fn(cw, H2, lay.R, lay.T, **kw),
        }
        label = (f"halo layout of {name} (N={lay.N}, R={lay.R}, chunk "
                 f"{lay.chunk}, Xa {lay.Xa}, activation {tuple(H2.shape)}, "
                 f"B3 rows {tuple(ch.shape)})")
        for case, call in calls.items():
            kernel = case.split()[0]
            got, ref = call(getattr(D, kernel)), call(getattr(D, f"plain_{kernel}"))
            if not isinstance(got, list):
                got, ref = [got], [ref]
            rel = max(record(kernel, f"{label} {case}", g, r,
                             kernel == "hgrad" and lay.R <= 16)
                      for g, r in zip(got, ref))
            print(f"B{3 if kernel == 'hgrad' else 4} {label} {case}: max rel "
                  f"err {rel:.3g} (limit {RTOL})", flush=True)
        del hh, W2, cots, H2, cw, ch


def deconv_model(name, models):
    N, C, S_out, kernel, R = DECONV[name]
    kw = {"T": kernel[0]} if name == "NMFD" else {"kernel_size": kernel}
    return getattr(models, name)((N, C) + S_out, R, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED),
                        **kw)


def deconv_target(name):
    N, C, S_out, _, _ = DECONV[name]
    rs = np.random.RandomState(SEED)
    return torch.from_numpy(np.abs(rs.randn(N, C, *S_out)).astype("f")
                            + 0.01).cuda()


def deconv_fits(models, beta_div, fm, D, card):
    """Phase 3, the deconv path: every fit on the kernels B3/B4 and none
    on B1/B2.  Returns the launch counts of the path's run."""
    ctr = counters(fm, D)
    zero(ctr)
    runs = [("NMFD", b) for b in DECONV_BETAS] + [("NMF2D", 1), ("NMF3D", 1)]
    for name, beta in runs:
        V = deconv_target(name)
        m = deconv_model(name, models)
        before = float(beta_div(m().detach(), V, beta))
        n_b3, n_b4 = D.hgrad.launches, D.wgrad.launches
        t0 = time.perf_counter()
        n_iter = m.fit(V, beta=beta, tol=0, max_iter=DECONV_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = float(beta_div(m().detach(), V, beta))
        d_b3, d_b4 = D.hgrad.launches - n_b3, D.wgrad.launches - n_b4
        tag = f"{name} beta={beta}"
        check(m.W.is_cuda and m.H.is_cuda, f"{tag}: factors left the card")
        for p in (m.W, m.H):
            check(bool(torch.isfinite(p).all()), f"{tag}: non-finite factor")
            check(bool((p >= 0).all()), f"{tag}: negative factor")
        check(after < before, f"{tag}: loss {before} -> {after} did not fall")
        check(d_b3 > 0 and d_b4 > 0, f"{tag}: {d_b3} B3 and {d_b4} B4 launches")
        print(f"phase 3: {tag} n_iter={n_iter} loss {before:.6g} -> "
              f"{after:.6g} in {secs:.2f} s; launches B3 {d_b3}, B4 {d_b4} "
              f"[{card}]", flush=True)
        del V, m
    launches = read(ctr)
    check(launches["fused_contractions"] == launches["fused_beta_loss"] == 0,
          f"the deconv fits launched B1/B2: {launches}")
    return launches


def time_fits(run_kernel, run_plain, loss_of, iters, tag):
    """Phases 3 and 4: the kernel path against the plain path, each run
    (``run_*() -> factors``) from the same inits, timed in turns (plain,
    kernel, kernel, plain) after a warm-up of each; the final losses
    (``loss_of(*factors)``) must agree within 1e-4 relative.  Returns the
    ms/iteration of each run."""
    run_kernel(), run_plain()  # warm-up
    times = {"kernel": [], "plain": []}
    finals = {}
    for path, fn in (("plain", run_plain), ("kernel", run_kernel),
                     ("kernel", run_kernel), ("plain", run_plain)):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        factors = fn()
        end.record()
        torch.cuda.synchronize()
        times[path].append(start.elapsed_time(end) / iters)
        finals[path] = loss_of(*factors)
    rel = abs(finals["kernel"] - finals["plain"]) / abs(finals["plain"])
    check(rel <= 1e-4, f"{tag}: kernel loss {finals['kernel']} vs "
          f"plain {finals['plain']} (rel {rel:.3g})")
    print(f"phase 3: {tag} {iters} iterations, final loss kernel "
          f"{finals['kernel']:.7g} plain {finals['plain']:.7g} "
          f"(rel {rel:.3g})", flush=True)
    return times


def nmf_runs(m, V, fit_kw, plain_fit):
    """``(run_kernel, run_plain)`` for :func:`time_fits`: ``m.fit`` from
    the model's current factors, and ``plain_fit(V, W, H)`` from the same."""
    W0, H0 = m.W.detach().clone(), m.H.detach().clone()

    def run_kernel():
        m.W.data.copy_(W0)
        m.H.data.copy_(H0)
        m.fit(V, **fit_kw)
        return m.W.detach(), m.H.detach()

    def run_plain():
        W, H, _ = plain_fit(V, W0.clone(), H0.clone())
        return W, H

    return run_kernel, run_plain


def counters(fm, D):
    """The four kernel wrappers, whose ``launches`` count their launches."""
    return {"fused_contractions": fm.fused_contractions,
            "fused_beta_loss": fm.fused_beta_loss,
            "hgrad": D.hgrad, "wgrad": D.wgrad}


class Count(int):
    """B3's launch count, carrying ``small``: how many of them ran its
    small-rank regime (``hgrad.launches_gemm``, the kernel line
    ``hgrad_r_le_16``), and ``windowed``: how many of those ran in windows
    along the output past the slab cap (``hgrad.launches_windowed``, the
    line ``hgrad_r_le_16_past_cap``).  It compares as the plain count, and
    sums and differences of counts carry both along."""

    def __new__(cls, n, small=0, windowed=0):
        c = super().__new__(cls, n)
        c.small, c.windowed = small, windowed
        return c

    def __add__(self, other):
        return Count(int(self) + int(other),
                     self.small + getattr(other, "small", 0),
                     self.windowed + getattr(other, "windowed", 0))

    __radd__ = __add__

    def __sub__(self, other):
        return Count(int(self) - int(other),
                     self.small - getattr(other, "small", 0),
                     self.windowed - getattr(other, "windowed", 0))


def zero(ctr):
    for fn in ctr.values():
        fn.launches = 0
        if hasattr(fn, "launches_gemm"):
            fn.launches_gemm = fn.launches_windowed = 0


def read(ctr):
    return {name: Count(fn.launches, fn.launches_gemm, fn.launches_windowed)
            if hasattr(fn, "launches_gemm") else fn.launches
            for name, fn in ctr.items()}


def restore(ctr, counts):
    """Sets the wrappers' counts back to ``counts`` (a :func:`read`)."""
    for k, v in counts.items():
        ctr[k].launches = int(v)
        if isinstance(v, Count):
            ctr[k].launches_gemm = v.small
            ctr[k].launches_windowed = v.windowed


def plca_problem(N, C, S_out, kernel, R, seed=SEED):
    """A SIPLCA-family target and inits (numpy ``rand``, uniform Z)."""
    rs = np.random.RandomState(seed)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    return {"V": rs.rand(N, C, *S_out).astype("f"),
            "W": rs.rand(C, R, *kernel).astype("f"),
            "H": rs.rand(N, R, *S_in).astype("f"),
            "Z": np.full(R, 1.0 / R, "f")}


def em_adjoints(recon3, V, W, H, Z, eps):
    """The EM E-step's three gradients: one backward pass of ``recon3``
    with cotangent ``Vn / (WZH + eps)``, on fresh leaves."""
    Vn = V / V.sum()
    leaves = [x.detach().clone().requires_grad_(True) for x in (H, W, Z)]
    WZH = recon3(*leaves)
    return torch.autograd.grad(WZH, leaves, Vn / (WZH.detach() + eps))


def siplca_recon3(F, recon, nd, kernels):
    """``recon3(H, W, Z)``: the kernel-adjoint deconvolution
    (``kernels="kernel"``) or its plain twin of the scaled kernel."""
    deconv = F.kernel_adjoint_deconv if kernels == "kernel" else F.plain_adjoint_deconv
    return lambda H, W, Z: deconv(H, recon.scaled_kernel(W, Z, nd))


def compare_em_adjoints(F, recon, plca_from_numpy, eps, card):
    """Phase 2, the SIPLCA family: the E-step's dH, dW and dZ through the
    kernel Function (B3/B4) against its plain twin at the bench rows,
    ``max|kernel - plain| ≤ 1e-4·max|plain|``, Dirichlet priors off; the
    flagship's E-step timed both ways."""
    for label, (N, C, S_out, kernel, R) in SIPLCA_ROWS.items():
        pr = plca_problem(N, C, S_out, kernel, R)
        m = plca_from_numpy(pr, "cuda")  # normalizes W, H, Z
        V = torch.from_numpy(pr["V"]).cuda()
        args = (V, m.W, m.H, m.Z, eps)
        nd = len(kernel)
        kern = siplca_recon3(F, recon, nd, "kernel")
        plain = siplca_recon3(F, recon, nd, "plain")
        got, ref = em_adjoints(kern, *args), em_adjoints(plain, *args)
        torch.cuda.synchronize()
        rels = []
        for name, g, r in zip(("dH", "dW", "dZ"), got, ref):
            check(g.is_cuda and g.shape == r.shape, f"E-step {label} {name}: bad output")
            check(bool(torch.isfinite(g).all()), f"E-step {label} {name}: non-finite")
            rel = float((g - r).abs().max()) / float(r.abs().max())
            check(rel <= RTOL, f"E-step {label} {name}: max|kernel-plain| / "
                  f"max|plain| = {rel:.3g}")
            rels.append(rel)
        line = (f"E-step {label}: max|kernel-plain|/max|plain| dH {rels[0]:.3g}, "
                f"dW {rels[1]:.3g}, dZ {rels[2]:.3g}")
        if label == "SIPLCA":
            ms = cuda_ms(lambda: em_adjoints(kern, *args), reps=10, warmup=1)
            pms = cuda_ms(lambda: em_adjoints(plain, *args), reps=10, warmup=1)
            line += f"; E-step kernel {ms:.4f} ms, plain {pms:.4f} ms [{card}]"
        print(line, flush=True)
        del V, m, got, ref


def simplex_error(p):
    """max |Σ over the non-rank axes − 1| of a probability factor."""
    x = p.detach()
    axes = tuple(d for d in range(x.ndim) if d != 1) if x.ndim > 1 else (0,)
    return float((x.sum(dim=axes) - 1).abs().max())


def siplca_fits(F, recon, solver, plca_from_numpy, kl_div, ctr, card, fit_ms):
    """Phase 3, the SIPLCA path: SIPLCA/SIPLCA2/SIPLCA3.fit through the
    kernels, EM_ITERS EM iterations at ``tol=0``: one B3 and one B4 launch per
    iteration (counts set to 0 before the path, read after it), the loss
    falls, the factors stay finite, on the card and on the simplex; then the
    kernel fit against the plain twin's in turns (final losses within 1e-4
    relative) and a ``torch.profiler`` split of one flagship iteration.
    Returns the path's launch counts."""
    problems = {}
    zero(ctr)
    for name in ("SIPLCA", "SIPLCA2", "SIPLCA3"):
        N, C, S_out, kernel, R = SIPLCA_ROWS[name]
        pr = plca_problem(N, C, S_out, kernel, R)
        m = plca_from_numpy(pr, "cuda")
        V = torch.from_numpy(pr["V"]).cuda()
        plain3 = siplca_recon3(F, recon, len(kernel), "plain")
        norm = V.sum()

        def loss(W, H, Z, plain3=plain3, V=V, norm=norm):
            with torch.no_grad():
                return float(torch.sqrt(2.0 * kl_div(plain3(H, W, Z) * norm, V)))

        init = tuple(p.detach().clone() for p in (m.W, m.H, m.Z))
        before = loss(*init)
        n0 = read(ctr)
        t0 = time.perf_counter()
        n_iter, _ = m.fit(V, tol=0, max_iter=EM_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        d = {k: v - n0[k] for k, v in read(ctr).items()}
        after = loss(m.W, m.H, m.Z)
        check(n_iter == EM_ITERS - 1, f"{name}: n_iter {n_iter}")
        check(d["hgrad"] == d["wgrad"] == EM_ITERS,
              f"{name}: {d['hgrad']} B3 and {d['wgrad']} B4 launches in "
              f"{EM_ITERS} iterations")
        check(after < before, f"{name}: loss {before} -> {after} did not fall")
        for p in (m.W, m.H, m.Z):
            check(p.is_cuda and bool(torch.isfinite(p).all()),
                  f"{name}: a factor is non-finite or left the card")
            check(simplex_error(p) <= 1e-4, f"{name}: a factor left the simplex "
                  f"({simplex_error(p):.3g})")
        print(f"phase 3: {name} n_iter={n_iter} loss {before:.6g} -> {after:.6g} "
              f"in {secs:.2f} s; launches B3 {d['hgrad']}, B4 {d['wgrad']} "
              f"[{card}]", flush=True)
        problems[name] = (m, V, init, plain3, loss)
    launches = read(ctr)
    check(launches["fused_contractions"] == launches["fused_beta_loss"] == 0,
          f"the SIPLCA fits launched B1/B2: {launches}")

    for name, (m, V, init, plain3, loss) in problems.items():
        one = V.new_ones(())
        plain_fit = solver.get_plca_fit(plain3, 0.0, EM_ITERS, True, True, True,
                                        False, False, False)

        def run_kernel(m=m, V=V, init=init):
            for p, x in zip((m.W, m.H, m.Z), init):
                p.data.copy_(x)
            m.fit(V, tol=0, max_iter=EM_ITERS)
            return m.W.detach(), m.H.detach(), m.Z.detach()

        def run_plain(V=V, init=init, plain_fit=plain_fit):
            W, H, Z, _, _ = plain_fit(V, *(x.clone() for x in init), one, one, one)
            return W, H, Z

        times = time_fits(run_kernel, run_plain, loss, EM_ITERS, name)
        N, C, S_out, kernel, R = SIPLCA_ROWS[name]
        shape = "x".join(map(str, (C,) + S_out)) + f"_r{R}_k" + "x".join(
            map(str, kernel))
        fit_ms[f"{name.lower()}_{shape}"] = times
        print(f"phase 4: {name} EM ms/iteration at {shape}: kernel "
              f"{times['kernel']}, plain {times['plain']} [{card}]", flush=True)

    # where one flagship EM iteration spends its device time
    from torch.profiler import ProfilerActivity, profile

    m, V, init, _, _ = problems["SIPLCA"]
    recon3 = type(m)._resolve_fit_recon3(V, m.W.detach(), m.H.detach(),
                                         m.Z.detach())
    Vn, one = V / V.sum(), V.new_ones(())

    def em():
        return solver._plca_em_iter(recon3, True, True, True, False, False,
                                    False, Vn, init, one, one, one)

    em()
    torch.cuda.synchronize()
    reps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        for _ in range(reps):
            em()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    split = {"reconstruction": 0.0, "B3": 0.0, "B4": 0.0, "B3/B4 split sums": 0.0,
             "rest": 0.0}
    for e in p.key_averages():
        ms = e.device_time_total / reps / 1e3
        key = e.key
        if ms <= 0:
            continue
        if "hgrad" in key:
            split["B3"] += ms
        elif "wgrad" in key:
            split["B4"] += ms
        elif "finish_kernel" in key:
            split["B3/B4 split sums"] += ms
        elif any(s in key.lower() for s in ("gemm", "xmma", "catarraybatchedcopy")):
            split["reconstruction"] += ms
        else:
            split["rest"] += ms
    total = sum(split.values())
    print("phase 4: SIPLCA flagship, one EM iteration's device time (ms; "
          "torch.profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; device {total:.4f}, wall {wall:.4f} [{card}]", flush=True)
    fit_ms["siplca_profile_ms"] = dict(split, device=total, wall=wall)
    return launches


def plca_fits(plca_from_numpy, kl_div, ctr, card, fit_ms):
    """Phase 3, dense PLCA at MAIN_SHAPE: the generic E-step against the
    opt-in fused one (``PNT_PLCA_FUSED=1``, two B1 launches an iteration and
    none without it); final losses within 1e-4 relative, both timed.
    Returns the fused path's launch counts."""
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    pr = {"V": rs.rand(M, K).astype("f"), "W": rs.rand(K, R).astype("f"),
          "H": rs.rand(M, R).astype("f"), "Z": np.full(R, 1.0 / R, "f")}
    V = torch.from_numpy(pr["V"]).cuda()
    m = plca_from_numpy(pr, "cuda")
    init = tuple(p.detach().clone() for p in (m.W, m.H, m.Z))
    norm = V.sum()

    def loss(W, H, Z):
        with torch.no_grad():
            return float(torch.sqrt(2.0 * kl_div(type(m).reconstruct(H, W, Z) * norm, V)))

    def run(fused):
        os.environ["PNT_PLCA_FUSED"] = "1" if fused else "0"
        try:
            for p, x in zip((m.W, m.H, m.Z), init):
                p.data.copy_(x)
            m.fit(V, tol=0, max_iter=PLCA_ITERS)
        finally:
            os.environ.pop("PNT_PLCA_FUSED")
        return m.W.detach().clone(), m.H.detach().clone(), m.Z.detach().clone()

    before = loss(*init)
    zero(ctr)
    factors = run(False)
    check(read(ctr)["fused_contractions"] == 0, "the generic E-step launched B1")
    check(loss(*factors) < before, "dense PLCA (generic): the loss did not fall")
    zero(ctr)
    factors = run(True)
    launches = read(ctr)
    check(launches["fused_contractions"] == 2 * PLCA_ITERS,
          f"fused E-step: {launches['fused_contractions']} B1 launches in "
          f"{PLCA_ITERS} iterations")
    check(loss(*factors) < before, "dense PLCA (fused): the loss did not fall")
    print(f"phase 3: PLCA {M}x{K} R={R} fused E-step: B1 {launches['fused_contractions']}"
          f" launches in {PLCA_ITERS} iterations", flush=True)
    times = time_fits(lambda: run(True), lambda: run(False), loss, PLCA_ITERS,
                      f"PLCA {M}x{K} R={R} (kernel: fused E-step, plain: generic)")
    fit_ms[f"plca_{M}x{K}_r{R}"] = {"fused": times["kernel"],
                                    "generic": times["plain"]}
    print(f"phase 4: PLCA EM ms/iteration at {M}x{K} R={R}: fused E-step "
          f"{times['kernel']}, generic {times['plain']} [{card}]", flush=True)
    return launches


def compiled_problem(ns, name, shape):
    """A compiled-fits cell's target and model on the card, numpy seed 0:
    ``|randn|`` for dense NMF (:func:`inputs`), ``rand`` otherwise (the
    PLCA family's inits normalized by the model)."""
    if name == "NMF":
        V, W, H = inputs(*shape)
        return V, ns.nmf_from_numpy({"W": W.cpu().numpy(),
                                     "H": H.cpu().numpy()}, "cuda")
    if name == "PLCA":
        M, K, R = shape
        rs = np.random.RandomState(SEED)
        pr = {"V": rs.rand(M, K).astype("f"), "W": rs.rand(K, R).astype("f"),
              "H": rs.rand(M, R).astype("f"), "Z": np.full(R, 1.0 / R, "f")}
    else:
        pr = plca_problem(*shape)
    V = torch.from_numpy(pr.pop("V")).cuda()
    if "PLCA" in name:
        return V, ns.plca_from_numpy(pr, "cuda")
    return V + 0.01, ns.nmf_from_numpy({"W": pr["W"] + 0.1,
                                        "H": pr["H"] + 0.1}, "cuda")


def fit_profile(run, iters):
    """Device milliseconds an iteration of ``run()`` (a fit of ``iters``
    iterations) in a ``torch.profiler`` trace of the card's activity (the
    kernels, graph-launched ones too, and copies)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3 / iters


class replay_marks:
    """CUDA events around every ``CUDAGraph.replay`` until
    :meth:`restore`."""

    def __init__(self):
        self.events, self.orig = [], torch.cuda.CUDAGraph.replay

        def replay(g):
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
            self.orig(g)
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()

        torch.cuda.CUDAGraph.replay = replay

    def restore(self):
        torch.cuda.CUDAGraph.replay = self.orig

    def per_iter(self, iters=None):
        """``(span, busy)`` ms an iteration of the replays, which ran
        ``iters`` iterations (default: a 10-iteration chunk each)."""
        torch.cuda.synchronize()
        ev = self.events
        iters = iters or 10 * len(ev) // 2
        busy = sum(a.elapsed_time(b) for a, b in zip(ev[::2], ev[1::2]))
        return ev[0].elapsed_time(ev[-1]) / iters, busy / iters


def other_inits(init):
    """A second set of inits of the same shapes and values: each factor
    rolled by one along its first axis (a warm fit's inits)."""
    return [torch.roll(x, 1, dims=0) for x in init]


def same_target(V):
    """A new target with ``V``'s shape, strides, alignment and values: a
    fit on it is a warm miss of the fits' cache."""
    out = torch.empty_strided(V.shape, V.stride(), dtype=V.dtype,
                              device=V.device)
    out.copy_(V)
    return out


def compiled_cell(ns, label, name, shape, kw, ctr, card):
    """One compiled-fits cell (module docstring); returns its record."""
    from pytorch_nmf_tpu_torch.ops import fast_plca, graphs

    solver = ns.solver
    V, m = compiled_problem(ns, name, shape)
    plca = "PLCA" in name
    cls = type(m)
    params = [getattr(m, k) for k in ("W", "H", "Z") if hasattr(m, k)]
    inits = {"A": [p.detach().clone() for p in params]}
    inits["B"] = other_inits(inits["A"])
    engine = fast_plca.plca_em_engine_fused if name == "PLCA" else None

    def graphed(tol, iters, which="A", X=V):  # the user's entry point
        for p, x in zip(params, inits[which]):
            p.data.copy_(x)
        out = m.fit(X, tol=tol, max_iter=iters, **kw)
        return (out[0] if plca else out), [p.detach().clone() for p in params]

    def eager(tol, iters, which="A"):  # the same updates through _graph=False
        x = [t.clone() for t in inits[which]]
        if plca:
            one = V.new_ones(())
            fit = solver.get_plca_fit(
                cls._resolve_fit_recon3(V, *x), tol, iters, True, True, True,
                False, False, False, em_engine=engine, _graph=False)
            *f, n, _ = fit(V, *x, one, one, one)
            return n, f
        beta = kw["beta"]
        fit = solver.get_dense_fit(
            cls.reconstruct, beta, tol, iters, True, True, 0.0, 0.0, False,
            cls._resolve_updater_factory(V, *x, beta), _graph=False)
        *f, n = fit(V, *x)
        return n, f

    V2 = same_target(V)
    runs = {"cold": graphed, "eager": eager, "eager B": lambda t, i: eager(
        t, i, "B"), "warm": lambda t, i: graphed(t, i, "B"),
        "new V": lambda t, i: graphed(t, i, X=V2)}
    if name == "PLCA":
        os.environ["PNT_PLCA_FUSED"] = "1"
    try:
        return compiled_measure(ns, label, name, kw, V, runs, ctr, card,
                                graphs._Graphs)
    finally:
        os.environ.pop("PNT_PLCA_FUSED", None)


def compiled_expected(name, kw, iters):
    """B1-B4 launches of a cell's fit of ``iters`` iterations at tol=0: B1
    twice an iteration (β ≠ 2; the fused PLCA E-step), B2 at every loss
    evaluation (β ∉ {1, 2}: the initial one and one a chunk), B3 and B4 once
    an iteration (the deconv fits at β=1 on the static ``fused`` engine,
    the SIPLCA E-steps)."""
    want = dict.fromkeys(REPLACES, 0)
    beta = kw.get("beta")
    if name in ("NMF", "PLCA") and beta != 2:
        want["fused_contractions"] = 2 * iters
    if name == "NMF" and beta not in (1, 2):
        want["fused_beta_loss"] = 1 + iters // 10
    if name not in ("NMF", "PLCA"):
        want["hgrad"] = want["wgrad"] = iters
    return want


# a cache cell's fits: (run, whose eager fit it equals, replays, captures
# and host reads as a function of the chunks).  The chunk loop is one
# WHILE node: a cold fit runs chunks 1-2 eagerly (its flag read before and
# after each), captures, and replays once; a warm fit and one on a new V
# replay once; each reads (k, stop) once at its end
CACHE_RUNS = (("cold", "eager", lambda c: (1, 1, 2 + 2 + 1)),
              ("eager", "eager", lambda c: (0, 0, c)),
              ("eager B", "eager B", lambda c: (0, 0, c)),
              ("warm", "eager B", lambda c: (1, 0, 1)),
              ("new V", "eager", lambda c: (1, 1, 1)))
# the Hoyer fits' chunk loop is one WHILE node too, the line searches'
# WHILE nodes nested in its body, and has no stop test: (replays,
# captures, the loop's host reads) as a function of the chunks; a cold fit
# runs chunks 1-2 eagerly (its flag read before and after each), captures
# and replays once; a warm fit and one on a new V replay once and read
# nothing
HOYER_RUNS = (("cold", "eager", lambda c: (1, 1, 2 + 2)),
              ("eager", "eager", lambda c: (0, 0, 0)),
              ("eager B", "eager B", lambda c: (0, 0, 0)),
              ("warm", "eager B", lambda c: (1, 0, 0)),
              ("new V", "eager", lambda c: (1, 1, 0)))


def cache_counts(solver):
    info = solver.compiled_cache_info()
    return {k: info[k] for k in ("hits", "warm_misses", "cold_misses")}


def cache_held(solver):
    """``(the cache's held bytes by its own count, the card's allocated and
    reserved bytes it gives back)``: cleared and emptied, so call it at a
    cell's end."""
    held = solver.compiled_cache_info()["held_bytes"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    solver.compiled_cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (held, a0 - torch.cuda.memory_allocated(),
            r0 - torch.cuda.memory_reserved())


def compiled_measure(ns, label, name, kw, V, runs, ctr, card, Graphs):
    """A compiled-fits cell as a cache cell: FIT_ITERS iterations at
    tol=0, in turns, a cold fit (the configuration's first: chunks 1-2
    eager, one capture), the eager loop from the same inits, the eager
    loop from other inits, a warm fit from those (a hit: every chunk a
    replay, no capture) and a fit on a new V of the same configuration (a
    warm miss: one capture, every chunk a replay); each bit for bit its
    eager twin, with exact launches, replays, captures and host reads, and
    the cache's counters.  The peak is what a fit adds above what was
    allocated before it (the cache's held bytes included)."""
    solver = ns.solver
    rec = {"ms_per_iter": {}}

    def gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a, b))

    solver.compiled_cache_clear()
    # chunk 1 (and the initial loss), the first chunk of every fit, after
    # a warm-up
    runs["eager"](0.0, 10)
    _, rec["chunk1_ms"] = events_ms(lambda: runs["cold"](0.0, 10))
    # that fit's entry (max_iter is not in the key) goes: the next is cold
    solver.compiled_cache_clear()
    finals = {}
    chunks = FIT_ITERS // 10
    for how, twin, expect in CACHE_RUNS:
        c0, r0, h0 = read(ctr), Graphs.replays, solver._read.reads
        s0, k0, q0 = Graphs.capture_s, Graphs.captures, cache_counts(solver)
        torch.cuda.synchronize()
        # either way the fit then takes its cuBLAS workspaces in the window
        torch._C._cuda_clearCublasWorkspaces()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = replay_marks() if how == "warm" else None
        try:
            (n, f), ms = events_ms(lambda: runs[how](0.0, FIT_ITERS))
        finally:
            if marks is not None:
                marks.restore()
                warm_marks = marks
        peak = torch.cuda.max_memory_allocated() - base
        d = {k: v - c0[k] for k, v in read(ctr).items()}
        replays, reads = Graphs.replays - r0, solver._read.reads - h0
        captures = Graphs.captures - k0
        q = {k: v - q0[k] for k, v in cache_counts(solver).items()}
        want = compiled_expected(name, kw, FIT_ITERS)
        tag = f"compiled {label} {how}"
        check(n == (FIT_ITERS - 1 if "PLCA" in name else FIT_ITERS),
              f"{tag}: n_iter {n}")
        check(d == want, f"{tag}: launches {d}, want {want}")
        check((replays, captures, reads) == expect(chunks),
              f"{tag}: {replays} replays, {captures} captures, {reads} host "
              f"reads in {chunks} chunks, want {expect(chunks)}")
        check_factors(tag, *f)
        rec["ms_per_iter"][how] = ms / FIT_ITERS
        for key, v in (("peak_gb", peak / 1e9), ("replays", replays),
                       ("captures", captures), ("host_reads", reads),
                       ("capture_ms", 1e3 * (Graphs.capture_s - s0)),
                       ("cache", q)):
            rec.setdefault(key, {})[how] = v
        rec["launches"] = {k: int(v) for k, v in d.items()}
        finals[how] = f
    for how, twin, _ in CACHE_RUNS:
        check(all(torch.equal(a, b) for a, b in zip(finals[how],
                                                    finals[twin])),
              f"compiled {label} {how}: not bit for bit its eager twin "
              f"({gap(finals[how], finals[twin]):.3g})")
    # the replayed chunks alone, from the warm fit's events around its one
    # replay (every chunk), and the replay's own device time
    rec["replayed_ms_per_iter"], rec["replay_device_ms_per_iter"] = \
        warm_marks.per_iter(FIT_ITERS)
    rec["held_bytes"], rec["freed_allocated"], rec["freed_reserved"] = \
        cache_held(solver)
    (ng, fg), (ne, fe) = runs["cold"](FIT_TOL, FIT_ITERS), runs["eager"](
        FIT_TOL, FIT_ITERS)
    rec["gap_tol"] = gap(fg, fe)
    rec["n_iter_tol"] = [int(ng), int(ne)]
    check(ng == ne, f"compiled {label}: tol={FIT_TOL} n_iter graphed {ng}, "
          f"eager {ne}")
    check(rec["gap_tol"] <= FIT_GAP,
          f"compiled {label}: graphed against eager {rec['gap_tol']} at "
          f"tol={FIT_TOL}")
    runs["warm"](0.0, FIT_PROFILE_ITERS)  # so the profiled one is a hit
    for how in ("warm", "eager"):
        dev = fit_profile(lambda: runs[how](0.0, FIT_PROFILE_ITERS),
                          FIT_PROFILE_ITERS)
        rec.setdefault("device_ms_per_iter", {})[how] = dev
    for how in ("warm", "eager"):
        rec.setdefault("idle_share", {})[how] = 1 - rec[
            "device_ms_per_iter"][how] / rec["ms_per_iter"][how]
    solver.compiled_cache_clear()
    t = {k: round(v, 4) for k, v in rec["ms_per_iter"].items()}
    print(f"phase 4: compiled {label}: ms/iteration cold {t['cold']}, warm "
          f"{t['warm']}, new V {t['new V']}, eager {t['eager']} and "
          f"{t['eager B']}; the replayed chunks alone "
          f"{rec['replayed_ms_per_iter']:.4f} (their device time "
          f"{rec['replay_device_ms_per_iter']:.4f}); device ms/iteration "
          f"(torch.profiler, {FIT_PROFILE_ITERS}-iteration fits) warm "
          f"{rec['device_ms_per_iter']['warm']:.4f}, eager "
          f"{rec['device_ms_per_iter']['eager']:.4f}; the card idle "
          f"{100 * rec['idle_share']['warm']:.1f}% warm, "
          f"{100 * rec['idle_share']['eager']:.1f}% eager; replays "
          f"{rec['replays']}, captures {rec['captures']}, host reads "
          f"{rec['host_reads']}; cache {rec['cache']}; launches "
          f"{rec['launches']} (as predicted, every way); chunk 1 "
          f"{rec['chunk1_ms']:.3f} ms, capture cold "
          f"{rec['capture_ms']['cold']:.2f} ms, new V "
          f"{rec['capture_ms']['new V']:.2f} (host); peak above what was "
          f"allocated before the fit (GB): "
          f"{ {k: round(v, 4) for k, v in rec['peak_gb'].items()} }; the "
          f"cache held {rec['held_bytes'] / 1e6:.2f} MB by its count "
          f"({rec['freed_allocated'] / 1e6:.2f} MB allocated and "
          f"{rec['freed_reserved'] / 1e6:.2f} MB reserved freed by "
          f"compiled_cache_clear); cold, warm and new V bit for bit their "
          f"eager twins; {rec['gap_tol']:.3g} with n_iter {ng} both ways "
          f"(tol={FIT_TOL}) [{card}]", flush=True)
    return rec


def compiled_fits(ns, ctr, card, fit_ms):
    """Phase 3 and 4, this slice: the fits' compiled chunk at every
    COMPILED_CELLS cell (:func:`compiled_cell`), and a fit whose updater
    reads the host refused on the card.  Returns the path's launches."""
    from pytorch_nmf_tpu_torch.ops import fast_nmf

    zero(ctr)
    out = {}
    print("phase 4: compiled: the chunk loop one CUDA-graph WHILE node (a "
          "warm fit one replay and one host read, the batched fits none): "
          "the dense, sparse and EM fits and the batched MU and EM fits; "
          "the Hoyer fits, single and batched, below (their loop's body "
          "holds the line searches' WHILE nodes, nested; a warm fit one "
          "replay and no host read)", flush=True)
    for label, name, shape, kw in COMPILED_CELLS:
        out[label] = compiled_cell(ns, label, name, shape, kw, ctr, card)
    V, W, H = inputs(*MAIN_SHAPE)

    def factory(beta, gamma, l1_reg, l2_reg):
        upd_W, upd_H, loss = fast_nmf.nmf_updater_factory_fused(
            beta, gamma, l1_reg, l2_reg)

        def reading(V, W, H):  # a host read an update
            check(float(W.sum()) > 0, "compiled: an empty factor")
            return upd_W(V, W, H)

        return reading, upd_H, loss

    try:
        ns.solver.get_dense_fit(ns.NMF.reconstruct, 1.0, 0.0, 30, True, True,
                                0.0, 0.0, False, factory)(V, W, H)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    check("cannot be captured" in refused, f"compiled: a host-reading "
          f"updater was not refused ({refused!r})")
    print("phase 3: compiled: a fit whose updater reads the host is refused "
          f"on the card [{card}]", flush=True)
    fit_ms["compiled_fits"] = out
    return read(ctr)


def split_loss(S, V, W, H, beta):
    """The sparse fit's loss ``sqrt(2·(V_norm + pos − neg))``."""
    with torch.no_grad():
        pos, neg = S.nmf_sp_pos_neg(V, H, W, beta)
        return float(torch.sqrt(2.0 * (S.get_V_norm(V, beta) + pos - neg)))


def set_tier(tier):
    for name in SPARSE_ENV:
        os.environ.pop(name, None)
    if tier == "densify":
        os.environ["PNT_SPARSE_DENSIFY"] = "1"
    elif tier == "ell":
        os.environ.update(PNT_SPARSE_DENSIFY="0", PNT_SPARSE_ELL="1")
    elif tier == "gather":
        os.environ.update(PNT_SPARSE_DENSIFY="0", PNT_SPARSE_ELL="0")


def timed_fit(m, V, beta, iters):
    """``(n_iter, ms/iteration)`` of one ``m.fit`` by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    n_iter = m.fit(V, beta=beta, tol=0, max_iter=iters)
    end.record()
    torch.cuda.synchronize()
    return n_iter, start.elapsed_time(end) / iters


def random_coo(M, K, nnz, rs):
    """``nnz`` distinct uniformly placed entries of ``rand + 0.01``, as a
    coalesced sparse tensor on the card (the bench's ``ell_row``)."""
    flat = np.unique(rs.randint(0, M * K, int(nnz * 1.1)).astype(np.int64))
    rs.shuffle(flat)
    flat = np.sort(flat[:nnz])
    idx = torch.from_numpy(np.stack([flat // K, flat % K])).cuda()
    vals = torch.from_numpy(rs.rand(len(flat)).astype("f") + 0.01).cuda()
    return torch.sparse_coo_tensor(idx, vals, (M, K), is_coalesced=True,
                                   check_invariants=False)


def sparse_fits(S, nmf_from_numpy, ctr, card, fit_ms):
    """Phase 3, sparse targets through ``NMF.fit``: top 2% of MAIN_SHAPE at
    β ∈ {1, 0.5, 2} (densify chosen, B1 at β ≠ 2, the loss falls; counts set
    to 0 before, read after); 8192² with 671k non-zeros at β ∈ {1, 1.5}
    forced through each tier (final losses within 1e-4 relative); 131072 ×
    65536 at 0.1% past the densify budget, where ELL is chosen and agrees
    with gather.  Returns the densify path's launch counts."""
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    Vd = rs.rand(M, K).astype("f")
    Vd = np.where(Vd > np.quantile(Vd, 0.98), Vd, 0).astype("f")
    V = S.sparse_from_dense(torch.from_numpy(Vd).cuda())
    inits = {"W": rs.rand(K, R).astype("f") + 0.1, "H": rs.rand(M, R).astype("f") + 0.1}
    set_tier(None)
    check(S.should_densify(V), f"{M}x{K} top 2% is not densified")
    zero(ctr)
    for beta in (1, 0.5, 2):
        m = nmf_from_numpy(inits, "cuda")
        before = split_loss(S, V, m.W, m.H, beta)
        n0 = read(ctr)
        n_iter, ms = timed_fit(m, V, beta, SPARSE_ITERS)
        d = {k: v - n0[k] for k, v in read(ctr).items()}
        after = split_loss(S, V, m.W, m.H, beta)
        check(after < before, f"sparse beta={beta}: loss {before} -> {after}")
        check((d["fused_contractions"] > 0) == (beta != 2) and
              d["fused_beta_loss"] == d["hgrad"] == d["wgrad"] == 0,
              f"sparse beta={beta}: launches {d}")
        check(m.W.is_cuda and bool(torch.isfinite(m.W).all() & torch.isfinite(m.H).all()),
              f"sparse beta={beta}: bad factors")
        fit_ms[f"sparse_{M}x{K}_r{R}_2pct_beta{beta}_densify"] = ms
        print(f"phase 3: sparse {M}x{K} R={R} top 2% ({V._nnz()} non-zeros) "
              f"beta={beta} densify: loss {before:.6g} -> {after:.6g}, B1 "
              f"{d['fused_contractions']}; {ms:.4f} ms/iteration [{card}]",
              flush=True)
    launches = read(ctr)
    del V

    M, K, R, nnz = SPARSE_ELL_CASE
    V = random_coo(M, K, nnz, rs)
    inits = {"W": rs.rand(K, R).astype("f") + 0.1, "H": rs.rand(M, R).astype("f") + 0.1}
    for beta in (1, 1.5):
        finals = {}
        for tier in ("densify", "ell", "gather"):
            set_tier(tier)
            finals[tier] = sparse_compiled(S, nmf_from_numpy, V, inits, beta,
                                           tier, card, fit_ms)
        spread = (max(finals.values()) - min(finals.values())) / min(finals.values())
        check(spread <= 1e-4, f"sparse {M}x{K} beta={beta}: tiers disagree {finals}")
        print(f"phase 3: sparse {M}x{K} beta={beta}: the three tiers agree "
              f"(spread {spread:.3g})", flush=True)
    set_tier(None)
    densify_oom(S, nmf_from_numpy, rs, card, fit_ms)
    del V

    M, K, R, density = SPARSE_BIG
    V = random_coo(M, K, int(round(density * M * K)), rs)
    inits = {"W": rs.rand(K, R).astype("f") + 0.1, "H": rs.rand(M, R).astype("f") + 0.1}
    check(not S.should_densify(V), f"{M}x{K} would be densified")
    t0 = time.perf_counter()
    ell = S.maybe_ell(V)
    torch.cuda.synchronize()
    check(ell is not None, f"{M}x{K}: no ELL layout")
    print(f"phase 3: sparse {M}x{K} ({V._nnz()} non-zeros): not densified; ELL "
          f"built in {time.perf_counter() - t0:.2f} s, widths {ell.row_idx.shape[1]}"
          f" (rows) and {ell.col_idx.shape[1]} (columns), spills "
          f"{ell.row_rem[2].numel()} and {ell.col_rem[2].numel()} [{card}]",
          flush=True)
    finals = {}
    try:
        for tier in ("ell", "gather"):
            set_tier(None if tier == "ell" else "gather")
            m = nmf_from_numpy(inits, "cuda")
            before = split_loss(S, V, m.W, m.H, 1)
            # the reductions' executions, replays included (graphs._Counted)
            n0 = S.ell_neg_grad.reductions
            _, ms = timed_fit(m, V, 1, SPARSE_BIG_ITERS)
            calls = S.ell_neg_grad.reductions - n0
            check((calls == 2 * SPARSE_BIG_ITERS) == (tier == "ell"),
                  f"{M}x{K} {tier}: {calls} ELL reductions")
            finals[tier] = split_loss(S, V, m.W, m.H, 1)
            check(finals[tier] < before, f"{M}x{K} {tier}: the loss did not fall")
            fit_ms[f"sparse_{M}x{K}_r{R}_0.1pct_beta1_{tier}"] = ms
            print(f"phase 4: sparse {M}x{K} R={R} 0.1% beta=1 {tier}: {ms:.4f} "
                  f"ms/iteration, loss {before:.7g} -> {finals[tier]:.7g} [{card}]",
                  flush=True)
    finally:
        set_tier(None)
    rel = abs(finals["ell"] - finals["gather"]) / finals["gather"]
    check(rel <= 1e-4, f"{M}x{K}: ELL and gather disagree {finals}")
    print(f"phase 3: sparse {M}x{K}: ELL and gather agree (rel {rel:.3g})",
          flush=True)
    return launches


def sparse_compiled(S, nmf_from_numpy, V, inits, beta, tier, card, fit_ms):
    """Phases 3 and 4, this slice: the sparse fit's chunk graphed at
    SPARSE_ELL_CASE, SPARSE_COMPILED_ITERS iterations at tol=0 through
    ``NMF.fit`` (a cold fit, then a warm one: a hit) against
    ``get_sparse_fit(..., _graph=False)`` from the same inits: replays,
    captures and host reads, ms/iteration and the device time an
    iteration (``torch.profiler``) both ways; densify and ELL bit for bit
    their eager runs, gather (scatter-adds by atomics) within 1e-4 and at
    ``tol=1e-4`` the same ``n_iter``.  Returns the final loss."""
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import graphs, solver

    Graphs, iters = graphs._Graphs, SPARSE_COMPILED_ITERS
    M, K = V.shape
    R, chunks = inits["W"].shape[1], iters // 10
    W0 = torch.from_numpy(inits["W"]).cuda()
    H0 = torch.from_numpy(inits["H"]).cuda()
    target = S.maybe_ell(V) if tier == "ell" else V
    check(target is not None, f"sparse {tier}: no ELL layout")
    solver.compiled_cache_clear()  # the timed fits' entries: the next is cold

    def graphed(tol=0.0):
        m = nmf_from_numpy(inits, "cuda")
        n = m.fit(V, beta=beta, tol=tol, max_iter=iters)
        return n, (m.W.detach(), m.H.detach())

    def eager(tol=0.0):
        factory = (NMF._resolve_updater_factory(V, W0, H0, float(beta))
                   if tier == "densify" else None)
        fit = solver.get_sparse_fit(NMF._sp_pos_neg, float(beta), tol, iters,
                                    True, True, 0.0, 0.0, False, tier,
                                    NMF.reconstruct, factory, _graph=False)
        W, H, n = fit(target, W0.clone(), H0.clone())
        return n, (W, H)

    rec, outs = {"ms_per_iter": {}}, {}
    tag = f"sparse compiled {M}x{K} R={R} {V._nnz()} non-zeros beta={beta} {tier}"
    # (replays, captures, host reads): the chunk loop one WHILE node
    for how, run, expect in (("cold", graphed, (1, 1, 2 + 2 + 1)),
                             ("eager", eager, (0, 0, chunks)),
                             ("warm", graphed, (1, 0, 1))):
        r0, k0, h0 = Graphs.replays, Graphs.captures, solver._read.reads
        (n, f), ms = events_ms(run)
        replays, captures = Graphs.replays - r0, Graphs.captures - k0
        reads = solver._read.reads - h0
        check(n == iters and (replays, captures, reads) == expect,
              f"{tag} {how}: n_iter {n}, {replays} replays, {captures} "
              f"captures, {reads} host reads, want {expect}")
        check_factors(f"{tag} {how}", *f)
        rec["ms_per_iter"][how] = ms / iters
        rec.setdefault("replays", {})[how] = replays
        rec.setdefault("host_reads", {})[how] = reads
        outs[how] = f
        if how == "warm":
            rec["held_bytes"] = solver.compiled_cache_info()["held_bytes"]
    gaps = [max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(outs[how], outs["eager"]))
            for how in ("cold", "warm")]
    rec["gap"] = max(gaps)
    if tier == "gather":
        check(rec["gap"] <= 1e-4, f"{tag}: graphed against eager {gaps}")
        (ng, fg), (ne, fe) = graphed(1e-4), eager(1e-4)
        rec["n_iter_tol"] = [int(ng), int(ne)]
        rec["gap_tol"] = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(fg, fe))
        check(ng == ne and rec["gap_tol"] <= 1e-4,
              f"{tag}: tol=1e-4 n_iter {ng} and {ne}, {rec['gap_tol']:.3g}")
    else:
        check(rec["gap"] == 0, f"{tag}: graphed against eager {gaps}")
    for how, run in (("warm", graphed), ("eager", eager)):
        rec.setdefault("device_ms_per_iter", {})[how] = fit_profile(run, iters)
        rec.setdefault("idle_share", {})[how] = 1 - rec["device_ms_per_iter"][
            how] / rec["ms_per_iter"][how]
    fit_ms[f"sparse_{M}x{K}_r{R}_{V._nnz()}nnz_beta{beta}_{tier}"] = rec
    t = {k: round(v, 4) for k, v in rec["ms_per_iter"].items()}
    d = {k: round(v, 4) for k, v in rec["device_ms_per_iter"].items()}
    print(f"phase 4: {tag}, {iters} iterations: ms/iteration {t}; device "
          f"ms/iteration (torch.profiler) {d}; the card idle "
          f"{ {k: round(100 * v, 1) for k, v in rec['idle_share'].items()} }"
          f"%; replays {rec['replays']}, host reads {rec['host_reads']}; the "
          f"cache held {rec['held_bytes'] / 1e6:.2f} MB after the warm fit; "
          f"graphed against eager {rec['gap']:.3g}"
          + (f", at tol=1e-4 n_iter {rec['n_iter_tol']} ({rec['gap_tol']:.3g})"
             if tier == "gather" else " (bit for bit)") + f" [{card}]",
          flush=True)
    return split_loss(S, V, *outs["warm"], beta)


def densify_oom(S, nmf_from_numpy, rs, card, fit_ms):
    """Phase 3, this slice: a densify fit out of card memory (the process's
    memory fraction set so that the dense target does not fit) is run once
    more on the ELL tier, graphed (one capture), as the JAX package
    retries; afterwards, the cache cleared and the target's cached layout
    dropped, the card's allocated memory is where it was before the fit."""
    from pytorch_nmf_tpu_torch.ops import graphs, solver

    M, K, R, nnz = SPARSE_OOM_CASE
    V = random_coo(M, K, nnz, rs)
    inits = {"W": rs.rand(K, R).astype("f") + 0.1, "H": rs.rand(M, R).astype("f") + 0.1}
    m = nmf_from_numpy(inits, "cuda")
    set_tier("densify")
    solver.compiled_cache_clear()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    allow = torch.cuda.memory_reserved() + SPARSE_OOM_HEADROOM
    dense = M * K * 4
    check(allow - torch.cuda.memory_reserved() < dense, "densify OOM: the "
          "headroom holds the dense target")
    c0, k0 = cache_counts(solver), graphs._Graphs.captures
    n0 = S.ell_neg_grad.reductions
    torch.cuda.set_per_process_memory_fraction(allow / total)
    try:
        n, ms = timed_fit(m, V, 1, SPARSE_OOM_ITERS)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        set_tier(None)
    q = {k: v - c0[k] for k, v in cache_counts(solver).items()}
    captures = graphs._Graphs.captures - k0
    reductions = S.ell_neg_grad.reductions - n0
    check(n == SPARSE_OOM_ITERS and reductions == 2 * SPARSE_OOM_ITERS
          and captures == 1, f"densify OOM: n_iter {n}, {reductions} ELL "
          f"reductions, {captures} captures")
    check_factors("densify OOM", m.W, m.H)
    held = solver.compiled_cache_info()["held_bytes"]
    solver.compiled_cache_clear()
    V._pnt_ell_cache = None
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    after = torch.cuda.memory_allocated()
    check(after == before, f"densify OOM: allocated {before} before, {after} "
          "after")
    fit_ms[f"sparse_densify_oom_{M}x{K}_r{R}"] = {
        "ms_per_iter": ms, "cache": q, "captures": captures,
        "held_bytes": held}
    print(f"phase 3: sparse {M}x{K} R={R} {V._nnz()} non-zeros, densify "
          f"forced with {SPARSE_OOM_HEADROOM / 2**20:.0f} MiB of headroom "
          f"(the dense target {dense / 2**20:.0f} MiB): out of memory, "
          f"retried on ELL ({reductions} ELL reductions, {captures} capture, "
          f"cache {q}), {ms:.4f} ms/iteration; the cache then held "
          f"{held / 1e6:.2f} MB; allocated memory back to {before} bytes "
          f"[{card}]", flush=True)


def sparse_hoyer(ns, card, fit_ms, p1):
    """Phase 3, this slice: the sparse-target Hoyer fit graphed, on the
    top 2% of MAIN_SHAPE (:func:`sparse_fits`' target), R=88, ``sW=0.5``,
    β=2, SPARSE_HOYER_ITERS iterations through ``NMF.sparse_fit`` (a cold
    fit, a warm one) against ``get_hoyer_fit(..., _graph=False)``: the
    same attempts, P1 launches one a constrained factor and attempt, no
    line-search host read from the first replay on, the factors within
    1e-4 (the gather's scatter-adds), ms/iteration."""
    from pytorch_nmf_tpu_torch.ops import graphs

    S, P, solver = ns.S, ns.P, ns.solver
    bt, Graphs, iters = solver._backtrack_project, graphs._Graphs, SPARSE_HOYER_ITERS
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    Vd = rs.rand(M, K).astype("f")
    Vd = np.where(Vd > np.quantile(Vd, 0.98), Vd, 0).astype("f")
    V = S.sparse_from_dense(torch.from_numpy(Vd).cuda())
    W0 = torch.from_numpy(rs.rand(K, R).astype("f") + 0.1).cuda()
    H0 = torch.from_numpy(rs.rand(M, R).astype("f") + 0.1).cuda()
    eager_fit = solver.get_hoyer_fit(None, ns.NMF._sp_pos_neg, 2.0, iters, True,
                                     True, 0.5, None, K, M, _graph=False)
    solver.compiled_cache_clear()  # the first fit is the configuration's

    def graphed():
        m = ns.NMF(W=W0.clone(), H=H0.clone(), device="cuda")
        m.sparse_fit(V, beta=2, max_iter=iters, sW=0.5)
        return m.W.detach(), m.H.detach()

    rec, outs = {"ms_per_iter": {}}, {}
    tag = f"sparse-target Hoyer {M}x{K} top 2% R={R} sW=0.5 beta=2"
    p1_total = 0
    # the chunk loop one replay after the cold fit's two eager chunks
    for how, run, expect in (("cold", graphed, (1, 1)),
                             ("eager", lambda: eager_fit(V, W0.clone(),
                                                         H0.clone())[:2],
                              (0, 0)),
                             ("warm", graphed, (1, 0))):
        a0, r0, q0 = bt.attempts, bt.reads, P.proj_rows.launches
        p0, k0 = Graphs.replays, Graphs.captures
        marks = read_marks(lambda: bt.reads) if how != "eager" else None
        try:
            f, ms = events_ms(run)
        finally:
            if marks is not None:
                marks.restore()
        attempts, reads = bt.attempts - a0, bt.reads - r0
        q = P.proj_rows.launches - q0
        p1_total += q
        replays, captures = Graphs.replays - p0, Graphs.captures - k0
        check((replays, captures) == expect, f"{tag} {how}: {replays} "
              f"replays, {captures} captures")
        check(q == 1 + attempts, f"{tag} {how}: {q} P1 launches, {attempts} "
              "attempts")
        if marks is not None:
            check(bt.reads == marks.reads[0], f"{tag} {how}: "
                  f"{bt.reads - marks.reads[0]} line-search reads from the "
                  "first replay on")
        else:
            check(reads == attempts, f"{tag} eager: {reads} reads")
        check_factors(f"{tag} {how}", *f)
        rec["ms_per_iter"][how] = ms / iters
        for key, v in (("attempts", attempts), ("host_reads", reads),
                       ("p1_launches", q), ("replays", replays)):
            rec.setdefault(key, {})[how] = v
        outs[how] = f
    check(len(set(rec["attempts"].values())) == 1,
          f"{tag}: attempts {rec['attempts']}")
    gaps = {how: max(float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(outs[how], outs["eager"]))
            for how in ("cold", "warm")}
    check(max(gaps.values()) <= 1e-4, f"{tag}: graphed against eager {gaps}")
    rec["gap"] = gaps
    p1["sparse_hoyer"] = p1_total
    fit_ms["sparse_hoyer_compiled"] = rec
    t = {k: round(v, 4) for k, v in rec["ms_per_iter"].items()}
    print(f"phase 3: {tag}, {iters} iterations: ms/iteration {t}; attempts "
          f"{rec['attempts']['warm']} every way; P1 launches "
          f"{rec['p1_launches']}; line-search host reads {rec['host_reads']} "
          f"(none from the first replay on); replays {rec['replays']}; "
          f"graphed against eager {gaps} [{card}]", flush=True)


def events_ms(fn):
    """``(fn(), milliseconds)`` of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def col_sparseness(x, axis=1):
    """Hoyer sparseness of every rank column of ``x`` (the slices along
    ``axis``), as a tensor."""
    cols = x.detach().movedim(axis, 0).reshape(x.shape[axis], -1)
    n = cols.shape[1]
    return (n**0.5 - cols.abs().sum(1) / cols.norm(dim=1)) / (n**0.5 - 1)


def check_factors(tag, *ps):
    for p in ps:
        check(p.is_cuda, f"{tag}: a factor left the card")
        check(bool(torch.isfinite(p).all()), f"{tag}: non-finite factor")
        check(bool((p >= 0).all()), f"{tag}: negative factor")


def host_reads(solver, P):
    """``(line-search reads, projection reads)`` so far."""
    return solver._backtrack_project.reads, P.proj_rows.reads


def hoyer_target(ns):
    """The NMFD flagship's Hoyer target: the reconstruction of random
    (``rand``) factors projected, per rank column, to unit norm at
    sparseness 0.5, plus ``0.01·rand``.  With both factors constrained their
    norms stay 1, so the fit only works at the scale such a model
    produces: on the ``|randn|`` target of the MU fits (5× larger) both
    packages' line searches fail every attempt from step 1 at these widths,
    keep the last candidate, and diverge to non-finite factors in 3
    iterations."""
    P, F = ns.P, ns.F
    N, C, S_out, kernel, R = DECONV["NMFD"]
    rs = np.random.RandomState(SEED)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    W = torch.from_numpy(rs.rand(C, R, *kernel).astype("f")).cuda()
    H = torch.from_numpy(rs.rand(N, R, *S_in).astype("f")).cuda()
    W = P.proj_columns_explicit(W, P.hoyer_l1_target(W.numel() // R, 0.5), 1.0)
    H = P.proj_columns_explicit(H, P.hoyer_l1_target(H.numel() // R, 0.5), 1.0)
    noise = torch.from_numpy(rs.rand(N, C, *S_out).astype("f")).cuda()
    with torch.no_grad():
        return F.plain_adjoint_deconv(H, W) + 0.01 * noise


def device_split(prof):
    """A deconv fit's device milliseconds in a ``torch.profiler`` trace, by
    kind: the reconstruction (cuBLAS GEMMs and their stacking copies), B3,
    B4, the projection kernel and the rest."""
    split = {"reconstruction": 0.0, "B3": 0.0, "B4": 0.0, "projection": 0.0,
             "rest": 0.0}
    for e in prof.key_averages():
        ms = e.device_time_total / 1e3
        key = e.key.lower()
        if ms <= 0:
            continue
        if "hoyer_proj" in key:
            split["projection"] += ms
        elif "hgrad" in key:
            split["B3"] += ms
        elif "wgrad" in key:
            split["B4"] += ms
        elif any(t in key for t in ("gemm", "xmma", "catarraybatchedcopy")):
            split["reconstruction"] += ms
        else:
            split["rest"] += ms
    return split


def hoyer_losses(solver, run, loss_of):
    """``run()`` (a Hoyer fit) with ``loss_of(W, H)`` recorded at the end of
    each iteration, after the renorm that closes it."""
    renorm, losses = solver.renorm, []

    def rec(w, h, unit):
        w, h = renorm(w, h, unit)
        losses.append(loss_of(w, h))
        return w, h

    solver.renorm = rec
    try:
        run()
    finally:
        solver.renorm = renorm
    return losses


class read_marks(replay_marks):
    """:class:`replay_marks` that also keeps ``counter()`` at every replay's
    start (the line search's host reads)."""

    def __init__(self, counter):
        super().__init__()
        self.reads, timed = [], torch.cuda.CUDAGraph.replay

        def replay(g):
            self.reads.append(counter())
            timed(g)

        torch.cuda.CUDAGraph.replay = replay


def hoyer_device(run, iters, replays=0):
    """``(device ms an iteration, the WHILE nodes' handle-setting kernels'
    ms an iteration, the device ms an iteration of the replayed chunks)`` of
    ``run()`` (a fit of ``iters`` iterations whose last ``replays`` chunks
    are graph replays), from a ``torch.profiler`` trace: the card's
    activity, and for the replays the kernels that start after the first
    ``cudaGraphLaunch`` (the eager chunks before it end in host reads, so
    their work is done by then); ``None`` without replays."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    total = cond = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += e.self_device_time_total / 1e3
        if "pnt_set_condition" in e.key:
            cond += e.self_device_time_total / 1e3
    replayed = None
    if replays:
        events = prof.events()
        first = min(e.time_range.start for e in events
                    if "cudaGraphLaunch" in e.name)
        replayed = sum(e.time_range.elapsed_us() for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.time_range.start >= first) / 1e3 / (10 * replays)
    return total / iters, cond / iters, replayed


def nested_while(ns, card, fit_ms):
    """Phase 4, this slice: nested device loops on the card, as the Hoyer
    fits' chunk loop holds its line searches (a body's capture opens WHILE
    nodes of its own, ``ops/graphs.py``): an outer loop on ``k < 3`` whose
    body holds two inner loops, on ``m < 2 + k`` and ``m < 3 + k``, each
    inner run an ``F.conv1d`` (NMFD's reconstruction) and a grouped
    convolution (``vmap``'s, the batched fits') of NESTED's problems with
    cuDNN on.  Captured after two eager runs and replayed once: equal to
    the eager run bit for bit, the runs counted on the device (3, 9 and
    12) and the bodies' executions on the card at each depth (3 and 21)."""
    from pytorch_nmf_tpu_torch.ops import graphs

    B, C, L, R, T = NESTED
    rs = np.random.RandomState(SEED)
    H = torch.from_numpy(rs.rand(B, 1, R, L - T + 1).astype("f")).cuda()
    W = torch.from_numpy(rs.rand(B, C, R, T).astype("f")).cuda()
    k = torch.zeros((), dtype=torch.int64, device="cuda")
    go = torch.zeros((), dtype=torch.bool, device="cuda")
    ms = [torch.zeros((), dtype=torch.int64, device="cuda") for _ in range(2)]
    again = [torch.zeros((), dtype=torch.bool, device="cuda") for _ in range(2)]
    acc = torch.zeros(B, 1, C, L, device="cuda")
    runs = torch.zeros(3, dtype=torch.int64, device="cuda")

    def product():
        grouped = torch.nn.functional.conv1d(
            H.reshape(1, B * R, L - T + 1), W.flip(3).reshape(B * C, R, T),
            padding=T - 1, groups=B).reshape(B, 1, C, L)
        return grouped + ns.models.NMFD.reconstruct(H[0], W[0])

    def inner(i):
        def body():
            acc.mul_(0.5).add_(product())
            ms[i].add_(1)
            runs[1 + i].add_(1)
            torch.lt(ms[i], k + 2 + i, out=again[i])

        return body

    def outer():
        for i in range(2):
            ms[i].zero_()
            again[i].fill_(True)
            graphs._device_while(again[i], inner(i))
        acc.add_(1.0)
        k.add_(1)
        runs[0].add_(1)
        torch.lt(k, 3, out=go)

    def work():
        k.zero_()
        acc.zero_()
        runs.zero_()
        torch.lt(k, 3, out=go)
        graphs._device_while(go, outer)

    g = graphs._Graphs([work], None, torch.device("cuda"), "nested device "
                       "loops cannot be captured", conditional=True)
    g()
    ref = (acc.clone(), runs.clone())
    g()
    g.capture()
    acc.zero_()
    runs.zero_()
    r0 = graphs._Graphs.replays
    _, ms_replay = events_ms(g)
    on_card = g.cond.count.tolist()[:2]
    g.flush()
    equal = torch.equal(acc, ref[0]) and torch.equal(runs, ref[1])
    rec = fit_ms["nested_while"] = {
        "equal": equal, "runs": runs.tolist(), "bodies_on_card": on_card,
        "replays": graphs._Graphs.replays - r0, "replay_ms": ms_replay}
    g.close()
    check(equal and rec["runs"] == [3, 9, 12] and on_card == [3, 21]
          and rec["replays"] == 1, f"nested_while: {rec}")
    print(f"phase 4: nested_while: an outer WHILE node (3 runs) holding two "
          f"inner ones (9 and 12 runs), F.conv1d and a grouped convolution "
          f"({B}x1x{C}x{L}, R={R}, T={T}) in the inner bodies, cuDNN on: one "
          f"replay ({ms_replay:.3f} ms) equal to the eager run bit for bit, "
          f"runs {rec['runs']}, the bodies' executions counted on the card "
          f"by depth {on_card} [{card}]", flush=True)


def hoyer_compiled(ns, ctr, card, fit_ms, Vd, Wd, Hd):
    """Phases 3 and 4, this slice: the Hoyer fit's compiled chunk, the line
    search's attempts 2-10 a CUDA-graph WHILE node on the card.  At each
    HOYER_GRAPHED cell (dense NMF at MAIN_SHAPE; the NMFD flagship on
    ``Vd`` from ``Wd``, ``Hd``), a cache cell (:data:`HOYER_RUNS`):
    ``sparse_fit`` through the model, cold, warm from other inits and on a
    new V, against ``get_hoyer_fit(..., _graph=False)`` (eager) from the
    same inits, in turns: factors equal bit for bit, the same attempts, P1
    launches equal to the constrained factors plus the attempts, the same
    B3/B4 launches (exactly 2 and 1 an iteration for ``sW``, 1 and 1 for
    ``sW+sH``), the expected replays, captures and loop host reads (a warm
    fit one replay of the whole chunk loop, no capture, no host read), no
    line-search host read from the first replay on (the eager fit reads
    once an attempt); ms/iteration every way, the warm fit's replayed
    chunk loop (CUDA events around the replay) against the device time an
    iteration
    (``torch.profiler``), the idle shares, the WHILE nodes' handle-setting
    kernels' share, the captures' host ms, attempts an iteration, the peak
    device memory and the cache's held bytes.  Then
    ``nmf_hoyer_fit_batched`` over BATCH's problems (one batched program)
    as a cache cell against ``_graph=False`` bit for bit (the same rounds,
    P1 launches one a round plus W's first projection for the whole batch,
    line-search host reads only in the cold fit's eager chunks) and the 16
    eager single fits as the yardstick."""
    from pytorch_nmf_tpu_torch.ops import graphs

    solver, P, Graphs = ns.solver, ns.P, graphs._Graphs
    bt = solver._backtrack_project
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    Vn = torch.from_numpy(rs.rand(M, K).astype("f") + 1e-3).cuda()
    Wn = torch.from_numpy(rs.rand(K, R).astype("f") + 0.1).cuda()
    Hn = torch.from_numpy(rs.rand(M, R).astype("f") + 0.1).cuda()
    # the fit takes a contiguous target as it is and copies any other once
    # a fit (a new target each time): the user's contiguous copy, made once
    problems = {"NMF": (ns.NMF, Vn, Wn, Hn),
                "NMFD": (ns.models.NMFD, Vd.contiguous(), Wd, Hd)}
    nested_while(ns, card, fit_ms)
    for label, name, iters, kw in HOYER_GRAPHED:
        cls, V, W0, H0 = problems[name]
        recon = cls._resolve_fit_recon2(V, W0, H0, 2.0)
        eager_fit = solver.get_hoyer_fit(
            recon, None, 2.0, iters, True, True, kw.get("sW"), kw.get("sH"),
            W0.numel() // W0.shape[1], H0.numel() // H0.shape[1], _graph=False)
        inits = {"A": (W0, H0), "B": tuple(other_inits((W0, H0)))}
        V2 = same_target(V)

        def graphed(which="A", X=V):  # the user's entry point
            W, H = inits[which]
            m = cls(W=W.clone(), H=H.clone(), device="cuda")
            m.sparse_fit(X, beta=2, max_iter=iters, **kw)
            return m.W.detach(), m.H.detach()

        def eager(which="A"):
            W, H = inits[which]
            return eager_fit(V, W.clone(), H.clone())[:2]

        runs = {"cold": graphed, "eager": eager,
                "eager B": lambda: eager("B"), "warm": lambda: graphed("B"),
                "new V": lambda: graphed(X=V2)}
        solver.compiled_cache_clear()
        rec = {"ms_per_iter": {}}
        finals, factors = {}, len(kw)
        b3, b4 = {"NMF": (0, 0), "NMFD": (2, 1) if factors == 1 else (1, 1)}[name]
        want = {"fused_contractions": 0, "fused_beta_loss": 0,
                "hgrad": b3 * iters, "wgrad": b4 * iters}
        chunks = iters // 10
        for how, twin, expect in HOYER_RUNS:
            c0, r0, q0 = read(ctr), bt.reads, P.proj_rows.launches
            a0, p0, s0 = bt.attempts, Graphs.replays, Graphs.capture_s
            k0, h0 = Graphs.captures, solver._read.reads
            torch.cuda.synchronize()
            torch._C._cuda_clearCublasWorkspaces()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            graphed_run = not how.startswith("eager")
            marks = read_marks(lambda: bt.reads) if graphed_run else None
            try:
                f, ms = events_ms(runs[how])
            finally:
                if marks is not None:
                    marks.restore()
            peak = torch.cuda.max_memory_allocated() - base
            d = {k: v - c0[k] for k, v in read(ctr).items()}
            attempts, reads = bt.attempts - a0, bt.reads - r0
            q, replays = P.proj_rows.launches - q0, Graphs.replays - p0
            captures, loop_reads = Graphs.captures - k0, solver._read.reads - h0
            tag = f"Hoyer compiled {label} {how}"
            check(d == want, f"{tag}: launches {d}, want {want}")
            check(q == factors + attempts, f"{tag}: {q} P1 launches, "
                  f"{attempts} attempts, {factors} constrained factors")
            check((replays, captures, loop_reads) == expect(chunks),
                  f"{tag}: {replays} replays, {captures} captures, "
                  f"{loop_reads} loop host reads")
            if graphed_run:
                check(bt.reads == marks.reads[0] and reads < attempts,
                      f"{tag}: {bt.reads - marks.reads[0]} line-search reads "
                      f"from the first replay on, {reads} of {attempts}")
                if how == "cold":
                    rec["eager_chunk_reads"] = marks.reads[0] - r0
                else:
                    check(reads == 0, f"{tag}: {reads} line-search reads")
                if how == "warm":  # one replay: every chunk
                    rec["replayed_ms_per_iter"], \
                        rec["replay_busy_ms_per_iter"] = marks.per_iter(iters)
            else:
                check(reads == attempts, f"{tag}: {reads} reads, {attempts} "
                      f"attempts")
            check_factors(tag, *f)
            for key, v in (("peak_gb", peak / 1e9), ("replays", replays),
                           ("captures", captures), ("host_reads", reads),
                           ("loop_reads", loop_reads),
                           ("attempts", attempts), ("p1_launches", q),
                           ("capture_ms", 1e3 * (Graphs.capture_s - s0))):
                rec.setdefault(key, {})[how] = v
            rec["ms_per_iter"][how] = ms / iters
            finals[how] = f
        for how, twin, _ in HOYER_RUNS:
            check(rec["attempts"][how] == rec["attempts"][twin]
                  and all(torch.equal(a, b) for a, b in zip(finals[how],
                                                            finals[twin])),
                  f"Hoyer compiled {label} {how}: not bit for bit its eager "
                  f"twin (attempts {rec['attempts']})")
        rec["held_bytes"], rec["freed_allocated"], rec["freed_reserved"] = \
            cache_held(solver)
        graphed("B")  # so the profiled graphed fit is a hit
        for how, run, replayed in (("warm", runs["warm"], chunks),
                                   ("eager", runs["eager"], 0)):
            dev, cond, rdev = hoyer_device(run, iters, replayed)
            rec.setdefault("device_ms_per_iter", {})[how] = dev
            rec.setdefault("idle_share", {})[how] = \
                1 - dev / rec["ms_per_iter"][how]
            if how == "warm":
                rec["while_kernels_ms_per_iter"] = cond
                rec["replay_device_ms_per_iter"] = rdev
        rec["replayed_idle_share"] = (1 - rec["replay_device_ms_per_iter"]
                                      / rec["replayed_ms_per_iter"])
        solver.compiled_cache_clear()
        fit_ms[f"hoyer_compiled_{label.replace(' ', '_')}"] = rec
        t = {k: round(v, 4) for k, v in rec["ms_per_iter"].items()}
        a = rec["attempts"]["warm"]
        print(f"phase 4: Hoyer compiled {label}, {iters} iterations: ms/"
              f"iteration {t}; the replayed chunk loop alone (warm) "
              f"{rec['replayed_ms_per_iter']:.4f} (inside the replays "
              f"{rec['replay_busy_ms_per_iter']:.4f}) against their "
              f"{rec['replay_device_ms_per_iter']:.4f} ms of device time an "
              f"iteration; the whole fit's device time an iteration "
              f"(torch.profiler) warm {rec['device_ms_per_iter']['warm']:.4f}, "
              f"eager {rec['device_ms_per_iter']['eager']:.4f}, of which the "
              f"WHILE nodes' handle-setting kernels "
              f"{rec['while_kernels_ms_per_iter']:.5f}; the card idle "
              f"{100 * rec['replayed_idle_share']:.1f}% in the replayed "
              f"chunks, {100 * rec['idle_share']['warm']:.1f}% in the whole "
              f"warm fit, {100 * rec['idle_share']['eager']:.1f}% eager; "
              f"captures {rec['captures']}, capture ms (host) "
              f"{ {k: round(v, 1) for k, v in rec['capture_ms'].items()} }; "
              f"attempts {rec['attempts']} ({a / iters:.2f} an iteration "
              f"warm); line-search host reads {rec['host_reads']} (the cold "
              f"fit's all in chunks 1-2); the chunk loop's host reads "
              f"{rec['loop_reads']}; replays {rec['replays']}; P1 "
              f"launches {rec['p1_launches']}; launches {want} every way; "
              f"peak above what was allocated before the fit (GB) "
              f"{ {k: round(v, 4) for k, v in rec['peak_gb'].items()} }; the "
              f"cache held {rec['held_bytes'] / 1e6:.2f} MB by its count "
              f"({rec['freed_allocated'] / 1e6:.2f} MB allocated, "
              f"{rec['freed_reserved'] / 1e6:.2f} MB reserved freed by "
              f"compiled_cache_clear); cold, warm and new V bit for bit their "
              f"eager twins [{card}]", flush=True)
    del Vn, Wn, Hn, problems

    hoyer_batched(ns, card, fit_ms)


def hoyer_batched(ns, card, fit_ms):
    """Phase 4, ``nmf_hoyer_fit_batched`` (:func:`hoyer_compiled`'s last
    part)."""
    from pytorch_nmf_tpu_torch.ops import graphs

    solver, P, Graphs = ns.solver, ns.P, graphs._Graphs
    bt = solver._backtrack_project
    B, Mb, Kb, Rb = BATCH
    rs = np.random.RandomState(SEED)
    V = torch.from_numpy(rs.rand(B, Mb, Kb).astype("f") + 0.01).cuda()
    W = torch.from_numpy(rs.rand(B, Kb, Rb).astype("f") + 0.1).cuda()
    H = torch.from_numpy(rs.rand(B, Mb, Rb).astype("f") + 0.1).cuda()
    bb = solver._batched_backtrack_project
    eager_batch = solver.get_batched_hoyer_fit(
        ns.NMF.reconstruct, 2.0, HOYER_BATCH_ITERS, True, True, 0.5, None, Kb,
        Mb, _graph=False)
    single = solver.get_hoyer_fit(ns.NMF.reconstruct, None, 2.0,
                                  HOYER_BATCH_ITERS, True, True, 0.5, None,
                                  Kb, Mb, _graph=False)
    Wb, Hb = other_inits((W, H))
    V2 = same_target(V)

    def graphed(X, W, H):
        return ns.functional.nmf_hoyer_fit_batched(
            X, W, H, max_iter=HOYER_BATCH_ITERS, sW=0.5)[:2]

    runs = {"cold": lambda: graphed(V, W, H),
            "eager": lambda: eager_batch(V, W, H)[:2],
            "singles": lambda: [single(V[b], W[b].clone(), H[b].clone())
                                for b in range(B)],
            "eager B": lambda: eager_batch(V, Wb, Hb)[:2],
            "warm": lambda: graphed(V, Wb, Hb),
            "new V": lambda: graphed(V2, W, H)}
    # (replays, captures): the chunk loop one replay after the cold fit's
    # two eager chunks; a warm fit and a new V's one replay
    expect = {"cold": (1, 1), "warm": (1, 0), "new V": (1, 1)}
    twins = {"cold": "eager", "warm": "eager B", "new V": "eager"}
    solver.compiled_cache_clear()
    rec = fit_ms["hoyer_batched"] = {}
    outs = {}
    for how in ("cold", "eager", "singles", "singles", "eager B", "warm",
                "new V"):
        p0, s0, c0 = Graphs.replays, Graphs.capture_s, Graphs.captures
        q0, n0, r0, a0 = P.proj_rows.launches, bb.rounds, bb.reads, bt.attempts
        h0 = solver._read.reads
        out, ms = events_ms(runs[how])
        if how == "singles":
            out = tuple(torch.stack([o[j] for o in out]) for j in (0, 1))
        q, rounds, reads = P.proj_rows.launches - q0, bb.rounds - n0, bb.reads - r0
        tag = f"batched Hoyer {how}"
        replays, captures = Graphs.replays - p0, Graphs.captures - c0
        if how != "singles":
            check((replays, captures) == expect.get(how, (0, 0)),
                  f"{tag}: {replays} replays, {captures} captures")
            # one P1 launch a round and one for W's first projection, for
            # the whole batch
            check(q == 1 + rounds, f"{tag}: {q} P1 launches, {rounds} rounds")
            check(reads == rounds if how.startswith("eager") else
                  (0 < reads < rounds if how == "cold" else reads == 0),
                  f"{tag}: {reads} line-search reads, {rounds} rounds")
            # the chunk loop's flag reads: the cold fit's two eager chunks'
            loop_reads = solver._read.reads - h0
            check(loop_reads == (4 if how == "cold" else 0),
                  f"{tag}: {loop_reads} loop host reads")
        check_factors(tag, *out)
        r = rec.setdefault(how, {"ms": [], "capture_ms": [], "p1_launches": q})
        r["ms"].append(ms)
        r["capture_ms"].append(1e3 * (Graphs.capture_s - s0))
        r["rounds" if how != "singles" else "attempts"] = (
            rounds if how != "singles" else bt.attempts - a0)
        outs.setdefault(how, out)
    for how, twin in twins.items():
        check(rec[how]["rounds"] == rec[twin]["rounds"]
              and rec[how]["p1_launches"] == rec[twin]["p1_launches"]
              and all(torch.equal(a, b) for a, b in zip(outs[how],
                                                        outs[twin])),
              f"batched Hoyer {how}: not bit for bit {twin} ({rec[how]}, "
              f"{rec[twin]})")
    gap = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(outs["cold"], outs["singles"]))
    rec["gap_to_singles"] = gap
    rec["held_bytes"], rec["freed_allocated"], rec["freed_reserved"] = \
        cache_held(solver)
    t = rec
    print(f"phase 4: nmf_hoyer_fit_batched {B}x{Mb}x{Kb} R={Rb} sW=0.5, "
          f"{HOYER_BATCH_ITERS} iterations, one batched program: cold "
          f"{t['cold']['ms']} ms (chunks 1-2 eager, one capture, "
          f"{t['cold']['capture_ms']} ms of host time, one replay of the "
          f"chunk loop), warm from other inits {t['warm']['ms']} ms (one "
          f"replay, no capture, no host read), a new V {t['new V']['ms']} ms "
          f"(one capture, {t['new V']['capture_ms']} ms; one replay), "
          f"_graph=False {t['eager']['ms']} and "
          f"{t['eager B']['ms']} ms, each graphed fit equal to its eager twin "
          f"bit for bit; P1 launches {t['cold']['p1_launches']} for the batch "
          f"({t['cold']['rounds']} line-search rounds), against "
          f"{t['singles']['p1_launches']} for the {B} eager single fits "
          f"({t['singles']['attempts']} attempts), which took "
          f"{t['singles']['ms']} ms; factors within {gap:.3g} of theirs; the "
          f"cache held {t['held_bytes'] / 1e6:.2f} MB by its count "
          f"({t['freed_allocated'] / 1e6:.2f} MB allocated, "
          f"{t['freed_reserved'] / 1e6:.2f} reserved freed) [{card}]",
          flush=True)


def hoyer_fits(ns, ctr, card, fit_ms, p1):
    """Phase 3, Hoyer ``sparse_fit`` at β=2.  Dense NMF at MAIN_SHAPE with
    ``sW=0.5`` (the JAX bench's row): no kernel, W's columns at sparseness
    0.5, the loss below its value after the initial projection.  NMFD at the
    flagship (:func:`hoyer_target`) with ``sW`` and ``sW+sH``, through the
    model (B3/B4 behind
    autograd: exactly 2 B3 and 1 B4 launches an iteration for ``sW``, 1 and
    1 for both) and through the plain twin; then, apart from the path's
    count, the first iteration's gradients kernel against plain, the losses
    of the first HOYER_TRACE iterations both ways, and a profile of one
    iteration.  Every projection is one launch of the projection kernel
    (P1) with no host read: a fit launches it exactly once per constrained
    factor (the initial projection) and once per line-search attempt; the
    dense fit's launches and device time an iteration are profiled.
    Returns the path's launch counts; P1's go into ``p1["hoyer"]``."""
    solver, P, F, beta_div = ns.solver, ns.P, ns.F, ns.beta_div
    zero(ctr)
    p1_start = P.proj_rows.launches

    def check_projections(tag, q0, r0, r1, factors):
        """P1 launched once per constrained factor and line-search attempt,
        the projection read nothing on the host."""
        q = P.proj_rows.launches - q0
        check(q == factors + r1[0] - r0[0] and r1[1] == r0[1],
              f"{tag}: {q} projection launches, {r1[0] - r0[0]} line-search "
              f"attempts, {r1[1] - r0[1]} projection host reads")
        return q

    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    V = torch.from_numpy(rs.rand(M, K).astype("f") + 1e-3).cuda()
    inits = {"W": rs.rand(K, R).astype("f") + 0.1,
             "H": rs.rand(M, R).astype("f") + 0.1}
    # a first call pays one-time host costs (autograd's lazy imports)
    ns.nmf_from_numpy(inits, "cuda").sparse_fit(V, beta=2, max_iter=1, sW=0.5)
    m = ns.nmf_from_numpy(inits, "cuda")
    Wp = P.proj_columns_explicit(m.W.detach(), P.hoyer_l1_target(K, 0.5), 1.0)
    before = float(beta_div(ns.NMF.reconstruct(m.H.detach(), Wp), V, 2))
    n0, r0, q0 = read(ctr), host_reads(solver, P), P.proj_rows.launches
    _, ms = events_ms(lambda: m.sparse_fit(V, beta=2, max_iter=HOYER_DENSE_ITERS,
                                           sW=0.5))
    d = {k: v - n0[k] for k, v in read(ctr).items()}
    r1 = host_reads(solver, P)
    after = float(beta_div(m().detach(), V, 2))
    sp = col_sparseness(m.W)
    tag = f"Hoyer NMF {M}x{K} R={R} sW=0.5"
    check_factors(tag, m.W, m.H)
    check(not any(d.values()), f"{tag}: kernel launches {d}")
    q = check_projections(tag, q0, r0, r1, 1)
    check(after < before, f"{tag}: loss {before} -> {after} did not fall")
    check(float((sp - 0.5).abs().max()) <= 1e-3,
          f"{tag}: column sparseness {sp.tolist()}")
    per = [(b - a) / HOYER_DENSE_ITERS for a, b in zip(r0, r1)]
    fit_ms[f"hoyer_nmf_{M}x{K}_r{R}_sW0.5_beta2"] = ms / HOYER_DENSE_ITERS
    print(f"phase 3: {tag}: loss {before:.7g} -> {after:.7g}, column "
          f"sparseness {float(sp.min()):.6f}..{float(sp.max()):.6f}; "
          f"{ms / HOYER_DENSE_ITERS:.4f} ms/iteration, host reads/iteration "
          f"{per[0]:.2f} (line search) + {per[1]:.2f} (projection), P1 "
          f"launches {q} [{card}]", flush=True)

    # its launches and device time an iteration: torch.profiler over fits of
    # 1 and 1 + HOYER_PROFILE iterations, differenced (the initial
    # projection and the first loss are the 1-iteration fit's)
    from torch.profiler import ProfilerActivity, profile

    def dense_profile(n):
        solver.compiled_cache_clear()  # eager chunks, as a first fit runs
        fit = ns.nmf_from_numpy(inits, "cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fit.sparse_fit(V, beta=2, max_iter=n, sW=0.5)
            torch.cuda.synchronize()
        out = {"launches": 0, "device": 0.0, "projection": 0.0, "gemm": 0.0}
        for e in prof.key_averages():
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                         "cuLaunchKernel", "cuLaunchKernelEx"):
                out["launches"] += e.count
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms_k = e.self_device_time_total / 1e3
            out["device"] += ms_k
            key = e.key.lower()
            if "hoyer_proj" in key:
                out["projection"] += ms_k
            elif any(t in key for t in ("gemm", "xmma", "sm90")):
                out["gemm"] += ms_k
        return out

    a, b = dense_profile(1), dense_profile(1 + HOYER_PROFILE)
    prof_it = {k: (b[k] - a[k]) / HOYER_PROFILE for k in a}
    prof_it["rest"] = prof_it["device"] - prof_it["projection"] - prof_it["gemm"]
    prof_it["idle_share"] = 1 - prof_it["device"] / (ms / HOYER_DENSE_ITERS)
    check(prof_it["projection"] > 0, f"{tag}: no projection kernel in the profile")
    fit_ms[f"hoyer_nmf_{M}x{K}_r{R}_sW0.5_profile"] = prof_it
    print(f"phase 4: {tag}, one iteration (torch.profiler, {1 + HOYER_PROFILE}-"
          f"iteration fit less 1-iteration fit): launches "
          f"{prof_it['launches']:.1f}, device ms {prof_it['device']:.4f} "
          f"(projection {prof_it['projection']:.4f}, GEMMs "
          f"{prof_it['gemm']:.4f}, rest {prof_it['rest']:.4f}); the card idle "
          f"{100 * prof_it['idle_share']:.1f}% of the "
          f"{ms / HOYER_DENSE_ITERS:.4f} ms/iteration [{card}]", flush=True)
    del V, m, Wp

    N, C, S_out, kernel, Rd = DECONV["NMFD"]
    V = hoyer_target(ns)
    m0 = deconv_model("NMFD", ns.models)
    W0, H0 = m0.W.detach().clone(), m0.H.detach().clone()
    del m0
    W_col, H_col = W0.numel() // Rd, H0.numel() // Rd
    shape = f"{C}x{S_out[0]}_r{Rd}_k{kernel[0]}"
    for recon in (F.kernel_adjoint_deconv, F.plain_adjoint_deconv):  # warm-up
        solver.get_hoyer_fit(recon, None, 2.0, 1, True, True, 0.5, None, W_col,
                             H_col)(V, W0, H0)
    for label, kw, (b3, b4) in HOYER_CASES:
        tag = f"Hoyer NMFD {shape} {label}"
        plain = solver.get_hoyer_fit(F.plain_adjoint_deconv, None, 2.0,
                                     HOYER_NMFD_ITERS, True, True, kw.get("sW"),
                                     kw.get("sH"), W_col, H_col)
        m = ns.models.NMFD(W=W0, H=H0, device="cuda")
        n0, r0, q0 = read(ctr), host_reads(solver, P), P.proj_rows.launches
        _, ms = events_ms(lambda: m.sparse_fit(V, beta=2,
                                               max_iter=HOYER_NMFD_ITERS, **kw))
        d = {k: v - n0[k] for k, v in read(ctr).items()}
        r1 = host_reads(solver, P)
        check_factors(tag, m.W, m.H)
        q = check_projections(tag, q0, r0, r1, len(kw))
        want = {"hgrad": b3 * HOYER_NMFD_ITERS, "wgrad": b4 * HOYER_NMFD_ITERS,
                "fused_contractions": 0, "fused_beta_loss": 0}
        check(d == want, f"{tag}: launches {d}, want {want}")
        (Wq, Hq, _), pms = events_ms(lambda: plain(V, W0.clone(), H0.clone()))
        check_factors(f"{tag} plain", Wq, Hq)
        loss_k = float(beta_div(F.plain_adjoint_deconv(m.H.detach(), m.W.detach()), V, 2))
        loss_p = float(beta_div(F.plain_adjoint_deconv(Hq, Wq), V, 2))
        per = [(b - a) / HOYER_NMFD_ITERS for a, b in zip(r0, r1)]
        fit_ms[f"hoyer_nmfd_{shape}_{label}_beta2"] = {
            "kernel": ms / HOYER_NMFD_ITERS, "plain": pms / HOYER_NMFD_ITERS}
        rel = abs(loss_k - loss_p) / loss_p
        print(f"phase 3: {tag}: launches B3 {d['hgrad']}, B4 {d['wgrad']} in "
              f"{HOYER_NMFD_ITERS} iterations; final loss kernel {loss_k:.7g} "
              f"plain {loss_p:.7g} (rel {rel:.3g}"
              f"{'; a line-search decision flipped after the compared ones' if rel > RTOL else ''}"
              f"); ms/iteration kernel {ms / HOYER_NMFD_ITERS:.3f}, plain "
              f"{pms / HOYER_NMFD_ITERS:.3f}; host reads/iteration "
              f"{per[0]:.2f} (line search) + {per[1]:.2f} (projection), P1 "
              f"launches {q} [{card}]", flush=True)
        del m, Wq, Hq
    hoyer_compiled(ns, ctr, card, fit_ms, V, W0, H0)
    launches = read(ctr)
    p1["hoyer"] = P.proj_rows.launches - p1_start

    # the first iteration's gradients: dW of the projected step at the
    # projected init, dH of the MU step's two cotangents
    Wp = P.proj_columns_explicit(W0, P.hoyer_l1_target(W_col, 0.5), 1.0)

    def first_grads(deconv):
        x = Wp.clone().requires_grad_(True)
        (dW,) = torch.autograd.grad(beta_div(deconv(H0, x), V, 2), x)
        h = H0.clone().requires_grad_(True)
        WH = deconv(h, Wp)
        neg = torch.autograd.grad(WH, h, V, retain_graph=True)[0]
        pos = torch.autograd.grad(WH, h, WH.detach())[0]
        return dW, neg, pos

    rels = []
    for name, g, r in zip(("dW", "dH neg", "dH pos"),
                          first_grads(F.kernel_adjoint_deconv),
                          first_grads(F.plain_adjoint_deconv)):
        torch.cuda.synchronize()
        rel = float((g - r).abs().max()) / float(r.abs().max())
        check(rel <= RTOL, f"Hoyer NMFD first-iteration {name}: "
              f"max|kernel-plain|/max|plain| = {rel:.3g}")
        rels.append(f"{name} {rel:.3g}")
    print("phase 3: Hoyer NMFD first-iteration gradients, max|kernel-plain|/"
          "max|plain|: " + ", ".join(rels) + f" [{card}]", flush=True)

    # per-iteration losses: the state at the end of each iteration (after
    # the renorm that closes it), kernel run against plain run
    def traced(run):
        return hoyer_losses(solver, run, lambda w, h: float(
            beta_div(F.plain_adjoint_deconv(h, w), V, 2)))

    for label, kw, _ in HOYER_CASES:
        args = (2.0, HOYER_TRACE, True, True, kw.get("sW"), kw.get("sH"),
                W_col, H_col)
        lk = traced(lambda: solver.get_hoyer_fit(F.kernel_adjoint_deconv, None,
                                                 *args)(V, W0, H0))
        lp = traced(lambda: solver.get_hoyer_fit(F.plain_adjoint_deconv, None,
                                                 *args)(V, W0, H0))
        rel = [abs(a - b) / b for a, b in zip(lk, lp)]
        check(len(rel) == HOYER_TRACE and max(rel) <= RTOL,
              f"Hoyer NMFD {label}: losses kernel {lk} plain {lp}")
        print(f"phase 3: Hoyer NMFD {label} losses, iterations 1-{HOYER_TRACE}: "
              f"kernel {[f'{x:.7g}' for x in lk]}, max rel to plain "
              f"{max(rel):.3g} [{card}]", flush=True)

    # where one sW iteration goes: the profiler's kernels by kind over fits
    # of 1 and 3 iterations, differenced (the initial projection to unit
    # norm, many rounds from a random init, is the 1-iteration fit's rest);
    # the projection and the reconstruction timed alone
    from torch.profiler import ProfilerActivity, profile

    def profiled(n):
        fit = solver.get_hoyer_fit(F.kernel_adjoint_deconv, None, 2.0, n, True,
                                   True, 0.5, None, W_col, H_col)
        r0 = host_reads(solver, P)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = events_ms(lambda: fit(V, W0, H0))
        r1 = host_reads(solver, P)
        ops = sum(e.count for e in prof.key_averages()
                  if e.device_time_total > 0)
        return (device_split(prof), wall,
                [b - a for a, b in zip(r0, r1)] + [ops])

    s1, w1, c1 = profiled(1)
    s3, w3, c3 = profiled(3)
    split = {k: (s3[k] - s1[k]) / 2 for k in s1}
    attempts, proj_reads = (c3[0] - c1[0]) / 2, (c3[1] - c1[1]) / 2
    device_ops = (c3[2] - c1[2]) / 2
    proj_ms = cuda_ms(lambda: P.proj_columns(Wp, P.hoyer_l1_target(W_col, 0.5)),
                      reps=5, warmup=1)
    rec_ms = cuda_ms(lambda: F._stream_recon(F._w2(Wp), H0, kernel), reps=5,
                     warmup=1)
    device = sum(split.values())
    fit_ms["hoyer_nmfd_profile_ms"] = dict(
        split, device=device, wall=(w3 - w1) / 2, projection_alone=proj_ms,
        reconstruction_alone=rec_ms, attempts=attempts,
        projection_reads=proj_reads, device_ops=device_ops,
        initial_projection=sum(s1.values()) - device)
    print("phase 4: Hoyer NMFD sW, one iteration's device time (ms; "
          "torch.profiler, 3-iteration fit less 1-iteration fit, halved): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; device {device:.3f}, wall {(w3 - w1) / 2:.3f}; line-search "
          f"attempts {attempts:.1f}, projection reads {proj_reads:.1f}, device "
          f"operations {device_ops:.1f}; the initial projection and first-call "
          f"costs {sum(s1.values()) - device:.3f}; "
          f"one projection of W {proj_ms:.3f}, one reconstruction {rec_ms:.3f} "
          f"[{card}]", flush=True)
    return launches


def functional_fits(ns, ctr, card):
    """Phase 3, the functional API against the models: ``nmf_fit`` at
    MAIN_SHAPE (β=0.5, B1/B2) and ``nmfd_fit`` at the NMFD flagship (β=1,
    B3/B4) return factors equal (``torch.equal``) to ``NMF.fit`` and
    ``NMFD.fit`` from the same inits, with the same launches.  Returns the
    functional path's launch counts (the model fits are counted apart)."""
    fn = ns.functional
    M, K, R = MAIN_SHAPE
    V, W, H = inputs(M, K, R)
    Vd = deconv_target("NMFD")
    m0 = deconv_model("NMFD", ns.models)
    Wd, Hd = m0.W.detach().clone(), m0.H.detach().clone()
    del m0
    runs = [("nmf_fit", ns.NMF, V, W, H, dict(beta=0.5, max_iter=FUNC_NMF_ITERS)),
            ("nmfd_fit", ns.models.NMFD, Vd, Wd, Hd,
             dict(beta=1, max_iter=FUNC_NMFD_ITERS))]
    zero(ctr)
    outs = []
    for name, _, V_, W_, H_, kw in runs:
        n0 = read(ctr)
        out = getattr(fn, name)(V_, W_, H_, tol=0, **kw)
        outs.append((out, {k: v - n0[k] for k, v in read(ctr).items()}))
    launches = read(ctr)
    for (name, model, V_, W_, H_, kw), ((Wf, Hf, nf), d) in zip(runs, outs):
        m = model(W=W_, H=H_, device="cuda")
        n0 = read(ctr)
        n = m.fit(V_, tol=0, **kw)
        dm = {k: v - n0[k] for k, v in read(ctr).items()}
        check(n == nf == kw["max_iter"], f"{name}: n_iter {nf} vs {n}")
        check(torch.equal(Wf, m.W.detach()) and torch.equal(Hf, m.H.detach()),
              f"{name}: factors differ from {model.__name__}.fit")
        check(d == dm and any(d.values()), f"{name}: launches {d}, model {dm}")
        check_factors(name, Wf, Hf)
        print(f"phase 3: {name} equals {model.__name__}.fit (torch.equal), "
              f"launches {d} [{card}]", flush=True)
    return launches


def batched_problem(plca=False):
    """BATCH's problems (numpy seed SEED): each V a mix of a rank-R product
    and uniform noise, the product's share rising from 0 to 1 across the
    batch, so the problems converge at different rates and one ``tol``
    stops them at different chunks; W and H ``rand + 0.1`` (PLCA: W and H
    normalized, Z uniform).  On the card."""
    B, M, K, R = BATCH
    rs = np.random.RandomState(SEED)
    noise = rs.rand(B, M, K).astype("f")
    low = np.einsum("bmr,bkr->bmk", rs.rand(B, M, R).astype("f"),
                    rs.rand(B, K, R).astype("f")) / R
    share = np.linspace(0, 1, B).astype("f")[:, None, None]
    V = share * low + (1 - share) * noise + 0.01
    W = rs.rand(B, K, R).astype("f") + 0.1
    H = rs.rand(B, M, R).astype("f") + 0.1
    out = [V, W, H]
    if plca:
        out = [V, W / W.sum(1, keepdims=True), H / H.sum(1, keepdims=True),
               np.full((B, R), 1.0 / R, "f")]
    return [torch.from_numpy(np.ascontiguousarray(x, "f")).cuda() for x in out]


def stagger_tol(losses):
    """``(tol, stops)``: from each problem's loss before a fit and after
    each chunk, ``(chunks + 1, B)``, the ``tol`` between two of their
    relative decreases at which the most distinct chunks of stopping occur,
    one of them 3 or later (the replays), the farthest from every decrease
    among those; ``stops[b]`` the chunk problem ``b`` stops at, 0 for
    none."""
    d = -np.diff(losses, axis=0) / losses[0]
    vals = np.sort(d[1:].ravel())
    best = None
    for tol in np.sqrt(vals[1:] * vals[:-1]):
        below = d < tol
        stops = np.where(below.any(0), below.argmax(0) + 1, 0).tolist()
        margin = float(np.min(np.maximum(d / tol, tol / d)))
        score = (len(set(stops)), margin)
        if max(stops) >= 3 and (best is None or score > best[0]):
            best = (score, float(tol), stops)
    check(best is not None and best[0][0] > 1,
          f"batched: no tol stops the problems at different chunks: {d}")
    return best[1], best[2]


def batched_fits(ns, ctr, card, fit_ms):
    """Phases 3 and 4, the batched MU and EM fits' compiled chunk.
    ``nmf_fit_batched`` at β ∈ {2, 1} and ``plca_fit_batched`` at BATCH
    (:func:`batched_problem`): the ``tol`` (:func:`stagger_tol`) read from
    the eager loop's per-problem losses after each chunk, so the problems
    stop at different chunks, some in the replays; through ``functional``
    (the user's entry point: a cold fit, a warm one from the same inits and
    one on a new V) and the solver with ``_graph=False`` (eager) in turns:
    factors and ``n_iter`` equal bit for bit, each problem's ``n_iter`` the
    stagger's, the chunk loop one WHILE node (cold: chunks 1-2 eager, one
    capture, one replay; warm and on a new V one replay; nothing read on
    the host after a replay); ms per batched iteration every way, the warm
    fit's replay (CUDA events around it) against its device time
    (``torch.profiler``), the warm fit's device time and the card's idle
    share, the captures' host ms, the cache's held bytes.
    The MU fits' problems also end within RTOL (final loss) of their single
    fits through the generic engine (the same ``n_iter``, or the cases that
    differ printed).  No kernel runs."""
    from pytorch_nmf_tpu_torch.ops import graphs
    from torch.func import vmap

    fn, solver, beta_div, Graphs = ns.functional, ns.solver, ns.beta_div, graphs._Graphs
    B, M, K, R = BATCH
    chunks = BATCH_ITERS // 10
    one = torch.ones((), device="cuda")
    zero(ctr)
    for case in ("beta=2", "beta=1", "PLCA"):
        plca = case == "PLCA"
        arrays = batched_problem(plca)
        if plca:
            V, W, H, Z = arrays
            norm = V.reshape(B, -1).sum(1)
            Vn = V / norm[:, None, None]
            loss_b = vmap(lambda vn, w, h, z, n: torch.sqrt(
                2.0 * ns.kl_div(ns.PLCA.reconstruct(h, w, z) * n, vn * n)))

            def eager(tol, iters):
                return solver.get_batched_plca_fit(
                    ns.PLCA.reconstruct, tol, iters, True, True, True, False,
                    False, False, _graph=False)(V, W, H, Z, one, one, one)

            def graphed(tol, X=V):
                return fn.plca_fit_batched(X, W, H, Z, tol=tol,
                                           max_iter=BATCH_ITERS)

            def loss_of(out):
                return loss_b(Vn, *out[:3], norm)
        else:
            V, W, H = arrays
            beta = float(case[5:])
            div_b = vmap(lambda wh, v, beta=beta: beta_div(wh, v, beta))

            def eager(tol, iters, beta=beta):
                return solver.get_batched_dense_fit(
                    ns.NMF.reconstruct, beta, tol, iters, True, True, 0.0,
                    0.0, ns.nmf_updater_factory_generic, _graph=False)(V, W, H)

            def graphed(tol, beta=beta, X=V):
                return fn.nmf_fit_batched(X, W, H, beta=beta, tol=tol,
                                          max_iter=BATCH_ITERS)

            def loss_of(out, div_b=div_b):
                return torch.sqrt(2.0 * div_b(ns.NMF.reconstruct(out[1], out[0]), V))

        losses = [loss_of(arrays[1:])]
        for c in range(1, chunks + 1):
            losses.append(loss_of(eager(0.0, 10 * c)))
        tol, stops = stagger_tol(torch.stack(losses).double().cpu().numpy())
        want = [10 * s - plca if s else BATCH_ITERS - plca for s in stops]
        run_chunks = chunks if 0 in stops else max(stops)
        V2 = same_target(V)
        # the warm fit starts from the same inits: the tol is the stagger's
        # for them
        runs = {"cold": lambda: graphed(tol), "warm": lambda: graphed(tol),
                "new V": lambda: graphed(tol, X=V2),
                "eager": lambda: eager(tol, BATCH_ITERS)}
        # (replays, captures, host reads): the chunk loop one WHILE node,
        # chunks 1-2 of a cold fit eager (the flag read before and after
        # each), nothing read on the host after a replay
        expect = {"cold": (1, 1, 2 + 2), "warm": (1, 0, 0),
                  "new V": (1, 1, 0), "eager": (0, 0, run_chunks)}
        solver.compiled_cache_clear()
        rec = {"tol": tol, "stops": stops, "ms": {}}
        outs = {}
        for how in ("cold", "eager", "eager", "warm", "new V"):
            r0, p0, s0 = solver._read.reads, Graphs.replays, Graphs.capture_s
            k0 = Graphs.captures
            marks = replay_marks() if how == "warm" else None
            try:
                out, ms = events_ms(runs[how])
            finally:
                if marks is not None:
                    marks.restore()
            reads, replays = solver._read.reads - r0, Graphs.replays - p0
            captures = Graphs.captures - k0
            tag = f"batched {case} {how}"
            n = out[3] if plca else out[2]
            check(n.tolist() == want, f"{tag}: n_iter {n.tolist()}, want {want}")
            check((replays, captures, reads) == expect[how],
                  f"{tag}: {replays} replays, {captures} captures, {reads} "
                  f"host reads, want {expect[how]}")
            rec.setdefault("host_reads", {})[how] = reads
            check_factors(tag, *out[:3 if plca else 2])
            rec["ms"].setdefault(how, []).append(ms)
            if how in ("cold", "new V"):
                rec.setdefault("capture_ms", {})[how] = \
                    1e3 * (Graphs.capture_s - s0)
            if how == "warm":
                rec["replayed_ms_per_iter"], rec["replay_busy_ms_per_iter"] = \
                    marks.per_iter(10 * run_chunks)
            outs.setdefault(how, out)
        for how in ("cold", "warm", "new V"):
            check(all(torch.equal(a, b) for a, b in zip(outs[how],
                                                        outs["eager"])),
                  f"batched {case} {how}: not bit for bit the eager fit")
        rec["held_bytes"], rec["freed_allocated"], rec["freed_reserved"] = \
            cache_held(solver)
        iters = 10 * run_chunks + (BATCH_ITERS % 10 if 0 in stops else 0)
        runs["warm"]()  # so the profiled one is a hit
        dev, _, rec["replay_device_ms_per_iter"] = hoyer_device(
            runs["warm"], iters, run_chunks)
        warm_ms = min(rec["ms"]["warm"]) / iters
        rec["device_ms_per_iter"] = dev
        rec["idle_share"] = 1 - dev / warm_ms
        rec["ms_per_batched_iter"] = {h: [t / iters for t in v]
                                      for h, v in rec["ms"].items()}
        differ, rels = [], []
        if not plca:
            single = solver.get_dense_fit(ns.NMF.reconstruct, beta, tol,
                                          BATCH_ITERS, True, True, 0.0, 0.0,
                                          False, ns.nmf_updater_factory_generic)
            singles, rec["singles_ms"] = events_ms(
                lambda: [single(V[b], W[b].clone(), H[b].clone()) for b in range(B)])
            Wb, Hb, nb = outs["cold"]
            for b, (w, h, n) in enumerate(singles):
                lb = float(beta_div(ns.NMF.reconstruct(Hb[b], Wb[b]), V[b], beta))
                ls = float(beta_div(ns.NMF.reconstruct(h, w), V[b], beta))
                rels.append(abs(lb - ls) / ls)
                if int(nb[b]) != n:
                    differ.append(f"problem {b}: n_iter {int(nb[b])} vs {n}, "
                                  f"loss ratio {lb / ls:.7g}")
            check(max(rels) <= RTOL, f"batched {case}: loss rel {max(rels):.3g}")
        fit_ms[f"batched_{B}x{M}x{K}_r{R}_{case.replace('=', '')}"] = rec
        t = rec["ms_per_batched_iter"]
        print(f"phase 3: batched {'plca_fit_batched' if plca else 'nmf_fit_batched ' + case} "
              f"{B}x{M}x{K} R={R}, tol {tol:.4g}: stops at chunks {stops} "
              f"(n_iter {want}), cold, warm and new V equal to eager bit for "
              f"bit; ms per batched iteration "
              f"{ {k: [round(x, 4) for x in v] for k, v in t.items()} }; the "
              f"replayed chunks (warm) "
              f"{rec['replayed_ms_per_iter']:.4f} (inside the replays "
              f"{rec['replay_busy_ms_per_iter']:.4f}) against their "
              f"{rec['replay_device_ms_per_iter']:.4f} ms of device time an "
              f"iteration; capture (host ms) "
              f"{ {k: round(v, 1) for k, v in rec['capture_ms'].items()} }; "
              f"the warm fit's device time {rec['device_ms_per_iter']:.4f} ms "
              f"an iteration, the card idle {100 * rec['idle_share']:.1f}%; "
              f"replays, captures and host reads {expect}; the cache held "
              f"{rec['held_bytes'] / 1e6:.2f} MB by its count "
              f"({rec['freed_allocated'] / 1e6:.2f} MB allocated, "
              f"{rec['freed_reserved'] / 1e6:.2f} reserved freed)"
              + ("" if plca else
                 f"; final losses within {max(rels):.3g} of the {B} single fits "
                 f"({rec['singles_ms']:.1f} ms; "
                 + ("; ".join(differ) or "the same n_iter") + ")")
              + f" [{card}]", flush=True)
    check(not any(read(ctr).values()), f"the batched fits launched {read(ctr)}")


def compare_projection(P, card, fit_ms):
    """Phases 2 and 4, the projection kernel (P1) against its plain version
    on the card (``plain_proj_rows`` on the columns copied out) at
    PROJ_CASES, from ``rand + 0.1`` to sparseness 0.5 at the columns' own
    norms: NaN in the same places, ``max|kernel - plain| ≤
    PROJ_RTOL·max|plain|`` on the finite entries, one launch and no host
    read; the regime the plan chose, its cluster and occupancy
    (``cudaOccupancyMaxActiveClusters``); the kernel's device time (CUDA
    graph replays of its launch), beside it the streaming regime's (one
    block a column, every round through HBM) on the same columns and the
    whole call's time by events; the plain version's time, and the bound:
    the larger of
    the values read and written once at the HBM rate and the operations of
    the rounds these columns needed (PROJ_OPS per value and round, from the
    plain version's count) at the f32 peak; beside it the bytes of a read
    and a write of every column each round.  Returns the PROJ_MAIN case's
    stats."""
    rs = np.random.RandomState(SEED)
    stats = None
    stream = P.Plan("stream", 1024, 1, 0, 0)
    for label, shape in PROJ_CASES:
        x = torch.from_numpy(rs.rand(*shape).astype("f") + 0.1).cuda()
        R = shape[1]
        N = x.numel() // R
        L1 = P.hoyer_l1_target(N, 0.5)
        cols = x.movedim(1, 0).reshape(R, N)
        norms = torch.sqrt(torch.sum(cols * cols, dim=1))
        k1, k2 = (L1 * norms).contiguous(), (norms * norms).contiguous()
        plan = P.kernel_plan(x, 1)
        clusters = P.max_active_clusters(x, 1)
        n0, r0 = P.proj_rows.launches, P.proj_rows.reads
        got = P.proj_columns(x, L1, norms=norms)
        torch.cuda.synchronize()
        check(P.proj_rows.launches - n0 == 1 and P.proj_rows.reads == r0,
              f"P1 at {label}: {P.proj_rows.launches - n0} launches, "
              f"{P.proj_rows.reads - r0} host reads")
        want, rounds = P.plain_proj_rows(cols, k1, k2, return_rounds=True)
        got = got.movedim(1, 0).reshape(R, N)
        check(torch.equal(torch.isnan(got), torch.isnan(want)),
              f"P1 at {label}: NaN where the plain version has none, or not "
              f"where it has")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        scale = float(want[fin].abs().max())
        check(err <= PROJ_RTOL * scale,
              f"P1 at {label}: max|kernel-plain| {err} against max|plain| {scale}")
        ms = graph_ms(lambda: P._kernel(x, 1, k1, k2))
        stream_ms = graph_ms(lambda: P._kernel(x, 1, k1, k2, plan=stream))
        call_ms = cuda_ms(lambda: P.proj_columns(x, L1, norms=norms), reps=10,
                          warmup=2)
        plain_ms = cuda_ms(lambda: P.plain_proj_rows(cols, k1, k2), reps=3,
                           warmup=1)
        value_rounds = int(rounds.sum()) * N
        bound_ms, bound_by, _ = bound(0, 2 * x.numel() * 4 + 2 * R * 4)
        ops_ms = 1e3 * PROJ_OPS * value_rounds / FP32_FLOPS
        if ops_ms > bound_ms:
            bound_ms, bound_by = ops_ms, "operations"
        st = dict(new_stats(), max_abs_err=err, max_rel_err=err / scale, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  regime=plan.regime, cluster=plan.cluster,
                  threads=plan.threads, max_active_clusters=clusters,
                  stream_ms=stream_ms, call_ms=call_ms,
                  rounds_mean=float(rounds.double().mean()),
                  rounds_max=int(rounds.max()),
                  bound_round_bytes_ms=1e3 * 8 * value_rounds / HBM_BYTES)
        fit_ms[f"hoyer_proj_{label.replace(' ', '_')}"] = st
        print(f"phase 2/4: P1 at {label}: regime {plan.regime}, cluster "
              f"{plan.cluster} of {plan.threads} threads, at most {clusters} "
              f"clusters at once; rounds mean {st['rounds_mean']:.2f}, max "
              f"{st['rounds_max']}; max|kernel-plain| {err:.3g} (max|plain| "
              f"{scale:.4g}); kernel {ms:.4f} ms (the streaming regime "
              f"{stream_ms:.4f}; the whole call {call_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); a "
              f"read and a write of every column each round "
              f"{st['bound_round_bytes_ms']:.4f} ms [{card}]", flush=True)
        if label == PROJ_MAIN:
            stats = st
        del x, cols, got, want
    return stats


def trainer_steps(ns, ctr, card, fit_ms, p1):
    """Phase 3, the optimizers, compiled (the default: CUDA graphs) against
    eager (``jit_compile=False``) from the same start.  ``BetaMu`` over the
    bench's chain (``torch.nn.Sequential`` of three ``NMF`` modules) at
    β=1: a first step (the probe, warm-up, capture and one replay), then
    BETAMU_STEPS steps by ``run``, which makes exactly one replay a step
    and no synchronizing call (``torch.cuda`` sync debug mode set to raise
    around it); every parameter within COMPILED_RTOL of the eager twin's,
    the divergence falls, every ``.grad`` set.  A closure that reads the
    host raises, naming ``jit_compile=False``, and leaves the parameters as
    they were.  ``SparsityProj`` with sparsity 0.5 on W of an ``NMF`` at
    MAIN_SHAPE, a first step then SPARSITY_STEPS steps by ``run``, from the
    same start at each of SPARSITY_CASES' step sizes: compiled (one replay a
    step, the line search a CUDA-graph WHILE node, no closure call and no
    eager loop read in the run, one host read for the whole run: the step
    size) against ``_graph=False`` (the same step called eagerly, one host
    read an attempt) bit for bit: W, loss, float32 step size; at 1/L
    against ``jit_compile=False`` too (W and the loss within COMPILED_RTOL,
    the same step size), the loss falls, W's columns at sparseness 0.5; at
    8/L the line search backtracks (more than one attempt a step on
    average, from the eager twin's closure calls).  Prints ms/step each way
    (CUDA events), replays and host reads, and the card's reserved memory
    before, with the compiled entries cached, and after the optimizers and
    the phase's tensors are dropped, when their graphs must be gone too.
    Neither runs
    B1-B4 (checked; the MU start of SparsityProj is β=2: Gram updates);
    SparsityProj
    projects with P1, whose launches go into ``p1["optimizers"]`` (counted
    where launched: in warm-up and capture; a replay repeats the captured
    ones uncounted)."""
    T, P, NMF = ns.trainer, ns.P, ns.NMF
    import gc
    import weakref

    def reserved_now():
        torch.cuda.synchronize()
        return torch.cuda.memory_reserved()

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    reserved = [reserved_now()]
    zero(ctr)
    p1_start = P.proj_rows.launches
    (M0, K0), rank, W2, W3 = CHAIN

    def chain():
        g = torch.Generator("cuda").manual_seed(SEED)
        return torch.nn.Sequential(
            NMF((M0, K0), rank=rank, device="cuda", generator=g),
            NMF(W=W2, device="cuda", generator=g),
            NMF(W=W3, device="cuda", generator=g))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rs = np.random.RandomState(SEED)
    target = torch.from_numpy(rs.rand(M0, W3[0]).astype("f")).cuda()
    chains = {"compiled": chain(), "eager": chain()}
    before = float(ns.beta_div(chains["eager"](None).detach(), target, 1))
    res, trainers = {}, []
    for how, c in chains.items():
        tr = ns.BetaMu(c.parameters(), 1, jit_compile=how == "compiled")
        trainers.append(tr)

        def closure(c=c):
            return target, c(None)

        def steps(tr=tr, closure=closure, strict=how == "compiled"):
            mode = torch.cuda.get_sync_debug_mode()
            if strict:  # a host read in the compiled run raises
                torch.cuda.set_sync_debug_mode("error")
            try:
                tr.run(closure, BETAMU_STEPS)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        _, first = events_ms(lambda: tr.step(closure))
        rp0 = T._Graphs.replays
        _, ms = events_ms(steps)
        res[how] = dict(first_ms=first, ms_per_step=ms / BETAMU_STEPS,
                        replays_per_step=(T._Graphs.replays - rp0) / BETAMU_STEPS)
    check(res["compiled"]["replays_per_step"] == 1.0
          and res["eager"]["replays_per_step"] == 0.0
          and len(trainers[0]._step_cache) == 1 and not trainers[1]._step_cache,
          f"BetaMu: graph replays per step {res}")
    gap = max(rel(a.detach(), b.detach()) for a, b in
              zip(chains["compiled"].parameters(), chains["eager"].parameters()))
    check(gap <= COMPILED_RTOL, f"BetaMu: compiled against eager {gap}")
    after = float(ns.beta_div(chains["compiled"](None).detach(), target, 1))
    check(after < before, f"BetaMu: divergence {before} -> {after}")
    for p in chains["compiled"].parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              "BetaMu: a .grad is not set")
        check_factors("BetaMu", p.detach())
    reserved.append(reserved_now())

    # a closure that reads the host is refused, and the warm-up undone
    c = chains["compiled"]
    snap = [p.detach().clone() for p in c.parameters()]

    def host_reading():
        WH = c(None)
        check(float(WH.detach().sum()) > 0, "BetaMu: an empty reconstruction")
        return target, WH

    try:
        ns.BetaMu(c.parameters(), 1).step(host_reading)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    check("jit_compile=False" in refused,
          f"BetaMu: a closure that reads the host was not refused ({refused!r})")
    check(all(torch.equal(a, p.detach()) for a, p in zip(snap, c.parameters())),
          "BetaMu: the refused closure's warm-up changed the parameters")
    tag = "2048x2048_r128_256_512"
    fit_ms[f"betamu_chain_{tag}_beta1"] = dict(res, rel_gap=gap)
    print(f"phase 3: BetaMu chain {tag} beta=1: divergence {before:.7g} -> "
          f"{after:.7g} in {1 + BETAMU_STEPS} steps; ms/step compiled "
          f"{res['compiled']['ms_per_step']:.4f} (first step "
          f"{res['compiled']['first_ms']:.1f} ms), eager "
          f"{res['eager']['ms_per_step']:.4f}; graph replays/step "
          f"{res['compiled']['replays_per_step']:.0f}, host reads/step 0; "
          f"compiled against eager {gap:.3g}; a host-reading closure refused "
          f"[{card}]", flush=True)
    # the compiled entries' graphs, whose pools go with them
    pools = [weakref.ref(e["graphs"]) for e in trainers[0]._step_cache.values()]
    del chains, c, snap, trainers, target

    # SparsityProj from a start it can improve: 50 MU iterations (β=2, the
    # Gram updates), W projected to sparseness 0.5 at its norms, and the
    # step 1/L (L the W gradient's Lipschitz constant, ‖HᵀH‖₂), rounded to
    # float32.  From the raw inits, or at the default step 1, every attempt
    # fails and the reference's undo onto the projected value raises the
    # loss, in both packages.
    M, K, R = MAIN_SHAPE
    V = torch.from_numpy(rs.rand(M, K).astype("f")).cuda()
    m = ns.nmf_from_numpy({"W": rs.rand(K, R).astype("f") + 0.1,
                           "H": rs.rand(M, R).astype("f") + 0.1}, "cuda")
    m.fit(V, beta=2, tol=0, max_iter=50)
    with torch.no_grad():
        start = {"W": P.proj_columns(m.W, P.hoyer_l1_target(K, 0.5)).cpu().numpy(),
                 "H": m.H.detach().cpu().numpy()}
        H = m.H.detach()
        lr = float(np.float32(1.0 / float(torch.linalg.matrix_norm(H.T @ H, 2))))
    sp_fits = {}
    for label, lr0, hows in SPARSITY_CASES:
        lr0 = float(np.float32(lr0 * lr))
        models = {how: ns.nmf_from_numpy(start, "cuda") for how in hows}
        res, losses, lrs = {}, {}, {}
        for how, m in models.items():
            sp = ns.SparsityProj([{"params": [m.W], "lr": lr0}], 0.5,
                                 jit_compile=how != "eager",
                                 _graph=how == "compiled")
            calls = [0]

            def closure(m=m, calls=calls):
                calls[0] += 1
                return ns.beta_div(m(), V, 2)

            losses[how] = [float(closure().detach())]
            c0 = calls[0]
            _, first = events_ms(lambda: sp.step(closure))
            first_calls = calls[0] - c0
            c0, r0, rp0 = calls[0], T._read_lrs.reads, T._Graphs.replays
            s0 = T._line_search.reads
            _, ms = events_ms(lambda: sp.run(closure, SPARSITY_STEPS))
            # an eager step calls the closure for its gradient and once an
            # attempt; a replayed one not at all
            eager = how != "compiled"
            res[how] = dict(
                first_ms=first, ms_per_step=ms / SPARSITY_STEPS,
                attempts_per_step=((calls[0] - c0 - SPARSITY_STEPS)
                                   / SPARSITY_STEPS if eager else None),
                first_step_attempts=first_calls - 1 if eager else None,
                run_host_reads=T._read_lrs.reads - r0,
                loop_host_reads=T._line_search.reads - s0,
                replays_per_step=(T._Graphs.replays - rp0) / SPARSITY_STEPS)
            check(eager or calls[0] == c0, f"SparsityProj {label}: a replayed "
                  f"step called the closure on the host")
            losses[how].append(float(closure().detach()))
            lrs[how] = sp.param_groups[0]["lr"]
            pools += [weakref.ref(e["graphs"]) for e in sp._step_cache.values()
                      if isinstance(e["graphs"], T._Graphs)]
        c, r = res["compiled"], res["reference"]
        check(c["replays_per_step"] == 1 and c["run_host_reads"] == 1
              and c["loop_host_reads"] == 0 and r["replays_per_step"] == 0
              and r["run_host_reads"] == 1
              and r["loop_host_reads"] == r["attempts_per_step"] * SPARSITY_STEPS,
              f"SparsityProj {label}: replays and host reads {res}")
        Wc, Wr = models["compiled"].W.detach(), models["reference"].W.detach()
        check(torch.equal(Wc, Wr) and lrs["compiled"] == lrs["reference"]
              and losses["compiled"] == losses["reference"],
              f"SparsityProj {label}: graphed and _graph=False differ (step "
              f"{lrs}, loss {losses})")
        check_factors(f"SparsityProj {label}", Wc)
        rec = dict(res, step_size=lrs, losses=losses)
        if "eager" in models:
            We = models["eager"].W.detach()
            gap = rel(Wc, We)
            lgap = abs(losses["compiled"][1] - losses["eager"][1]) / losses["eager"][1]
            check(gap <= COMPILED_RTOL and lgap <= COMPILED_RTOL
                  and abs(lrs["compiled"] - lrs["eager"]) <= 1e-6 * lrs["eager"],
                  f"SparsityProj {label}: compiled against eager W {gap}, loss "
                  f"{lgap}, step {lrs}")
            before, after = losses["compiled"]
            s = col_sparseness(models["compiled"].W)
            check(after < before, f"SparsityProj: loss {before} -> {after}")
            check(float((s - 0.5).abs().max()) <= 1e-3,
                  f"SparsityProj: column sparseness {s.tolist()}")
            rec.update(rel_gap=gap, loss_gap=lgap)
            del We
            detail = (f"column sparseness {float(s.min()):.6f}.."
                      f"{float(s.max()):.6f}; ms/step eager (jit_compile=False) "
                      f"{res['eager']['ms_per_step']:.4f}; compiled against "
                      f"eager W {gap:.3g}, loss {lgap:.3g}")
        else:
            average = ((r["first_step_attempts"] + r["attempts_per_step"]
                        * SPARSITY_STEPS) / (1 + SPARSITY_STEPS))
            check(average > 1, f"SparsityProj {label}: {average} attempts a "
                  f"step, no backtracking")
            rec["attempts_per_step_all"] = average
            detail = (f"attempts a step over all {1 + SPARSITY_STEPS} steps "
                      f"{average:.2f} (first step {r['first_step_attempts']})")
        sp_fits[label] = rec
        print(f"phase 3: SparsityProj {M}x{K} R={R} sparsity 0.5 on W, start "
              f"step {label}: loss {losses['compiled'][0]:.7g} -> "
              f"{losses['compiled'][1]:.7g} in {1 + SPARSITY_STEPS} steps, step "
              f"size {lr0:.4g} -> {lrs['compiled']:.4g}; ms/step compiled "
              f"{c['ms_per_step']:.4f} (first step {c['first_ms']:.1f} ms), "
              f"_graph=False {r['ms_per_step']:.4f}; attempts/step in the run "
              f"{r['attempts_per_step']:.2f}; compiled: graph replays/step "
              f"{c['replays_per_step']:.2f}, host reads in the {SPARSITY_STEPS}-"
              f"step run {c['run_host_reads']} (eager loop reads "
              f"{c['loop_host_reads']}; _graph=False {r['loop_host_reads']} and "
              f"{r['run_host_reads']}); equal to _graph=False bit for bit; "
              f"{detail} [{card}]", flush=True)
        del models, sp, m, Wc, Wr
    reserved.append(reserved_now())
    del V
    gc.collect()
    torch.cuda.empty_cache()
    reserved.append(reserved_now())
    check(len(pools) == 1 + len(SPARSITY_CASES) and not any(w() for w in pools),
          "the compiled optimizers' graphs outlived them")
    p1["optimizers"] = P.proj_rows.launches - p1_start
    check(p1["optimizers"] > 0, "SparsityProj launched no projection kernel")
    check(not any(read(ctr).values()), f"the optimizers launched {read(ctr)}")
    fit_ms[f"sparsityproj_{M}x{K}_r{R}_s0.5"] = sp_fits
    fit_ms["optimizers_memory_reserved_gb"] = [r / 1e9 for r in reserved]
    print(f"phase 3: the optimizers' P1 launches {p1['optimizers']}; memory "
          f"reserved (GB) before, after BetaMu, after SparsityProj, released: "
          f"{', '.join(f'{r / 1e9:.3f}' for r in reserved)} [{card}]", flush=True)


def float64_targets(ns, card):
    """Phase 3: a float64 numpy V (numpy's default) on float32 models warns
    and fits in float32 on the card: ``NMF.fit``, ``PLCA.fit``,
    ``nmf_fit``."""
    import warnings

    M, K, R = MAIN_SHAPE
    V = np.abs(np.random.RandomState(SEED).randn(M, K)) + 0.01
    check(V.dtype == np.float64, "the target is not float64")

    def gen():
        return torch.Generator("cuda").manual_seed(SEED)

    def nmf():
        m = ns.NMF((M, K), R, device="cuda", generator=gen())
        m.fit(V, beta=1, tol=0, max_iter=10)
        return m.W, m.H

    def plca():
        m = ns.PLCA((M, K), R, device="cuda", generator=gen())
        m.fit(V, tol=0, max_iter=10)
        return m.W, m.H, m.Z

    def functional():
        m = ns.NMF((M, K), R, device="cuda", generator=gen())
        return ns.functional.nmf_fit(V, m.W.detach(), m.H.detach(), beta=1,
                                     tol=0, max_iter=10)[:2]

    for name, run in (("NMF.fit", nmf), ("PLCA.fit", plca),
                      ("nmf_fit", functional)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            factors = run()
        check(any(issubclass(w.category, UserWarning) and "float64" in
                  str(w.message) for w in caught), f"{name}: no float64 warning")
        for p in factors:
            check(p.dtype == torch.float32, f"{name}: a factor is {p.dtype}")
        check_factors(name, *(p.detach() for p in factors))
        print(f"phase 3: {name} with a float64 numpy V: warned, fitted in "
              f"float32 on the card [{card}]", flush=True)


def streaming_fits(ns, ctr, card, fit_ms):
    """Phase 3, ``streaming_nmf_fit`` with V in host memory.  MAIN_SHAPE in
    blocks of STREAM_ROW_BLOCK rows at β ∈ STREAM_BETAS, STREAM_ITERS
    iterations: exactly 2 B1 launches a block an iteration, one B2 a block a
    loss evaluation at β ∉ {1, 2}, and the final loss within 1e-4 of the
    in-memory ``NMF.fit``'s from the same init.  Then the 1 GiB STREAM_BIG
    target: ms/iteration, the host-to-card rate, the share of the copies'
    time that overlaps a kernel (``torch.profiler``), and the loss within
    1e-4 of the in-memory fit's.  Returns the path's launch counts (the
    in-memory fits are not counted)."""
    from pytorch_nmf_tpu_torch.functional import streaming_nmf_fit

    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    V = np.abs(rs.randn(M, K)).astype("f") + 0.01
    W0 = torch.from_numpy(np.abs(rs.randn(K, R)).astype("f")).cuda()
    H0 = torch.from_numpy(np.abs(rs.randn(M, R)).astype("f")).cuda()
    Vd = torch.from_numpy(V).cuda()
    n_blocks = -(-M // STREAM_ROW_BLOCK)
    inf = float("-inf")
    path = {k: 0 for k in ctr}
    for beta in STREAM_BETAS:
        streaming_nmf_fit(V, W0, H0, beta=beta, max_iter=1,
                          row_block=STREAM_ROW_BLOCK)  # warm-up
        zero(ctr)
        (W, H, n), ms = events_ms(lambda: streaming_nmf_fit(
            V, W0, H0, beta=beta, tol=inf, max_iter=STREAM_ITERS,
            row_block=STREAM_ROW_BLOCK))
        d = read(ctr)
        path = {k: path[k] + d[k] for k in ctr}
        tag = f"streaming {M}x{K} R={R} beta={beta} row_block={STREAM_ROW_BLOCK}"
        check_factors(tag, W, H)
        evals = 1 + STREAM_ITERS // 10
        want = {"fused_contractions": 2 * n_blocks * STREAM_ITERS,
                "fused_beta_loss": 0 if beta in (1, 2) else n_blocks * evals,
                "hgrad": 0, "wgrad": 0}
        check(d == want and n == STREAM_ITERS, f"{tag}: launches {d}, want "
              f"{want}; n_iter {n}")
        m = ns.NMF(W=W0, H=H0, device="cuda")
        m.fit(Vd, beta=beta, tol=inf, max_iter=STREAM_ITERS)
        ls = float(ns.beta_div(ns.NMF.reconstruct(H, W), Vd, beta))
        lm = float(ns.beta_div(m().detach(), Vd, beta))
        rel = abs(ls - lm) / lm
        check(rel <= RTOL, f"{tag}: loss {ls} vs in-memory {lm} (rel {rel:.3g})")
        fit_ms[f"streaming_{M}x{K}_r{R}_beta{beta}_block{STREAM_ROW_BLOCK}"] = (
            ms / STREAM_ITERS)
        print(f"phase 3: {tag}: launches B1 {d['fused_contractions']}, B2 "
              f"{d['fused_beta_loss']} ({n_blocks} blocks); final loss {ls:.7g},"
              f" in-memory {lm:.7g} (rel {rel:.3g}); {ms / STREAM_ITERS:.3f} "
              f"ms/iteration [{card}]", flush=True)
    del Vd, m

    Mb, Kb, Rb, block = STREAM_BIG
    Vb = np.empty((Mb, Kb), np.float32)
    np.random.default_rng(SEED).random(out=Vb, dtype=np.float32)
    Vb += 0.01
    g = np.random.RandomState(SEED + 1)
    Wb0 = torch.from_numpy(g.rand(Kb, Rb).astype("f") + 0.1).cuda()
    Hb0 = torch.from_numpy(g.rand(Mb, Rb).astype("f") + 0.1).cuda()
    tag = f"streaming {Mb}x{Kb} R={Rb} beta=1 row_block={block}"

    def fit(iters):
        return streaming_nmf_fit(Vb, Wb0, Hb0, beta=1, tol=inf, max_iter=iters,
                                 row_block=block)

    fit(1)  # warm-up: pinned buffers, first launches
    zero(ctr)
    (W, H, _), ms = events_ms(lambda: fit(STREAM_BIG_ITERS))
    d = read(ctr)
    path = {k: path[k] + d[k] for k in ctr}
    check_factors(tag, W, H)
    passes = 2 * STREAM_BIG_ITERS + 1  # two a iteration, one initial loss
    gbs = passes * Vb.nbytes / (ms / 1e3) / 1e9
    overlap = copy_overlap(lambda: fit(2))
    Vd = torch.from_numpy(Vb).cuda()
    m = ns.NMF(W=Wb0, H=Hb0, device="cuda")
    m.fit(Vd, beta=1, tol=inf, max_iter=STREAM_BIG_ITERS)
    ls = float(ns.beta_div(ns.NMF.reconstruct(H, W), Vd, 1))
    lm = float(ns.beta_div(m().detach(), Vd, 1))
    rel = abs(ls - lm) / lm
    check(rel <= RTOL, f"{tag}: loss {ls} vs in-memory {lm} (rel {rel:.3g})")
    fit_ms[f"streaming_{Mb}x{Kb}_r{Rb}_beta1_block{block}"] = {
        "ms_per_iter": ms / STREAM_BIG_ITERS, "host_to_card_GBps": gbs,
        "copy_overlap": overlap}
    print(f"phase 3: {tag} (V {Vb.nbytes / 2**30:.2f} GiB on the host): "
          f"{ms / STREAM_BIG_ITERS:.2f} ms/iteration, host-to-card "
          f"{gbs:.2f} GB/s over {passes} passes of V, copy time overlapping "
          f"a kernel {100 * overlap:.1f}%; launches B1 "
          f"{d['fused_contractions']}; final loss {ls:.7g}, in-memory "
          f"{lm:.7g} (rel {rel:.3g}) [{card}]", flush=True)
    return path


def copy_overlap(run):
    """The share of ``run()``'s host-to-card copy time during which a
    kernel runs on the card, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    path = os.path.join(scratch_dir(), "streaming_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)

    def spans(pred):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X" and pred(e))

    copies = spans(lambda e: e.get("cat") == "gpu_memcpy"
                   and "HtoD" in e.get("name", ""))
    busy = []
    for a, b in spans(lambda e: e.get("cat") == "kernel"):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    total = sum(b - a for a, b in copies)
    check(total > 0, "the streaming trace holds no host-to-card copy")
    shared = sum(max(0.0, min(b, y) - max(a, x))
                 for a, b in copies for x, y in busy)
    return shared / total


# --------------------------------------------------------------------------
# bfloat16 target storage: B1/B2 reading a half-width V, and the fits that
# keep V at half width on the card
# --------------------------------------------------------------------------
def bf16_kernels(fm, kl_pos_W, kl_pos_H, card):
    """B1 (both sides; β=1 with and without the epilogue, β=0.5 with its
    denominator) and B2 (β=0.5) reading a bfloat16 V at MAIN_SHAPE, each
    against its plain version (V upcast, exactly) within RTOL per element;
    then the β=0.5 iteration's B1 pair and B2 timed on the bfloat16 V beside
    the float32 kernels on its float32 upcast, in turns (f32, bf16, bf16,
    f32).  Returns the two bfloat16 entries' stats (:func:`new_stats`)."""
    M, K, R = MAIN_SHAPE
    V, W, H = inputs(M, K, R)
    # rows padded to 16 bytes, as target_like copies a target to the card
    Vb = fm.aligned_copy(V, V.device, torch.bfloat16)
    Vf = fm.aligned_copy(Vb, V.device, torch.float32)
    check(Vb.dtype == torch.bfloat16 and Vb.stride(0) == K + -K % 8,
          f"bf16 V: dtype {Vb.dtype}, row stride {Vb.stride(0)}")
    stats = {name: new_stats() for name in BF16_KERNELS}

    def record(name, got, ref):
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.is_cuda
              and got.dtype == torch.float32, f"{name}: bad output")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=0)
        err = (got - ref).abs()
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], float(err.max()))
        rel = float((err / ref.abs().clamp_min(1e-30)).max())
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        return rel

    for w_side in (True, False):
        mu_pos = kl_pos_W(H) if w_side else kl_pos_H(W)
        for beta, need_pos, mp in ((1.0, False, None), (1.0, False, mu_pos),
                                   (0.5, True, None)):
            kw = dict(beta=beta, need_pos=need_pos, w_side=w_side, mu_pos=mp)
            n = fm.fused_contractions.launches_bf16
            got = fm.fused_contractions(Vb, H, W, **kw)
            check(fm.fused_contractions.launches_bf16 == n + 1,
                  "a bf16 V did not launch B1's bf16 instance")
            ref = fm.plain_contractions(Vb, H, W, **kw)
            rels = [record("fused_contractions_bf16", g, r)
                    for g, r in zip(got, ref) if r is not None]
            case = "epilogue" if mp is not None else (
                "neg+pos" if need_pos else "neg")
            print(f"B1 bf16 V {M}x{K} R={R} {'W' if w_side else 'H'}-side "
                  f"beta={beta} {case}: max rel err {max(rels):.3g}",
                  flush=True)
    rel = record("fused_beta_loss_bf16", fm.fused_beta_loss(Vb, H, W, 0.5),
                 fm.plain_beta_loss(Vb, H, W, 0.5))
    print(f"B2 bf16 V {M}x{K} R={R} beta=0.5: rel err {rel:.3g}", flush=True)

    def b1(X, fn):
        def run():
            fn(X, H, W, beta=0.5, need_pos=True, w_side=True)
            fn(X, H, W, beta=0.5, need_pos=True, w_side=False)
        return run

    times = {"b1": {"f32": [], "bf16": []}, "b2": {"f32": [], "bf16": []}}
    for tag, X in (("f32", Vf), ("bf16", Vb), ("bf16", Vb), ("f32", Vf)):
        times["b1"][tag].append(cuda_ms(b1(X, fm.fused_contractions)))
        times["b2"][tag].append(
            cuda_ms(lambda: fm.fused_beta_loss(X, H, W, 0.5)))
    plain = {"b1": cuda_ms(b1(Vb, fm.plain_contractions)),
             "b2": cuda_ms(lambda: fm.plain_beta_loss(Vb, H, W, 0.5))}
    # as phase 2's float32 entries, with V read at 2 bytes a value
    work = {"b1": (2 * 6 * M * K * R,
                   2 * (2 * M * K + 4 * (M + K) * R) + 2 * 4 * 2 * (M + K) * R),
            "b2": (2 * M * K * R, 2 * M * K + 4 * ((M + K) * R + 1))}
    for key, name in (("b1", "fused_contractions_bf16"),
                      ("b2", "fused_beta_loss_bf16")):
        ms = min(times[key]["bf16"])
        b_ms, b_by, _ = bound(*work[key])
        stats[name].update(ms=ms, plain_ms=plain[key], bound_ms=b_ms,
                           bound_by=b_by)
        print(f"{name}: kernel {ms:.4f} ms on the bf16 V, float32 kernel "
              f"{min(times[key]['f32']):.4f} ms on its upcast (in turns: "
              f"f32 {times[key]['f32']}, bf16 {times[key]['bf16']}), plain "
              f"{plain[key]:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]",
              flush=True)
    return stats


def bf16_dense(ns, fm, card, fit_ms):
    """``NMF.fit`` at MAIN_SHAPE with a bfloat16 host V (which reaches the
    card at half width, rows padded to 8 values) at β ∈ BF16_BETAS, tol
    1e-4, DENSE_ITERS: the final loss (in float32 against the rounded V)
    within RTOL of the float32 fit on the rounded V, the same ``n_iter``,
    and exactly 2 B1 launches an iteration (β ≠ 2) and one B2 a loss
    evaluation (β ∉ {1, 2}), every one of them the bfloat16 instance's in
    the bfloat16 fit and none in the float32 one.  Then ``nmf_fit`` with
    the bfloat16 V equals ``NMF.fit`` (``torch.equal``) launch for launch.
    Returns the bfloat16 launches of these fits."""
    NMF = ns.NMF
    M, K, R = MAIN_SHAPE
    V, _, _ = inputs(M, K, R)
    Vb = V.bfloat16().cpu()
    Vr = Vb.float()
    Vr_card = Vr.cuda()
    del V
    wrappers = (fm.fused_contractions, fm.fused_beta_loss)
    path = {"fused_contractions_bf16": 0, "fused_beta_loss_bf16": 0}

    def counts():
        return [w.launches for w in wrappers] + [w.launches_bf16
                                                 for w in wrappers]

    def model():
        return NMF((M, K), R, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(SEED))

    for beta in BF16_BETAS:
        runs = {}
        for tag, X in (("f32", Vr), ("bf16", Vb)):
            m = model()
            c0 = counts()
            (n_iter, ms) = events_ms(lambda: m.fit(X, beta=beta, tol=1e-4,
                                                   max_iter=DENSE_ITERS))
            d = [b - a for a, b in zip(c0, counts())]
            check_factors(f"bf16 dense {tag} beta={beta}", m.W, m.H)
            check(m.W.dtype == m.H.dtype == torch.float32,
                  f"beta={beta}: {tag} factors {m.W.dtype}")
            loss = float(ns.beta_div(NMF.reconstruct(m.H.detach(),
                                                     m.W.detach()), Vr_card,
                                     beta))
            runs[tag] = (n_iter, d, loss, ms / n_iter)
            del m
        (n32, d32, l32, ms32), (n16, d16, l16, ms16) = runs["f32"], runs["bf16"]
        b1 = 0 if beta == 2 else 2 * n16
        b2 = 0 if beta in (1, 2) else 1 + n16 // 10
        rel = abs(l16 - l32) / l32
        tag = f"NMF.fit bf16 V {M}x{K} R={R} beta={beta}"
        check(n16 == n32, f"{tag}: n_iter {n16}, float32 fit {n32}")
        check(d16 == [b1, b2, b1, b2], f"{tag}: launches (B1, B2, B1 bf16, "
              f"B2 bf16) {d16}, want {[b1, b2, b1, b2]}")
        check(d32 == [b1, b2, 0, 0], f"{tag}: the float32 fit's launches {d32}")
        check(rel <= RTOL, f"{tag}: loss {l16} vs float32 {l32} (rel {rel:.3g})")
        path["fused_contractions_bf16"] += d16[2]
        path["fused_beta_loss_bf16"] += d16[3]
        fit_ms[f"nmf_bf16_{M}x{K}_r{R}_beta{beta}"] = {"bf16": ms16,
                                                       "f32": ms32}
        print(f"phase 3: {tag}: n_iter {n16} (float32 {n32}), final loss "
              f"{l16:.7g} vs {l32:.7g} (rel {rel:.3g}); launches B1 {d16[2]}, "
              f"B2 {d16[3]}, all bf16; {ms16:.3f} ms/iteration, float32 "
              f"{ms32:.3f} [{card}]", flush=True)

    m = model()
    W0, H0 = m.W.detach().clone(), m.H.detach().clone()
    c0 = counts()
    Wf, Hf, nf = ns.functional.nmf_fit(Vb, W0, H0, beta=0.5, tol=0,
                                       max_iter=FUNC_NMF_ITERS)
    d = [b - a for a, b in zip(c0, counts())]
    c0 = counts()
    n = m.fit(Vb, beta=0.5, tol=0, max_iter=FUNC_NMF_ITERS)
    dm = [b - a for a, b in zip(c0, counts())]
    check(nf == n == FUNC_NMF_ITERS and torch.equal(Wf, m.W.detach())
          and torch.equal(Hf, m.H.detach()) and d == dm and d[2] == d[0] > 0,
          f"nmf_fit bf16: n_iter {nf}/{n}, launches {d} vs {dm}")
    path["fused_contractions_bf16"] += d[2]
    path["fused_beta_loss_bf16"] += d[3]
    print(f"phase 3: nmf_fit with the bf16 V equals NMF.fit (torch.equal), "
          f"launches B1 {d[2]}, B2 {d[3]}, all bf16 [{card}]", flush=True)
    return path


def bf16_capacity(ns, fm, card, fit_ms):
    """The capacity the knob buys: the peak device memory of ``NMF.fit`` at
    β=1 on BF16_CAPACITY (4097 columns: rows padded to 4100 floats or 4104
    bfloat16 values), BF16_CAPACITY_ITERS iterations on a target on the
    card, in float32 (on the rounded values) and in bfloat16, each beside
    the cache entry of an earlier fit of another configuration (β=1 at
    ``tol=-inf``) on the same target.  The peak above what was allocated
    before the fit (the target and the cache's held bytes, reported beside
    it) must be at most BF16_PEAK_RATIO of the float32 fit's, and the two
    final losses agree within RTOL.  Then, in float32, a third
    configuration given only the memory it needs without the entries held
    (:func:`capacity_beside_the_cache`)."""
    NMF, solver = ns.NMF, ns.solver
    M, K, R = BF16_CAPACITY
    g = torch.Generator().manual_seed(SEED)
    Vb = (torch.rand((M, K), generator=g) + 0.01).bfloat16()
    out, held = {}, {}
    for tag, X in (("f32", Vb.float()), ("bf16", Vb)):
        X = X.cuda()
        solver.compiled_cache_clear()

        def model():
            return NMF((M, K), R, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(SEED))

        model().fit(X, beta=1, tol=float("-inf"),
                    max_iter=BF16_CAPACITY_ITERS)  # the earlier entry
        m = model()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = solver.compiled_cache_info()["held_bytes"]
        base, base_r = torch.cuda.memory_allocated(), \
            torch.cuda.memory_reserved()
        n, ms = events_ms(lambda: m.fit(X, beta=1, tol=0,
                                        max_iter=BF16_CAPACITY_ITERS))
        peak = torch.cuda.max_memory_allocated() - base
        need = torch.cuda.max_memory_reserved() - base_r
        held[tag] = (before, solver.compiled_cache_info()["held_bytes"])
        check(before > 0, f"capacity {tag}: no entry held before the fit")
        check_factors(f"capacity {tag}", m.W, m.H)
        out[tag] = (peak, X.numel() * X.element_size(), m.W.detach(),
                    m.H.detach(), ms / n)
        if tag == "f32":
            fit_ms["capacity_beside_the_cache"] = capacity_beside_the_cache(
                ns, X, need, card)
        del m, X
        solver.compiled_cache_clear()
    Vr = Vb.float().cuda()
    losses = {tag: float(fm.fused_beta_loss(Vr, o[3], o[2], 1.0))
              for tag, o in out.items()}
    del Vr
    rel = abs(losses["bf16"] - losses["f32"]) / losses["f32"]
    ratio = out["bf16"][0] / out["f32"][0]
    tag = f"capacity NMF.fit {M}x{K} R={R} beta=1"
    for t in ("f32", "bf16"):
        print(f"phase 3: {tag} {t}: V {out[t][1] / 1e9:.3f} GB on the card, "
              f"peak device memory above what was allocated before the fit "
              f"{out[t][0] / 1e9:.3f} GB, beside the fits' cache holding "
              f"{held[t][0] / 1e9:.3f} GB (an earlier fit's entry; "
              f"{held[t][1] / 1e9:.3f} GB after), {out[t][4]:.2f} "
              f"ms/iteration (a cold fit) [{card}]", flush=True)
    check(ratio <= BF16_PEAK_RATIO, f"{tag}: bf16 peak {out['bf16'][0]} is "
          f"{ratio:.3f} of the float32 fit's {out['f32'][0]}")
    check(rel <= RTOL, f"{tag}: final loss {losses['bf16']} vs float32 "
          f"{losses['f32']} (rel {rel:.3g})")
    fit_ms[f"capacity_{M}x{K}_r{R}_beta1"] = {
        t: {"peak_bytes": out[t][0], "V_bytes": out[t][1],
            "ms_per_iter": out[t][4], "cache_held_bytes": held[t]}
        for t in out}
    print(f"phase 3: {tag}: bf16 peak / float32 peak = {ratio:.3f} (at most "
          f"{BF16_PEAK_RATIO}), each above the cache's held bytes; final "
          f"loss {losses['bf16']:.7g} vs {losses['f32']:.7g} (rel "
          f"{rel:.3g}) [{card}]", flush=True)


def capacity_beside_the_cache(ns, X, need, card):
    """A third configuration (β=1 at ``tol=-1``) on the capacity target
    ``X``, whose two earlier fits' entries the cache holds, with the
    process's memory capped at what the card has reserved now plus
    ``need`` (the reserved memory a cold fit of the target added) less
    half the entries' held bytes: it fits only without them.  It runs out
    of memory, the cache is emptied, and it runs once more (two cold
    misses), equal bit for bit to its ``_graph=False`` fit."""
    NMF, solver = ns.NMF, ns.solver
    M, K = X.shape
    R = BF16_CAPACITY[2]
    m = NMF((M, K), R, device="cuda",
            generator=torch.Generator("cuda").manual_seed(SEED + 1))
    W0, H0 = m.W.detach().clone(), m.H.detach().clone()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    info = solver.compiled_cache_info()
    held, entries = info["held_bytes"], info["entries"]
    total = torch.cuda.get_device_properties(0).total_memory
    limit = torch.cuda.memory_reserved() + need - held // 2
    q0 = cache_counts(solver)
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        n, ms = events_ms(lambda: m.fit(X, beta=1, tol=-1.0,
                                        max_iter=BF16_CAPACITY_ITERS))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    q = {k: v - q0[k] for k, v in cache_counts(solver).items()}
    after = solver.compiled_cache_info()["entries"]
    fit = solver.get_dense_fit(
        NMF.reconstruct, 1.0, -1.0, BF16_CAPACITY_ITERS, True, True, 0.0, 0.0,
        False, NMF._resolve_updater_factory(X, W0, H0, 1.0), _graph=False)
    W, H, ne = fit(X, W0, H0)
    tag = f"capacity NMF.fit {M}x{K} R={R} beta=1 f32, a third configuration"
    check(entries == 2 and q == {"hits": 0, "warm_misses": 0,
                                 "cold_misses": 2} and after == 1,
          f"{tag}: {entries} entries before, cache {q}, {after} after")
    check(n == ne and torch.equal(m.W, W) and torch.equal(m.H, H),
          f"{tag}: not bit for bit its eager fit (n_iter {n}, {ne})")
    print(f"phase 3: {tag}: the card capped at {limit / 1e9:.3f} GB "
          f"reserved, {need / 1e9:.3f} GB for a cold fit beside the cache's "
          f"{held / 1e9:.3f} GB ({entries} entries): out of memory, the "
          f"cache emptied, run once more (cache {q}), bit for bit its eager "
          f"fit, {ms / n:.2f} ms/iteration with the retry [{card}]",
          flush=True)
    return {"limit_bytes": limit, "need_bytes": need, "held_bytes": held,
            "cache": q, "ms_per_iter": ms / n}


def bf16_streaming(ns, fm, card, fit_ms):
    """``streaming_nmf_fit`` with a bfloat16 host V: MAIN_SHAPE at β=1 in
    blocks of STREAM_ROW_BLOCK rows, exactly 2 B1 launches (the bfloat16
    instance's) a block an iteration, and the final loss within RTOL of the
    in-memory bfloat16 fit's; then STREAM_BIG held in bfloat16 (half the
    1 GiB of float32): ms/iteration and the host-to-card rate, beside the
    float32 run's.  Returns the path's bfloat16 launches."""
    from pytorch_nmf_tpu_torch.functional import streaming_nmf_fit

    inf = float("-inf")
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    Vb = torch.from_numpy(np.abs(rs.randn(M, K)).astype("f") + 0.01).bfloat16()
    W0 = torch.from_numpy(np.abs(rs.randn(K, R)).astype("f")).cuda()
    H0 = torch.from_numpy(np.abs(rs.randn(M, R)).astype("f")).cuda()
    n_blocks = -(-M // STREAM_ROW_BLOCK)
    b1 = fm.fused_contractions
    n0 = b1.launches_bf16
    W, H, n = streaming_nmf_fit(Vb, W0, H0, beta=1, tol=inf,
                                max_iter=STREAM_ITERS,
                                row_block=STREAM_ROW_BLOCK)
    d = b1.launches_bf16 - n0
    tag = f"streaming bf16 V {M}x{K} R={R} beta=1 row_block={STREAM_ROW_BLOCK}"
    check_factors(tag, W, H)
    check(n == STREAM_ITERS and d == 2 * n_blocks * STREAM_ITERS,
          f"{tag}: n_iter {n}, bf16 B1 launches {d}")
    m = ns.NMF(W=W0, H=H0, device="cuda")
    m.fit(Vb, beta=1, tol=inf, max_iter=STREAM_ITERS)
    Vr = Vb.float().cuda()
    ls = float(fm.fused_beta_loss(Vr, H, W, 1.0))
    lm = float(fm.fused_beta_loss(Vr, m.H.detach(), m.W.detach(), 1.0))
    rel = abs(ls - lm) / lm
    check(rel <= RTOL, f"{tag}: loss {ls} vs in-memory {lm} (rel {rel:.3g})")
    print(f"phase 3: {tag}: bf16 B1 launches {d} ({n_blocks} blocks); final "
          f"loss {ls:.7g}, in-memory bf16 fit {lm:.7g} (rel {rel:.3g}) "
          f"[{card}]", flush=True)
    path = d
    del m, Vr

    Mb, Kb, Rb, block = STREAM_BIG
    Vh = np.empty((Mb, Kb), np.float32)
    np.random.default_rng(SEED).random(out=Vh, dtype=np.float32)
    Vh += 0.01
    Vbig = torch.from_numpy(Vh).bfloat16()
    del Vh
    g = np.random.RandomState(SEED + 1)
    Wb0 = torch.from_numpy(g.rand(Kb, Rb).astype("f") + 0.1).cuda()
    Hb0 = torch.from_numpy(g.rand(Mb, Rb).astype("f") + 0.1).cuda()

    def fit(iters):
        return streaming_nmf_fit(Vbig, Wb0, Hb0, beta=1, tol=inf,
                                 max_iter=iters, row_block=block)

    fit(1)  # warm-up
    n0 = b1.launches_bf16
    (W, H, _), ms = events_ms(lambda: fit(STREAM_BIG_ITERS))
    d = b1.launches_bf16 - n0
    path += d
    n_blocks = -(-Mb // block)
    tag = f"streaming bf16 V {Mb}x{Kb} R={Rb} beta=1 row_block={block}"
    check_factors(tag, W, H)
    check(d == 2 * n_blocks * STREAM_BIG_ITERS, f"{tag}: bf16 B1 launches {d}")
    nbytes = Vbig.numel() * Vbig.element_size()
    passes = 2 * STREAM_BIG_ITERS + 1
    gbs = passes * nbytes / (ms / 1e3) / 1e9
    f32 = fit_ms.get(f"streaming_{Mb}x{Kb}_r{Rb}_beta1_block{block}", {})
    fit_ms[f"streaming_bf16_{Mb}x{Kb}_r{Rb}_beta1_block{block}"] = {
        "ms_per_iter": ms / STREAM_BIG_ITERS, "host_to_card_GBps": gbs}
    print(f"phase 3: {tag} (V {nbytes / 2**30:.2f} GiB on the host): "
          f"{ms / STREAM_BIG_ITERS:.2f} ms/iteration, host-to-card "
          f"{gbs:.2f} GB/s over {passes} passes of V; the float32 run "
          f"{f32.get('ms_per_iter', float('nan')):.2f} ms/iteration, "
          f"{f32.get('host_to_card_GBps', float('nan')):.2f} GB/s; bf16 B1 "
          f"launches {d} [{card}]", flush=True)
    return {"fused_contractions_bf16": path, "fused_beta_loss_bf16": 0}


def bf16_other_paths(ns, ctr, card):
    """The NMFD flagship at β=1 (B3/B4, whose cotangents are float32) with
    a bfloat16 V against the float32 fit on the rounded V: final losses
    within RTOL, the same B3/B4 launches and none of B1/B2; and dense PLCA
    at MAIN_SHAPE (the generic E-step, which the bfloat16 V takes as the
    JAX package's does) against the float32 fit on its normalized target
    ``Vb / ΣVb``, rounded to bfloat16 as the fit rounds it: factors within
    RTOL of their largest entry."""
    V = deconv_target("NMFD")
    Vb = V.bfloat16()
    Vr = Vb.float()
    del V
    runs = {}
    for tag, X in (("f32", Vr), ("bf16", Vb)):
        m = deconv_model("NMFD", ns.models)
        zero(ctr)
        n = m.fit(X, beta=1, tol=0, max_iter=DECONV_ITERS)
        d = read(ctr)
        check_factors(f"NMFD bf16 {tag}", m.W, m.H)
        runs[tag] = (n, d, float(ns.beta_div(m().detach(), Vr, 1)))
        del m
    (n32, d32, l32), (n16, d16, l16) = runs["f32"], runs["bf16"]
    rel = abs(l16 - l32) / l32
    tag = "NMFD flagship bf16 V beta=1"
    check(n16 == n32 == DECONV_ITERS and d16 == d32 and d16["hgrad"] > 0
          and d16["wgrad"] > 0 and d16["fused_contractions"] == 0,
          f"{tag}: n_iter {n16}/{n32}, launches {d16} vs float32 {d32}")
    check(rel <= RTOL, f"{tag}: loss {l16} vs float32 {l32} (rel {rel:.3g})")
    print(f"phase 3: {tag}: final loss {l16:.7g} vs float32 on the rounded V "
          f"{l32:.7g} (rel {rel:.3g}); launches B3 {d16['hgrad']}, B4 "
          f"{d16['wgrad']}, as the float32 fit's [{card}]", flush=True)
    del Vb, Vr

    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    pr = {"V": rs.rand(M, K).astype("f"), "W": rs.rand(K, R).astype("f"),
          "H": rs.rand(M, R).astype("f"), "Z": np.full(R, 1.0 / R, "f")}
    Vb = torch.from_numpy(pr["V"]).bfloat16().cuda()
    Vn = (Vb / Vb.sum()).float()  # the bf16 fit's own normalized target
    fits = {}
    for tag, X in (("f32", Vn), ("bf16", Vb)):
        m = ns.plca_from_numpy(pr, "cuda")
        n, norm = m.fit(X, tol=0, max_iter=PLCA_ITERS)
        check_factors(f"PLCA bf16 {tag}", m.W, m.H, m.Z)
        fits[tag] = (n, [p.detach() for p in (m.W, m.H, m.Z)])
        del m
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(fits["bf16"][1], fits["f32"][1]))
    tag = f"PLCA {M}x{K} R={R} bf16 V"
    check(fits["bf16"][0] == fits["f32"][0] and rel <= RTOL,
          f"{tag}: n_iter {fits['bf16'][0]}/{fits['f32'][0]}, factors "
          f"{rel:.3g} from the float32 fit on the normalized target")
    print(f"phase 3: {tag}: factors within {rel:.3g} of the float32 fit on "
          f"its normalized target, {PLCA_ITERS} iterations [{card}]",
          flush=True)


def bf16_phase(ns, fm, ctr, kl_pos_W, kl_pos_H, card, fit_ms):
    """The bfloat16 target storage phase; returns its kernels' stats and
    their launches (``launches_bf16``) over the phase's bfloat16 fits."""
    stats = bf16_kernels(fm, kl_pos_W, kl_pos_H, card)
    path = bf16_dense(ns, fm, card, fit_ms)
    bf16_capacity(ns, fm, card, fit_ms)
    for k, v in bf16_streaming(ns, fm, card, fit_ms).items():
        path[k] += v
    bf16_other_paths(ns, ctr, card)
    for name in BF16_KERNELS:
        check(path[name] > 0, f"{name}: no launch on the bf16 path")
    return stats, path


def scratch_dir():
    """``build/chip_smoke`` beside this script (git-ignored)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    os.makedirs(path, exist_ok=True)
    return path


def checkpoint_fits(ns, ctr, card, fit_ms):
    """Phase 3, ``checkpointed_fit``: NMF at MAIN_SHAPE, β=0.5, in two
    sessions of CKPT_EVERY iterations (the second a fresh model that
    resumes from the directory), equal to one uninterrupted fit; the NMFD
    flagship at β=1, CKPT_NMFD_ITERS iterations in segments of
    CKPT_NMFD_EVERY, on B3/B4 (one of each an iteration), equal to the
    uninterrupted fit.  Returns the path's launch counts (the uninterrupted
    fits are not counted)."""
    import shutil

    from pytorch_nmf_tpu_torch.utils.checkpoint import checkpointed_fit

    inf = float("-inf")
    root = os.path.join(scratch_dir(), "checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    M, K, R = MAIN_SHAPE
    V, W0, H0 = inputs(M, K, R)
    path = {k: 0 for k in ctr}

    def counted(fn):
        zero(ctr)
        out = fn()
        d = read(ctr)
        for k in ctr:
            path[k] += d[k]
        return out, d

    def same(a, b):
        return max(float((x.detach() - y.detach()).abs().max()
                         / y.detach().abs().max())
                   for x, y in zip(a, b))

    d_nmf = os.path.join(root, "nmf")
    from pytorch_nmf_tpu_torch.ops import graphs

    Graphs, solver = graphs._Graphs, ns.solver
    solver.compiled_cache_clear()
    k0, r0, q0 = Graphs.captures, Graphs.replays, cache_counts(solver)
    a = ns.NMF(W=W0, H=H0, device="cuda")
    (n1, _), d1 = counted(lambda: (checkpointed_fit(
        a, V, beta=0.5, tol=inf, max_iter=CKPT_EVERY, every=CKPT_EVERY,
        directory=d_nmf), None))
    b = ns.NMF((M, K), R, device="cuda")  # a new session: factors from disk
    (n2, _), d2 = counted(lambda: (checkpointed_fit(
        b, V, beta=0.5, tol=inf, max_iter=CKPT_ITERS, every=CKPT_EVERY,
        directory=d_nmf), None))
    captures, replays = Graphs.captures - k0, Graphs.replays - r0
    q = {k: v - q0[k] for k, v in cache_counts(solver).items()}
    ref = ns.NMF(W=W0, H=H0, device="cuda")
    ref.fit(V, beta=0.5, tol=inf, max_iter=CKPT_ITERS)
    rel = same((b.W, b.H), (ref.W, ref.H))
    tag = f"checkpointed NMF {M}x{K} R={R} beta=0.5"
    check_factors(tag, b.W, b.H)
    check(n1 == CKPT_EVERY and n2 == CKPT_ITERS and rel <= 1e-6,
          f"{tag}: n_iter {n1}, {n2}; factors {rel:.3g} from the "
          "uninterrupted fit")
    check(d1["fused_contractions"] == 2 * CKPT_EVERY and
          d2["fused_contractions"] == 2 * (CKPT_ITERS - CKPT_EVERY),
          f"{tag}: launches {d1}, {d2}")
    segments = CKPT_ITERS // CKPT_EVERY
    # one replay a segment (the first one's chunks 3-5, every chunk after)
    check(captures == 1 and replays == segments,
          f"{tag}: {captures} captures, {replays} replays in {segments} "
          "segments")
    print(f"phase 3: {tag}: sessions of {n1} and {n2 - n1} iterations in "
          f"segments of {CKPT_EVERY} equal the uninterrupted {CKPT_ITERS} "
          f"(max rel {rel:.3g}); one capture for the {segments} segments "
          f"({replays} replays; cache {q}); launches B1 "
          f"{d1['fused_contractions']} + {d2['fused_contractions']}, B2 "
          f"{d1['fused_beta_loss']} + {d2['fused_beta_loss']} [{card}]",
          flush=True)
    del a, b, ref, V

    Vd = deconv_target("NMFD")
    m0 = deconv_model("NMFD", ns.models)
    Wd, Hd = m0.W.detach().clone(), m0.H.detach().clone()
    del m0
    c = ns.models.NMFD(W=Wd, H=Hd, device="cuda")
    (n, _), d = counted(lambda: (checkpointed_fit(
        c, Vd, beta=1, tol=inf, max_iter=CKPT_NMFD_ITERS, every=CKPT_NMFD_EVERY,
        directory=os.path.join(root, "nmfd")), None))
    ref = ns.models.NMFD(W=Wd, H=Hd, device="cuda")
    ref.fit(Vd, beta=1, tol=inf, max_iter=CKPT_NMFD_ITERS)
    rel = same((c.W, c.H), (ref.W, ref.H))
    tag = "checkpointed NMFD flagship beta=1"
    check_factors(tag, c.W, c.H)
    want = {"fused_contractions": 0, "fused_beta_loss": 0,
            "hgrad": CKPT_NMFD_ITERS, "wgrad": CKPT_NMFD_ITERS}
    check(n == CKPT_NMFD_ITERS and d == want and rel <= 1e-6,
          f"{tag}: n_iter {n}, launches {d} (want {want}), factors {rel:.3g} "
          "from the uninterrupted fit")
    print(f"phase 3: {tag}: {n} iterations in segments of {CKPT_NMFD_EVERY} "
          f"equal the uninterrupted fit (max rel {rel:.3g}); launches B3 "
          f"{d['hgrad']}, B4 {d['wgrad']} [{card}]", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return path


def tune_problem(models, name, row):
    """A deconv target (``|randn| + 0.01``, seed SEED) and the model's seeded
    inits at ``row``."""
    N, C, S_out, kernel, R = row
    rs = np.random.RandomState(SEED)
    V = torch.from_numpy(np.abs(rs.randn(N, C, *S_out)).astype("f")
                         + 0.01).cuda()
    kw = {"T": kernel[0]} if name == "NMFD" else {"kernel_size": kernel}
    m = getattr(models, name)((N, C) + S_out, R, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(SEED),
                              **kw)
    return V, m.W.detach().clone(), m.H.detach().clone()


# the halo tuner's rows: one rank's local problem of these PAR_CASES
HALO_TUNE_CASES = ("nmfd_b1", "nmf2d_b1", "nmf3d_b1")
HALO_YARDSTICKS = ("stream", "unrolled", "conv")


def halo_tuner(card, fit_ms):
    """The halo fits' mode tuner (``autotune.autotune_halo_mode``, at
    ``PNT_NMFD_AUTOTUNE=1``) on the card at HALO_TUNE_CASES' per-rank
    problems: ``fused`` against ``fused_w`` (its candidates on the card),
    each timed over one rank's real per-shard step without collectives; the
    winner and the first resolution's seconds; the library modes timed the
    same way (one reading each) as yardsticks, never candidates.  cuDNN
    picks its own algorithms here, as in the fits (not the deterministic
    ones of the comparisons)."""
    from pytorch_nmf_tpu_torch.ops import autotune
    from pytorch_nmf_tpu_torch.parallel import halo

    torch.backends.cudnn.deterministic = False
    for name in HALO_TUNE_CASES:
        _, shape, kw = PAR_CASES[name]
        N, C, R, lead_in, kernel, L_loc = shape
        chunk = max(L_loc, kernel[-1] - 1)
        beta = float(kw["beta"])
        args = (N, C, lead_in, chunk, kernel, R, beta)
        heuristic = halo._halo_unfold_mode(N, lead_in, chunk, kernel, R,
                                           "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        winner = autotune.autotune_halo_mode(*args, heuristic, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        key = autotune._halo_key("cuda", *args, True)
        ms = {m: 1e3 * t for m, t in autotune._MEASURED[key].items()}
        check(set(ms) == {"fused", "fused_w"} and winner in ms,
              f"halo tuner {name}: candidates {ms}, winner {winner}")
        _, h_chunk, v_local, _ = autotune._halo_shapes(*args[:-1])
        rs = np.random.RandomState(0)
        Vl, Wl, Hp = (torch.from_numpy(rs.rand(*s).astype("f") + lo).cuda()
                      for s, lo in ((v_local, 0.01), ((C, R) + kernel, 0.1),
                                    (h_chunk, 0.1)))
        yard = {m: 1e3 * autotune._time_candidate(
            halo._local_run(m, Vl, Wl, Hp, beta), "cuda", reps=1)
            for m in HALO_YARDSTICKS}
        fit_ms[f"halo autotune {name}"] = {"winner": winner,
                                           "candidate_ms": ms,
                                           "yardstick_ms": yard,
                                           "setup_s": secs}
        print(f"phase 3: halo autotune {name} (one rank's problem: V "
              f"{v_local}, H {h_chunk}, beta={beta:g}; heuristic "
              f"{heuristic}): winner {winner} (first resolution {secs:.3f} "
              f"s); candidates ms/iteration "
              + ", ".join(f"{m} {t:.3f}" for m, t in ms.items())
              + "; library yardsticks ms/iteration "
              + ", ".join(f"{m} {t:.3f}" for m, t in yard.items())
              + f" [{card}]", flush=True)
        del Vl, Wl, Hp


def autotune_cases(ns, ctr, card, fit_ms):
    """Phase 3, the autotuner at ``PNT_NMFD_AUTOTUNE=1``: the MU engine at
    TUNE_CASES, the SIPLCA EM reconstruction at the SIPLCA row, and the
    Hoyer reconstruction at the NMFD flagship (``sW=0.5``, β=2).  On the
    card the MU tuner times the kernel engines alone (``fused``, B3/B4;
    ``fused_w``, B4 and the streamed fold) and the EM and Hoyer
    reconstructions have one candidate, ``fused``, kept untimed.  For each
    case: the first resolution's wall seconds (what tuning adds to a fit),
    the candidates' ms/iteration as the tuner measured them and the winner,
    which must be a kernel engine; the library engines (``unfold``,
    ``autocorr`` at 1-D β=2, ``conv``) timed beside them by the tuner's own
    clock as yardsticks, never chosen; every engine's TUNE_ITERS-iteration
    fit (HOYER_TRACE for Hoyer, whose line search may branch) within 1e-4
    relative loss of ``fused``'s, with its exact launches (the library
    engines none); the model's autotuned fit equal (``torch.equal``) to the
    winner's forced fit, with the winner's exact B3/B4 counts.  The timing
    runs and the comparisons are not counted: the path's count is the
    autotuned model fits', run after the winner is cached.  The comparisons
    run cuDNN's deterministic algorithms, the timing does not."""
    from pytorch_nmf_tpu_torch.ops import autotune

    solver, F, beta_div = ns.solver, ns.F, ns.beta_div
    os.environ["PNT_NMFD_AUTOTUNE"] = "1"
    autotune.clear_cache()
    path = {k: 0 for k in ctr}
    inf = float("-inf")

    def tuned(fn, *args):
        torch.backends.cudnn.deterministic = False
        try:
            return fn(*args)
        finally:
            torch.backends.cudnn.deterministic = True

    def first_resolution(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tuned(fn, *args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def yardstick(run, device):
        return 1e3 * tuned(autotune._time_candidate, run, device)

    def launches(want_b3, want_b4):
        return {"fused_contractions": 0, "fused_beta_loss": 0,
                "hgrad": want_b3, "wgrad": want_b4}

    def counted(tag, want, fn):
        n0 = read(ctr)
        out = fn()
        d = {k: v - n0[k] for k, v in read(ctr).items()}
        check(d == want, f"{tag}: launches {d}, want {want}")
        return out

    def default_fit(tag, want, fit, forced, params):
        nonlocal path
        zero(ctr)
        fit()
        d = read(ctr)
        check(d == want, f"{tag}: the autotuned fit's launches {d}, want {want}")
        path = {k: path[k] + d[k] for k in ctr}
        check(all(torch.equal(p.detach(), q) for p, q in zip(params, forced)),
              f"{tag}: the autotuned fit differs from the forced winner's")
        return d

    def report(tag, key, winner, secs, yard, losses, extra, own=None):
        """``own``: the engine's time measured here where the tuner timed
        nothing (a lone candidate); else the tuner's measurements."""
        ms = own if own is not None else {
            n: 1e3 * t for n, t in autotune._MEASURED[key].items()}
        ref = losses["fused"]
        rels = {n: abs(l - ref) / abs(ref) for n, l in losses.items()}
        bad = {n: r for n, r in rels.items() if r > RTOL}
        check(not bad, f"{tag}: engines' losses off the fused one's: {bad}")
        fit_ms[f"autotune {tag}"] = {"winner": winner, "candidate_ms": ms,
                                     "yardstick_ms": yard, "setup_s": secs}
        print(f"phase 3: autotune {tag}: winner {winner} (first resolution "
              f"{secs:.3f} s); "
              + ("one candidate, untimed by the tuner, timed here: "
                 if own is not None else "candidates ms/iteration ")
              + ", ".join(f"{n} {t:.3f}" for n, t in ms.items())
              + "; library yardsticks ms/iteration "
              + ", ".join(f"{n} {t:.3f}" for n, t in yard.items())
              + "; loss rel to fused "
              + ", ".join(f"{n} {r:.2g}" for n, r in rels.items())
              + f"{extra} [{card}]", flush=True)

    try:
        for label, name, beta, row in TUNE_CASES:
            model = getattr(ns.models, name)
            V, W0, H0 = tune_problem(ns.models, name, row)
            nd = len(row[3])
            tag = f"{label} beta={beta}"
            winner, secs = first_resolution(
                autotune.autotune_winner, V, W0, H0, beta, nd,
                model.reconstruct)
            key = (autotune._platform(V.device), nd, float(beta),
                   tuple(V.shape), tuple(H0.shape))
            cands = dict(autotune._candidates(V, H0, float(beta), nd))
            check(list(cands) == ["fused", "fused_w"] and winner in cands,
                  f"{tag}: candidates {list(cands)}, winner {winner}")
            library = {}
            if autotune._unfold_ok(V, H0):
                library["unfold"] = F.deconv_updater_factory_unfold(nd)
            if nd == 1 and beta == 2 and F.autocorr_supported(
                    V.shape, H0.shape, V.dtype, V.device):
                library["autocorr"] = F.nmfd_autocorr_updater_factory
            library["conv"] = None
            yard = {n: yardstick(autotune._mu_run(V, W0, H0, float(beta), f,
                                                  model.reconstruct), V.device)
                    for n, f in library.items()}
            want = {"fused": launches(TUNE_ITERS * (1 if beta == 1 else 2),
                                      TUNE_ITERS),
                    "fused_w": launches(0, TUNE_ITERS)}
            losses, forced = {}, None
            for cname, factory in dict(cands, **library).items():
                fit = solver.get_dense_fit(model.reconstruct, float(beta), inf,
                                           TUNE_ITERS, True, True, 0.0, 0.0,
                                           False, factory)
                W, H, _ = counted(f"{tag} {cname}",
                                  want.get(cname, launches(0, 0)),
                                  lambda: fit(V, W0, H0))
                check_factors(f"{tag} {cname}", W, H)
                losses[cname] = float(beta_div(model.reconstruct(H, W), V, beta))
                if cname == winner:
                    forced = (W, H)
            m = model(W=W0, H=H0, device="cuda")
            d = default_fit(
                tag, want[winner],
                lambda: m.fit(V, beta=beta, tol=inf, max_iter=TUNE_ITERS),
                forced, (m.W, m.H))
            report(tag, key, winner, secs, yard, losses,
                   f"; fused_w launches B4 {TUNE_ITERS}, B3 0 in {TUNE_ITERS} "
                   f"iterations, the library engines none; the autotuned fit "
                   f"equals the forced winner's, launches {d}")
            if "unfold" in yard and row[4] <= 16:
                fused = 1e3 * autotune._MEASURED[key]["fused"]
                print(f"phase 3: autotune {tag}: fused (B3 in its small-rank "
                      f"regime, B4) {fused:.3f} ms/iteration against the "
                      f"unfold yardstick's {yard['unfold']:.3f}: "
                      f"{'faster' if fused < yard['unfold'] else 'slower'} "
                      f"[{card}]", flush=True)
            del V, W0, H0, m, forced

        # the SIPLCA EM reconstruction at the SIPLCA row
        N, C, S_out, kernel, R = SIPLCA_ROWS["SIPLCA"]
        pr = plca_problem(N, C, S_out, kernel, R)
        V = torch.from_numpy(pr["V"]).cuda()
        m = ns.plca_from_numpy({k: pr[k] for k in "WHZ"}, "cuda")
        # the constructor normalizes: every fit starts from its factors
        W0, H0, Z0 = (p.detach().clone() for p in (m.W, m.H, m.Z))
        SIPLCA = ns.SIPLCA
        tag = f"SIPLCA EM {C}x{S_out[0]} R={R} T={kernel[0]}"
        recon3, secs = first_resolution(autotune.resolve_plca_recon3, SIPLCA,
                                        V, W0, H0, Z0)
        key = (autotune._platform(V.device), "plca-em", 0.0, tuple(V.shape),
               tuple(H0.shape))
        winner = autotune._WINNERS[key]
        check(winner == "fused" and recon3 is F._RECON3[1, "fused"],
              f"{tag}: resolved {winner}, not the kernel adjoints")
        engines = {"fused": F._RECON3[1, "fused"],
                   "unfold": F._RECON3[1, "unfold"],
                   "conv": SIPLCA.reconstruct}
        yard = {n: yardstick(autotune._em_run(V, W0, H0, Z0, r), V.device)
                for n, r in engines.items() if n != "fused"}
        own = {"fused": yardstick(
            autotune._em_run(V, W0, H0, Z0, engines["fused"]), V.device)}
        losses, forced = {}, None
        for cname, rec in engines.items():
            fit = solver.get_plca_fit(rec, inf, TUNE_ITERS, True, True, True,
                                      False, False, False)
            k = TUNE_ITERS if cname == "fused" else 0
            W, H, Z, _, norm = counted(
                f"{tag} {cname}", launches(k, k),
                lambda: fit(V, W0, H0, Z0,
                            *(torch.ones((), device="cuda") for _ in range(3))))
            losses[cname] = float(ns.kl_div(SIPLCA.reconstruct(H, W, Z) * norm, V))
            if cname == winner:
                forced = (W, H, Z)
        d = default_fit(tag, launches(TUNE_ITERS, TUNE_ITERS),
                        lambda: m.fit(V, tol=inf, max_iter=TUNE_ITERS), forced,
                        (m.W, m.H, m.Z))
        report(tag, key, winner, secs, yard, losses,
               f"; the autotuned fit equals the forced winner's, launches {d}",
               own)
        del V, W0, H0, Z0, m, forced

        # the Hoyer reconstruction at the NMFD flagship, sW=0.5, β=2
        V = hoyer_target(ns)
        _, W0, H0 = tune_problem(ns.models, "NMFD", DECONV["NMFD"])
        NMFD = ns.models.NMFD
        tag = "Hoyer NMFD flagship sW=0.5 beta=2"
        recon2, secs = first_resolution(autotune.resolve_hoyer_recon2, NMFD,
                                        V, W0, H0, 2.0)
        key = (autotune._platform(V.device), "hoyer-recon2", 2.0,
               tuple(V.shape), tuple(H0.shape))
        winner = autotune._WINNERS[key]
        check(winner == "fused" and recon2 is F.kernel_adjoint_deconv,
              f"{tag}: resolved {winner}, not the kernel adjoints")
        engines = {"fused": F.kernel_adjoint_deconv,
                   "unfold": F.unfold_deconv, "conv": NMFD.reconstruct}
        yard = {n: yardstick(autotune._hoyer_run(V, W0, H0, 2.0, r), V.device)
                for n, r in engines.items() if n != "fused"}
        own = {"fused": yardstick(
            autotune._hoyer_run(V, W0, H0, 2.0, engines["fused"]), V.device)}
        W_col, H_col = W0.numel() // W0.shape[1], H0.numel() // H0.shape[1]
        b3, b4 = dict((lbl, n) for lbl, _, n in HOYER_CASES)["sW"]
        losses, forced = {}, None
        for cname, rec in engines.items():
            fit = solver.get_hoyer_fit(rec, None, 2.0, HOYER_TRACE, True, True,
                                       0.5, None, W_col, H_col)
            k = HOYER_TRACE if cname == "fused" else 0
            W, H, _ = counted(f"{tag} {cname}", launches(b3 * k, b4 * k),
                              lambda: fit(V, W0, H0))
            losses[cname] = float(beta_div(NMFD.reconstruct(H, W), V, 2))
            if cname == winner:
                forced = (W, H)
        m = NMFD(W=W0, H=H0, device="cuda")
        d = default_fit(tag, launches(b3 * HOYER_TRACE, b4 * HOYER_TRACE),
                        lambda: m.sparse_fit(V, beta=2, max_iter=HOYER_TRACE,
                                             sW=0.5),
                        forced, (m.W, m.H))
        report(tag, key, winner, secs, yard, losses,
               f"; the autotuned {HOYER_TRACE}-iteration fit equals the forced "
               f"winner's, launches {d}", own)
        del V, W0, H0, m, forced
        halo_tuner(card, fit_ms)
    finally:
        os.environ["PNT_NMFD_AUTOTUNE"] = "0"
        torch.backends.cudnn.deterministic = False
    return path


# ---------------------------------------------------------------------------
# The examples phase: the port's example scripts
# ---------------------------------------------------------------------------
def load_example(name):
    """``examples/torch_port/<name>.py`` as a module (by file path: its
    basename is also a JAX example's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_port_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def audio_full_width(ns, ctr, card, fit_ms):
    """The audio separation at full width (AUDIO_FULL) through the
    example's ``separate``: AUDIO_ITERS iterations at β=1 on B3/B4, exactly
    one of each an iteration (the static engine), finite stems, the SI-SNR
    gain reported.  Returns the path's launch counts; then, apart from
    them, the fit's ms/iteration (CUDA events) and its first AUDIO_TRACE
    iterations on the kernels against the plain versions (final losses
    within 1e-4 relative)."""
    from pytorch_nmf_tpu_torch.ops.solver import get_dense_fit

    ex = load_example("audio_separation")
    NMFD, F, beta_div = ns.models.NMFD, ns.F, ns.beta_div
    cfg = dict(AUDIO_FULL)
    sources, sr = ex.synth_sources(sr=cfg.pop("sr"),
                                   duration=cfg.pop("duration"))
    mix = sources.sum(0)
    Z, S = ex.spectrogram(mix, sr, cfg["nperseg"], cfg["noverlap"])
    W0, H0 = ex.init_factors(S.shape, cfg["rank"], cfg["T"])
    shape = "x".join(map(str, S.shape[1:])) + f"_r{cfg['rank']}_k{cfg['T']}"
    tag = f"audio separation {shape}"
    zero(ctr)
    t0 = time.perf_counter()
    stems, comps, n_iter = ex.separate(mix, sr, max_iter=AUDIO_ITERS,
                                       device="cuda", W0=W0, H0=H0,
                                       tol=float("-inf"), **cfg)
    secs = time.perf_counter() - t0
    d = read(ctr)
    want = {"fused_contractions": 0, "fused_beta_loss": 0,
            "hgrad": AUDIO_ITERS, "wgrad": AUDIO_ITERS}
    check(n_iter == AUDIO_ITERS and d == want,
          f"{tag}: n_iter {n_iter}, launches {d} (want {want})")
    check(bool(np.isfinite(stems).all() and np.isfinite(comps).all()),
          f"{tag}: non-finite stems")
    gain = ex.score(stems, sources, mix, verbose=False)

    V = torch.from_numpy(S).cuda()
    m = NMFD(W=torch.from_numpy(W0), H=torch.from_numpy(H0), device="cuda")
    _, ms = events_ms(lambda: m.fit(V, beta=1, tol=float("-inf"),
                                    max_iter=AUDIO_ITERS))
    check_factors(tag, m.W, m.H)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m.fit(V, beta=1, tol=float("-inf"), max_iter=AUDIO_TRACE)
        torch.cuda.synchronize()
    split = {k: v / AUDIO_TRACE for k, v in device_split(prof).items()}
    fit_ms[f"audio_nmfd_{shape}_beta1"] = ms / AUDIO_ITERS
    fit_ms[f"audio_nmfd_{shape}_beta1_profile_ms"] = split
    plain_fit = get_dense_fit(
        NMFD.reconstruct, 1.0, float("-inf"), AUDIO_TRACE, True, True, 0.0,
        0.0, False, F.deconv_updater_factory_plain(1))
    m = NMFD(W=torch.from_numpy(W0), H=torch.from_numpy(H0), device="cuda")
    m.fit(V, beta=1, tol=float("-inf"), max_iter=AUDIO_TRACE)
    Wp, Hp, _ = plain_fit(V, torch.from_numpy(W0).cuda(),
                          torch.from_numpy(H0).cuda())
    lk = float(beta_div(NMFD.reconstruct(m.H.detach(), m.W.detach()), V, 1))
    lp = float(beta_div(NMFD.reconstruct(Hp, Wp), V, 1))
    rel = abs(lk - lp) / abs(lp)
    check(rel <= RTOL, f"{tag}: {AUDIO_TRACE} iterations, loss kernel {lk} "
          f"plain {lp} (rel {rel:.3g})")
    print(f"phase 3: {tag}: {n_iter} iterations at beta=1 in {secs:.2f} s "
          f"(STFT, fit, masks, ISTFT); launches B3 {d['hgrad']}, B4 "
          f"{d['wgrad']}; mean SI-SNR gain {gain:.4f} dB (reported, not "
          f"gated); fit {ms / AUDIO_ITERS:.4f} ms/iteration; "
          f"{AUDIO_TRACE} iterations kernel loss {lk:.7g} plain {lp:.7g} "
          f"(rel {rel:.3g}) [{card}]", flush=True)
    print(f"phase 4: {tag}: one iteration's device time (ms; torch.profiler "
          f"over {AUDIO_TRACE} iterations): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" [{card}]", flush=True)
    print(f"phase 4: {tag}: B3 {split['B3']:.4f} ms of device time an "
          f"iteration (its W2 split and small-rank gemm kernels, one launch "
          f"of the wrapper an iteration, {d['hgrad'].small} of "
          f"{d['hgrad']} in its small-rank regime; its slab sum counts in "
          f"the rest) [{card}]", flush=True)
    return d


def example_mains(card):
    """Every script's ``main`` on the card against the same script on the
    CPU, from the same numpy inits: numbers within EXAMPLE_RTOL relative
    (``max_rel_delta``, a sharded fit's distance from its single-device
    fit, and ``max_rel_delta_*``, the model API's, at most 1e-5 on both);
    the audio separation at the CPU test's setting above AUDIO_MIN_GAIN
    dB.  ``multi_device_fit`` starts 2 gloo
    ranks (sharing the card with ``device="cuda"``); its two runs go in
    threads beside the others.  The card runs' launches count on the
    caller's counters (the rank processes' are their own)."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    def quiet(fn, **kw):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(**kw)

    par = load_example("multi_device_fit")
    with ThreadPoolExecutor(2) as pool:
        futures = {dev: pool.submit(par.main, device=dev, world=2,
                                    verbose=False) for dev in ("cuda", "cpu")}
        runs = {}
        for name, kw in (("audio_separation", AUDIO_SMALL),
                         ("spectrogram_nmfd", dict(verbose=False)),
                         ("basic_tutorial", {}),
                         ("source_filter_model", {})):
            main = load_example(name).main
            runs[name] = {dev: quiet(main, device=dev, **kw)
                          for dev in ("cuda", "cpu")}
        runs["multi_device_fit"] = {dev: f.result()
                                    for dev, f in futures.items()}
    for name, got in runs.items():
        card_out, cpu_out = ({"gain": x} if isinstance(x, float) else x
                             for x in (got["cuda"], got["cpu"]))
        check(card_out.keys() == cpu_out.keys(), f"{name}: {got}")
        gaps = {}
        for key, b in cpu_out.items():
            a = card_out[key]
            check(np.isfinite(a) and np.isfinite(b), f"{name} {key}: {a}, {b}")
            if key.startswith("max_rel_delta"):
                check(a <= 1e-5 and b <= 1e-5, f"{name}: {key} {a} (card), "
                      f"{b} (CPU): a sharded fit from the single-device fit "
                      f"(or the model API's from the explicit call)")
                continue
            gaps[key] = abs(a - b) / max(abs(b), 1e-30)
        worst = max(gaps, key=gaps.get)
        check(gaps[worst] <= EXAMPLE_RTOL, f"{name}: {worst} card "
              f"{card_out[worst]} CPU {cpu_out[worst]} (rel {gaps[worst]:.3g})")
        if name == "audio_separation":
            check(card_out["gain"] > AUDIO_MIN_GAIN,
                  f"{name}: gain {card_out['gain']} dB on the card")
        print(f"phase 3: example {name}: card {json.dumps(card_out)}; largest "
              f"gap to the CPU run {worst} rel {gaps[worst]:.3g} [{card}]",
              flush=True)


def notebook_kernel(name):
    """``python3 chip_smoke.py --notebook NAME``: the committed notebook
    NAME executed on the card in this fresh process, as a notebook's kernel
    runs it (its code cells in turn, in one namespace, from its directory).
    Prints one JSON line: each cell's standard output, the seconds, and
    the B1-B4 and P1 launches."""
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops import projection as P
    from pytorch_nmf_tpu_torch.ops._build import load_all

    nbm = load_example("make_notebooks")
    load_all()  # the parent's build: loads, compiles nothing
    ctr = counters(fm, D)
    zero(ctr)
    p1_start = P.proj_rows.launches
    cells = nbm.read_notebook(os.path.join(EXAMPLES, f"{name}.ipynb"))
    t0 = time.perf_counter()
    ran = nbm.execute_cells([c[:2] for c in cells], EXAMPLES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: int(v) for k, v in read(ctr).items()}
    launches["hoyer_proj"] = P.proj_rows.launches - p1_start
    print(json.dumps({"stdout": [c[2] for c in ran], "seconds": secs,
                      "launches": launches}), flush=True)


def notebooks_on_card(card):
    """The committed notebooks (NOTEBOOKS) executed on the card, each in a
    process of its own (:func:`notebook_kernel`, the environment's
    ``PNT_*`` switches left out, as a user's kernel starts).  No cell
    raises; each prints the lines its committed output has, the device
    line this card's name, and every number within
    ``make_notebooks.RTOL`` of the committed one (integers equal).  The
    basic tutorial launches B1, B2 and P1, the source-filter model none
    (its ``BetaMu`` runs cuBLAS).  Returns the B1-B4 launches and P1's."""
    nbm = load_example("make_notebooks")
    device_line = nbm.DEVICE + torch.cuda.get_device_name()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PNT_")}
    total = dict.fromkeys(REPLACES, 0)
    total["hoyer_proj"] = 0
    report = []
    for name in NOTEBOOKS:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--notebook", name],
            capture_output=True, text=True, env=env, timeout=600)
        check(r.returncode == 0, f"notebook {name}: exit {r.returncode}: "
              f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
        run = json.loads(r.stdout.strip().splitlines()[-1])
        cells = nbm.read_notebook(os.path.join(EXAMPLES, f"{name}.ipynb"))
        check(len(run["stdout"]) == len(cells), f"notebook {name}: "
              f"{len(run['stdout'])} cells ran of {len(cells)}")
        n_code = 0
        for i, ((kind, _, want), got) in enumerate(zip(cells, run["stdout"])):
            if kind != "code":
                continue
            n_code += 1
            diff = nbm.compare_outputs(got, want)
            check(diff is None, f"notebook {name} cell {i + 1}: {diff}")
            devices = [line for line in got.splitlines()
                       if line.startswith(nbm.DEVICE)]
            n_want = sum(line.startswith(nbm.DEVICE)
                         for line in want.splitlines())
            check(devices == [device_line] * n_want,
                  f"notebook {name} cell {i + 1}: device lines {devices}, "
                  f"want {n_want} of {device_line!r}")
        d = run["launches"]
        kernels = ("fused_contractions", "fused_beta_loss", "hoyer_proj")
        if name == "basic_tutorial":
            check(all(d[k] > 0 for k in kernels) and not d["hgrad"]
                  and not d["wgrad"], f"notebook {name}: launches {d}")
        else:
            check(not any(d.values()), f"notebook {name}: launches {d}")
        for k, v in d.items():
            total[k] += v
        report.append(f"{name}.ipynb ({n_code} code cells, "
                      f"{run['seconds']:.2f} s of "
                      f"{time.perf_counter() - t0:.1f} s in its process): "
                      f"B1 {d['fused_contractions']}, B2 "
                      f"{d['fused_beta_loss']}, P1 {d['hoyer_proj']}")
    print(f"phase 3: notebooks executed on the card, every cell's output "
          f"as committed (numbers within {nbm.RTOL:g} relative plus one "
          f"unit of the last printed digit, integers equal; the device line "
          f"{device_line!r}): " + "; ".join(report) + f" [{card}]",
          flush=True)
    p1 = total.pop("hoyer_proj")
    return total, p1


def c3_on_card(ns, ctr, card):
    """The Hoyer projection's overflow case on the card (C3_PROBE): the
    NMFD fit finite after C3_PROBE_ITERS iterations on B3/B4 (2 and 1 an
    iteration), its first HOYER_TRACE iterations' losses within 1e-4 of
    the plain twin's; the dense NMF fit (no kernel) finite after
    HOYER_TRACE iterations with its loss fallen."""
    solver, F, beta_div = ns.solver, ns.F, ns.beta_div
    NMFD = ns.models.NMFD
    for seed in (0, 1):
        rs = np.random.RandomState(seed)
        V, W0, H0 = (torch.from_numpy(rs.rand(*s).astype("f") + 0.01).cuda()
                     for s in C3_PROBE)
        tag = f"Hoyer NMFD {'x'.join(map(str, C3_PROBE[0]))} seed {seed}"
        n0 = read(ctr)
        m = NMFD(W=W0, H=H0, device="cuda")
        m.sparse_fit(V, beta=0.5, max_iter=C3_PROBE_ITERS, sW=0.4)
        d = {k: v - n0[k] for k, v in read(ctr).items()}
        check_factors(tag, m.W, m.H)
        want = {"fused_contractions": 0, "fused_beta_loss": 0,
                "hgrad": 2 * C3_PROBE_ITERS, "wgrad": C3_PROBE_ITERS}
        check(d == want, f"{tag}: launches {d}, want {want}")
        W_col, H_col = W0.numel() // W0.shape[1], H0.numel() // H0.shape[1]
        args = (0.5, HOYER_TRACE, True, True, 0.4, None, W_col, H_col)

        def loss_of(w, h):
            return float(beta_div(F.plain_adjoint_deconv(h, w), V, 0.5))

        n1 = read(ctr)
        lk, lp = (hoyer_losses(solver, lambda: solver.get_hoyer_fit(
            recon, None, *args)(V, W0, H0), loss_of)
            for recon in (F.kernel_adjoint_deconv, F.plain_adjoint_deconv))
        restore(ctr, n1)  # the comparison is not the path's
        rel = [abs(a - b) / b for a, b in zip(lk, lp)]
        check(len(rel) == HOYER_TRACE and max(rel) <= RTOL,
              f"{tag}: losses kernel {lk} plain {lp}")
        print(f"phase 3: {tag} beta=0.5 sW=0.4: finite after "
              f"{C3_PROBE_ITERS} iterations, launches B3 {d['hgrad']}, B4 "
              f"{d['wgrad']}; losses 1-{HOYER_TRACE} kernel "
              f"{[f'{x:.7g}' for x in lk]}, max rel to plain {max(rel):.3g} "
              f"[{card}]", flush=True)
    M, K, R = MAIN_SHAPE
    rs = np.random.RandomState(SEED)
    V = torch.from_numpy((C3_DENSE_SCALE * (rs.rand(M, K) + 1e-3))
                         .astype("f")).cuda()
    inits = {"W": rs.rand(K, R).astype("f") + 0.1,
             "H": (C3_DENSE_SCALE * (rs.rand(M, R) + 0.1)).astype("f")}
    m = ns.nmf_from_numpy(inits, "cuda")
    before = float(beta_div(m().detach(), V, 0.5))
    n0 = read(ctr)
    m.sparse_fit(V, beta=0.5, max_iter=HOYER_TRACE, sW=0.5)
    d = {k: v - n0[k] for k, v in read(ctr).items()}
    after = float(beta_div(m().detach(), V, 0.5))
    tag = f"Hoyer NMF {M}x{K} R={R} beta=0.5 sW=0.5"
    check_factors(tag, m.W, m.H)
    check(not any(d.values()), f"{tag}: kernel launches {d}")
    check(after < before, f"{tag}: loss {before} -> {after} did not fall")
    print(f"phase 3: {tag}: finite after {HOYER_TRACE} iterations, loss "
          f"{before:.7g} -> {after:.7g}, no kernel [{card}]", flush=True)


def examples_phase(ns, ctr, card, fit_ms, p1):
    """Phase 3, the port's examples (``examples/torch_port/``) at the
    static engine choice: the audio separation at full width, every
    script's ``main`` on the card against the CPU, the tutorial notebooks
    against their committed outputs, and the Hoyer projection's overflow
    case.  Returns the path's launch counts; P1's (the scripts' and the
    notebooks') go into ``p1["examples"]``."""
    os.environ["PNT_NMFD_AUTOTUNE"] = "0"
    path = audio_full_width(ns, ctr, card, fit_ms)
    zero(ctr)
    p1_start = ns.P.proj_rows.launches
    example_mains(card)
    mains = read(ctr)
    notebooks, p1_notebooks = notebooks_on_card(card)
    p1["examples"] = ns.P.proj_rows.launches - p1_start + p1_notebooks
    zero(ctr)
    c3_on_card(ns, ctr, card)
    return {k: path[k] + mains[k] + notebooks[k] + v
            for k, v in read(ctr).items()}


# ---------------------------------------------------------------------------
# The parallel phase: the sharded fits of ``pytorch_nmf_tpu_torch.parallel``
# in rank processes that share the card
# ---------------------------------------------------------------------------
# each rank at bench_multichip.py:42-51's full-width per-device case (weak
# scaling: the global problem is the world's ranks' blocks side by side;
# the SIPLCA flagship is split instead).  (kind, shape, fit keywords):
# nmf/plca (M per rank, K, R); sparse (M per rank, K, R, nnz per rank);
# deconv/siplca (N, C, R, leading S_in, kernel, trailing L_out per rank)
PAR_WORLD = 2
PAR_TIMEOUT_S = 600
# a rank's destroy_process_group, with compiled fits of the group cached,
# fails the run past this (C12 hung there)
TEARDOWN_S = 120
PAR_CASES = {
    "nmf_b1": ("nmf", (5168, 1025, 88), dict(beta=1, tol=0, max_iter=20)),
    "nmf_b0.5": ("nmf", (5168, 1025, 88), dict(beta=0.5, tol=0, max_iter=20)),
    "nmf_b2": ("nmf", (5168, 1025, 88), dict(beta=2, tol=0, max_iter=20)),
    "nmf_model_b1": ("nmf", (5168, 1025, 88),
                     dict(beta=1, tol=0, max_iter=20, model_axis="model")),
    "nmf_early_b1": ("nmf", (5168, 1025, 88),
                     dict(beta=1, tol=1e-3, max_iter=200)),
    "plca": ("plca", (5168, 1025, 88), dict(tol=0, max_iter=20)),
    "sparse_b1": ("sparse", (8192, 8192, 64, 671_000),
                  dict(beta=1, tol=0, max_iter=10)),
    "nmfd_b1": ("deconv", (1, 1025, 88, (), (400,), 1250),
                dict(beta=1, tol=0, max_iter=4)),
    "nmfd_b2": ("deconv", (1, 1025, 88, (), (400,), 1250),
                dict(beta=2, tol=0, max_iter=4)),
    "nmfd_r8_b1": ("deconv", (1, 1025, 8, (), (400,), 1250),
                   dict(beta=1, tol=0, max_iter=4)),
    "nmfd_n2_b1": ("deconv", (2, 1025, 88, (), (400,), 1250),
                   dict(beta=1, tol=0, max_iter=3)),
    "nmf2d_b1": ("deconv", (1, 256, 64, (121,), (8, 8), 128),
                 dict(beta=1, tol=0, max_iter=4)),
    "nmf3d_b1": ("deconv", (1, 64, 16, (16, 16), (4, 4, 4), 64),
                 dict(beta=1, tol=0, max_iter=4)),
    "siplca_r8": ("siplca", (1, 513, 8, (), (200,), 3000),
                  dict(tol=0, max_iter=10)),
    "siplca_flagship": ("siplca", (1, 513, 64, (), (200,), 1500),
                        dict(tol=0, max_iter=10)),
    "siplca2": ("siplca", (1, 256, 64, (121,), (8, 8), 128),
                dict(tol=0, max_iter=4)),
    # the halo fits' other per-shard modes, forced through the private
    # fits' ``mode`` (B4 alone in fused_w, no kernel in the library modes),
    # and the NMFD flagship in the mode its tuner picks (PAR_TUNED)
    "nmfd_b1_fused_w": ("deconv", (1, 1025, 88, (), (400,), 1250),
                        dict(beta=1, tol=0, max_iter=3, mode="fused_w")),
    "nmfd_b0.5_fused_w": ("deconv", (1, 1025, 88, (), (400,), 1250),
                          dict(beta=0.5, tol=0, max_iter=3, mode="fused_w")),
    "nmfd_b1_stream": ("deconv", (1, 1025, 88, (), (400,), 1250),
                       dict(beta=1, tol=0, max_iter=3, mode="stream")),
    "nmfd_b1_conv": ("deconv", (1, 1025, 88, (), (400,), 1250),
                     dict(beta=1, tol=0, max_iter=3, mode="conv")),
    "nmf2d_b1_unrolled": ("deconv", (1, 256, 64, (121,), (8, 8), 128),
                          dict(beta=1, tol=0, max_iter=3, mode="unrolled")),
    "nmf3d_b1_fused_w": ("deconv", (1, 64, 16, (16, 16), (4, 4, 4), 64),
                         dict(beta=1, tol=0, max_iter=3, mode="fused_w")),
    "siplca_flagship_conv": ("siplca", (1, 513, 64, (), (200,), 1500),
                             dict(tol=0, max_iter=3, mode="conv")),
    "siplca2_unrolled": ("siplca", (1, 256, 64, (121,), (8, 8), 128),
                         dict(tol=0, max_iter=3, mode="unrolled")),
    "nmfd_b1_tuned": ("deconv", (1, 1025, 88, (), (400,), 1250),
                      dict(beta=1, tol=0, max_iter=3)),
}
# the cases whose ranks resolve their mode with the tuner on (the others
# run at PNT_NMFD_AUTOTUNE=0: the static "fused" unless a mode is forced)
PAR_TUNED = ("nmfd_b1_tuned",)
# the one-rank NCCL group's cases; over NCCL the sharded fits are compiled
# (their chunk loop one CUDA-graph WHILE node): each case also runs cold,
# warm and on a new V against its eager twin (par_compiled), at
# PAR_COMPILED_ITERS iterations where it has tol=0 (5 chunks: the cold
# fit's two eager chunks, its capture, a replay; the halo fits 3)
PAR_NCCL_ONE = ("nmf_b1", "nmf_b0.5", "nmf_b2", "nmf_model_b1", "nmf_early_b1",
                "plca", "sparse_b1", "nmfd_b1", "nmfd_b2", "nmfd_r8_b1",
                "nmfd_n2_b1", "nmfd_b1_fused_w", "nmfd_b1_conv", "nmf2d_b1",
                "nmf3d_b1", "siplca_flagship", "siplca_flagship_conv",
                "siplca2")
PAR_COMPILED_KINDS = ("nmf", "plca", "sparse", "deconv", "siplca")
PAR_COMPILED_ITERS = {"deconv": 30, "siplca": 30}  # 50 for the others
# the early stop's compiled runs (on one rank they stop at chunk 7; the
# case's own tol, 1e-3, stops at chunk 2 there: the replays would run none)
PAR_COMPILED_TOL = {"nmf_early_b1": 3e-4}
# (run, graphed, the run's (replays, captures, host reads)): the
# configuration's first fit on shard_target DTensors, its eager twin on the
# same, a warm fit on them (a hit) and a fit on new DTensors of the same
# values (a new target: a warm miss), as CACHE_RUNS
PAR_COMPILED_RUNS = (("cold", True, (1, 1, 2 + 2 + 1)), ("eager", False, None),
                     ("warm", True, (1, 0, 1)), ("new V", True, (1, 1, 1)))
# the halo fits' (their entry copies each fit's chunk of V into its own):
# a fit on another V of the same shape (V rolled one frame along the
# sharded axis) is a hit, held to its own eager twin; "recaptured" drops
# the entry but keeps its configuration: the capture comes before chunk 1
PAR_COMPILED_HALO_RUNS = (
    ("cold", True, (1, 1, 2 + 2 + 1)), ("eager", False, None),
    ("warm", True, (1, 0, 1)), ("other V", True, (1, 0, 1)),
    ("other V eager", False, None), ("recaptured", True, (1, 1, 1)))
PAR_PATHS = {"nmf": "sharded", "plca": "sharded", "sparse": "sharded_sparse",
             "deconv": "halo", "siplca": "halo"}
# the model API on DTensor targets (par_routed): each case's model.fit on
# shard_target DTensors after its explicit fit, in every group; over NCCL
# PAR_ROUTED_WARM's cases also fit twice on their own DTensor factors at
# PAR_COMPILED_ITERS iterations, the second a hit of the fits' cache
PAR_ROUTED = ("nmf_b1", "nmf_model_b1", "plca", "nmfd_b1", "nmf2d_b1",
              "nmf3d_b1", "siplca_flagship", "siplca2")
PAR_ROUTED_WARM = ("nmf_b1", "nmfd_b1")
# the explicit fits the model API routes to, by case kind
PAR_ROUTES = {"nmf": ("sharded", "sharded_nmf_fit"),
              "plca": ("sharded", "sharded_plca_fit"),
              "deconv": ("halo", "_sharded_deconv_fit"),
              "siplca": ("halo", "_sharded_siplca_fit")}


def par_inputs(name, world):
    """The full inputs of case ``name`` over ``world`` ranks, from SEED:
    the same arrays in every rank and in the parent."""
    kind, shape, _ = PAR_CASES[name]
    rs = np.random.RandomState(SEED)

    def pos(*s):
        return np.abs(rs.randn(*s)).astype("f")

    if kind in ("nmf", "plca"):
        M, K, R = shape
        M *= world
        if kind == "nmf":
            return {"V": pos(M, K) + 0.01, "W": pos(K, R), "H": pos(M, R)}
        W, H = rs.rand(K, R).astype("f"), rs.rand(M, R).astype("f")
        return {"V": rs.rand(M, K).astype("f"), "W": W / W.sum(0),
                "H": H / H.sum(0), "Z": np.full(R, 1.0 / R, "f")}
    if kind == "sparse":
        M_loc, K, R, nnz = shape
        flats = []
        for r in range(world):  # each rank's row block holds nnz entries
            flat = np.unique(rs.randint(0, M_loc * K, int(nnz * 1.1)))
            rs.shuffle(flat)
            flats.append(np.sort(flat[:nnz]).astype(np.int64) + r * M_loc * K)
        flat = np.concatenate(flats)
        return {"idx": np.stack([flat // K, flat % K]),
                "vals": rs.rand(len(flat)).astype("f") + 0.01,
                "shape": np.array([M_loc * world, K]),
                "W": rs.rand(K, R).astype("f") + 0.1,
                "H": rs.rand(M_loc * world, R).astype("f") + 0.1}
    N, C, R, lead_in, kernel, L_loc = shape
    L_out = L_loc * (2 if name.startswith("siplca_flagship") else world)
    S_out = tuple(s + k - 1 for s, k in zip(lead_in, kernel[:-1])) + (L_out,)
    S_in = tuple(lead_in) + (L_out - kernel[-1] + 1,)
    if kind == "deconv":
        return {"V": pos(N, C, *S_out) + 0.01, "W": pos(C, R, *kernel),
                "H": pos(N, R, *S_in)}
    W = rs.rand(C, R, *kernel).astype("f")
    H = rs.rand(N, R, *S_in).astype("f")
    axes = (0,) + tuple(range(2, W.ndim))
    return {"V": rs.rand(N, C, *S_out).astype("f"),
            "W": W / W.sum(axes, keepdims=True),
            "H": H / H.sum(axes, keepdims=True),
            "Z": np.full(R, 1.0 / R, "f")}


def par_sparse(inp, device="cpu"):
    return torch.sparse_coo_tensor(
        torch.from_numpy(inp["idx"]), torch.from_numpy(inp["vals"]),
        tuple(int(s) for s in inp["shape"]), is_coalesced=True,
        check_invariants=False).to(device)


def par_fit(par, name, inp, mesh, **override):
    """One sharded fit of case ``name`` through the port's entry point
    (``override``: fit keywords in place of the case's)."""
    kind, shape, kw = PAR_CASES[name]
    kw = dict(kw, **override)
    mode = kw.pop("mode", None)
    if kind == "nmf":
        W, H, n = par.sharded_nmf_fit(inp["V"], inp["W"], inp["H"], mesh, **kw)
        return {"W": W, "H": H, "n_iter": n}
    if kind == "plca":
        W, H, Z, n, norm = par.sharded_plca_fit(
            inp["V"], inp["W"], inp["H"], inp["Z"], mesh, **kw)
        return {"W": W, "H": H, "Z": Z, "n_iter": n, "norm": norm}
    if kind == "sparse":
        W, H, n = par.sharded_sparse_nmf_fit(par_sparse(inp), inp["W"],
                                             inp["H"], mesh, **kw)
        return {"W": W, "H": H, "n_iter": n}
    nd = len(shape[4])
    if kind == "deconv":
        if mode is not None:
            W, H, n = par.halo._sharded_deconv_fit(
                inp["V"], inp["W"], inp["H"], mesh, nd, mode=mode, **kw)
        else:
            fit = (par.sharded_nmfd_fit, par.sharded_nmf2d_fit,
                   par.sharded_nmf3d_fit)[nd - 1]
            W, H, n = fit(inp["V"], inp["W"], inp["H"], mesh, **kw)
        return {"W": W, "H": H, "n_iter": n}
    if mode is not None:
        W, H, Z, n, norm = par.halo._sharded_siplca_fit(
            inp["V"], inp["W"], inp["H"], inp["Z"], mesh, nd, mode=mode, **kw)
    else:
        fit = (par.sharded_siplca_fit, par.sharded_siplca2_fit,
               par.sharded_siplca3_fit)[nd - 1]
        W, H, Z, n, norm = fit(inp["V"], inp["W"], inp["H"], inp["Z"], mesh,
                               **kw)
    return {"W": W, "H": H, "Z": Z, "n_iter": n, "norm": norm}


def par_iters(name, n_iter):
    """Iterations a fit ran: the PLCA family returns the raw loop index."""
    return n_iter + 1 if PAR_CASES[name][0] in ("plca", "siplca") else n_iter


def par_expected(name, n_iter, mode=None):
    """Each rank's exact launches of case ``name`` (B1, B2, B3, B4), as the
    code implies, the halo fits' in their per-shard ``mode``: B1 twice an
    iteration at β ≠ 2 (the W side's raw sums and the H side), B2 once a
    loss evaluation (one at entry, one a chunk of 10) at β ∉ {1, 2}; in
    ``fused`` B4 once an iteration (the neg/pos pair in one call), B3 once
    an iteration at β=1 and twice otherwise (one a cotangent), in
    ``fused_w`` B4 alone; the SIPLCA E-step in ``fused`` one B3 and one B4;
    the library modes, PLCA's E-step and the sparse ELL path none."""
    kind, _, kw = PAR_CASES[name]
    beta, runs = kw.get("beta"), par_iters(name, n_iter)
    if kind == "nmf":
        return (0 if beta == 2 else 2 * runs,
                1 + runs // 10 if beta not in (1, 2) else 0, 0, 0)
    if kind == "deconv":
        b3 = runs * (1 if beta == 1 else 2) if mode == "fused" else 0
        return 0, 0, b3, runs if mode in ("fused", "fused_w") else 0
    if kind == "siplca":
        k = runs if mode == "fused" else 0
        return 0, 0, k, k
    return 0, 0, 0, 0


def par_mode_spy(halo, ctr):
    """Wrap ``halo._resolve_halo_mode`` to record each resolution's mode,
    its wall seconds and the kernel launches of the tuner's timing runs
    (not the fit's) in the returned dict."""
    seen = {}
    resolve = halo._resolve_halo_mode

    def spy(*args, **kw):
        n0 = read(ctr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen["mode"] = resolve(*args, **kw)
        torch.cuda.synchronize()
        seen["resolve_s"] = time.perf_counter() - t0
        seen["launches"] = {k: v - n0[k] for k, v in read(ctr).items()}
        return seen["mode"]

    halo._resolve_halo_mode = spy
    return seen


def par_compiled(par, name, world, mesh, ctr):
    """Case ``name`` through its compiled sharded fit on this NCCL rank
    (PAR_COMPILED_RUNS, or PAR_COMPILED_HALO_RUNS for a halo fit, from an
    empty cache): each graphed run bit for bit its eager twin (the rank's
    blocks, ``n_iter``, PLCA's ``norm``), its replays, captures and host
    reads as listed, B1-B4 launches and the all-reduces' and halo shifts'
    calls and bytes the twin's; returns each run's ms/iteration (CUDA
    events around the whole call), counts, the entry's held bytes after the
    warm fit (a halo fit's chunk of V and its flat copy among them,
    ``chunk_bytes``) and, on one rank, the single-card warm fit of the same
    problem (the same card V twice: a hit) in ms/iteration, on several the
    host ms of the ranks' agreement on the loop's path (``agree``: what a
    fit's agreement costs alone, on the ranks' rendezvous store)."""
    import torch.distributed as dist

    from pytorch_nmf_tpu_torch.ops import graphs, solver
    from pytorch_nmf_tpu_torch.parallel import comm
    from pytorch_nmf_tpu_torch.parallel.sharded import placements

    kind, shape, kw = PAR_CASES[name]
    kw = dict(kw)
    if not kw.get("tol"):
        kw["max_iter"] = PAR_COMPILED_ITERS.get(kind, 50)
    kw["tol"] = PAR_COMPILED_TOL.get(name, kw["tol"])
    inp = par_inputs(name, world)
    halo = kind in ("deconv", "siplca")
    nd = len(shape[4]) if halo else 0
    rows = placements(mesh, {1 + nd: "seq"} if halo else {0: "data"})
    if halo:  # another V of the same shape
        inp["V other"] = np.ascontiguousarray(np.roll(inp["V"], 1, axis=-1))

    def targets(v="V"):
        if kind == "sparse":
            V = par_sparse(inp)
        else:
            V = par.shard_target(inp[v], mesh, placements(
                mesh, {0: "data", 1: kw.get("model_axis")}) if kind == "nmf"
                else rows)
        return V, par.shard_target(inp["H"], mesh, rows)

    def fit(*args, _graph):
        fkw = dict(kw)
        if not halo:
            return {"nmf": par.sharded_nmf_fit, "plca": par.sharded_plca_fit,
                    "sparse": par.sharded_sparse_nmf_fit}[kind](
                *args, mesh, _graph=_graph, **fkw)
        mode = fkw.pop("mode", None)
        f = (par.halo._sharded_deconv_fit if kind == "deconv"
             else par.halo._sharded_siplca_fit)
        return f(*args, mesh, nd, mode=mode, _graph=_graph, **fkw)

    solver.compiled_cache_clear()
    first = targets()
    runs, outs = {}, {}
    plan = PAR_COMPILED_HALO_RUNS if halo else PAR_COMPILED_RUNS
    cudnn = kw.get("mode") == "conv"
    if cudnn:
        # the conv mode's cuDNN backward is free to pick an algorithm that
        # is not deterministic (atomics): two eager fits of the case with
        # it and their drift (par_drift), then every run of the case with
        # cuDNN's deterministic algorithms, so that the graphed runs can be
        # held bit for bit
        args = (first[0], inp["W"], first[1]) + (
            (inp["Z"],) if "Z" in inp else ())
        twice = [fit(*args, _graph=False) for _ in range(2)]
        runs["cudnn"] = par_drift(name, inp, kw, twice, world)
        del twice
        torch.backends.cudnn.deterministic = True
    for label, graph, want in plan:
        V, H = (targets() if label == "new V" else
                targets("V other") if label.startswith("other V") else first)
        args = (V, inp["W"], H) + ((inp["Z"],) if "Z" in inp else ())
        if label == "recaptured":  # the configuration stays seen
            solver._CACHE.clear(seen=False)
        dist.barrier()  # each rank's time from one start: no rank's skew
        torch.cuda.synchronize()
        zero(ctr)
        comm.stats.reset()
        before = (graphs._Graphs.replays, graphs._Graphs.captures,
                  solver._read.reads)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fit(*args, _graph=graph)
        end.record()
        torch.cuda.synchronize()
        got = (graphs._Graphs.replays, graphs._Graphs.captures,
               solver._read.reads)
        n = int(out[3] if kind in ("plca", "siplca") else out[2])
        outs[label] = out
        runs[label] = {
            "n_iter": n, "ms_per_iter": start.elapsed_time(end)
            / par_iters(name, n),
            "counts": [a - b for a, b in zip(got, before)],
            "launches": {k: int(v) for k, v in read(ctr).items()},
            "comm": [[comm.stats.calls[k], comm.stats.bytes[k]]
                     for k in ("all_reduce", "halo")]}
        if label == "warm":
            runs[label]["held_bytes"] = solver.compiled_cache_info()[
                "held_bytes"]
            runs[label]["chunk_bytes"] = sum(
                t.untyped_storage().nbytes() for e in solver._CACHE.entries
                .values() for k, t in e.derived.items()
                if k in ("Vl", "target", "Vn"))
    # the cold fit captures after its second eager chunk when a third may
    # follow (then replays once, stopped or not)
    chunks = runs["eager"]["n_iter"] // 10
    check(chunks >= 2 and kw["max_iter"] >= 30, f"{name}: the eager twin "
          f"ran {chunks} chunks of {kw['max_iter'] // 10}; the cold fit "
          f"captures after a second eager chunk when a third may follow")
    for label, graph, want in plan:
        if not graph:
            continue
        twin = "other V eager" if label == "other V" else "eager"
        out, run, ref = outs[label], runs[label], runs[twin]
        same = all(torch.equal(a.to_local(), b.to_local())
                   if hasattr(a, "to_local") else a == b
                   for a, b in zip(out, outs[twin]))
        check(same, f"{name} [nccl{world}]: the {label} fit differs from its "
              f"eager twin")
        check(tuple(run["counts"]) == want, f"{name} [nccl{world}]: the "
              f"{label} fit's (replays, captures, host reads) "
              f"{run['counts']}, expected {want}")
        check(run["launches"] == ref["launches"]
              and run["comm"] == ref["comm"],
              f"{name} [nccl{world}]: the {label} fit's launches "
              f"{run['launches']} and (all-reduce, halo) calls and bytes "
              f"{run['comm']}, the eager twin's {ref['launches']} and "
              f"{ref['comm']}")
    if halo:
        check(not torch.equal(outs["other V"][0].to_local(),
                              outs["warm"][0].to_local()),
              f"{name}: the fit on another V gave the first V's W")
    torch.backends.cudnn.deterministic = False
    del outs, first
    solver.compiled_cache_clear()
    if world == 1:
        runs["single warm"] = par_single_warm(name, inp, kw)
    else:  # the ranks' agreement on the loop's path, alone, a fit
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            comm.agree_min(mesh, 3)
        runs["agree"] = {"ms": 1e3 * (time.perf_counter() - t0) / 20}
    return runs


def par_drift(name, inp, kw, twice, world):
    """The halo ``conv`` mode's run-to-run drift under cuDNN's default
    algorithms, from two eager fits ``twice`` of case ``name`` at fit
    keywords ``kw``: whether they differ, the largest difference of each
    factor (W, H; the EM's Z) between them and, on one rank, of each from
    the single-card fit of the same problem (the model's ``fit``, the
    static engine), each relative to the factor's largest value, as the
    halo fits' agreement with the single-card fit (par_check) measures it,
    and within its RTOL."""
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    def local(v):
        return v.to_local() if hasattr(v, "to_local") else v

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    keys = ("W", "H", "Z") if PAR_CASES[name][0] == "siplca" else ("W", "H")
    fits = [{k: local(v) for k, v in zip(keys, out)} for out in twice]
    out = {"eager twice differ": not all(
        torch.equal(local(a), local(b)) if torch.is_tensor(local(a))
        else a == b for a, b in zip(*twice)),
        "between": {k: rel(fits[1][k], fits[0][k]) for k in keys}}
    if world == 1:  # the rank's blocks are the whole factors
        m = (plca_from_numpy if "Z" in keys else nmf_from_numpy)(
            {k: inp[k] for k in keys}, "cuda")
        m.fit(torch.from_numpy(inp["V"]).cuda(),
              **{k: v for k, v in kw.items() if k != "mode"})
        ref = {k: getattr(m, k).detach() for k in keys}
        out["vs single"] = [{k: rel(f[k], ref[k]) for k in keys}
                            for f in fits]
        worst = max(max(d.values()) for d in out["vs single"])
        check(worst <= RTOL, f"{name}: a conv-mode fit under cuDNN's "
              f"default algorithms is off the single-card fit by "
              f"{out['vs single']} (the halo fits' bar {RTOL})")
    return out


def destroy_group(tag):
    """``torch.distributed.destroy_process_group()`` with no cache clear
    before it (C12: the call drops the group's compiled fits itself); a
    rank still in the call after TEARDOWN_S seconds prints its stack and
    exits with an error, which fails the run (``spawn_ranks``).  Returns
    the call's seconds."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.dump_traceback_later(TEARDOWN_S, exit=True)
    t0 = time.perf_counter()
    try:
        dist.destroy_process_group()
    finally:
        faulthandler.cancel_dump_traceback_later()
    return time.perf_counter() - t0


def par_regroup(par, name, world, rank, workdir, mesh):
    """Across cards: a halo case's cold compiled fit, then every rank
    destroys the process group with the fit's entry still in the cache
    (C12: the call drops it; :func:`destroy_group`), starts a new one and
    makes the mesh again, and the same fit runs cold on the new group (the
    halo shift's pair connections made anew): bit for bit the first.
    Returns the new mesh."""
    import faulthandler

    import torch.distributed as dist

    from pytorch_nmf_tpu_torch.ops import graphs, solver

    kind, shape, kw = PAR_CASES[name]
    kw = dict(kw, max_iter=PAR_COMPILED_ITERS[kind], tol=0)
    mode = kw.pop("mode", None)
    inp = par_inputs(name, world)
    f = (par.halo._sharded_deconv_fit if kind == "deconv"
         else par.halo._sharded_siplca_fit)
    args = (inp["V"], inp["W"], inp["H"]) + ((inp["Z"],) if "Z" in inp
                                             else ())
    def holding():  # the entries that hold a group's collectives
        return sum(1 for e in list(solver._CACHE.entries.values())
                   if e.groups)

    outs = []
    solver.compiled_cache_clear()
    for i in range(2):
        if i:
            held = holding()
            dist.barrier()
            s = destroy_group(f"{name} [nccl{world}]")
            faulthandler.dump_traceback_later(PAR_TIMEOUT_S - 60)
            check(held >= 1 and holding() == 0,
                  f"{name} [nccl{world}]: {held} entries held the group, "
                  f"{holding()} after destroy_process_group")
            print(f"{name} [nccl{world}] rank {rank}: destroy_process_group "
                  f"with the fit's entry cached returned in {s:.3f} s, "
                  f"{held} entry dropped", flush=True)
            par.distributed.initialize(
                "file://" + os.path.join(workdir, f"store-regroup{world}"),
                world, rank, backend="nccl", timeout_s=PAR_TIMEOUT_S)
            mesh = par.make_mesh({"seq": world}, "cuda")
        captures = graphs._Graphs.captures
        outs.append(f(*args, mesh, len(shape[4]), mode=mode, **kw))
        check(graphs._Graphs.captures - captures == 1,
              f"{name} [nccl{world}]: the fit on the "
              f"{'new' if i else 'first'} group did not capture once")
    check(all(torch.equal(a.to_local(), b.to_local()) if hasattr(
        a, "to_local") else a == b for a, b in zip(*outs)),
        f"{name} [nccl{world}]: the fit on the new group differs")
    return mesh


def par_single_warm(name, inp, kw):
    """The single-card fit of case ``name``'s whole problem at fit keywords
    ``kw`` on this card, run twice on one card V (the second a hit of the
    fits' cache): the second's ms/iteration by CUDA events."""
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    kind = PAR_CASES[name][0]
    kw = {k: v for k, v in kw.items() if k not in ("model_axis", "mode")}
    if kind == "sparse":
        set_tier("ell")  # the sharded path's engine
        V = par_sparse(inp, "cuda")
    else:
        V = torch.from_numpy(inp["V"]).cuda()
    for _ in range(2):
        m = (plca_from_numpy({k: inp[k] for k in ("W", "H", "Z")}, "cuda")
             if kind in ("plca", "siplca") else
             nmf_from_numpy({k: inp[k] for k in ("W", "H")}, "cuda"))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = m.fit(V, **kw)
        end.record()
        torch.cuda.synchronize()
    if kind == "sparse":
        set_tier(None)
    n = int(out[0] if isinstance(out, tuple) else out)
    return {"n_iter": n, "ms_per_iter": start.elapsed_time(end)
            / par_iters(name, n)}


def par_routed(par, name, world, backend, mesh, ctr, path):
    """Case ``name`` through the model API on this rank: the model made
    from the case's inputs on the card, ``model.fit`` on ``shard_target``
    DTensors placed as the explicit fit takes them (the rows over "data",
    and the columns over "model" where the case has it; the trailing axis
    over "seq"), beside the explicit fit on the full arrays from the
    model's start, each timed by CUDA events around the whole call, with
    its peak memory (``max_memory_allocated`` from a reset) and its
    launches.  Over 2 or more ranks the layout routes: the explicit fit
    the route calls is spied (called once), the routed factors, their
    placements and ``n_iter`` are the explicit fit's bit for bit, the
    launches the same, and a halo fit reads its block of V without a
    gather.  On one rank the route declines, as JAX's does on one device:
    no explicit fit is called, and the factors (whole) are saved under
    ``path`` for the parent to hold to its single-card fit.  Over NCCL,
    PAR_ROUTED_WARM's cases then fit a fresh model twice on the same
    DTensor at PAR_COMPILED_ITERS iterations, the second on its own
    DTensor factors: a hit of the fits' cache, (replays, captures, host
    reads) (1, 0, 1)."""
    from pytorch_nmf_tpu_torch.ops import graphs, solver
    from pytorch_nmf_tpu_torch.parallel.sharded import placements
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy
    import torch.distributed as dist

    kind, shape, kw = PAR_CASES[name]
    kw = {k: v for k, v in kw.items() if k != "mode"}
    model_axis = kw.pop("model_axis", None)
    inp = par_inputs(name, world)
    em = kind in ("plca", "siplca")
    names = ("W", "H", "Z") if em else ("W", "H")
    halo = kind in ("deconv", "siplca")
    nd = len(shape[4]) if halo else 0

    def model():
        make = plca_from_numpy if em else nmf_from_numpy
        return make({k: inp[k] for k in names}, "cuda")

    V = par.shard_target(inp["V"], mesh, placements(
        mesh, {1 + nd: "seq"} if halo else {0: "data", 1: model_axis}))
    start = [getattr(model(), k).detach() for k in names]

    def explicit():
        if kind == "nmf":
            return par.sharded_nmf_fit(inp["V"], *start, mesh,
                                       model_axis=model_axis, **kw)
        if kind == "plca":
            return par.sharded_plca_fit(inp["V"], *start, mesh, **kw)
        f = (par.halo._sharded_deconv_fit if kind == "deconv"
             else par.halo._sharded_siplca_fit)
        return f(inp["V"], *start, mesh, nd, **kw)

    def timed(fn):
        """``fn()`` from an empty cache (cold, as the explicit call on new
        full arrays is): (its output, ms, its peak memory above what was
        allocated before it, its launches)."""
        solver.compiled_cache_clear()
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero(ctr)
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        out = fn()
        end_ev.record()
        torch.cuda.synchronize()
        return (out, start_ev.elapsed_time(end_ev),
                torch.cuda.max_memory_allocated() - base, read(ctr))

    # the route's explicit fit, and the halo fits' gathers of V, spied
    module, fn_name = PAR_ROUTES[kind]
    module = getattr(par, module)
    routed_fn, gather = getattr(module, fn_name), par.halo.full_array
    seen = {"calls": 0, "v_gathers": 0}

    def spy(*args, **kwargs):
        seen["calls"] += 1
        return routed_fn(*args, **kwargs)

    def spy_gather(x):
        seen["v_gathers"] += tuple(x.shape) == tuple(inp["V"].shape)
        return gather(x)

    def routed():
        m = model()
        setattr(module, fn_name, spy)
        par.halo.full_array = spy_gather
        try:
            out = m.fit(V, **kw)
        finally:
            setattr(module, fn_name, routed_fn)
            par.halo.full_array = gather
        return out, [getattr(m, k).detach() for k in names]

    # in turns: explicit, routed, routed, explicit
    runs = [timed(f) for f in (explicit, routed, routed, explicit)]

    def factors(i):
        return runs[i][0][1] if i in (1, 2) else runs[i][0][:len(names)]

    for a, b in ((0, 3), (1, 2)):  # each fit's two runs: the same
        check(runs[a][3] == runs[b][3] and all(
            torch.equal(x.to_local(), y.to_local())
            for x, y in zip(factors(a), factors(b))),
            f"{name} [{backend}{world}]: two runs of the "
            f"{'routed' if a else 'explicit'} fit differ")
    fitted, out_e, launches_r = factors(1), factors(0), runs[1][3]
    n_e = int(runs[0][0][3] if em else runs[0][0][2])
    n_r = int(runs[1][0][0][0] if em else runs[1][0][0])
    routes = world > 1
    got = {"routes": routes, "n_iter": n_r, "explicit_n_iter": n_e,
           "calls": seen["calls"], "v_gathers": seen["v_gathers"],
           "ms_per_iter": [runs[i][1] / par_iters(name, n_r) for i in (1, 2)],
           "explicit_ms_per_iter": [runs[i][1] / par_iters(name, n_e)
                                    for i in (0, 3)],
           "peak_mib": [runs[i][2] / 2**20 for i in (1, 2)],
           "explicit_peak_mib": [runs[i][2] / 2**20 for i in (0, 3)],
           "launches": {k: int(v) for k, v in launches_r.items()},
           "hgrad_small": launches_r["hgrad"].small,
           "explicit_launches": {k: int(v) for k, v in runs[0][3].items()}}
    check(all(hasattr(p, "to_local") for p in fitted),
          f"{name} [{backend}{world}]: the model's factors after a fit on a "
          f"DTensor are not DTensors")
    if routes:
        check(seen["calls"] == 2, f"{name} [{backend}{world}]: the model "
              f"API called {fn_name} {seen['calls']} times in two fits")
        check(not seen["v_gathers"], f"{name} [{backend}{world}]: the "
              f"routed halo fit gathered V")
        check(n_r == n_e and all(
            list(p.placements) == list(q.placements)
            and torch.equal(p.to_local(), q.to_local())
            for p, q in zip(fitted, out_e)), f"{name} [{backend}{world}]: "
            f"the routed fit differs from the explicit fit")
        check(got["launches"] == got["explicit_launches"],
              f"{name} [{backend}{world}]: the routed fit launched "
              f"{got['launches']}, the explicit fit "
              f"{got['explicit_launches']}")
    else:
        check(seen["calls"] == 0, f"{name} [{backend}{world}]: a one-rank "
              f"mesh routed to {fn_name}")
        torch.save({k: p.to_local().cpu() for k, p in zip(names, fitted)},
                   path)
    del out_e, fitted, runs
    if backend == "nccl" and name in PAR_ROUTED_WARM:
        solver.compiled_cache_clear()
        kw2 = dict(kw, max_iter=PAR_COMPILED_ITERS.get(kind, 50))
        m = model()
        m.fit(V, **kw2)  # cold: two eager chunks, the capture, a replay
        before = (graphs._Graphs.replays, graphs._Graphs.captures,
                  solver._read.reads, solver.compiled_cache_info()["hits"])
        dist.barrier()
        torch.cuda.synchronize()
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        out_w = m.fit(V, **kw2)
        end_ev.record()
        torch.cuda.synchronize()
        ms_w = start_ev.elapsed_time(end_ev)
        counts = [a - b for a, b in zip((
            graphs._Graphs.replays, graphs._Graphs.captures,
            solver._read.reads, solver.compiled_cache_info()["hits"]),
            before)]
        hits = counts.pop()
        check(hits == 1 and counts == [1, 0, 1], f"{name} "
              f"[{backend}{world}]: the second fit on the model's own "
              f"DTensor factors counted {hits} cache hits and (replays, "
              f"captures, host reads) {counts}, not a hit (1, 0, 1)")
        n_w = int(out_w[0] if em else out_w)
        got["warm"] = {"counts": counts, "n_iter": n_w,
                       "ms_per_iter": ms_w / par_iters(name, n_w)}
        del m
        solver.compiled_cache_clear()
    return got


def par_rank(rank, world, backend, workdir, names):
    """One rank: every case of ``names`` through the sharded fits; writes
    its factors' local blocks and a report (``n_iter``, the kernels'
    launches, ms/iteration by CUDA events, the collectives' calls, bytes
    and ms) under ``workdir``.  A rank that crashes prints its Python
    stack (``faulthandler``), as does one still running a minute before
    the ranks' time limit."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()
    faulthandler.dump_traceback_later(PAR_TIMEOUT_S - 60)
    os.environ["PNT_NMFD_AUTOTUNE"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pytorch_nmf_tpu_torch import parallel as par
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.parallel import comm

    tag = f"{backend}{world}"
    check(torch.cuda.is_available(), f"rank {rank} finds no card")
    par.distributed.initialize(
        "file://" + os.path.join(workdir, f"store-{tag}"), world, rank,
        backend=backend, timeout_s=PAR_TIMEOUT_S)
    load_all()  # the parent's build: loads, compiles nothing
    ctr = counters(fm, D)
    comm.stats.timed = True
    from pytorch_nmf_tpu_torch.ops import autotune

    seen = par_mode_spy(par.halo, ctr)
    meshes, report = {}, {}
    for i, name in enumerate(names):
        kind, _, kw = PAR_CASES[name]
        if name in PAR_TUNED:  # the default tuning rule: above 1e9 MACs
            os.environ.pop("PNT_NMFD_AUTOTUNE", None)
            autotune.clear_cache()
        else:
            os.environ["PNT_NMFD_AUTOTUNE"] = "0"
        seen.clear()
        axis = "seq" if kind in ("deconv", "siplca") else "data"
        axes = ((axis, world),) + ((("model", 1),) if "model_axis" in kw
                                   else ())
        if axes not in meshes:
            meshes[axes] = par.make_mesh(dict(axes), "cuda")
        mesh = meshes[axes]
        inp = par_inputs(name, world)
        if i == 0:  # warm-up: the card's libraries, the group's first calls
            par_fit(par, name, inp, mesh, max_iter=2)
        dist.barrier()
        zero(ctr)
        comm.stats.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = par_fit(par, name, inp, mesh)
        end.record()
        torch.cuda.synchronize()
        n = int(out["n_iter"])
        tuning = seen.get("launches", {})
        launches = {k: v - tuning.get(k, 0) for k, v in read(ctr).items()}
        report[name] = {
            "n_iter": n, "launches": launches,
            "hgrad_small": launches["hgrad"].small,
            # the mode's resolution (rank 0's timing, rank 1's wait) aside
            "ms_per_iter": (start.elapsed_time(end)
                            - 1e3 * seen.get("resolve_s", 0.0))
            / par_iters(name, n),
            "comm": comm.stats.summary(),
            "transport": comm.comm_for(mesh, axis).transport,
            "device": torch.cuda.current_device(),
            "mode": seen.get("mode"), "resolve_s": seen.get("resolve_s"),
            # the halo tuner's table (rank 0 alone times)
            "tuner_ms": {"|".join(map(str, key)): {
                m: 1e3 * t for m, t in ms.items()}
                for key, ms in autotune._MEASURED.items()
                if str(key[1]).startswith("halo")}}
        blocks = {k: v.to_local().cpu() for k, v in out.items()
                  if hasattr(v, "to_local") and (k == "H" or rank == 0)}
        torch.save(blocks, os.path.join(workdir, f"{name}-{tag}-r{rank}.pt"))
        del out, blocks
    # the model API on DTensor targets, at the static per-shard mode
    os.environ["PNT_NMFD_AUTOTUNE"] = "0"
    for name in names:
        if name in PAR_ROUTED:
            kind, _, kw = PAR_CASES[name]
            axis = "seq" if kind in ("deconv", "siplca") else "data"
            axes = ((axis, world),) + ((("model", 1),) if "model_axis" in kw
                                       else ())
            report[name]["routed"] = par_routed(
                par, name, world, backend, meshes[axes], ctr, os.path.join(
                    workdir, f"routed-{name}-{tag}-r{rank}.pt"))
    if backend == "nccl":  # the compiled fits: cold, warm, new V, eager
        for name in names:
            kind, _, kw = PAR_CASES[name]
            if kind in PAR_COMPILED_KINDS:
                axis = "seq" if kind in ("deconv", "siplca") else "data"
                axes = ((axis, world),) + ((("model", 1),)
                                           if "model_axis" in kw else ())
                dist.barrier()
                report[name]["compiled"] = par_compiled(
                    par, name, world, meshes[axes], ctr)
        if "nmfd_b1" in names:  # one rank too: C12 showed across cards
            par_regroup(par, "nmfd_b1", world, rank, workdir,
                        meshes[(("seq", world),)])
            report["nmfd_b1"]["regrouped"] = True
    with open(os.path.join(workdir, f"report-{tag}-r{rank}.json"), "w") as f:
        json.dump(report, f)
    # the compiled fits' entries (captured NCCL kernels of the group) still
    # cached: the call drops them (C12)
    dist.barrier()
    destroy_group(f"rank {rank} [{tag}]")


def spawn_ranks(backend, world, names, workdir):
    """Start ``world`` rank processes (``spawn``), wait for every one;
    a rank that raises or dies raises here, one that hangs past
    PAR_TIMEOUT_S is killed and raises."""
    import torch.multiprocessing as mp

    for store in (f"store-{backend}{world}", f"store-regroup{world}"):
        if os.path.exists(os.path.join(workdir, store)):
            os.remove(os.path.join(workdir, store))  # a killed run's keys
    ctx = mp.start_processes(par_rank, (world, backend, workdir, names),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"the {backend} ranks hung past {PAR_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def par_single(ns, name, inp, part=False):
    """The port's single-card fit of case ``name``'s whole problem (or, with
    ``part``, of rank 0's block alone), same engine, same start:
    ``(factors, n_iter, ms/iteration)`` by CUDA events."""
    kind, shape, kw = PAR_CASES[name]
    kw = {k: v for k, v in kw.items() if k not in ("model_axis", "mode")}
    if part:
        inp = dict(inp)
        if kind == "sparse":
            M_loc = shape[0]
            keep = inp["idx"][0] < M_loc
            inp.update(idx=inp["idx"][:, keep], vals=inp["vals"][keep],
                       shape=np.array([M_loc, shape[1]]), H=inp["H"][:M_loc])
        elif kind in ("nmf", "plca"):
            inp.update(V=inp["V"][:shape[0]], H=inp["H"][:shape[0]])
        else:
            L, T = shape[5], shape[4][-1]
            inp.update(V=inp["V"][..., :L], H=inp["H"][..., :L - T + 1])
    cuda = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in inp.items() if k in ("V",)}
    if kind in ("plca", "siplca"):
        m = ns.plca_from_numpy({k: inp[k] for k in ("W", "H", "Z")}, "cuda")
    else:
        m = ns.nmf_from_numpy({k: inp[k] for k in ("W", "H")}, "cuda")
    V = par_sparse(inp, "cuda") if kind == "sparse" else cuda["V"]
    if kind == "sparse":
        set_tier("ell")  # the sharded path's engine
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = m.fit(V, **kw)
    end.record()
    torch.cuda.synchronize()
    if kind == "sparse":
        set_tier(None)
    n = int(out[0] if isinstance(out, tuple) else out)
    factors = {k: getattr(m, k).detach() for k in ("W", "H", "Z")
               if hasattr(m, k)}
    return factors, n, start.elapsed_time(end) / par_iters(name, n)


def par_loss(ns, name, inp, f):
    """The final loss of factors ``f`` on case ``name``'s whole target."""
    from pytorch_nmf_tpu_torch.ops import recon

    kind, shape, kw = PAR_CASES[name]
    if kind == "sparse":
        from pytorch_nmf_tpu_torch.ops import sparse as S

        return split_loss(S, par_sparse(inp, "cuda"), f["W"], f["H"],
                          kw["beta"])
    V = torch.from_numpy(inp["V"]).cuda()
    with torch.no_grad():
        if kind in ("nmf", "plca"):
            W = f["W"] * f["Z"] if kind == "plca" else f["W"]
            WH = f["H"] @ W.T
        else:
            nd = len(shape[4])
            W = recon.scaled_kernel(f["W"], f["Z"], nd) if "Z" in f else f["W"]
            WH = getattr(recon, f"deconv{nd}d")(f["H"], W)
        if kind in ("plca", "siplca"):
            return float(ns.kl_div(WH * V.sum(), V))
        return float(ns.beta_div(WH, V, kw["beta"]))


def par_check(ns, name, backend, world, workdir, single, card):
    """Hold one case's ranks to the single-card fit (factors and final
    loss within 1e-4 relative, the same ``n_iter`` on every rank and in the
    single fit) and to their exact launches; print its times and traffic.
    Returns the launches summed over the ranks."""
    kind, shape, kw = PAR_CASES[name]
    tag = f"{backend}{world}"
    reps = []
    for r in range(world):
        with open(os.path.join(workdir, f"report-{tag}-r{r}.json")) as fh:
            reps.append(json.load(fh)[name])
    blocks = [torch.load(os.path.join(workdir, f"{name}-{tag}-r{r}.pt"))
              for r in range(world)]
    inp = par_inputs(name, world)
    key = (name, world)
    if key not in single:
        par_single(ns, name, inp)  # warm-up: the timed run is the second
        ref, n_ref, ms_ref = par_single(ns, name, inp)
        _, _, ms_part = par_single(ns, name, inp, part=True)
        single[key] = (ref, n_ref, ms_ref, ms_part, par_loss(ns, name, inp,
                                                             ref))
    ref, n_ref, ms_ref, ms_part, loss_ref = single[key]
    n_iters = [rep["n_iter"] for rep in reps]
    check(len(set(n_iters)) == 1, f"{name} [{tag}]: n_iter differs across "
          f"ranks: {n_iters}")
    check(n_iters[0] == n_ref, f"{name} [{tag}]: n_iter {n_iters[0]}, the "
          f"single-card fit {n_ref}")
    dim = -1 if kind in ("deconv", "siplca") else 0
    got = {"W": blocks[0]["W"].cuda(),
           "H": torch.cat([b["H"] for b in blocks], dim=dim).cuda()}
    if "Z" in ref:
        got["Z"] = blocks[0]["Z"].cuda()
    errs = {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
            for k in ref}
    loss = par_loss(ns, name, inp, got)
    errs["loss"] = abs(loss - loss_ref) / abs(loss_ref)
    bad = {k: e for k, e in errs.items() if not e <= RTOL}
    check(not bad, f"{name} [{tag}]: off the single-card fit by {bad}")
    modes = [rep["mode"] for rep in reps]
    mode = modes[0]
    if kind in ("deconv", "siplca"):
        # forced, tuned (a kernel mode on the card), or the static "fused"
        want_mode = kw.get("mode", "fused")
        check(len(set(modes)) == 1 and (
            mode in ("fused", "fused_w") if name in PAR_TUNED
            else mode == want_mode), f"{name} [{tag}]: the ranks ran the "
            f"per-shard modes {modes}")
    want = dict(zip(("fused_contractions", "fused_beta_loss", "hgrad",
                     "wgrad"), par_expected(name, n_iters[0], mode)))
    for r, rep in enumerate(reps):
        check(rep["launches"] == want, f"{name} [{tag}] rank {r}: launches "
              f"{rep['launches']}, expected {want}")
    if name in PAR_TUNED:
        tables = [rep["tuner_ms"] for rep in reps]
        check(tables[0] and not any(tables[1:]), f"{name} [{tag}]: the "
              f"tuner's tables by rank {tables} (rank 0 alone times)")
        print(f"phase 3, parallel [{tag}]: {name} resolved per-shard mode "
              f"by rank {modes} (rank 0 timed, then broadcast; first "
              f"resolution {reps[0]['resolve_s']:.3f} s on rank 0, "
              f"{reps[1]['resolve_s']:.3f} s on rank 1, waiting); rank 0's "
              f"tuner ms/iteration of the local problem "
              f"{json.dumps(tables[0])} [{card}]", flush=True)
    iters = par_iters(name, n_iters[0])
    traffic = "; ".join(
        f"{kindc} {c['calls'] / iters:g} calls, {c['bytes'] / iters:.0f} B"
        + (f", {c['ms'] / iters:.3f} ms per iteration"
           if c["timed_calls"] == c["calls"] else
           f", {c['ms'] / max(c['timed_calls'], 1):.3f} ms a call over its "
           f"{c['timed_calls']} eager calls (those a graph replays untimed)")
        for kindc, c in reps[0]["comm"].items() if c["calls"])
    print(f"phase 3, parallel [{reps[0]['transport']}, world {world}, ranks "
          f"on cuda:{sorted({rep['device'] for rep in reps})}]: {name}"
          + (f" (per-shard mode {mode})" if mode else "") +
          f" n_iter {n_iters[0]} on every rank and alone; off the single-card "
          f"fit by " + ", ".join(f"{k} {e:.2g}" for k, e in errs.items())
          + f"; launches per rank B1 {want['fused_contractions']}, B2 "
          f"{want['fused_beta_loss']}, B3 {want['hgrad']}, B4 "
          f"{want['wgrad']} (as predicted); ms/iteration per rank "
          + ", ".join(f"{rep['ms_per_iter']:.3f}" for rep in reps)
          + f" (whole calls), single card: whole problem {ms_ref:.3f}, one "
          f"rank's block {ms_part:.3f}; rank 0's traffic: {traffic} [{card}]",
          flush=True)
    if "compiled" in reps[0]:
        par_compiled_line(name, tag, reps, card)
    out = {k: world * v for k, v in want.items()}
    out["hgrad"] = Count(out["hgrad"], sum(rep["hgrad_small"] for rep in reps))
    for rep in reps:  # the compiled runs' launches, per run
        for run in rep.get("compiled", {}).values():
            for k, v in run.get("launches", {}).items():
                out[k] += v
    return out


def par_routed_check(name, backend, world, workdir, single, card):
    """Print case ``name``'s model-API fits (par_routed; each rank checked
    its own against the explicit fit where the layout routes), hold the
    one-rank group's declined fits to the single-card fit of par_check
    (factors within 1e-4 relative, the same ``n_iter``) and their launches
    to the explicit path's kernels (each launched, or not, as there).
    Returns the routed fits' launches summed over the ranks."""
    kind = PAR_CASES[name][0]
    tag = f"{backend}{world}"
    reps = []
    for r in range(world):
        with open(os.path.join(workdir, f"report-{tag}-r{r}.json")) as fh:
            reps.append(json.load(fh)[name]["routed"])
    got = reps[0]
    ref, n_ref = single[(name, world)][:2]
    if got["routes"]:
        verdict = (f"routed to {PAR_ROUTES[kind][1]} (spied: once a fit), "
                   f"bit for bit the explicit fit on every rank"
                   + (", V read as each rank's block, not gathered"
                      if kind in ("deconv", "siplca") else ""))
    else:
        check(got["n_iter"] == n_ref, f"{name} [{tag}] routed: n_iter "
              f"{got['n_iter']}, the single-card fit {n_ref}")
        whole = torch.load(os.path.join(workdir,
                                        f"routed-{name}-{tag}-r0.pt"))
        errs = {k: float((whole[k].cuda() - ref[k]).abs().max()
                         / ref[k].abs().max()) for k in ref}
        bad = {k: e for k, e in errs.items() if not e <= RTOL}
        check(not bad, f"{name} [{tag}] routed: the declined fit off the "
              f"single-card fit by {bad}")
        want = par_expected(name, got["n_iter"], "fused")
        launched = [got["launches"][k] > 0 for k in (
            "fused_contractions", "fused_beta_loss", "hgrad", "wgrad")]
        check(launched == [w > 0 for w in want], f"{name} [{tag}] routed: "
              f"the declined fit launched {got['launches']}; the explicit "
              f"path launches {want}")
        verdict = ("declined (a one-rank mesh, as JAX's route on one "
                   "device): the single-card fit of the gathered V, off "
                   "par_single's by " + ", ".join(
                       f"{k} {e:.2g}" for k, e in errs.items()))
    warm = got.get("warm")

    def pair(xs, digits):
        return "/".join(f"{x:.{digits}f}" for x in xs)

    print(f"phase 3, model API [{tag}]: {name} model.fit on a DTensor target "
          f"{verdict}; n_iter {got['n_iter']}; launches per rank "
          f"{got['launches']}; in turns (explicit, routed, routed, "
          f"explicit; each from an empty cache) ms/iteration per rank routed "
          + ", ".join(pair(rep["ms_per_iter"], 3) for rep in reps)
          + ", the explicit fit on full arrays "
          + ", ".join(pair(rep["explicit_ms_per_iter"], 3) for rep in reps)
          + " (whole calls); peak memory above the allocated before per "
          f"rank routed "
          + ", ".join(pair(rep["peak_mib"], 1) for rep in reps)
          + " MiB, explicit " + ", ".join(pair(rep["explicit_peak_mib"], 1)
                                          for rep in reps) + " MiB"
          + (f"; a second fit on its own DTensor factors (replays, captures, "
             f"host reads) {tuple(warm['counts'])} (a hit), "
             f"{warm['ms_per_iter']:.4f} ms/iteration over "
             f"{warm['n_iter']} iterations" if warm else "")
          + f" [{card}]", flush=True)
    out = {k: sum(rep["launches"][k] for rep in reps) for k in REPLACES}
    out["hgrad"] = Count(out["hgrad"], sum(rep["hgrad_small"] for rep in reps))
    return out


def par_compiled_line(name, tag, reps, card):
    """Print case ``name``'s compiled runs (par_compiled; each rank checked
    its own): counts, launches, all-reduces and shifts per iteration,
    ms/iteration warm, eager, cold, new (or other) V and recaptured beside
    the single-card warm fit, held bytes."""
    runs = reps[0]["compiled"]
    warm = runs["warm"]
    agree = runs.get("agree")
    iters = par_iters(name, warm["n_iter"])
    per_iter = {k: round(v / iters, 3) for k, v in warm["launches"].items()
                if v}
    single = runs.get("single warm")
    traffic = ", ".join(
        f"{kind} {c / iters:g} calls, {b / iters:.0f} B"
        for kind, (c, b) in zip(("all-reduce", "halo"), warm["comm"]))
    timed = [k for k in runs if "ms_per_iter" in runs[k] and k not in (
        "warm", "single warm")]
    chunk = warm.get("chunk_bytes")
    cudnn = runs.get("cudnn")
    drift = ""
    if cudnn:

        def rels(d):
            return ", ".join(f"{k} {v:.3g}" for k, v in d.items())

        drift = (f"two eager fits with its default ones "
                 f"{'differ' if cudnn['eager twice differ'] else 'agree'}, "
                 f"by {rels(cudnn['between'])} between them (largest "
                 f"difference / largest value)")
        if "vs single" in cudnn:
            drift += ", off the single-card fit by " + " and ".join(
                f"({rels(d)})" for d in cudnn["vs single"])
    print(f"phase 3, compiled sharded [{tag}]: {name} n_iter "
          f"{warm['n_iter']}; bit for bit the eager twin on every rank "
          f"({', '.join(k for k in timed if 'eager' not in k)}); (replays, "
          f"captures, host reads) per rank "
          + ", ".join(f"{k} {tuple(runs[k]['counts'])}" for k in runs
                      if "counts" in runs[k])
          + f" (as predicted); per iteration launches {per_iter}, {traffic} "
          f"(the eager twin's); ms/iteration per rank warm "
          + ", ".join(f"{rep['compiled']['warm']['ms_per_iter']:.4f}"
                      for rep in reps)
          + "".join(f", {k} {runs[k]['ms_per_iter']:.4f}" for k in timed)
          + (f"; the single-card warm fit {single['ms_per_iter']:.4f} "
             f"(n_iter {single['n_iter']})" if single else "")
          + (f"; the ranks' path agreement {agree['ms']:.3f} ms a fit (host)"
             if agree else "")
          + f"; the entry holds {warm['held_bytes'] / 2**20:.2f} MiB"
          + (f", its chunk of V (and flat copy) {chunk / 2**20:.2f} MiB"
             if chunk else "")
          + (f"; cuDNN's deterministic algorithms on ({drift})"
             if cudnn else "") + f" [{card}]", flush=True)


def parallel_phase(ns, card):
    """Phase 3, the sharded fits: every case over PAR_WORLD gloo ranks on
    this one card (card tensors staged through pinned host memory, as
    :mod:`pytorch_nmf_tpu_torch.parallel.comm` says), PAR_NCCL_ONE over
    one NCCL rank, and over NCCL across cards where there are several.
    Returns the kernels' launches per path, summed over ranks and groups."""
    workdir = os.path.join(scratch_dir(), "parallel")
    os.makedirs(workdir, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    runs = [("gloo", PAR_WORLD, tuple(PAR_CASES)), ("nccl", 1, PAR_NCCL_ONE)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("nccl", min(n_cards, 4), tuple(PAR_CASES)))
    else:
        print(f"phase 3, parallel: NCCL across cards not run: "
              f"torch.cuda.device_count() is {n_cards} (NCCL takes one rank "
              f"per card) [{card}]", flush=True)
    by_path = {p: dict.fromkeys(REPLACES, 0) for p in
               ("sharded", "sharded_sparse", "halo", "routed")}
    single = {}
    for backend, world, names in runs:
        t0 = time.perf_counter()
        spawn_ranks(backend, world, names, workdir)
        print(f"phase 3, parallel: {world} {backend} rank(s) ran "
              f"{len(names)} cases in {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)
        for name in names:
            got = par_check(ns, name, backend, world, workdir, single, card)
            path = by_path[PAR_PATHS[PAR_CASES[name][0]]]
            for k, v in got.items():
                path[k] += v
            if name in PAR_ROUTED:
                got = par_routed_check(name, backend, world, workdir, single,
                                       card)
                for k, v in got.items():
                    by_path["routed"][k] += v
        torch.cuda.empty_cache()
    return by_path


def namespace():
    """The port's modules and entry points the phases take, as ``ns``."""
    from types import SimpleNamespace

    from pytorch_nmf_tpu_torch import functional, trainer
    from pytorch_nmf_tpu_torch import nmf as models
    from pytorch_nmf_tpu_torch.metrics import beta_div, kl_div
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import projection as P
    from pytorch_nmf_tpu_torch.ops import solver
    from pytorch_nmf_tpu_torch.ops import sparse as S
    from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_generic
    from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA
    from pytorch_nmf_tpu_torch.trainer import BetaMu, SparsityProj
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    return SimpleNamespace(
        models=models, NMF=NMF, PLCA=PLCA, SIPLCA=SIPLCA, F=F, P=P, S=S,
        solver=solver, functional=functional, beta_div=beta_div,
        kl_div=kl_div, plca_from_numpy=plca_from_numpy, BetaMu=BetaMu,
        SparsityProj=SparsityProj, trainer=trainer,
        nmf_from_numpy=nmf_from_numpy,
        nmf_updater_factory_generic=nmf_updater_factory_generic)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA GPU")
    if sys.argv[1:2] == ["--notebook"]:  # one notebook's process
        return notebook_kernel(sys.argv[2])
    ns = namespace()
    from pytorch_nmf_tpu_torch import nmf as models
    from pytorch_nmf_tpu_torch.constants import eps
    from pytorch_nmf_tpu_torch.metrics import beta_div, kl_div
    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.ops import fused_deconv as D
    from pytorch_nmf_tpu_torch.ops import fused_mu as fm
    from pytorch_nmf_tpu_torch.ops import recon, solver
    from pytorch_nmf_tpu_torch.ops import sparse as S
    from pytorch_nmf_tpu_torch.ops._build import load_all
    from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_plain
    from pytorch_nmf_tpu_torch.ops.mu import kl_pos_H, kl_pos_W
    from pytorch_nmf_tpu_torch.ops.solver import get_dense_fit
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy
    from pytorch_nmf_tpu_torch.ops import projection as P

    # the earlier paths run the static engine choice, whose launches per
    # iteration they count; the autotuner's phase sets it to 1 for itself
    os.environ["PNT_NMFD_AUTOTUNE"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is still on")

    # phase 1: the card, the build
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    load_all()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    def stamp(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done [{card}]",
              flush=True)

    # phase 2: kernels against their plain versions
    stats = compare_kernels(fm, kl_pos_W, kl_pos_H)
    stats.update(compare_deconv_kernels(F, D, kl_pos_W))
    stats.update(compare_b3_past_cap(F, D))
    compare_em_adjoints(F, recon, plca_from_numpy, eps, card)
    fit_ms = {}
    proj_stats = compare_projection(P, card, fit_ms)
    print("phase 2: kernels agree with their plain versions", flush=True)
    stamp("phase 2")
    ctr = counters(fm, D)

    # phase 3, this slice: the sharded fits in rank processes sharing the
    # card (their launches are the ranks' own; the parent's single-card
    # references count nowhere: the dense phase zeroes the counts first)
    by_path_parallel = parallel_phase(ns, card)
    stamp("parallel")

    # phase 3: the main path, dense NMF.fit at full width
    M, K, R = MAIN_SHAPE
    V, _, _ = inputs(M, K, R)

    def model():
        return NMF((M, K), R, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(SEED))

    zero(ctr)
    for beta in BETAS:
        m = model()
        before = float(beta_div(m().detach(), V, beta))
        n_b1, n_b2 = fm.fused_contractions.launches, fm.fused_beta_loss.launches
        n_iter = m.fit(V, beta=beta, tol=1e-4, max_iter=DENSE_ITERS)
        torch.cuda.synchronize()
        after = float(beta_div(m().detach(), V, beta))
        d_b1 = fm.fused_contractions.launches - n_b1
        d_b2 = fm.fused_beta_loss.launches - n_b2
        check(m.W.is_cuda and m.H.is_cuda, f"beta={beta}: factors left the card")
        for p in (m.W, m.H):
            check(bool(torch.isfinite(p).all()), f"beta={beta}: non-finite factor")
            check(bool((p >= 0).all()), f"beta={beta}: negative factor")
        check(after < before, f"beta={beta}: loss {before} -> {after} did not fall")
        check((d_b1 > 0) == (beta != 2), f"beta={beta}: {d_b1} B1 launches")
        check((d_b2 > 0) == (beta not in (1, 2)), f"beta={beta}: {d_b2} B2 launches")
        print(f"phase 3: beta={beta} n_iter={n_iter} loss {before:.6g} -> "
              f"{after:.6g}; launches B1 {d_b1}, B2 {d_b2}", flush=True)
    by_path = {"nmf": read(ctr)}
    by_path.update(by_path_parallel)
    stamp("dense fits")
    check(by_path["nmf"]["hgrad"] == by_path["nmf"]["wgrad"] == 0,
          "the dense fits launched B3/B4")

    # phases 3 and 4: kernel path against plain path, 100 iterations each,
    # timed in turns (plain, kernel, kernel, plain)
    for beta in (1, 0.5):
        plain_fit = get_dense_fit(NMF.reconstruct, float(beta), 0.0, 100, True,
                                  True, 0.0, 0.0, False, nmf_updater_factory_plain)
        times = time_fits(
            *nmf_runs(model(), V, dict(beta=beta, tol=0, max_iter=100), plain_fit),
            lambda W, H: float(beta_div(NMF.reconstruct(H, W), V, beta)),
            100, f"NMF beta={beta}")
        fit_ms[f"nmf_{M}x{K}_r{R}_beta{beta}"] = times
        print(f"phase 4: beta={beta} fit ms/iteration at {M}x{K} R={R}: "
              f"kernel {times['kernel']}, plain {times['plain']} [{card}]",
              flush=True)
    del V, m

    stamp("dense timing")
    # phase 3, the deconv path: NMFD/NMF2D/NMF3D fits on B3/B4
    by_path["deconv"] = deconv_fits(models, beta_div, fm, D, card)
    for name, beta in (("NMFD", 1), ("NMFD", 0.5), ("NMF2D", 1), ("NMF3D", 1)):
        N, C, S_out, kernel, Rd = DECONV[name]
        V = deconv_target(name)
        m = deconv_model(name, models)
        recon2 = type(m).reconstruct
        plain_fit = get_dense_fit(
            recon2, float(beta), 0.0, DECONV_ITERS, True, True, 0.0, 0.0, False,
            F.deconv_updater_factory_plain(len(kernel)))
        times = time_fits(
            *nmf_runs(m, V, dict(beta=beta, tol=0, max_iter=DECONV_ITERS),
                      plain_fit),
            lambda W, H: float(beta_div(recon2(H, W), V, beta)),
            DECONV_ITERS, f"{name} beta={beta}")
        shape = "x".join(map(str, (C,) + S_out)) + f"_r{Rd}_k" + "x".join(
            map(str, kernel))
        fit_ms[f"{name.lower()}_{shape}_beta{beta}"] = times
        print(f"phase 4: beta={beta} {name} fit ms/iteration at {shape}: "
              f"kernel {times['kernel']}, plain {times['plain']} [{card}]",
              flush=True)
    del V, m

    # phase 3, this slice: B3's small-rank regime past the former slab cap
    stamp("deconv fits and timing")
    by_path["deconv_past_cap"] = deconv_long_fit(models, beta_div, D, ctr,
                                                 card, fit_ms)
    stamp("NMFD past the cap")
    # phase 3, the PLCA family: SIPLCA/2/3 on B3/B4, dense PLCA's fused
    # E-step on B1; then sparse NMF targets, whose densify tier runs B1
    by_path["siplca"] = siplca_fits(F, recon, solver, plca_from_numpy, kl_div,
                                    ctr, card, fit_ms)
    stamp("SIPLCA")
    by_path["plca_fused"] = plca_fits(plca_from_numpy, kl_div, ctr, card, fit_ms)
    stamp("PLCA")
    # phase 3 and 4, this slice: the fits' chunk as CUDA graphs
    by_path["compiled_fits"] = compiled_fits(ns, ctr, card, fit_ms)
    stamp("compiled fits")
    by_path["stale_target"] = stale_target(ns, ctr, card)
    stamp("C8: a kept fit after a write")
    by_path["sparse_densify"] = sparse_fits(S, nmf_from_numpy, ctr, card, fit_ms)
    stamp("sparse")

    # phase 3: Hoyer on B3/B4 (dense NMF on none), the functional API on
    # the models' kernels, the batched fits and the optimizers on none, and
    # float64 targets; this slice: every projection on P1, the optimizers
    # compiled into CUDA graphs (P1's launches counted by path apart)
    p1_by_path = {}
    by_path["hoyer"] = hoyer_fits(ns, ctr, card, fit_ms, p1_by_path)
    stamp("Hoyer")
    # this slice: the sparse-target Hoyer fit graphed (P1; no B1-B4)
    zero(ctr)
    sparse_hoyer(ns, card, fit_ms, p1_by_path)
    check(not any(read(ctr).values()),
          f"the sparse-target Hoyer fit launched {read(ctr)}")
    stamp("sparse-target Hoyer")
    by_path["functional"] = functional_fits(ns, ctr, card)
    batched_fits(ns, ctr, card, fit_ms)
    trainer_steps(ns, ctr, card, fit_ms, p1_by_path)
    float64_targets(ns, card)
    stamp("functional, batched, optimizers, float64")

    # phase 3, this slice: streaming on B1/B2, checkpointed fits, and the
    # autotuner's choices between the deconv engines
    by_path["streaming"] = streaming_fits(ns, ctr, card, fit_ms)
    stamp("streaming")
    by_path["checkpoint"] = checkpoint_fits(ns, ctr, card, fit_ms)
    stamp("checkpoint")

    # phase 3, this slice: bfloat16 targets (B1/B2's bf16 instances; their
    # launches are counted apart, the float32 reference fits nowhere)
    bf16_stats, bf16_launches = bf16_phase(ns, fm, ctr, kl_pos_W, kl_pos_H,
                                           card, fit_ms)
    stamp("bf16 targets")
    by_path["autotune"] = autotune_cases(ns, ctr, card, fit_ms)
    stamp("autotune")
    # phase 3, this slice: the example scripts, the audio separation at the
    # reference demo's width on B3/B4
    by_path["examples"] = examples_phase(ns, ctr, card, fit_ms, p1_by_path)
    stamp("examples")
    launches = {name: sum(n[name] for n in by_path.values()) for name in REPLACES}
    check(all(isinstance(n["hgrad"], Count) for n in by_path.values()),
          "a path's B3 count lost its small-rank share")
    small_by_path = {p: n["hgrad"].small for p, n in by_path.items()}
    windowed_by_path = {p: n["hgrad"].windowed for p, n in by_path.items()}
    check(launches["hgrad"].small > 0,
          "no path launched B3's small-rank regime")
    check(launches["hgrad"].windowed > 0,
          "no path launched B3's small-rank regime in windows")
    print(f"phase 3: launches by path {json.dumps(by_path)}; of B3's, the "
          f"small-rank regime's {json.dumps(small_by_path)}", flush=True)

    N, C, S_out, kernel, Rd = DECONV["NMFD"]
    for name, st in stats.items():
        at = (f"{M}x{K} R={R}" if name in ("fused_contractions", "fused_beta_loss")
              else DEMO_B3 if name == SMALL_B3
              else "R=16 1025x100000 T=400" if name == B3_CAP
              else f"{C}x{S_out[0]} R={Rd} T={kernel[0]}")
        lib = "none" if st["library_ms"] is None else f"{st['library_ms']:.4f} ms"
        print(f"phase 4: {name} at {at}: kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, library {lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}) [{card}]",
              flush=True)
    fit_ms["compiled_cache"] = solver.compiled_cache_info()
    print(f"the fits' cache over the run: {json.dumps(fit_ms['compiled_cache'])}"
          f" [{card}]", flush=True)
    print(f"whole run {time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
    summary = {"kernels": [
        dict({"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": REPLACES[name], "launches": launches[name],
              "launches_by_path": {p: n[name] for p, n in by_path.items()}},
             **stats[name])
        for name in REPLACES
    ] + [
        dict({"name": SMALL_B3, "route": "cuda", "source": SOURCES["hgrad"],
              "replaces": REPLACES["hgrad"], "regime": "gemm (ranks <= 16)",
              "launches": launches["hgrad"].small,
              "launches_by_path": small_by_path}, **stats[SMALL_B3])
    ] + [
        dict({"name": B3_CAP, "route": "cuda", "source": SOURCES["hgrad"],
              "replaces": REPLACES["hgrad"],
              "regime": "gemm (ranks <= 16) in windows past the slab cap",
              "launches": launches["hgrad"].windowed,
              "launches_by_path": windowed_by_path}, **stats[B3_CAP])
    ] + [
        dict({"name": name, "route": "cuda", "source": SOURCES[base],
              "replaces": REPLACES[base], "launches": bf16_launches[name],
              "launches_by_path": {"bf16": bf16_launches[name]}},
             **bf16_stats[name])
        for name, base in BF16_KERNELS.items()
    ] + [
        dict({"name": PROJ_NAME, "route": "cuda", "source": PROJ_SOURCE,
              "replaces": PROJ_REPLACES, "launches": sum(p1_by_path.values()),
              "launches_by_path": p1_by_path}, **proj_stats)
    ], "fit_ms_per_iter": fit_ms}
    print(card_line(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
