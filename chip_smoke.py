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
  each tier forced), and 131072×65536 at 0.1% (rank 64), past the densify
  budget, where the ELL tier is chosen;
* Hoyer ``sparse_fit`` at β=2: dense ``NMF`` at 5168×1025 rank 88 with
  ``sW=0.5`` (the JAX bench's row; no MU kernel, as there), and ``NMFD`` at
  the flagship with ``sW=0.5`` and with ``sW=sH=0.5``, whose gradients run
  B3 and B4 behind autograd (``kernel_adjoint_deconv``): exactly 2 B3 and 1
  B4 launches an iteration, 1 and 1 with both; every projection is one
  launch of the projection kernel P1 (``csrc/hoyer_proj.cu``), exactly one
  per constrained factor and line-search attempt, with no host read; the
  dense fit's launches, device time and idle share an iteration
  (``torch.profiler``);
* the functional API: ``nmf_fit`` (5168×1025, β=0.5) and ``nmfd_fit`` (the
  flagship, β=1) equal ``NMF.fit`` and ``NMFD.fit``, launch for launch;
  ``nmf_fit_batched`` over 16 problems of 1025×400 rank 16 against their
  single fits; the ``BetaMu`` optimizer over the bench's chain
  (``torch.nn.Sequential`` of three ``NMF`` modules, 2048² target, 31
  steps) and ``SparsityProj`` at 5168×1025 (11 steps), compiled into CUDA
  graphs (the default ``jit_compile=True``) against eager from the same
  start: within 1e-5, one replay a ``BetaMu`` step and no host read in its
  ``run``, one replay and one host read a line-search attempt, a closure
  that reads the host refused, ms/step both ways and the graph pools'
  reserved memory; and float64 numpy targets, which warn and fit in
  float32;
* the compiled fits: the single-card dense MU and EM fits replay their
  10-iteration chunk as a CUDA graph from chunk 3 on.  At dense ``NMF``
  5168×1025 R=88 (β ∈ {0.5, 1, 2}), the reference demo's ``NMFD``
  (1×1025×4997, R=3, T=400), the NMFD flagship (the device-bound control),
  the NMF2D and NMF3D rows, dense ``PLCA`` 5168×1025 R=88 (fused E-step)
  and the SIPLCA, SIPLCA2 and SIPLCA3 rows: 100 iterations at ``tol=0``
  through the model's ``fit`` (graphed) and through ``get_dense_fit`` or
  ``get_plca_fit`` with ``_graph=False`` (eager), timed in turns (graphed,
  eager, eager, graphed), each with exactly its B1-B4 launches, 8 replays
  (graphed) and one host read a chunk; the replayed chunks' ms/iteration
  (CUDA events around the replays) and their device time; chunk 1's time
  and the capture's host time (the capture runs right after chunk 2 is
  enqueued); the
  peak device memory above the factors both ways; the device time an
  iteration and the card's idle share both ways (``torch.profiler``,
  30-iteration fits); factors within 1e-6 of eager at ``tol=0`` and with
  the same ``n_iter`` at ``tol=1e-4``; and a fit whose updater reads the
  host refused on the card;
* ``streaming_nmf_fit`` with V in host memory: 5168×1025 (rank 88, β ∈ {1,
  0.5}) in 6 blocks of 1024 rows, exactly 2 B1 launches a block an
  iteration and one B2 a block a loss evaluation at β=0.5, equal to the
  in-memory ``NMF.fit`` within 1e-4; and a 1 GiB 65536×4096 target (rank
  64, β=1, 8 blocks): ms/iteration, the host-to-card rate and the share of
  the copies' time a kernel overlaps (``torch.profiler``);
* ``checkpointed_fit``: NMF 5168×1025 β=0.5 in two sessions of 50
  iterations, and the NMFD flagship at β=1 in segments of 10 (one B3 and
  one B4 an iteration), each equal to the uninterrupted fit;
* bfloat16 targets (a capacity knob: V held at half width on the card,
  factors and arithmetic float32): B1 (both sides, β=1 with and without
  the epilogue, β=0.5) and B2 (β=0.5) reading a bfloat16 V at 5168×1025
  R=88 against their plain versions, and timed beside the float32 kernels;
  ``NMF.fit`` with a bfloat16 host V at β ∈ {1, 0.5, 2} within 1e-4 of the
  float32 fit on the rounded V, with its ``n_iter`` and exactly its B1/B2
  launches, every one the bfloat16 instance's; ``nmf_fit``; the peak device
  memory of a β=1 fit at 65536×4097 R=64 from a host V (30 iterations, the
  third chunk a graph replay), bfloat16 at most 0.6 of float32's;
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
  run its choice); one NCCL rank runs the dense and NMFD β=1 cases; NCCL
  across cards runs every case where there are several.  Each case agrees
  with the single-card fit of the whole problem (W, the assembled H and the
  final loss within 1e-4 relative, the same ``n_iter`` and per-shard mode
  on every rank), each rank launches exactly the kernels its code and mode
  imply, and the ranks' ms/iteration and their collectives' calls, bytes
  and ms an iteration are printed beside the single-card fits of the whole
  problem and of one rank's block;
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
  with 2 gloo ranks sharing the card); and the Hoyer projection's overflow
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
SPARSE_BIG_ITERS = 10
SPARSE_ENV = ("PNT_SPARSE_DENSIFY", "PNT_SPARSE_ELL")
DENSE_ITERS = 100  # the β sweep's max_iter (tol=1e-4)
# Hoyer: dense NMF at MAIN_SHAPE (bench.py:711-733) and the NMFD flagship,
# β=2; per-iteration losses compared over the first HOYER_TRACE iterations
HOYER_DENSE_ITERS = 20
HOYER_NMFD_ITERS = 6
HOYER_TRACE = 5
HOYER_CASES = (("sW", dict(sW=0.5), (2, 1)),  # (B3, B4) launches/iteration
               ("sW+sH", dict(sW=0.5, sH=0.5), (1, 1)))
FUNC_NMF_ITERS = 50
FUNC_NMFD_ITERS = 10
# the batched fit: 16 short spectrogram excerpts, (B, M, K, R)
BATCH = (16, 1025, 400, 16)
BATCH_ITERS = 50
# the BetaMu chain of bench.py:742-786 against a 2048² target
CHAIN = ((2048, 256), 128, (512, 256), (2048, 512))
BETAMU_STEPS = 30
SPARSITY_STEPS = 10
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
    ``hgrad_r_le_16``).  It compares as the plain count, and sums and
    differences of counts carry it along."""

    def __new__(cls, n, small=0):
        c = super().__new__(cls, n)
        c.small = small
        return c

    def __add__(self, other):
        return Count(int(self) + int(other),
                     self.small + getattr(other, "small", 0))

    __radd__ = __add__

    def __sub__(self, other):
        return Count(int(self) - int(other),
                     self.small - getattr(other, "small", 0))


def zero(ctr):
    for fn in ctr.values():
        fn.launches = 0
        if hasattr(fn, "launches_gemm"):
            fn.launches_gemm = 0


def read(ctr):
    return {name: Count(fn.launches, fn.launches_gemm)
            if hasattr(fn, "launches_gemm") else fn.launches
            for name, fn in ctr.items()}


def restore(ctr, counts):
    """Sets the wrappers' counts back to ``counts`` (a :func:`read`)."""
    for k, v in counts.items():
        ctr[k].launches = int(v)
        if isinstance(v, Count):
            ctr[k].launches_gemm = v.small


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

    def per_iter(self):
        """``(span, busy)`` ms an iteration of the replayed chunks."""
        torch.cuda.synchronize()
        ev, iters = self.events, 10 * len(self.events) // 2
        busy = sum(a.elapsed_time(b) for a, b in zip(ev[::2], ev[1::2]))
        return ev[0].elapsed_time(ev[-1]) / iters, busy / iters


def compiled_cell(ns, label, name, shape, kw, ctr, card):
    """One compiled-fits cell (module docstring); returns its record."""
    from pytorch_nmf_tpu_torch.ops import fast_plca, graphs

    solver = ns.solver
    V, m = compiled_problem(ns, name, shape)
    plca = "PLCA" in name
    cls = type(m)
    params = [getattr(m, k) for k in ("W", "H", "Z") if hasattr(m, k)]
    init = [p.detach().clone() for p in params]
    engine = fast_plca.plca_em_engine_fused if name == "PLCA" else None

    def graphed(tol, iters):  # the user's entry point, the default path
        for p, x in zip(params, init):
            p.data.copy_(x)
        out = m.fit(V, tol=tol, max_iter=iters, **kw)
        return (out[0] if plca else out), [p.detach().clone() for p in params]

    def eager(tol, iters):  # the same updates through _graph=False
        x = [t.clone() for t in init]
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

    runs = {"graphed": graphed, "eager": eager}
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


def compiled_measure(ns, label, name, kw, V, runs, ctr, card, Graphs):
    solver = ns.solver
    rec = {"ms_per_iter": {"graphed": [], "eager": []}}

    def gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a, b))

    # chunk 1 (and the initial loss), the first chunk of every fit, after
    # a warm-up
    runs["eager"](0.0, 10)
    _, rec["chunk1_ms"] = events_ms(lambda: runs["graphed"](0.0, 10))
    finals = {}
    for i, how in enumerate(("graphed", "eager", "eager", "graphed")):
        c0, r0, h0 = read(ctr), Graphs.replays, solver._read.reads
        s0 = Graphs.capture_s
        torch.cuda.synchronize()
        # either way the fit then takes its cuBLAS workspaces in the window
        torch._C._cuda_clearCublasWorkspaces()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = replay_marks() if i == 3 else None
        try:
            (n, f), ms = events_ms(lambda: runs[how](0.0, FIT_ITERS))
        finally:
            if marks is not None:
                marks.restore()
        peak = torch.cuda.max_memory_allocated() - base
        d = {k: v - c0[k] for k, v in read(ctr).items()}
        replays, reads = Graphs.replays - r0, solver._read.reads - h0
        want = compiled_expected(name, kw, FIT_ITERS)
        check(n == (FIT_ITERS - 1 if "PLCA" in name else FIT_ITERS),
              f"compiled {label} {how}: n_iter {n}")
        check(d == want, f"compiled {label} {how}: launches {d}, want {want}")
        chunks = FIT_ITERS // 10
        check(replays == (chunks - 2 if how == "graphed" else 0)
              and reads == chunks, f"compiled {label} {how}: {replays} "
              f"replays, {reads} host reads in {chunks} chunks")
        check_factors(f"compiled {label} {how}", *f)
        rec["ms_per_iter"][how].append(ms / FIT_ITERS)
        for key, v in (("peak_gb", peak / 1e9), ("replays", replays),
                       ("host_reads", reads),
                       ("capture_ms", 1e3 * (Graphs.capture_s - s0))):
            rec.setdefault(key, {}).setdefault(how, v)
        rec["launches"] = {k: int(v) for k, v in d.items()}
        finals[how] = f
    # the replayed chunks alone, from the last graphed fit's events: from
    # the first replay's start to the last one's end (the host's read a
    # chunk between them), and the replays' own device time
    rec["replayed_ms_per_iter"], rec["replay_device_ms_per_iter"] = \
        marks.per_iter()
    rec["gap_tol0"] = gap(finals["graphed"], finals["eager"])
    (ng, fg), (ne, fe) = runs["graphed"](FIT_TOL, FIT_ITERS), runs["eager"](
        FIT_TOL, FIT_ITERS)
    rec["gap_tol"] = gap(fg, fe)
    rec["n_iter_tol"] = [int(ng), int(ne)]
    check(ng == ne, f"compiled {label}: tol={FIT_TOL} n_iter graphed {ng}, "
          f"eager {ne}")
    check(rec["gap_tol0"] <= FIT_GAP and rec["gap_tol"] <= FIT_GAP,
          f"compiled {label}: graphed against eager {rec['gap_tol0']}, "
          f"{rec['gap_tol']} at tol={FIT_TOL}")
    for how in ("graphed", "eager"):
        dev = fit_profile(lambda: runs[how](0.0, FIT_PROFILE_ITERS),
                          FIT_PROFILE_ITERS)
        mean = sum(rec["ms_per_iter"][how]) / 2
        rec.setdefault("device_ms_per_iter", {})[how] = dev
        rec.setdefault("idle_share", {})[how] = 1 - dev / mean
    t = rec["ms_per_iter"]
    print(f"phase 4: compiled {label}: ms/iteration graphed "
          f"{t['graphed']}, eager {t['eager']}, the replayed chunks alone "
          f"{rec['replayed_ms_per_iter']:.4f} (their device time "
          f"{rec['replay_device_ms_per_iter']:.4f}); device ms/iteration "
          f"(torch.profiler, {FIT_PROFILE_ITERS}-iteration fits) graphed "
          f"{rec['device_ms_per_iter']['graphed']:.4f}, eager "
          f"{rec['device_ms_per_iter']['eager']:.4f}; the card idle "
          f"{100 * rec['idle_share']['graphed']:.1f}% graphed, "
          f"{100 * rec['idle_share']['eager']:.1f}% eager; replays a fit "
          f"{rec['replays']}, host reads {rec['host_reads']}; launches "
          f"{rec['launches']} (as predicted, both ways); chunk 1 "
          f"{rec['chunk1_ms']:.3f} ms, capture "
          f"{rec['capture_ms']['graphed']:.2f} ms (host); peak above the "
          f"factors graphed "
          f"{rec['peak_gb']['graphed']:.4f} GB, eager "
          f"{rec['peak_gb']['eager']:.4f}; graphed against eager "
          f"{rec['gap_tol0']:.3g} (tol=0), {rec['gap_tol']:.3g} with n_iter "
          f"{ng} both ways (tol={FIT_TOL}) [{card}]", flush=True)
    return rec


def compiled_fits(ns, ctr, card, fit_ms):
    """Phase 3 and 4, this slice: the fits' compiled chunk at every
    COMPILED_CELLS cell (:func:`compiled_cell`), and a fit whose updater
    reads the host refused on the card.  Returns the path's launches."""
    from pytorch_nmf_tpu_torch.ops import fast_nmf

    zero(ctr)
    out = {}
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
            nmf_from_numpy(inits, "cuda").fit(V, beta=beta, tol=0, max_iter=2)
            m = nmf_from_numpy(inits, "cuda")
            _, ms = timed_fit(m, V, beta, SPARSE_ITERS)
            finals[tier] = split_loss(S, V, m.W, m.H, beta)
            fit_ms[f"sparse_{M}x{K}_r{R}_{nnz}nnz_beta{beta}_{tier}"] = ms
            print(f"phase 4: sparse {M}x{K} R={R} {nnz} non-zeros beta={beta} "
                  f"{tier}: {ms:.4f} ms/iteration, final loss "
                  f"{finals[tier]:.7g} [{card}]", flush=True)
        spread = (max(finals.values()) - min(finals.values())) / min(finals.values())
        check(spread <= 1e-4, f"sparse {M}x{K} beta={beta}: tiers disagree {finals}")
        print(f"phase 3: sparse {M}x{K} beta={beta}: the three tiers agree "
              f"(spread {spread:.3g})", flush=True)
    set_tier(None)
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
    calls = []
    ell_neg_grad = S.ell_neg_grad

    def counted(*args, **kwargs):
        calls.append(1)
        return ell_neg_grad(*args, **kwargs)

    finals = {}
    S.ell_neg_grad = counted
    try:
        for tier in ("ell", "gather"):
            set_tier(None if tier == "ell" else "gather")
            m = nmf_from_numpy(inits, "cuda")
            before = split_loss(S, V, m.W, m.H, 1)
            calls.clear()
            _, ms = timed_fit(m, V, 1, SPARSE_BIG_ITERS)
            check((len(calls) == 2 * SPARSE_BIG_ITERS) == (tier == "ell"),
                  f"{M}x{K} {tier}: {len(calls)} ELL reductions")
            finals[tier] = split_loss(S, V, m.W, m.H, 1)
            check(finals[tier] < before, f"{M}x{K} {tier}: the loss did not fall")
            fit_ms[f"sparse_{M}x{K}_r{R}_0.1pct_beta1_{tier}"] = ms
            print(f"phase 4: sparse {M}x{K} R={R} 0.1% beta=1 {tier}: {ms:.4f} "
                  f"ms/iteration, loss {before:.7g} -> {finals[tier]:.7g} [{card}]",
                  flush=True)
    finally:
        S.ell_neg_grad = ell_neg_grad
        set_tier(None)
    rel = abs(finals["ell"] - finals["gather"]) / finals["gather"]
    check(rel <= 1e-4, f"{M}x{K}: ELL and gather disagree {finals}")
    print(f"phase 3: sparse {M}x{K}: ELL and gather agree (rel {rel:.3g})",
          flush=True)
    return launches


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


def batched_fits(ns, ctr, card, fit_ms):
    """Phase 3, ``nmf_fit_batched``: BATCH problems at β ∈ {2, 1}, tol 1e-4,
    each problem's final loss within 1e-4 relative of its single fit through
    the generic engine (the same ``n_iter``, or the cases that differ
    printed); no kernel runs.  Both timed."""
    fn, solver, beta_div = ns.functional, ns.solver, ns.beta_div
    B, M, K, R = BATCH
    rs = np.random.RandomState(SEED)
    V = torch.from_numpy(rs.rand(B, M, K).astype("f") + 0.01).cuda()
    W = torch.from_numpy(rs.rand(B, K, R).astype("f") + 0.1).cuda()
    H = torch.from_numpy(rs.rand(B, M, R).astype("f") + 0.1).cuda()
    zero(ctr)
    for beta in (2, 1):
        (Wb, Hb, nb), ms = events_ms(lambda: fn.nmf_fit_batched(
            V, W, H, beta=beta, tol=1e-4, max_iter=BATCH_ITERS))
        check_factors(f"batched beta={beta}", Wb, Hb)
        single = solver.get_dense_fit(ns.NMF.reconstruct, float(beta), 1e-4,
                                      BATCH_ITERS, True, True, 0.0, 0.0, False,
                                      ns.nmf_updater_factory_generic)
        outs, sms = events_ms(lambda: [single(V[b], W[b].clone(), H[b].clone())
                                       for b in range(B)])
        rels, differ = [], []
        for b, (w, h, n) in enumerate(outs):
            lb = float(beta_div(ns.NMF.reconstruct(Hb[b], Wb[b]), V[b], beta))
            ls = float(beta_div(ns.NMF.reconstruct(h, w), V[b], beta))
            rels.append(abs(lb - ls) / ls)
            if int(nb[b]) != n:
                differ.append(f"problem {b}: n_iter {int(nb[b])} vs {n}, "
                              f"loss ratio {lb / ls:.7g}")
        check(max(rels) <= RTOL, f"batched beta={beta}: loss rel {max(rels):.3g}")
        iters = int(nb.max())
        fit_ms[f"batched_{B}x{M}x{K}_r{R}_beta{beta}"] = {
            "batch_ms": ms, "singles_ms": sms, "max_n_iter": iters}
        print(f"phase 3: nmf_fit_batched {B}x{M}x{K} R={R} beta={beta}: n_iter "
              f"{nb.tolist()}; final losses within {max(rels):.3g} of the single "
              f"fits; " + ("; ".join(differ) or "the same n_iter") +
              f"; batch {ms:.1f} ms ({ms / iters:.4f} ms per batched iteration), "
              f"{B} single fits {sms:.1f} ms [{card}]", flush=True)
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
    MAIN_SHAPE, a first step then SPARSITY_STEPS steps, both ways from the
    same start and float32 step size: W and the loss within COMPILED_RTOL,
    the same step size, one host read per line-search attempt (the eager
    twin's attempts, from its closure calls), the loss falls, W's columns
    at sparseness 0.5.  Prints ms/step both ways (CUDA events), replays and
    host reads per step, and the card's reserved memory before, with the
    compiled entries cached, and after the optimizers and the phase's
    tensors are dropped, when their graphs must be gone too.  Neither runs
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
    models = {how: ns.nmf_from_numpy(start, "cuda") for how in ("compiled", "eager")}
    res, losses, lrs = {}, {}, {}
    for how, m in models.items():
        sp = ns.SparsityProj([{"params": [m.W], "lr": lr}], 0.5,
                             jit_compile=how == "compiled")
        calls = [0]

        def closure(m=m, calls=calls):
            calls[0] += 1
            return ns.beta_div(m(), V, 2)

        losses[how] = [float(closure().detach())]
        _, first = events_ms(lambda: sp.step(closure))
        c0, r0, rp0 = calls[0], T._read_worse.reads, T._Graphs.replays
        _, ms = events_ms(lambda: sp.run(closure, SPARSITY_STEPS))
        attempts = (calls[0] - c0 - SPARSITY_STEPS if how == "eager"
                    else T._read_worse.reads - r0)
        res[how] = dict(first_ms=first, ms_per_step=ms / SPARSITY_STEPS,
                        attempts_per_step=attempts / SPARSITY_STEPS,
                        host_reads_per_step=attempts / SPARSITY_STEPS,
                        replays_per_step=(T._Graphs.replays - rp0) / SPARSITY_STEPS)
        losses[how].append(float(closure().detach()))
        lrs[how] = sp.param_groups[0]["lr"]
        pools += [weakref.ref(e["graphs"]) for e in sp._step_cache.values()]
    check(res["compiled"]["replays_per_step"] == res["compiled"]["attempts_per_step"]
          == res["eager"]["attempts_per_step"] and res["eager"]["replays_per_step"] == 0,
          f"SparsityProj: replays and attempts per step {res}")
    Wc, We = models["compiled"].W.detach(), models["eager"].W.detach()
    gap = rel(Wc, We)
    lgap = abs(losses["compiled"][1] - losses["eager"][1]) / losses["eager"][1]
    check(gap <= COMPILED_RTOL and lgap <= COMPILED_RTOL
          and abs(lrs["compiled"] - lrs["eager"]) <= 1e-6 * lrs["eager"],
          f"SparsityProj: compiled against eager W {gap}, loss {lgap}, step "
          f"{lrs}")
    before, after = losses["compiled"]
    s = col_sparseness(models["compiled"].W)
    check(after < before, f"SparsityProj: loss {before} -> {after}")
    check(float((s - 0.5).abs().max()) <= 1e-3,
          f"SparsityProj: column sparseness {s.tolist()}")
    check_factors("SparsityProj", Wc)
    reserved.append(reserved_now())
    del sp, models, m, Wc, We, V
    gc.collect()
    torch.cuda.empty_cache()
    reserved.append(reserved_now())
    check(len(pools) == 2 and not any(w() for w in pools),
          "the compiled optimizers' graphs outlived them")
    p1["optimizers"] = P.proj_rows.launches - p1_start
    check(p1["optimizers"] > 0, "SparsityProj launched no projection kernel")
    check(not any(read(ctr).values()), f"the optimizers launched {read(ctr)}")
    fit_ms[f"sparsityproj_{M}x{K}_r{R}_s0.5"] = dict(res, rel_gap=gap,
                                                      loss_gap=lgap)
    fit_ms["optimizers_memory_reserved_gb"] = [r / 1e9 for r in reserved]
    print(f"phase 3: SparsityProj {M}x{K} R={R} sparsity 0.5 on W: loss "
          f"{before:.7g} -> {after:.7g} in {1 + SPARSITY_STEPS} steps, column "
          f"sparseness {float(s.min()):.6f}..{float(s.max()):.6f}, step size "
          f"{lr:.4g} -> {lrs['compiled']:.4g}; ms/step compiled "
          f"{res['compiled']['ms_per_step']:.4f} (first step "
          f"{res['compiled']['first_ms']:.1f} ms), eager "
          f"{res['eager']['ms_per_step']:.4f}; line-search attempts (host "
          f"reads)/step {res['compiled']['attempts_per_step']:.2f}, graph "
          f"replays/step {res['compiled']['replays_per_step']:.2f}; compiled "
          f"against eager W {gap:.3g}, loss {lgap:.3g}; P1 launches "
          f"{p1['optimizers']}; memory reserved (GB) before, after BetaMu, "
          f"after SparsityProj, released: "
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
    bfloat16 values), BF16_CAPACITY_ITERS iterations from a host V, in
    float32 (on the rounded values) and in bfloat16.  The peak above what
    was allocated before V reached the card (the model's factors) must be
    at most BF16_PEAK_RATIO of the float32 fit's, and the two final losses
    agree within RTOL."""
    NMF = ns.NMF
    M, K, R = BF16_CAPACITY
    g = torch.Generator().manual_seed(SEED)
    Vb = (torch.rand((M, K), generator=g) + 0.01).bfloat16()
    out = {}
    for tag, X in (("f32", Vb.float()), ("bf16", Vb)):
        m = NMF((M, K), R, device="cuda",
                generator=torch.Generator("cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n, ms = events_ms(lambda: m.fit(X, beta=1, tol=0,
                                        max_iter=BF16_CAPACITY_ITERS))
        peak = torch.cuda.max_memory_allocated() - base
        check_factors(f"capacity {tag}", m.W, m.H)
        out[tag] = (peak, X.numel() * X.element_size(), m.W.detach(),
                    m.H.detach(), ms / n)
        del m, X
    Vr = Vb.float().cuda()
    losses = {tag: float(fm.fused_beta_loss(Vr, o[3], o[2], 1.0))
              for tag, o in out.items()}
    del Vr
    rel = abs(losses["bf16"] - losses["f32"]) / losses["f32"]
    ratio = out["bf16"][0] / out["f32"][0]
    tag = f"capacity NMF.fit {M}x{K} R={R} beta=1"
    for t in ("f32", "bf16"):
        print(f"phase 3: {tag} {t}: V {out[t][1] / 1e9:.3f} GB on the host, "
              f"peak device memory above the factors {out[t][0] / 1e9:.3f} GB,"
              f" {out[t][4]:.2f} ms/iteration (the fit's time, its copy of V "
              f"to the card included) [{card}]", flush=True)
    check(ratio <= BF16_PEAK_RATIO, f"{tag}: bf16 peak {out['bf16'][0]} is "
          f"{ratio:.3f} of the float32 fit's {out['f32'][0]}")
    check(rel <= RTOL, f"{tag}: final loss {losses['bf16']} vs float32 "
          f"{losses['f32']} (rel {rel:.3g})")
    fit_ms[f"capacity_{M}x{K}_r{R}_beta1"] = {
        t: {"peak_bytes": out[t][0], "V_bytes": out[t][1],
            "ms_per_iter_with_copy": out[t][4]} for t in out}
    print(f"phase 3: {tag}: bf16 peak / float32 peak = {ratio:.3f} (at most "
          f"{BF16_PEAK_RATIO}); final loss {losses['bf16']:.7g} vs "
          f"{losses['f32']:.7g} (rel {rel:.3g}) [{card}]", flush=True)


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
    a = ns.NMF(W=W0, H=H0, device="cuda")
    (n1, _), d1 = counted(lambda: (checkpointed_fit(
        a, V, beta=0.5, tol=inf, max_iter=CKPT_EVERY, every=CKPT_EVERY,
        directory=d_nmf), None))
    b = ns.NMF((M, K), R, device="cuda")  # a new session: factors from disk
    (n2, _), d2 = counted(lambda: (checkpointed_fit(
        b, V, beta=0.5, tol=inf, max_iter=2 * CKPT_EVERY, every=CKPT_EVERY,
        directory=d_nmf), None))
    ref = ns.NMF(W=W0, H=H0, device="cuda")
    ref.fit(V, beta=0.5, tol=inf, max_iter=2 * CKPT_EVERY)
    rel = same((b.W, b.H), (ref.W, ref.H))
    tag = f"checkpointed NMF {M}x{K} R={R} beta=0.5"
    check_factors(tag, b.W, b.H)
    check(n1 == CKPT_EVERY and n2 == 2 * CKPT_EVERY and rel <= 1e-6,
          f"{tag}: n_iter {n1}, {n2}; factors {rel:.3g} from the "
          "uninterrupted fit")
    check(d1["fused_contractions"] == d2["fused_contractions"]
          == 2 * CKPT_EVERY, f"{tag}: launches {d1}, {d2}")
    print(f"phase 3: {tag}: sessions of {n1} and {n2 - n1} iterations equal "
          f"the uninterrupted {2 * CKPT_EVERY} (max rel {rel:.3g}); launches "
          f"B1 {d1['fused_contractions']} + {d2['fused_contractions']}, B2 "
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
    fit, at most 1e-5 on both); the audio separation at the CPU test's
    setting above AUDIO_MIN_GAIN dB.  ``multi_device_fit`` starts 2 gloo
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
            if key == "max_rel_delta":
                check(a <= 1e-5 and b <= 1e-5, f"{name}: the sharded fit "
                      f"{a} (card), {b} (CPU) from the single-device fit")
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


def examples_phase(ns, ctr, card, fit_ms):
    """Phase 3, the port's examples (``examples/torch_port/``) at the
    static engine choice: the audio separation at full width, every
    script's ``main`` on the card against the CPU, and the Hoyer
    projection's overflow case.  Returns the path's launch counts."""
    os.environ["PNT_NMFD_AUTOTUNE"] = "0"
    path = audio_full_width(ns, ctr, card, fit_ms)
    zero(ctr)
    example_mains(card)
    c3_on_card(ns, ctr, card)
    return {k: path[k] + v for k, v in read(ctr).items()}


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
# the one-rank NCCL group's cases
PAR_NCCL_ONE = ("nmf_b1", "nmfd_b1")
PAR_PATHS = {"nmf": "sharded", "plca": "sharded", "sparse": "sharded_sparse",
             "deconv": "halo", "siplca": "halo"}


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


def par_rank(rank, world, backend, workdir, names):
    """One rank: every case of ``names`` through the sharded fits; writes
    its factors' local blocks and a report (``n_iter``, the kernels'
    launches, ms/iteration by CUDA events, the collectives' calls, bytes
    and ms) under ``workdir``."""
    import torch.distributed as dist

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
    with open(os.path.join(workdir, f"report-{tag}-r{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(backend, world, names, workdir):
    """Start ``world`` rank processes (``spawn``), wait for every one;
    a rank that raises or dies raises here, one that hangs past
    PAR_TIMEOUT_S is killed and raises."""
    import torch.multiprocessing as mp

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
        f"{kindc} {c['calls'] / iters:g} calls, {c['bytes'] / iters:.0f} B, "
        f"{c['ms'] / iters:.3f} ms per iteration"
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
    out = {k: world * v for k, v in want.items()}
    out["hgrad"] = Count(out["hgrad"], sum(rep["hgrad_small"] for rep in reps))
    return out


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
               ("sharded", "sharded_sparse", "halo")}
    single = {}
    for backend, world, names in runs:
        store = os.path.join(workdir, f"store-{backend}{world}")
        if os.path.exists(store):  # a killed run's rendezvous: stale keys
            os.remove(store)
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
        torch.cuda.empty_cache()
    return by_path


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA GPU")
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
    from pytorch_nmf_tpu_torch import functional
    from pytorch_nmf_tpu_torch.ops import projection as P
    from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_generic
    from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA
    from pytorch_nmf_tpu_torch import trainer
    from pytorch_nmf_tpu_torch.trainer import BetaMu, SparsityProj
    from types import SimpleNamespace

    ns = SimpleNamespace(
        models=models, NMF=NMF, PLCA=PLCA, SIPLCA=SIPLCA, F=F, P=P,
        solver=solver, functional=functional, beta_div=beta_div,
        kl_div=kl_div, plca_from_numpy=plca_from_numpy, BetaMu=BetaMu,
        SparsityProj=SparsityProj, trainer=trainer,
        nmf_from_numpy=nmf_from_numpy,
        nmf_updater_factory_generic=nmf_updater_factory_generic)

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

    # phase 3, the PLCA family: SIPLCA/2/3 on B3/B4, dense PLCA's fused
    # E-step on B1; then sparse NMF targets, whose densify tier runs B1
    stamp("deconv fits and timing")
    by_path["siplca"] = siplca_fits(F, recon, solver, plca_from_numpy, kl_div,
                                    ctr, card, fit_ms)
    stamp("SIPLCA")
    by_path["plca_fused"] = plca_fits(plca_from_numpy, kl_div, ctr, card, fit_ms)
    stamp("PLCA")
    # phase 3 and 4, this slice: the fits' chunk as CUDA graphs
    by_path["compiled_fits"] = compiled_fits(ns, ctr, card, fit_ms)
    stamp("compiled fits")
    by_path["sparse_densify"] = sparse_fits(S, nmf_from_numpy, ctr, card, fit_ms)
    stamp("sparse")

    # phase 3: Hoyer on B3/B4 (dense NMF on none), the functional API on
    # the models' kernels, the batched fits and the optimizers on none, and
    # float64 targets; this slice: every projection on P1, the optimizers
    # compiled into CUDA graphs (P1's launches counted by path apart)
    p1_by_path = {}
    by_path["hoyer"] = hoyer_fits(ns, ctr, card, fit_ms, p1_by_path)
    stamp("Hoyer")
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
    by_path["examples"] = examples_phase(ns, ctr, card, fit_ms)
    stamp("examples")
    launches = {name: sum(n[name] for n in by_path.values()) for name in REPLACES}
    check(all(isinstance(n["hgrad"], Count) for n in by_path.values()),
          "a path's B3 count lost its small-rank share")
    small_by_path = {p: n["hgrad"].small for p, n in by_path.items()}
    check(launches["hgrad"].small > 0,
          "no path launched B3's small-rank regime")
    print(f"phase 3: launches by path {json.dumps(by_path)}; of B3's, the "
          f"small-rank regime's {json.dumps(small_by_path)}", flush=True)

    N, C, S_out, kernel, Rd = DECONV["NMFD"]
    for name, st in stats.items():
        at = (f"{M}x{K} R={R}" if name in ("fused_contractions", "fused_beta_loss")
              else DEMO_B3 if name == SMALL_B3
              else f"{C}x{S_out[0]} R={Rd} T={kernel[0]}")
        lib = "none" if st["library_ms"] is None else f"{st['library_ms']:.4f} ms"
        print(f"phase 4: {name} at {at}: kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, library {lib}, bound "
              f"{st['bound_ms']:.4f} ms ({st['bound_by']}) [{card}]",
              flush=True)
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
