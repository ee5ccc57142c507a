// Fused deconvolutional MU contractions for NMFD/NMF2D/NMF3D.
//
// Replaces the two TPU kernels of pytorch_nmf_tpu/ops/pallas_deconv.py:
//
//   pnt_hgrad  <- hgrad (:392-440, body _hgrad_kernel :357-389)
//   pnt_wgrad  <- wgrad (:504-609, body _wgrad_kernel :443-501)
//
// With the kernel in its flat GEMM layout W2 (K*R, C) (row j*R + r holds
// W[:, r, tau_j]), channels-last cotangents cot (Lp, C) and the
// length-major activation H2 (L_h, R):
//
//   hgrad: out[r, l'] = sum_{j, c} cot[l' + tau_j, c] * W2[j*R + r, c]
//   wgrad: out[j*R + r, c] = sum_l H2[l + off - tau_j, r] * cot[l, c]
//
// (off = 0 when H2 gets T-1 leading zero rows, T-1 when it carries them).
// Both are GEMMs whose second operand is a shifted copy of a small matrix:
// hgrad is G = cot @ W2^T folded by overlap-add, wgrad is P^T @ cot for the
// patch matrix P of the activation.  Neither kernel builds G or P in device
// memory: each block gathers the tiles it needs straight from cot or H2 (the
// flagship's cot is 20 MB and H2 1.8 MB, both inside the 50 MB L2), and at
// small ranks hgrad shares one cotangent window among a group of offsets
// (only its W2 operand is rewritten, once per call, split into TF32 tiles).
// Reads outside an operand are zero, so padded rows need no special case: the
// stacked N > 1 layout and the flat-offset N-D layout put their zero
// separators and pad columns exactly where the wrap-around reads land.
//
// What bounds them on the H100: the flagship (C=1025, L_out=5000, R=88,
// T=400) does about 0.36 TFLOP per cotangent in each kernel against
// 20-144 MB of operands, so both are bound by their operations.  Kept
// f32-accurate, the fastest of those is 3xTF32 on the tensor cores
// (tf32x3.cuh): 165 TFLOP/s effective, about 2 ms per kernel at the
// flagship, against 5.4 ms for f32 FMAs on the CUDA cores (67 TFLOP/s).
// Both kernels run there (wgmma), their tiles copied 16 bytes at a time
// (the wrappers pad the channels to a multiple of 4, fused_mu.aligned_rows:
// C = 1025 is read as 1028); each stage splits the operand tiles into
// TF32 hi/lo once.  Those splits and copies, not the products, take most
// of either kernel's time, and in wgrad they barely overlap the products
// (PERF.md).
//
// Design, and what differs from the TPU kernels:
//
// * The TPU grid runs in order and carries its accumulator across grid
//   steps (pallas_deconv.py:374-387, :478-486).  On Hopper the reduction
//   is split over gridDim.z blocks when the output tiles alone cannot fill
//   the card; each split writes its own partial slab and a second pass sums
//   the slabs in a fixed order.  No atomics: results are reproducible, so
//   the tolerance stop of a fit is too.
// * hgrad's output (R, L_in) is tiny against its (tau, c) reduction of
//   K*C terms (410k at the flagship): its grid is (L_in / 128) x (R / 128)
//   x splits, the reduction flattened to k = j*C + c so a split or a
//   32-deep step may cross from one offset to the next, and C=1028 leaves
//   no ragged step.  l' sits on the wgmma's M dimension and the rank on N,
//   so R = 88 is N = 88 with no padding.
// * At ranks up to 16 a wgmma of R columns would be mostly padding.  There
//   a group of J offsets consecutive along the kernel's innermost axis
//   shares one window of the cotangent: the GEMM G = window . W2_group^T
//   puts the group's J*R (offset, rank) columns on N (up to 128), and the
//   epilogue folds G along its diagonals (hgrad_gemm_kernel).  Offsets in
//   N-D group along the innermost axis, so their windows stay short.  Which
//   regime runs, and its groups, tile and splits, is the wrapper's plan
//   (fused_deconv._hgrad_plan), passed to pnt_hgrad and checked there.
// * wgrad's output (K*R, C) is large and its reduction runs over Lp rows:
//   128 (j, r) rows by 128 channels per block, or 64 channels for the
//   neg/pos cotangent pair, whose two accumulators share every patch
//   fragment.  The (j, r) rows are flattened on the wgmma's M, so small
//   ranks cost no padding; a last channel tile with at most 16 real
//   channels takes the N = 16 wgmma.  Each patch row is gathered at its own
//   shift tau_j (the TPU kernel slices it from the resident activation),
//   so any offset map, 1-D or N-D, runs the same loads.
// * The beta=1 MU epilogue w2 * (relu(acc) + eps) / pos[r] runs after the
//   complete sum: in the main kernel with one split, else in the second pass.
// * geom: tau_j = ((j / (k1 k2)) mod k0) s0 + ((j / k2) mod k1) s1 +
//   (j mod k2) s2, the N-D flat-offset map (_flat_tau,
//   pallas_deconv.py:73-90); 1-D is (k0, k1, k2) = (1, 1, K), s = (0, 0, 1).
// * The port's W2 has exactly K*R rows (no TPU tau-tile padding), so no row
//   of either output is padding.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr int kThreads = 256;  // finish, hgrad's W2 split
// wgrad on the tensor cores
constexpr int kWThreads = 256;  // 2 warpgroups, 64 (j, r) rows each
constexpr int WGM = 128;        // (j, r) rows per block
constexpr int WGK = 32;         // reduction depth (rows l) of one stage
constexpr int WGN = 128;        // most channels of a block, all cotangents
constexpr int WGS = WGM + 8;    // row stride of the raw tiles, 8 mod 32
constexpr int WRAW = 2 * WGK * WGS;    // floats of a raw stage: patch, cot
constexpr int WSPLIT = 2 * WGN * WGK;  // floats of a hi/lo cot buffer
constexpr int kWgradSmemBytes = 4 * (3 * WRAW + 2 * WSPLIT);
// hgrad on the tensor cores
constexpr int kHThreads = 256;  // 2 warpgroups, 64 l' rows each
constexpr int HBM = 128;        // l' rows per block
constexpr int HBK = 32;         // reduction depth of one stage
constexpr int HRN = 128;        // most ranks of a block
constexpr int HRS = HBK + 4;    // row stride of the raw tiles
constexpr int kHgradSmemBytes =
    4 * (2 * (HBM + HRN) * HRS + 2 * 2 * (HBM + HRN) * HBK);
constexpr int kMaxSlabFloats = 1 << 26;  // partial slabs stay under 256 MB
// hgrad at ranks up to 16: a windowed GEMM on the tensor cores
constexpr int kGThreads = 256;  // 2 warpgroups, two m64 tiles of G rows each
constexpr int GM = 256;         // G rows (cotangent rows) of a block
constexpr int GK = 32;          // channels of one stage
constexpr int GAS = GK + 4;     // row stride of the raw cotangent tile
constexpr int GSTAGES = 3;      // the copy ring
constexpr int GMAXN = 128;      // most (offset, rank) columns of G
constexpr int GA = GM * GAS;           // floats of a stage's cotangent tile
constexpr int GB = 2 * GMAXN * GK;     // floats of a stage's hi, lo W2 tiles
constexpr int kGemmSmemBytes = 4 * GSTAGES * (GA + GB);
static_assert(GM * (GMAXN + 1) <= GSTAGES * (GA + GB), "G fits the ring");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float relu(float a) {
  return a < 0.f ? 0.f : a;  // NaN passes through, as torch.relu
}

struct Geom {
  int k1, k2, s0, s1, s2;
  __host__ __device__ __forceinline__ int tau(int j) const {
    return (j / (k1 * k2)) * s0 + ((j / k2) % k1) * s1 + (j % k2) * s2;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes; src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- hgrad --
// On the tensor cores (3xTF32 wgmma, tf32x3.cuh), as the GEMM
// out^T (L_in x R) = A (L_in x KC) . B (KC x R) with A[l', k] =
// cot[l' + tau_j, c] and B[k, r] = W2[j*R + r, c], k = j*C + c.
// Block (bx, by, bz): rows l' in [128 bx, +128), ranks [128 by, +8 NT),
// reduction k in [k_per_split bz, +k_per_split), in HBK = 32-deep stages.
// Warpgroup wg holds l' rows 64 wg + [0, 64) by all 8 NT ranks (R = 88 is
// NT = 11, no padding) in registers.
//
// Per stage the block copies the shifted cotangent rows and the W2 rows
// into raw tiles (cp.async; a thread keeps one k, so one (j, c), and a warp
// reads 4 rows x 8 channels, whole 32-byte sectors), splits them into
// TF32 hi/lo tiles in the wgmma layout (each value once, for every product
// it feeds), and runs 12 wgmmas per warpgroup (4 k8 steps x 3 terms).  The
// hi/lo tiles have two buffers: the split of stage s+1 runs while the
// wgmmas of stage s do.  Each stage's products go to a zeroed run that is
// added to the total with f32 adds (the tensor cores truncate as they
// accumulate).
template <int NT>
__global__ void __launch_bounds__(kHThreads, 1)
    hgrad_kernel(const float* __restrict__ cot, const float* __restrict__ w2,
                 float* __restrict__ dst, int Lp, int C, int R, int L_in,
                 int KC, int k_per_split, Geom g) {
  extern __shared__ __align__(128) float hsmem[];
  // [2][cotangent rows (HBM x HRS), W2 rows (HRN x HRS)] as they land, then
  // [2][A hi, A lo, W hi, W lo] split
  constexpr int RAW = (HBM + HRN) * HRS;
  float* hilo = hsmem + 2 * RAW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int l0 = blockIdx.x * HBM, r0 = blockIdx.y * HRN;
  const int rw = imin(HRN, R - r0);
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = imin(k_begin + k_per_split, KC);
  const int kk = 4 * (tid % 8), row = tid / 8;

  int k = k_begin + kk;  // this thread's reduction index, and its (j, c)
  int j = k / C, c = k % C;
  int tau = g.tau(j);
  auto load = [&](int st) {  // the next stage into raw buffer st
    float* Araw = hsmem + st * RAW;
    float* Wraw = Araw + HBM * HRS;
    const bool kv = k < k_end;
    const float* b = cot + ((size_t)l0 + tau) * C + c;
#pragma unroll
    for (int i = 0; i < HBM / 32; ++i) {
      const int n = row + 32 * i;
      const bool ok = kv && l0 + n + tau < Lp;
      cp_async16(&Araw[n * HRS + kk], ok ? b + (size_t)n * C : cot, ok);
    }
    const float* w = w2 + ((size_t)j * R + r0) * C + c;
#pragma unroll
    for (int i = 0; i < cdiv(8 * NT, 32); ++i) {  // the 8 NT rank rows
      const int m = row + 32 * i;
      const bool ok = kv && m < rw;  // zero past R
      if (m < 8 * NT)
        cp_async16(&Wraw[m * HRS + kk], ok ? w + (size_t)m * C : w2, ok);
    }
    cp_async_commit();
    k += HBK;
    c += HBK;
    if (c >= C) {
      do {
        c -= C;
        ++j;
      } while (c >= C);
      tau = g.tau(j);
    }
  };
  // raw tiles -> buf; element e of a split tile is (row, k) = (8 (e / 256)
  // + (e / 4) % 8, 4 ((e / 32) % 8) + e % 4), the no-swizzle layout with
  // 128-byte steps along K and 1024-byte steps between 8-row groups.  All
  // loads come first: the compiler cannot tell the tiles apart, and would
  // otherwise wait out each load-split-store chain before the next load.
  auto raw_at = [](int e) {
    return (8 * (e / 256) + (e / 4) % 8) * HRS + 4 * ((e / 32) % 8) + e % 4;
  };
  auto split = [&](int st, float* buf) {  // raw buffer st -> buf
    constexpr int NA = HBM * HBK / kHThreads, NW = 8 * NT * HBK / kHThreads;
    const float* Araw = hsmem + st * RAW;
    const float* Wraw = Araw + HBM * HRS;
    float va[NA], vw[NW];
#pragma unroll
    for (int i = 0; i < NA; ++i) va[i] = Araw[raw_at(tid + kHThreads * i)];
#pragma unroll
    for (int i = 0; i < NW; ++i) vw[i] = Wraw[raw_at(tid + kHThreads * i)];
    float* a = buf;
    float* w = buf + 2 * HBM * HBK;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + kHThreads * i;
      tf32x3::split(va[i], a[e], a[HBM * HBK + e]);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int e = tid + kHThreads * i;
      tf32x3::split(vw[i], w[e], w[HRN * HBK + e]);
    }
    tf32x3::fence_async_smem();
  };

  float total[4 * NT], run[4 * NT];
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) total[i] = run[i] = 0.f;

  constexpr int BUF = 2 * (HBM + HRN) * HBK;  // floats of one hi/lo buffer
  // stage t is copied into raw buffer t % 2 two stages ahead, and split
  // into hi/lo buffer t % 2 while the wgmmas of stage t-1 run
  const int steps = cdiv(k_end - k_begin, HBK);
  if (steps > 0) load(0);
  if (steps > 1) load(1);
  if (steps > 0) {
    if (steps > 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    split(0, hilo);
    __syncthreads();
    if (steps > 2) load(0);
  }
  for (int s = 0; s < steps; ++s) {
    const float* buf = hilo + (s & 1) * BUF;
    const float* ahi = buf + wg * 64 * HBK;  // this warpgroup's 64 rows
    const float* alo = ahi + HBM * HBK;
    const float* whi = buf + 2 * HBM * HBK;
    const float* wlo = whi + HRN * HBK;
    tf32x3::fence_operand(run);
    tf32x3::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HBK / 8; ++ks) {
      const int o = 64 * ks;  // two core matrices along K
      tf32x3::wgmma<NT>(run, tf32x3::desc(ahi + o, 128, 1024),
                        tf32x3::desc(wlo + o, 128, 1024), ks > 0);
      tf32x3::wgmma<NT>(run, tf32x3::desc(alo + o, 128, 1024),
                        tf32x3::desc(whi + o, 128, 1024), 1);
      tf32x3::wgmma<NT>(run, tf32x3::desc(ahi + o, 128, 1024),
                        tf32x3::desc(whi + o, 128, 1024), 1);
    }
    tf32x3::wgmma_commit();
    if (s + 1 < steps) {  // the next stage is split while the wgmmas run
      if (s + 2 < steps) cp_async_wait<1>();  // stage s+2 may stay in flight
      else cp_async_wait<0>();
      __syncthreads();  // both warpgroups are done with stage s-1's buffer
      split((s + 1) & 1, hilo + ((s + 1) & 1) * BUF);
      __syncthreads();
      if (s + 3 < steps) load((s + 1) & 1);
    }
    tf32x3::wgmma_wait<0>();
    tf32x3::fence_operand(run);
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) total[i] += run[i];
  }

  float* out = dst + (size_t)blockIdx.z * R * L_in;  // slab bz, or the output
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + 64 * wg + 16 * (warp % 4) + gid + 8 * (q / 2);
      const int r = r0 + 8 * n + 2 * tig + q % 2;
      if (r < R && l < L_in) out[(size_t)r * L_in + l] = total[4 * n + q];
    }
}

// ---------------------------------------------------- small-rank hgrad --
// Ranks up to 16 (the plan is fused_deconv._hgrad_plan), on the tensor
// cores (3xTF32 wgmma) as a windowed GEMM with a diagonal fold.  A group of
// J offsets j0 .. j0+J-1, consecutive along the kernel's innermost axis
// (tau_j = tau_j0 + (j - j0) s2), shares one window of the cotangent:
//
//   G[m, (jj, r)] = sum_c cot[l0 + tau_j0 + m, c] * W2[(j0 + jj) R + r, c]
//   out[r, l0 + l'] = sum_jj G[l' + jj s2, (jj, r)],   l' in [0, bm)
//
// with m in [0, GM) on the wgmma's M, the group's J R columns (jj, r) on N
// (N = 8 NT in {32, 64, 96, 128}: at most 7 columns of rank padding), and
// bm = GM - (J - 1) s2.
// Block (bx, by, bz): output columns [bm bx, +bm), group by, channel stages
// [sper bz, +sper) of GK = 32 channels; it writes slab (by, bz) of its
// columns, and finish() sums the slabs in a fixed order (no atomics).
// Warpgroup wg holds G rows 128 wg + [0, 128) as two m64 tiles of f32
// accumulators.  A block's whole run of at most sper stages (17 at most:
// 204 wgmmas) stays in one accumulator, so the tensor cores' truncation
// costs under 2.5e-5 of the value; the slabs are f32 sums.
//
// What bounds it: 2 R L_in K C operations against (Lp + K R + R L_in) C
// floats, operations at every rank (11.3 GFLOP and 25.5 MB at the reference
// demo, R = 3).  Both operands are K-major (c contiguous), as TF32 wgmma
// takes them, so neither needs a transposing pass: a first kernel splits
// W2 once per call into hi/lo tiles in the wgmma layout, one pair a (group,
// stage), zero past the group and past C; each stage then copies its
// cotangent rows (16-byte cp.async, zero past Lp) and its W2 tiles into a
// ring three stages deep, and each lane reads its A fragments from the raw
// cotangent rows and splits them in registers as it reads (row stride GAS =
// 4 mod 32: conflict-free).  The wgmmas of each 8-channel step are one
// commit group, and up to four stay in flight across the stages.  The
// epilogue stores G in shared memory (row stride N + 1: the fold's lanes
// read consecutive rows) and sums each output along its diagonal in the
// order jj = 0..J-1.
template <int NT>
__global__ void __launch_bounds__(kGThreads, 1)
    hgrad_gemm_kernel(const float* __restrict__ cot,
                      const float* __restrict__ wsplit, float* __restrict__ dst,
                      int Lp, int C, int R, int L_in, int ld, int J, int bm,
                      int n_stages, int sper, Geom g) {
  constexpr int N = 8 * NT, GS = N + 1;
  extern __shared__ __align__(128) float gsmem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int l0 = blockIdx.x * bm, grp = blockIdx.y;
  const int per_row = cdiv(g.k2, J);  // groups along the innermost axis
  const int a = grp % per_row * J;
  const int len = imin(J, g.k2 - a);  // offsets of this group
  const int t0 = g.tau(grp / per_row * g.k2 + a);
  const int s_begin = blockIdx.z * sper;
  const int steps = imin(sper, n_stages - s_begin);
  const float* wsrc = wsplit + (size_t)grp * n_stages * 2 * N * GK;
  const size_t row0 = (size_t)l0 + t0;  // the cotangent row of G row 0

  auto load = [&](int slot, int s) {  // stage s into ring slot `slot`
    float* A = gsmem + slot * (GA + GB);
    float* B = A + GA;
    const int c0 = s * GK;
#pragma unroll
    for (int i = 0; i < GM * GK / 4 / kGThreads; ++i) {
      const int e = tid + kGThreads * i, m = e / (GK / 4), q = e % (GK / 4);
      const size_t l = row0 + m;
      const int c = c0 + 4 * q;
      const bool ok = l < (size_t)Lp && c < C;
      cp_async16(&A[m * GAS + 4 * q], ok ? cot + l * C + c : cot, ok);
    }
    const float* w = wsrc + (size_t)s * 2 * N * GK;
#pragma unroll
    for (int i = 0; i < 2 * N * GK / 4 / kGThreads; ++i) {
      const int e = 4 * (tid + kGThreads * i);
      cp_async16(&B[e], w + e, true);
    }
    cp_async_commit();
  };

  // the first wgmma of the block writes acc (scale_d = 0): no instruction
  // but a wgmma defines it, so ptxas need not serialize them
  float acc[2][4 * NT];
  tf32x3::FragA f[2][GK / 8];

  // stage s lands in slot s % GSTAGES, copied GSTAGES - 1 stages ahead
#pragma unroll
  for (int p = 0; p < GSTAGES - 1; ++p) {
    if (p < steps) load(p, s_begin + p);
    else cp_async_commit();  // an empty group keeps the count
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<GSTAGES - 2>();  // this thread's copies of stage s
    tf32x3::fence_async_smem();    // ... visible to the wgmmas
    __syncthreads();               // ... and every thread's
    const float* A = gsmem + (s % GSTAGES) * (GA + GB);
    const float* B = A + GA;
#pragma unroll
    for (int t = 0; t < 2; ++t) tf32x3::fence_operand(acc[t]);
    // One commit group a k8 step: a step's fragments are read and split
    // while the tensor cores run the steps before, into registers that the
    // group four back read, once it is done; a fence orders them before
    // the step's wgmmas.  So the tensor cores run on across the stages,
    // and stage s-1's slot is free once every warp has waited out its last
    // group, at the last step.
#pragma unroll
    for (int ks = 0; ks < GK / 8; ++ks) {
      tf32x3::wgmma_wait<GK / 8 - 1>();
      if (ks == GK / 8 - 1) {
        __syncthreads();
        if (s + GSTAGES - 1 < steps)
          load((s + GSTAGES - 1) % GSTAGES, s_begin + s + GSTAGES - 1);
        else
          cp_async_commit();  // an empty group keeps the count
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float* p =
            A + (128 * wg + 64 * t + 16 * (warp % 4) + gid) * GAS + 8 * ks + tig;
        f[t][ks] = tf32x3::frag_a(p[0], p[8 * GAS], p[4], p[8 * GAS + 4]);
      }
      tf32x3::wgmma_fence();
      const float* bh = B + 64 * ks;  // two core matrices along K
      const float* bl = bh + N * GK;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        tf32x3::wgmma<NT>(acc[t], f[t][ks].hi, tf32x3::desc(bl, 128, 1024),
                          (s | ks) != 0);
        tf32x3::wgmma<NT>(acc[t], f[t][ks].lo, tf32x3::desc(bh, 128, 1024), 1);
        tf32x3::wgmma<NT>(acc[t], f[t][ks].hi, tf32x3::desc(bh, 128, 1024), 1);
      }
      tf32x3::wgmma_commit();
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) tf32x3::fence_operand(acc[t]);
  }
  tf32x3::wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < 2; ++t) tf32x3::fence_operand(acc[t]);
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  float* G = gsmem;  // [GM][GS]
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) {
      const int m = 128 * wg + 64 * t + 16 * (warp % 4) + gid + 8 * ((i % 4) / 2);
      G[m * GS + 8 * (i / 4) + 2 * tig + i % 2] = acc[t][i];
    }
  __syncthreads();
  float* out = dst + (size_t)(blockIdx.y * gridDim.z + blockIdx.z) * R * ld;
  for (int e = tid; e < R * bm; e += kGThreads) {
    const int r = e / bm, i = e % bm, l = l0 + i;
    if (l >= L_in) continue;
    float v = 0.f;
    for (int jj = 0; jj < len; ++jj) v += G[(i + jj * g.s2) * GS + jj * R + r];
    out[(size_t)r * ld + l] = v;
  }
}

// W2 (K R, C) -> the small-rank hgrad's B tiles: for each (group, stage)
// the hi tile then the lo tile of N x GK floats, element (n, k) at
// (n / 8) 256 + (k / 4) 32 + (n % 8) 4 + k % 4 (the no-swizzle K-major
// layout of tf32x3.cuh: 8-row groups 1024 bytes apart, core matrices 128
// bytes apart along K).  Column n = jj R + r of a group is offset
// j0 + jj; zero past the group and past C.
__global__ void hgrad_split_w_kernel(const float* __restrict__ w2,
                                     float* __restrict__ wsplit, int C, int R,
                                     int J, int N, int n_stages, int groups,
                                     Geom g) {
  const size_t tile = (size_t)N * GK;
  const size_t total = (size_t)groups * n_stages * tile;
  const int per_row = cdiv(g.k2, J);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(e % GK), n = (int)(e / GK % N);
    const size_t gs = e / tile;  // group * n_stages + stage
    const int s = (int)(gs % n_stages), grp = (int)(gs / n_stages);
    const int a = grp % per_row * J, jj = n / R, c = s * GK + k;
    float v = 0.f;
    if (jj < imin(J, g.k2 - a) && c < C)
      v = w2[((size_t)(grp / per_row * g.k2 + a + jj) * R + n % R) * C + c];
    float* t = wsplit + gs * 2 * tile;
    const int o = (n / 8) * 256 + (k / 4) * 32 + (n % 8) * 4 + k % 4;
    tf32x3::split(v, t[o], t[tile + o]);
  }
}

// ---------------------------------------------------------------- wgrad --
// On the tensor cores (3xTF32 wgmma, tf32x3.cuh), as the GEMM
// out (K*R x C) = P^T (K*R x Lp) . cot (Lp x C) for each cotangent, with
// P[l, j*R + r] = H2[l + off - tau_j, r].  Block (bx, by, bz): channels
// [BN bx, +BN) of each of the NCOT cotangents (BN = 8 NT), rows m = j*R + r
// in [128 by, +128), l in [l_per_split bz, +l_per_split), in WGK = 32-deep
// stages.  Warpgroup wg holds rows 64 wg + [0, 64) by the BN channels of
// each cotangent in registers: (j, r) is flattened on M, so no rank is
// padding.
//
// Per stage the block copies the patch tile P [k][m] (each row m gathered
// at its own H2 row l + off - tau_j: any offset map, 1-D or N-D) and the
// cotangent rows [k][c] into a raw stage, three stages deep, with 16-byte
// cp.async (patch rows 4 bytes at a time when R % 4 != 0).  A = P^T comes
// from registers: each lane reads its fragment from the raw patch tile and
// splits it into hi/lo as it reads.  TF32 wgmma takes B only K-major, and
// the cotangent rows arrive channel-major, so a transposing pass splits
// them into the hi/lo wgmma layout, two buffers deep.  The issue of a wgmma
// waits for room in the tensor cores' queue (a clock profile found a third
// of each stage spent so; PERF.md), so the split of the next stage runs in
// quarters between the wgmmas.  The raw
// tiles' row stride WGS = 8 mod 32 keeps the split's reads and the
// fragment reads on 32 banks.
// Each stage's products go to a zeroed run that is added to the f32 total
// (the tensor cores truncate as they accumulate).
template <int NT, int NCOT>
__device__ __forceinline__ void wgrad_tile(
    float* smem, const float* __restrict__ h2, const float* __restrict__ cot0,
    const float* __restrict__ cot1, const float* __restrict__ mu_w2,
    const float* __restrict__ mu_pos, float* __restrict__ dst0,
    float* __restrict__ dst1, int L_h, int Lp, int C, int ldc, int R, int KR,
    int off, int l_per_split, int c0, const Geom& g) {
  constexpr int BN = 8 * NT;     // channels of each cotangent
  constexpr int NB = NCOT * BN;  // B rows of the block, cotangent-major
  constexpr int Q = NB / 4;      // 16-byte pieces of a raw cotangent row
  float* split_buf = smem + 3 * WRAW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * WGM;
  const int l_begin = blockIdx.z * l_per_split;
  const int l_end = imin(l_begin + l_per_split, Lp);
  // 16-byte patch copies take 4 consecutive rows m = j*R + r .. r+3 of one
  // offset: R % 4 == 0 and 16-byte aligned H2 rows
  const bool vec = R % 4 == 0 && reinterpret_cast<size_t>(h2) % 16 == 0;

  // a loader copies patch rows am .. am+3 (vec) or am, so its H2 shift is
  // fixed
  const int am = vec ? 4 * (tid % 32) : tid % WGM;
  const bool m_ok = m0 + am < KR;
  const int ar = m_ok ? (m0 + am) % R : 0;
  const int hoff = m_ok ? off - g.tau((m0 + am) / R) : 0;
  auto load = [&](int st, int l0) {  // the stage at l0 into raw stage st
    float* P = smem + st * WRAW;
    float* Cr = P + WGK * WGS;
    if (vec) {
#pragma unroll
      for (int i = 0; i < WGK / 8; ++i) {
        const int k = tid / 32 + 8 * i, l = l0 + k, hr = l + hoff;
        const bool ok = m_ok && l < l_end && hr >= 0 && hr < L_h;
        cp_async16(&P[k * WGS + am], ok ? h2 + (size_t)hr * R + ar : h2, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < WGK / 2; ++i) {
        const int k = tid / WGM + 2 * i, l = l0 + k, hr = l + hoff;
        const bool ok = m_ok && l < l_end && hr >= 0 && hr < L_h;
        cp_async4(&P[k * WGS + am], ok ? h2 + (size_t)hr * R + ar : h2, ok);
      }
    }
    constexpr int NL = (WGK * Q + kWThreads - 1) / kWThreads;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int e = tid + kWThreads * i;
      const int k = e / Q, q = e % Q, l = l0 + k;
      const int c = c0 + 4 * (q % (BN / 4));
      const float* src = q < BN / 4 ? cot0 : cot1;
      const bool ok = l < l_end && c < C;
      if (e < WGK * Q)
        cp_async16(&Cr[k * WGS + 4 * q], ok ? src + (size_t)l * ldc + c : src,
                   ok);
    }
    cp_async_commit();
  };
  // part q (of 4) of the raw cotangent tile of stage st -> hi/lo buffer sb;
  // element e of the split tile is (n, k) = (8 (e / 256) + (e / 4) % 8,
  // 4 ((e / 32) % 8) + e % 4), the no-swizzle layout with 128-byte steps
  // along K and 1024-byte steps between 8-row groups.  All loads come first
  // (the compiler cannot tell the tiles apart).
  constexpr int NE = NB * WGK / kWThreads;  // elements a thread splits
  constexpr int PER = (NE + 3) / 4;
  auto split = [&](int st, float* sb, int q) {
    const float* Cr = smem + st * WRAW + WGK * WGS;
    float v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + kWThreads * (PER * q + i);
      if (PER * q + i < NE)
        v[i] = Cr[(4 * ((e / 32) % 8) + e % 4) * WGS + 8 * (e / 256) +
                  (e / 4) % 8];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + kWThreads * (PER * q + i);
      if (PER * q + i < NE) tf32x3::split(v[i], sb[e], sb[NB * WGK + e]);
    }
  };

  float total[NCOT][4 * NT], run[NCOT][4 * NT];
#pragma unroll
  for (int t = 0; t < NCOT; ++t)
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) total[t][i] = run[t][i] = 0.f;

  // Stage s is copied into raw stage s % 3 three stages ahead, its patch
  // fragments are read when its wgmmas are issued, and its cotangent tile
  // is split into hi/lo buffer s % 2 a quarter at a time between the
  // wgmmas of stage s-1: the issue of a wgmma waits for room in the tensor
  // cores' queue, and the split fills those waits.  (The copies stay after
  // the stage's barrier: between the wgmmas they cost more.)  The split's
  // writes reach the next stage's wgmmas through a proxy fence and the one
  // barrier that ends each stage.
  const int steps = cdiv(l_end - l_begin, WGK);
  for (int s = 0; s < 3 && s < steps; ++s) load(s, l_begin + s * WGK);
  if (steps > 0) {
    if (steps > 2) cp_async_wait<1>();  // stages 0 and 1
    else cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) split(0, split_buf, q);
    tf32x3::fence_async_smem();
    __syncthreads();
  }
  for (int s = 0; s < steps; ++s) {
    // this lane's patch rows and the stage's hi/lo cotangent buffer
    const float* P = smem + (s % 3) * WRAW + 64 * wg + 16 * (warp % 4) + gid;
    const float* sb = split_buf + (s & 1) * WSPLIT;
    float* sb_next = split_buf + ((s + 1) & 1) * WSPLIT;
    const bool next = s + 1 < steps;
    tf32x3::FragA a[WGK / 8];
#pragma unroll
    for (int ks = 0; ks < WGK / 8; ++ks) {
      const float* p = P + (8 * ks + tig) * WGS;
      a[ks] = tf32x3::frag_a(p[0], p[8], p[4 * WGS], p[4 * WGS + 8]);
    }
#pragma unroll
    for (int t = 0; t < NCOT; ++t) tf32x3::fence_operand(run[t]);
    tf32x3::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WGK / 8; ++ks) {
#pragma unroll
      for (int t = 0; t < NCOT; ++t) {
        const float* bh = sb + t * BN * WGK + 64 * ks;  // two K core matrices
        const float* bl = bh + NB * WGK;
        tf32x3::wgmma<NT>(run[t], a[ks].hi, tf32x3::desc(bl, 128, 1024),
                          ks > 0);
        tf32x3::wgmma<NT>(run[t], a[ks].lo, tf32x3::desc(bh, 128, 1024), 1);
        tf32x3::wgmma<NT>(run[t], a[ks].hi, tf32x3::desc(bh, 128, 1024), 1);
      }
      // stage s-1's wgmmas, done before the last barrier, read sb_next
      if (next) split((s + 1) % 3, sb_next, ks);
    }
    tf32x3::wgmma_commit();
    tf32x3::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < NCOT; ++t) {
      tf32x3::fence_operand(run[t]);
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) total[t][i] += run[t][i];
    }
    tf32x3::fence_async_smem();
    if (s + 2 < steps) cp_async_wait<0>();  // stage s+2, for the next split
    // every lane is done with raw stage s % 3 and has split stage s+1
    __syncthreads();
    if (s + 3 < steps) load(s % 3, l_begin + (s + 3) * WGK);
  }

  // The beta=1 epilogue reads the block's (128, BN) tile of mu_w2: copied
  // into the idle shared memory with every copy in flight at once, where
  // 64 dependent loads a thread would each wait out the memory's latency.
  constexpr int MS = BN + 4;  // row stride of the staged tile
  const bool epilogue = mu_w2 != nullptr && gridDim.z == 1;
  if (epilogue) {
    __syncthreads();  // every warp is done with the stages and buffers
    for (int e = tid; e < WGM * BN; e += kWThreads) {
      const int r = e / BN, c = e % BN;
      const bool ok = m0 + r < KR && c0 + c < C;
      cp_async4(&smem[r * MS + c],
                ok ? mu_w2 + (size_t)(m0 + r) * C + c0 + c : mu_w2, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const size_t slab = (size_t)blockIdx.z * KR * C;
  float* dsts[2] = {dst0, dst1};
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) {
    const int r = 64 * wg + 16 * (warp % 4) + gid + 8 * ((i % 4) / 2);
    const int n = 8 * (i / 4) + 2 * tig + i % 2, m = m0 + r, c = c0 + n;
    if (m >= KR || c >= C) continue;
    const size_t o = (size_t)m * C + c;
#pragma unroll
    for (int t = 0; t < NCOT; ++t) {
      float v = total[t][i];
      if (epilogue) v = smem[r * MS + n] * ((relu(v) + kEps) / mu_pos[m % R]);
      dsts[t][slab + o] = v;
    }
  }
}

// The block's channel tile takes the NT instance, or the m64n16 one when at
// most 16 of its channels are real (C = 1025: the last of 9 tiles holds 1).
template <int NT, int NCOT>
__global__ void __launch_bounds__(kWThreads, 1)
    wgrad_kernel(const float* __restrict__ h2, const float* __restrict__ cot0,
                 const float* __restrict__ cot1,
                 const float* __restrict__ mu_w2,
                 const float* __restrict__ mu_pos, float* __restrict__ dst0,
                 float* __restrict__ dst1, int L_h, int Lp, int C, int ldc,
                 int R, int KR, int off, int l_per_split, Geom g) {
  extern __shared__ __align__(128) float wsmem[];
  const int c0 = blockIdx.x * 8 * NT;
  if constexpr (NT > 2) {
    if (C - c0 <= 16) {
      wgrad_tile<2, NCOT>(wsmem, h2, cot0, cot1, mu_w2, mu_pos, dst0, dst1,
                          L_h, Lp, C, ldc, R, KR, off, l_per_split, c0, g);
      return;
    }
  }
  wgrad_tile<NT, NCOT>(wsmem, h2, cot0, cot1, mu_w2, mu_pos, dst0, dst1, L_h,
                       Lp, C, ldc, R, KR, off, l_per_split, c0, g);
}

// second pass of a split reduction: out = sum_s part[s n + i] in the
// order s = 0..S-1, then the optional beta=1 epilogue (row = i / C_row);
// element i of the parts (rows of `cols`) lands in out's row i / cols at
// column i % cols, its rows `ld` apart (a window of hgrad's output)
__global__ void finish_kernel(const float* __restrict__ part,
                              const float* __restrict__ mu_w2,
                              const float* __restrict__ mu_pos,
                              float* __restrict__ out, size_t n, int splits,
                              int C_row, int R, size_t cols, size_t ld) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += part[s * n + i];
    if (mu_w2 != nullptr)
      a = mu_w2[i] * ((relu(a) + kEps) / mu_pos[(i / C_row) % R]);
    out[i / cols * ld + i % cols] = a;
  }
}

cudaError_t finish(const float* part, const float* mu_w2, const float* mu_pos,
                   float* out, size_t n, int splits, int C_row, int R,
                   cudaStream_t stream, size_t cols = 0, size_t ld = 0) {
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  if (cols == 0) cols = ld = n;  // out contiguous
  finish_kernel<<<blocks, kThreads, 0, stream>>>(part, mu_w2, mu_pos, out, n,
                                                 splits, C_row, R, cols, ld);
  return cudaGetLastError();
}

// hgrad's regimes, as fused_deconv._hgrad_plan names them
enum HRegime { kTensorCore = 0, kGemm = 1 };

template <int NT>
cudaError_t launch_hgrad(dim3 grid, cudaStream_t stream, const float* cot,
                         const float* w2, float* dst, int Lp, int C, int R,
                         int L_in, int KC, int kper, const Geom& g) {
  static const cudaError_t configured = [] {  // once per instance
    cudaError_t e = cudaFuncSetAttribute(
        hgrad_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kHgradSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        hgrad_kernel<NT>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (configured != cudaSuccess) return configured;
  hgrad_kernel<NT><<<grid, kHThreads, kHgradSmemBytes, stream>>>(
      cot, w2, dst, Lp, C, R, L_in, KC, kper, g);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_hgrad_gemm(dim3 grid, cudaStream_t stream, const float* cot,
                              const float* wsplit, float* dst, int Lp, int C,
                              int R, int L_in, int ld, int J, int bm,
                              int n_stages, int sper, const Geom& g) {
  static const cudaError_t configured = [] {  // once per instance
    cudaError_t e = cudaFuncSetAttribute(
        hgrad_gemm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGemmSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        hgrad_gemm_kernel<NT>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (configured != cudaSuccess) return configured;
  hgrad_gemm_kernel<NT><<<grid, kGThreads, kGemmSmemBytes, stream>>>(
      cot, wsplit, dst, Lp, C, R, L_in, ld, J, bm, n_stages, sper, g);
  return cudaGetLastError();
}

// Splits of a reduction of `steps` steps whose output has `tiles`
// block tiles of `slab` floats: about four waves of two blocks per SM, at
// least 8 steps per split, slabs under kMaxSlabFloats.
int num_splits(int tiles, int steps, long long slab, int num_sms) {
  int s = cdiv(8 * num_sms, tiles);
  s = imin(s, imax(1, steps / 8));
  s = (int)(s * slab > kMaxSlabFloats ? kMaxSlabFloats / slab : s);
  return imax(s, 1);
}

// per-split extent, a whole number of `unit`s; cdiv(total, per) splits
int per_split(int total, int splits, int unit) {
  return cdiv(cdiv(total, splits), unit) * unit;
}

// the NT instance of wgrad whose channel tile covers C, at most 128
// channels a block over all cotangents (wgmma widths 8 NT: 16, 64, 128)
int wgrad_nt(int C, int n_cots) {
  const int w = imin(C, WGN / n_cots);
  return w <= 16 ? 2 : w <= 64 ? 8 : 16;
}

template <int NT, int NCOT>
cudaError_t launch_wgrad(dim3 grid, cudaStream_t stream, const float* h2,
                         const float* cot0, const float* cot1,
                         const float* mu_w2, const float* mu_pos, float* d0,
                         float* d1, int L_h, int Lp, int C, int ldc, int R,
                         int KR, int off, int lper, const Geom& g) {
  static const cudaError_t configured = [] {  // once per instance
    cudaError_t e = cudaFuncSetAttribute(
        wgrad_kernel<NT, NCOT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWgradSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        wgrad_kernel<NT, NCOT>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (configured != cudaSuccess) return configured;
  wgrad_kernel<NT, NCOT><<<grid, kWThreads, kWgradSmemBytes, stream>>>(
      h2, cot0, cot1, mu_w2, mu_pos, d0, d1, L_h, Lp, C, ldc, R, KR, off,
      lper, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  The plan (regime, nt, group, bm,
// groups, splits, sper) is fused_deconv._hgrad_plan's, checked here:
//  * kTensorCore: hgrad_kernel<nt>, sper HBK-deep steps of k = j C + c a
//    split; groups = 1;
//  * kGemm: hgrad_split_w_kernel into wsplit (groups x cdiv(C, GK) x 2 x
//    8 nt x GK floats), then hgrad_gemm_kernel<nt> over groups of `group`
//    offsets, bm output columns a block, sper GK-channel stages a split; C
//    a multiple of 4 (16-byte rows).
// part holds (groups x splits, R, L_in) floats when that is above 1 and is
// unused otherwise; finish() then sums the slabs in order.  out's rows are
// ldo floats apart: a launch may write a window of L_in columns of a wider
// output (the gemm regime's windows along the output, fused_deconv.
// _hgrad_windows: cot and out offset to the window's first row and column,
// Lp the rows from there); split_w = 0 skips the W2 split pass of a window
// after the first (wsplit holds its tiles).
int pnt_hgrad(const float* cot, const float* w2, float* out, float* part,
              float* wsplit, int Lp, int C, int R, int K, int L_in, int ldo,
              int k0, int k1, int k2, int s0, int s1, int s2, int regime,
              int nt, int group, int bm, int groups, int splits, int sper,
              int split_w, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (Lp < 1 || C < 1 || R < 1 || K < 1 || L_in < 1 || ldo < L_in ||
      splits < 1 || sper < 1 || groups < 1 || k0 * k1 * k2 != K)
    return (int)cudaErrorInvalidValue;
  const Geom g{k1, k2, s0, s1, s2};
  const int slabs = groups * splits;
  float* dst = slabs == 1 ? out : part;
  cudaError_t err = cudaErrorInvalidValue;
  if (regime == kTensorCore) {
    const int steps = cdiv(K * C, HBK);
    if (groups != 1 || cdiv(steps, sper) != splits || ldo != L_in)
      return (int)cudaErrorInvalidValue;
    const dim3 grid(cdiv(L_in, HBM), cdiv(R, HRN), splits);
    const int KC = K * C, kper = sper * HBK;
#define PNT_HGRAD(NT)                                                   \
  err = launch_hgrad<NT>(grid, stream, cot, w2, dst, Lp, C, R, L_in, KC, \
                         kper, g)
    if (nt == 2) PNT_HGRAD(2);
    else if (nt == 4) PNT_HGRAD(4);
    else if (nt == 8) PNT_HGRAD(8);
    else if (nt == 11) PNT_HGRAD(11);
    else if (nt == 12) PNT_HGRAD(12);
    else if (nt == 16) PNT_HGRAD(16);
#undef PNT_HGRAD
  } else if (regime == kGemm) {
    const int n_stages = cdiv(C, GK);
    if (C % 4 || group < 1 || group * R > 8 * nt || wsplit == nullptr ||
        bm != GM - (group - 1) * s2 || bm < 1 ||
        groups != k0 * k1 * cdiv(k2, group) ||
        cdiv(n_stages, sper) != splits || sper > n_stages)
      return (int)cudaErrorInvalidValue;
    if (split_w) {
      const size_t total = (size_t)groups * n_stages * 8 * nt * GK;
      const size_t want = (total + kThreads - 1) / kThreads;
      hgrad_split_w_kernel<<<(int)(want < 8192 ? want : 8192), kThreads, 0,
                             stream>>>(w2, wsplit, C, R, group, 8 * nt,
                                       n_stages, groups, g);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaErrorInvalidValue;
    const dim3 grid(cdiv(L_in, bm), groups, splits);
    const int ld = slabs == 1 ? ldo : L_in;  // out's rows, or a slab's
#define PNT_GEMM(NT)                                                    \
  err = launch_hgrad_gemm<NT>(grid, stream, cot, wsplit, dst, Lp, C, R, \
                              L_in, ld, group, bm, n_stages, sper, g)
    if (nt == 4) PNT_GEMM(4);
    else if (nt == 8) PNT_GEMM(8);
    else if (nt == 12) PNT_GEMM(12);
    else if (nt == 16) PNT_GEMM(16);
#undef PNT_GEMM
  }
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)finish(part, nullptr, nullptr, out, (size_t)R * L_in, slabs,
                     L_in, R, stream, (size_t)L_in, (size_t)ldo);
}

// Splits of the wgrad reduction over Lp, for n_cots cotangents.
int pnt_wgrad_splits(int KR, int C, int Lp, int n_cots, int num_sms) {
  const int tiles = cdiv(C, 8 * wgrad_nt(C, n_cots)) * cdiv(KR, WGM);
  const int s = num_splits(tiles, cdiv(Lp, WGK), (long long)n_cots * KR * C,
                           num_sms);
  return cdiv(Lp, per_split(Lp, s, WGK));
}

// Returns a cudaError_t.  cot1/out1/part1 are null for one cotangent;
// part0/part1 hold (splits, K*R, C) floats when splits > 1.  mu_w2 (K*R, C)
// with mu_pos (R,) selects the beta=1 epilogue (one cotangent).  The
// cotangents' rows are ldc floats apart, ldc a multiple of 4 and the rows
// 16-byte aligned (columns C..ldc are never read).
int pnt_wgrad(const float* h2, const float* cot0, const float* cot1,
              const float* mu_w2, const float* mu_pos, float* out0,
              float* out1, float* part0, float* part1, int L_h, int Lp, int C,
              int ldc, int R, int K, int off, int k0, int k1, int k2, int s0,
              int s1, int s2, int splits, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_cots = cot1 == nullptr ? 1 : 2;
  if (L_h < 1 || Lp < 1 || C < 1 || R < 1 || K < 1 || splits < 1 ||
      ldc < C || ldc % 4 || k0 * k1 * k2 != K ||
      (mu_w2 != nullptr && n_cots != 1))
    return (int)cudaErrorInvalidValue;
  const int KR = K * R;
  const int lper = per_split(Lp, splits, WGK);
  if (cdiv(Lp, lper) != splits) return (int)cudaErrorInvalidValue;
  const Geom g{k1, k2, s0, s1, s2};
  const int nt = wgrad_nt(C, n_cots);
  const dim3 grid(cdiv(C, 8 * nt), cdiv(KR, WGM), splits);
  float* d0 = splits == 1 ? out0 : part0;
  float* d1 = splits == 1 ? out1 : part1;
  cudaError_t err;
#define PNT_WGRAD(NT, NCOT)                                                   \
  err = launch_wgrad<NT, NCOT>(grid, stream, h2, cot0, cot1, mu_w2, mu_pos,   \
                               d0, d1, L_h, Lp, C, ldc, R, KR, off, lper, g)
  if (n_cots == 1) {
    if (nt == 2) PNT_WGRAD(2, 1);
    else if (nt == 8) PNT_WGRAD(8, 1);
    else PNT_WGRAD(16, 1);
  } else {
    if (nt == 2) PNT_WGRAD(2, 2);
    else PNT_WGRAD(8, 2);
  }
#undef PNT_WGRAD
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)KR * C;
  err = finish(part0, mu_w2, mu_pos, out0, n, splits, C, R, stream);
  if (err != cudaSuccess || n_cots == 1) return (int)err;
  return (int)finish(part1, nullptr, nullptr, out1, n, splits, C, R, stream);
}

}  // extern "C"
