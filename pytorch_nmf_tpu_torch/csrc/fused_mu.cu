// Fused beta-divergence MU contractions and loss for dense NMF, V ~ H W^T.
//
// Replaces the two TPU kernels of pytorch_nmf_tpu/ops/pallas_mu.py:
//
//   pnt_fused_contractions  <- _fused_contractions (:212-299, body :116-186)
//   pnt_fused_beta_loss     <- fused_beta_loss     (:347-380, body :302-344)
//
// Both compute a tile of the reconstruction WH = H W^T on chip, apply the
// beta-specific elementwise map with V, and reduce it: into the (rows, R)
// MU numerator/denominator (contractions) or into one scalar (loss).  WH
// never reaches device memory.
//
// What bounds them on the H100: per entry of V the contraction does R FMAs
// for WH plus R (2R with the denominator) for the contraction, against 4
// bytes of V read once: at R = 88 about 130 FLOP per byte, so the work, not
// HBM, is the bound.  The products have to stay f32-accurate, and the
// fastest f32-accurate arithmetic on the card is 3xTF32 on the tensor cores
// (tf32x3.cuh): 165 TFLOP/s effective, against 67 TFLOP/s of f32 FMA on
// the CUDA cores.
//
// The contraction runs on the tensor cores (wgmma, 3xTF32), in the shape of
// FlashAttention-2: F plays Q, G plays both K and V.
//
// * A block is one warpgroup; it owns 64 rows of F (16 per warp) and loops
//   over 32-row steps of G.  Per step it computes its 64 x 32 tile of WH,
//   maps it to the cotangents in registers, and multiplies them into its
//   (64, 8 NT) accumulators: the rank sits on the wgmma's N, so R = 88 is
//   N = 88 with no padding.
// * Both products take A from registers.  The WH product splits F into
//   hi/lo as each fragment is read from the F tile, which stays whole in
//   shared memory, loaded once per block.  The contraction's A is the
//   cotangent: the accumulator layout gives a lane the WH columns (2 tig,
//   2 tig + 1) of each 8-column tile, and the A layout wants (tig, tig + 4).
//   The sum over g does not care about the order of its 8 terms, so the G
//   operand of the contraction stores row 2 tig at K position tig and
//   2 tig + 1 at tig + 4, and the cotangents never leave registers.
// * G's step tile is split into TF32 hi/lo once, when it lands, into both
//   wgmma layouts it feeds (K = rank for WH, K = g for the contraction).
// * Every tile comes by 16-byte cp.async.  V's rows (K = 1025 floats, 4100
//   bytes) are not 16-byte aligned, so V reaches the card with padded rows
//   (models/_common.target_like, fused_mu.aligned_copy); 4-byte copies made
//   the tile loads half of the kernel's time (PERF.md).
// * V is float32 or bfloat16 (a template parameter on its element type):
//   a bfloat16 target is held at half width on the card, its tile comes in
//   at its own width (8 values per 16-byte copy) and each value is upcast
//   to float32, exactly, where the cotangent or the loss term reads it.
//   Everything after that read is the float32 kernel.
// * Up to 256 ranks the F tile stays resident and the next step's G and V
//   tiles are copied during this step; a block accumulates 128 rank
//   columns (gridDim.z covers the rest, each block recomputing WH).  Wider
//   ranks stream the WH product through 256-column chunks.
// * The cotangents take no branch (fast division, log2 and exp2 for
//   fractional beta), so a thread's 16 of them interleave.

// What stays from the first design:
//
// * One kernel serves both sides.  The factor being updated is F (n_f rows),
//   the other factor G (n_g rows): H side F=H, G=W, V(f, g) = V[f][g]; W
//   side F=W, G=H, V(f, g) = V[g][f].  WH(f, g) = F[f] . G[g] on both sides.
// * The TPU grid runs in order on one core and carries the accumulator
//   across grid steps.  Here a block loops over the G steps itself.  When
//   the F tiles alone cannot fill the card (W side: K=1025 gives 17 tiles
//   for 132 SMs) the G range is split over gridDim.y blocks, each writing
//   its own (n_f, R) partial slab, and a second pass sums the slabs in a
//   fixed order.  No atomics: the result is reproducible, so the tolerance
//   stop of a fit is too.
// * The beta=1 MU epilogue f * (relu(acc) + eps) / mu_pos runs after the
//   complete reduction: in the main kernel when there is one split, else in
//   the second pass.
// * Ragged edges: rows of F or G past their end, rank columns past R and V
//   outside the matrix load as zero, and the cotangent (or loss term) of
//   every entry outside the matrix is forced to zero, so padding never
//   enters a sum (the beta=0 term 1/(0+eps) would).
//
// The loss (B2) is a mode of the same kernel on the H side: the same
// resident F = H tile, G = W split once per step, 16-byte V copies and
// rank-chunked WH product, but each WH entry maps to its loss term in
// registers in place of the cotangents and the contraction.  Each thread
// sums its terms, each block its threads in a fixed-order tree, and a
// second pass the blocks: the result is deterministic, as the tolerance
// stop needs.
//
// The cotangents mirror _cotangent_tiles (pallas_mu.py:76-92) and the loss
// terms _loss_kernel (:318-332): one shared (wh+eps)^(beta-2) for
// fractional beta, 1/(wh+eps) squared at beta=0, no eps at beta=2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr int kThreads = 256;  // the second passes
constexpr int BF = 64;         // F rows per block
// the contraction and the loss on the tensor cores
constexpr int kTcThreads = 128;  // one warpgroup, 16 F rows per warp
constexpr int TBG = 32;          // G rows per step
constexpr int TZR = 128;         // rank columns a block accumulates
constexpr int TRC = 256;         // rank chunk of the WH product

// the V tile of an element type TV: VEC values per 16-byte copy, row strides
// padded by one copy, H side [BF][H], W side [TBG][W]; ELEMS per step
// parity.  The float tile is the larger, and shared memory is sized for it.
template <typename TV>
struct VTile {
  static constexpr int VEC = 16 / (int)sizeof(TV);
  static constexpr int H = TBG + VEC;
  static constexpr int W = BF + VEC;
  static constexpr int ELEMS = BF * H > TBG * W ? BF * H : TBG * W;
};
constexpr int TV_FLOATS = VTile<float>::ELEMS;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);  // exact
}

__device__ __forceinline__ float relu(float a) {
  return a < 0.f ? 0.f : a;  // NaN passes through, as jax.nn.relu / torch.relu
}

// Tile loads copy global memory straight into shared memory with cp.async
// (no staging registers); entries outside the matrix are zero-filled.
// cp_async_wait() completes every copy this thread issued; a
// __syncthreads() after it publishes them to the block.

// 16 bytes, of which the first src_bytes come from src and the rest are 0;
// src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x (ex2.approx: relative error 2^-22.5)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cotangents(float v, float wh, float beta,
                                           float& cn, float& cp) {
  if (beta == 2.f) {
    cn = v;
    cp = wh;
  } else if (beta == 1.f) {
    cn = __fdividef(v, wh + kEps);
    cp = 0.f;
  } else if (beta == 0.f) {
    const float r = __fdividef(1.f, wh + kEps);
    cn = r * r * v;
    cp = r;
  } else {
    // whe > 0, so whe^(beta-2) = 2^((beta-2) log2 whe): no branches, so the
    // 16 cotangents of a thread interleave (powf's special cases serialize
    // them).  The fast division, log2 and exp2 err by about 2^-22
    // (|beta-2| |log2 whe|) relative, under 1e-5.
    const float whe = wh + kEps;
    const float p2 = ex2((beta - 2.f) * __log2f(whe));
    cn = p2 * v;
    cp = p2 * whe;
  }
}

__device__ __forceinline__ float loss_term(float v, float wh, float beta) {
  if (beta == 2.f) {
    const float d = wh - v;
    return 0.5f * d * d;
  }
  if (beta == 1.f) return v * (logf(v + kEps) - logf(wh + kEps)) - v + wh;
  if (beta == 0.f) {
    const float te = v + kEps, ie = wh + kEps;
    return te / ie - logf(te) + logf(ie) - 1.f;
  }
  // ie^(beta-1) and t^beta as 2^(y log2 x), ie^beta = ie^(beta-1) ie: no
  // branches, so a thread's terms interleave (powf's special cases
  // serialize them).  t = 0 (beta > 0) gives 2^-inf = 0.  The accurate
  // log2f and exp2f (1-2 ulp), not B1's approximations: the terms are
  // differences of their powers, and the sum is held to 1e-4.
  const float t = beta < 0.f ? v + kEps : v;
  const float ie = wh + kEps;
  const float ie_bm1 = exp2f((beta - 1.f) * log2f(ie));
  return (exp2f(beta * log2f(t)) + (beta - 1.f) * ie_bm1 * ie -
          beta * t * ie_bm1) /
         (beta * (beta - 1.f));
}

// the kernel may take `bytes` of dynamic shared memory, and prefers the
// largest shared-memory carveout (two or three blocks per SM)
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// ------------------------------------------- the contraction (tensor cores)
//
// Shared memory of a block (floats), for rank chunks of width rcw =
// min(8 cdiv(R, 8), TRC) and a row stride fs = rcw + 4 of the raw tiles:
//   F     [BF][fs]        the F rows (the whole rank when R <= TRC)
//   Graw  [TBG][fs]       the step's G rows as they land
//   GS    hi, lo          G for the WH product: N = the TBG rows, K = rank
//   GO    hi, lo          G for the contraction: N = 8 NT rank columns,
//                         K = the TBG rows (permuted, see contract_kernel)
//   V     [2][TV_FLOATS]  the step's V tile, one per step parity
// GS and GO are in the wgmma no-swizzle layout (tf32x3.cuh): core matrices
// of 8 rows x 4 K, 128-byte steps along K; GS's 8-row groups are rcw * 32
// bytes apart, GO's 1024.

__host__ __device__ inline int tc_rcw(int R) {
  return imin(8 * cdiv(R, 8), TRC);
}

size_t contract_smem_bytes(int R, int NT) {
  const int rcw = tc_rcw(R);
  return sizeof(float) * ((size_t)(BF + TBG) * (rcw + 4) + 2 * TBG * rcw +
                          2 * 8 * NT * TBG + 2 * TV_FLOATS);
}

// rows [row0, row0 + rows) x columns [c0, c0 + width) of a row-major
// (n, R) matrix with 16-byte aligned rows ld floats apart into dst (row
// stride ds), in 16-byte copies; width and c0 are multiples of 8, and
// entries outside the matrix are 0
__device__ __forceinline__ void tc_load(float* dst, int ds,
                                        const float* __restrict__ src,
                                        int row0, int rows, int n, int R,
                                        int ld, int c0, int width) {
  const int q4 = width / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * q4; e += kTcThreads) {
    const int r = e / q4, c = 4 * (e % q4);
    const int valid = imin(4, R - c0 - c);  // floats inside the matrix
    const bool ok = row0 + r < n && valid > 0;
    cp_async16(&dst[r * ds + c],
               ok ? src + (size_t)(row0 + r) * ld + c0 + c : src,
               ok ? 4 * valid : 0);
  }
}

// the (BF, TBG) tile of V at (f0, g0) in V's own orientation (a row of the
// tile runs along V's contiguous axis, g on the H side, f on the W side):
// V(f, g) at V[f ldv + g] on the H side, V[g ldv + f] on the W side, rows
// 16-byte aligned (ldv a multiple of VEC elements); 16-byte copies of VEC
// elements, the ragged edge's copy cut to the elements inside the matrix
template <typename TV>
__device__ __forceinline__ void tc_load_v(TV* Vs, const TV* __restrict__ V,
                                          int f0, int g0, int n_f, int n_g,
                                          int ldv, bool h_side) {
  constexpr int VEC = VTile<TV>::VEC;
#pragma unroll
  for (int k = 0; k < BF * TBG / VEC / kTcThreads; ++k) {
    const int idx = threadIdx.x + k * kTcThreads;
    // a row of the tile runs along V's contiguous axis, in 16-byte chunks
    const int o = h_side ? idx / (TBG / VEC) : idx / (BF / VEC);  // f or g
    const int i = VEC * (h_side ? idx % (TBG / VEC) : idx % (BF / VEC));
    const int o0 = h_side ? f0 : g0, i0 = h_side ? g0 : f0;
    const int valid = imin(VEC, (h_side ? n_g : n_f) - i0 - i);
    const bool ok = o0 + o < (h_side ? n_f : n_g) && valid > 0;
    cp_async16(&Vs[o * (h_side ? VTile<TV>::H : VTile<TV>::W) + i],
               ok ? V + (size_t)(o0 + o) * ldv + i0 + i : V,
               ok ? (int)sizeof(TV) * valid : 0);
  }
}

// Graw (TBG x width, row stride fs) split into GS (hi, lo) and, for the
// rank columns [zc, zc + zw) of the chunk, into GO (hi, lo).  Lane l of a
// warp takes G row 8 q + l / 4 and rank column 4 rq + l % 4, so the GS
// stores of a warp hit 32 banks.  Each quad's four loads come first (the
// compiler cannot tell the tiles apart).
__device__ __forceinline__ void tc_split(float* gs, float* go,
                                         const float* graw, int fs,
                                         int width, int zc, int zw,
                                         int go_size) {
  const int lane = threadIdx.x % 32, gl = lane / 4, kl = lane % 4;
  const int gs_size = TBG * width;
#pragma unroll 2
  for (int rq = threadIdx.x / 32; rq < width / 4; rq += kTcThreads / 32) {
    const int k = 4 * rq + kl, r = k - zc;
    float v[TBG / 8];
#pragma unroll
    for (int q = 0; q < TBG / 8; ++q) v[q] = graw[(8 * q + gl) * fs + k];
#pragma unroll
    for (int q = 0; q < TBG / 8; ++q) {
      float hi, lo;
      tf32x3::split(v[q], hi, lo);
      const int os = q * (8 * width) + rq * 32 + gl * 4 + kl;
      gs[os] = hi;
      gs[gs_size + os] = lo;
      if (r >= 0 && r < zw) {
        // g = 8 q + gl sits at K position p = 8 q + gl / 2 + 4 (gl % 2)
        const int p = 8 * q + gl / 2 + 4 * (gl % 2);
        const int oo = (r / 8) * 256 + (p / 4) * 32 + (r % 8) * 4 + p % 4;
        go[oo] = hi;
        go[go_size + oo] = lo;
      }
    }
  }
  tf32x3::fence_async_smem();
}

// fixed-order tree sum of the N values in red; the result is red[0]
template <int N>
__device__ void block_sum(float* red) {
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
}

// what contract_kernel computes: the numerator, both MU contractions, or the
// loss
enum Mode { kNeg, kNegPos, kLoss };

// out_neg/out_pos: the (n_f, R) outputs when gridDim.y == 1, else the
// (gridDim.y, n_f, R) partial slabs.  kLoss (H side, one rank block) writes
// the block's sum of loss terms to out_neg[blockIdx.y gridDim.x +
// blockIdx.x] instead.  mu_pos (R,) selects the beta=1
// epilogue; it is applied here only when there is one split.  Warp w of the
// warpgroup holds rows f0 + 16 w + [0, 16) of the WH tile and of the
// accumulators (rank columns z0 + [0, 8 NT)), in the mma C layout.
//
// Per step: WH (64 x TBG) = F G^T, one wgmma per k8 of rank and term, A
// from registers (F split as it is read); the cotangents in registers;
// then acc += C G, A from registers again.  A lane holds WH columns
// (2 tig, 2 tig + 1) of each 8-column tile, and an A fragment wants K
// columns (tig, tig + 4): the sum over g does not care about the order of
// its 8 terms, so GO stores G row 2 tig at K position tig and 2 tig + 1 at
// tig + 4, and the cotangents never leave registers.
template <typename TV, int NT, int MODE>
__global__ void __launch_bounds__(kTcThreads, 1)
    contract_kernel(const TV* __restrict__ V, const float* __restrict__ F,
                    const float* __restrict__ G,
                    const float* __restrict__ mu_pos,
                    float* __restrict__ out_neg, float* __restrict__ out_pos,
                    int n_f, int n_g, int R, int ldv, int ldr, int h_side,
                    int tiles_per_split, float beta) {
  constexpr bool POS = MODE == kNegPos, LOSS = MODE == kLoss;
  extern __shared__ __align__(128) float smem[];
  const int rcw = tc_rcw(R), fs = rcw + 4;
  constexpr int GO_SIZE = 8 * NT * TBG;
  float* Fs = smem;
  float* Graw = Fs + BF * fs;
  float* GS = Graw + TBG * fs;
  float* GO = GS + 2 * TBG * rcw;
  constexpr int V_ELEMS = VTile<TV>::ELEMS;
  TV* Vbuf = reinterpret_cast<TV*>(GO + 2 * GO_SIZE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int vsf = h_side ? VTile<TV>::H : 1, vsg = h_side ? 1 : VTile<TV>::W;
  const int f0 = blockIdx.x * BF;
  const int z0 = blockIdx.z * TZR, zw = imin(TZR, R - z0);
  const bool resident = R <= TRC;  // one rank chunk: F loaded once
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = imin(t_begin + tiles_per_split, cdiv(n_g, TBG));
  const float* Fw = Fs + 16 * warp * fs;

  // GO rows past the block's rank columns stay zero
  if (!LOSS)
    for (int e = threadIdx.x; e < 2 * GO_SIZE; e += kTcThreads) GO[e] = 0.f;

  float an[4 * NT], ap[4 * NT], loss = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) an[i] = ap[i] = 0.f;

  if (resident && t_begin < t_end) {
    tc_load(Fs, fs, F, f0, BF, n_f, R, ldr, 0, rcw);
    tc_load(Graw, fs, G, t_begin * TBG, TBG, n_g, R, ldr, 0, rcw);
    tc_load_v(Vbuf, V, f0, t_begin * TBG, n_f, n_g, ldv, h_side);
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int g0 = t * TBG;
    TV* Vs = Vbuf + ((t - t_begin) & 1) * V_ELEMS;
    // WH in two partial sums over alternate k8 steps: the wgmmas into one
    // accumulator wait on each other, two chains keep the tensor cores busier
    float s[4 * (TBG / 8)], s1[4 * (TBG / 8)];
    if (!resident) tc_load_v(Vs, V, f0, g0, n_f, n_g, ldv, h_side);
    for (int rc = 0; rc < R; rc += TRC) {  // one pass when resident
      const int w8 = imin(TRC, 8 * cdiv(R - rc, 8));
      if (!resident) {
        tc_load(Fs, fs, F, f0, BF, n_f, R, ldr, rc, w8);
        tc_load(Graw, fs, G, g0, TBG, n_g, R, ldr, rc, w8);
      }
      cp_async_wait();
      tf32x3::wgmma_wait<0>();  // the last products are done with GS, GO
      __syncthreads();
      tc_split(GS, GO, Graw, fs, w8, z0 - rc, LOSS ? 0 : zw, GO_SIZE);
      __syncthreads();
      if (resident && t + 1 < t_end) {  // the next step's tiles, meanwhile
        tc_load(Graw, fs, G, g0 + TBG, TBG, n_g, R, ldr, 0, rcw);
        tc_load_v(Vbuf + ((t - t_begin + 1) & 1) * V_ELEMS, V, f0,
                  g0 + TBG, n_f, n_g, ldv, h_side);
      }
      tf32x3::fence_operand(s);
      tf32x3::fence_operand(s1);
      tf32x3::wgmma_fence();
      const int sbo = 32 * w8;  // GS: two core matrices per k8
      for (int k = 0; k < w8; k += 16) {
        const tf32x3::FragA a = tf32x3::load_a(Fw + k, fs, gid, tig);
        const float* bh = GS + 8 * k;
        const float* bl = bh + TBG * w8;
        tf32x3::wgmma<TBG / 8>(s, a.hi, tf32x3::desc(bl, 128, sbo),
                               rc > 0 || k > 0);
        tf32x3::wgmma<TBG / 8>(s, a.lo, tf32x3::desc(bh, 128, sbo), 1);
        tf32x3::wgmma<TBG / 8>(s, a.hi, tf32x3::desc(bh, 128, sbo), 1);
        if (k + 8 < w8) {
          const tf32x3::FragA a1 = tf32x3::load_a(Fw + k + 8, fs, gid, tig);
          tf32x3::wgmma<TBG / 8>(s1, a1.hi, tf32x3::desc(bl + 64, 128, sbo),
                                 rc > 0 || k > 0);
          tf32x3::wgmma<TBG / 8>(s1, a1.lo, tf32x3::desc(bh + 64, 128, sbo), 1);
          tf32x3::wgmma<TBG / 8>(s1, a1.hi, tf32x3::desc(bh + 64, 128, sbo), 1);
        }
      }
      tf32x3::wgmma_commit();
      tf32x3::wgmma_wait<0>();
      tf32x3::fence_operand(s);
      tf32x3::fence_operand(s1);
      if (rc + TRC >= R && R > 8)  // the last chunk: one sum
#pragma unroll
        for (int i = 0; i < 4 * (TBG / 8); ++i) s[i] += s1[i];
      if (!resident) __syncthreads();  // the next chunk overwrites F, Graw
    }

    if constexpr (LOSS) {
      // the loss terms of the 64 x TBG tile, 0 outside the matrix
#pragma unroll
      for (int i = 0; i < 4 * (TBG / 8); ++i) {
        const int f = 16 * warp + gid + 8 * ((i % 4) / 2);
        const int g = 8 * (i / 4) + 2 * tig + i % 2;
        const float term =
            loss_term(to_f32(Vs[f * vsf + g * vsg]), s[i], beta);
        loss += f0 + f < n_f && g0 + g < n_g ? term : 0.f;
      }
    } else {
      // the cotangents of the 64 x TBG tile, all at once (their exp2/log2
      // chains are independent), then the contraction, one k8 per 8 columns
      float cn[4 * (TBG / 8)], cp[4 * (TBG / 8)];
#pragma unroll
      for (int i = 0; i < 4 * (TBG / 8); ++i) {
        const int f = 16 * warp + gid + 8 * ((i % 4) / 2);
        const int g = 8 * (i / 4) + 2 * tig + i % 2;
        float a, b;
        cotangents(to_f32(Vs[f * vsf + g * vsg]), s[i], beta, a, b);
        const bool ok = f0 + f < n_f && g0 + g < n_g;
        cn[i] = ok ? a : 0.f;
        cp[i] = ok ? b : 0.f;
      }
      tf32x3::fence_operand(an);
      if (POS) tf32x3::fence_operand(ap);
      tf32x3::wgmma_fence();
#pragma unroll
      for (int j = 0; j < TBG / 8; ++j) {
        const float* c = cn + 4 * j;
        const tf32x3::FragA a_neg = tf32x3::frag_a(c[0], c[2], c[1], c[3]);
        const uint64_t bh = tf32x3::desc(GO + 64 * j, 128, 1024);
        const uint64_t bl = tf32x3::desc(GO + GO_SIZE + 64 * j, 128, 1024);
        tf32x3::wgmma<NT>(an, a_neg.hi, bl, 1);
        tf32x3::wgmma<NT>(an, a_neg.lo, bh, 1);
        tf32x3::wgmma<NT>(an, a_neg.hi, bh, 1);
        if (POS) {
          const float* d = cp + 4 * j;
          const tf32x3::FragA a_pos = tf32x3::frag_a(d[0], d[2], d[1], d[3]);
          tf32x3::wgmma<NT>(ap, a_pos.hi, bl, 1);
          tf32x3::wgmma<NT>(ap, a_pos.lo, bh, 1);
          tf32x3::wgmma<NT>(ap, a_pos.hi, bh, 1);
        }
      }
      tf32x3::wgmma_commit();  // waited for before the next split
    }
  }
  if constexpr (LOSS) {
    // the block's sum; shared memory is free once every thread is past its
    // last read of V
    __syncthreads();
    smem[threadIdx.x] = loss;
    __syncthreads();
    block_sum<kTcThreads>(smem);
    if (threadIdx.x == 0)
      out_neg[blockIdx.y * gridDim.x + blockIdx.x] = smem[0];
    return;
  }
  tf32x3::wgmma_wait<0>();
  tf32x3::fence_operand(an);
  if (POS) tf32x3::fence_operand(ap);

  const bool epilogue = mu_pos != nullptr && gridDim.y == 1;
  const size_t slab = (size_t)blockIdx.y * n_f * R;
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) {
    const int f = f0 + 16 * warp + gid + 8 * ((i % 4) / 2);
    const int c = 8 * (i / 4) + 2 * tig + i % 2;
    if (f >= n_f || c >= zw) continue;
    const size_t o = (size_t)f * R + z0 + c;
    float a = an[i];
    if (epilogue)
      a = F[(size_t)f * ldr + z0 + c] * ((relu(a) + kEps) / mu_pos[z0 + c]);
    out_neg[slab + o] = a;
    if (POS) out_pos[slab + o] = ap[i];
  }
}

// second pass of a split contraction: sum the slabs in order s = 0..S-1,
// then the optional beta=1 epilogue
__global__ void contract_finish_kernel(
    const float* __restrict__ part_neg, const float* __restrict__ part_pos,
    const float* __restrict__ F, const float* __restrict__ mu_pos,
    float* __restrict__ out_neg, float* __restrict__ out_pos, int n_f, int R,
    int ldr, int splits, int need_pos) {
  const size_t n = (size_t)n_f * R;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += part_neg[s * n + idx];
    if (mu_pos != nullptr)
      a = F[idx / R * ldr + idx % R] * ((relu(a) + kEps) / mu_pos[idx % R]);
    out_neg[idx] = a;
    if (need_pos) {
      float p = 0.f;
      for (int s = 0; s < splits; ++s) p += part_pos[s * n + idx];
      out_pos[idx] = p;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    loss_finish_kernel(const float* __restrict__ partials, int n,
                       float* __restrict__ out) {
  __shared__ float red[kThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partials[i];
  red[threadIdx.x] = s;
  __syncthreads();
  block_sum<kThreads>(red);
  if (threadIdx.x == 0) out[0] = red[0];
}

// the instance's shared-memory attributes, set once, to the most any rank
// needs (two CUDA runtime calls per launch cost host time that a small
// fit's kernel feels)
template <typename TV, int NT, int MODE>
cudaError_t configure_contract() {
  static const cudaError_t configured = set_smem(
      contract_kernel<TV, NT, MODE>, contract_smem_bytes(TRC, NT));
  return configured;
}

template <typename TV, int NT, int MODE>
cudaError_t launch_contract(dim3 grid, cudaStream_t stream,
                            const TV* V, const float* F, const float* G,
                            const float* mu_pos, float* out_neg,
                            float* out_pos, int n_f, int n_g, int R,
                            int ldv, int ldr, int h_side, int tiles_per_split,
                            float beta) {
  const size_t smem = contract_smem_bytes(R, NT);
  const cudaError_t configured = configure_contract<TV, NT, MODE>();
  if (configured != cudaSuccess) return configured;
  contract_kernel<TV, NT, MODE><<<grid, kTcThreads, smem, stream>>>(
      V, F, G, mu_pos, out_neg, out_pos, n_f, n_g, R, ldv, ldr, h_side,
      tiles_per_split, beta);
  return cudaGetLastError();
}

// the contraction's instance for V's element type, the mode and the n8
// tiles of the widest block (as a wgmma width, tf32x3.cuh)
template <typename TV>
cudaError_t launch_contractions(dim3 grid, cudaStream_t stream, const TV* V,
                                const float* F, const float* G,
                                const float* mu_pos, float* dn, float* dp,
                                int n_f, int n_g, int R, int ldv, int ldr,
                                int h_side, int tps, float beta,
                                int need_pos) {
#define PNT_CONTRACT(NT)                                                   \
  return need_pos ? launch_contract<TV, NT, kNegPos>(                      \
                        grid, stream, V, F, G, mu_pos, dn, dp, n_f, n_g, R, \
                        ldv, ldr, h_side, tps, beta)                        \
                  : launch_contract<TV, NT, kNeg>(                         \
                        grid, stream, V, F, G, mu_pos, dn, dp, n_f, n_g, R, \
                        ldv, ldr, h_side, tps, beta)
  const int nt = cdiv(imin(R, TZR), 8);
  if (nt <= 2) PNT_CONTRACT(2);
  if (nt <= 4) PNT_CONTRACT(4);
  if (nt <= 8) PNT_CONTRACT(8);
  if (nt <= 11) PNT_CONTRACT(11);
  if (nt <= 12) PNT_CONTRACT(12);
  PNT_CONTRACT(16);
#undef PNT_CONTRACT
}

// enough splits of the n_g reduction (steps of `rows`) for two blocks per
// SM, and never a split without a step
int num_splits(int blocks, int n_g, int rows, int num_sms) {
  const int n_gt = cdiv(n_g, rows);
  int s = cdiv(2 * num_sms, blocks);
  s = s < 1 ? 1 : (s > n_gt ? n_gt : s);
  return cdiv(n_gt, cdiv(n_gt, s));
}

}  // namespace

extern "C" {

// Splits of the contraction over n_g (the partial slabs it needs).
int pnt_contract_splits(int n_f, int n_g, int R, int num_sms) {
  return num_splits(cdiv(n_f, BF) * cdiv(R, TZR), n_g, TBG, num_sms);
}

// Returns a cudaError_t (0 on success).  V is float32, or bfloat16 when
// v_bf16 is 1; F and G are float32.  All are row-major with 16-byte aligned
// rows, ldv elements (V) and ldr floats (F, G) apart: V is (n_f, n_g) on
// the H side (h_side = 1), (n_g, n_f) on the W side.  part_neg/part_pos
// hold (splits, n_f, R) floats when splits > 1 and are unused otherwise;
// out_pos/part_pos are unused when need_pos is 0.
int pnt_fused_contractions(const void* V, const float* F, const float* G,
                           const float* mu_pos, float* out_neg,
                           float* out_pos, float* part_neg, float* part_pos,
                           int n_f, int n_g, int R, int ldv, int ldr,
                           int h_side, int splits, float beta, int need_pos,
                           int v_bf16, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_f < 1 || n_g < 1 || R < 1 || splits < 1 || ldv % (v_bf16 ? 8 : 4) ||
      ldr % 4 || ldr < R || ldv < (h_side ? n_g : n_f))
    return (int)cudaErrorInvalidValue;
  const int tps = cdiv(cdiv(n_g, TBG), splits);
  const dim3 grid(cdiv(n_f, BF), splits, cdiv(R, TZR));
  float* dn = splits == 1 ? out_neg : part_neg;
  float* dp = splits == 1 ? out_pos : part_pos;
  const cudaError_t err =
      v_bf16 ? launch_contractions(grid, stream,
                                   static_cast<const __nv_bfloat16*>(V), F,
                                   G, mu_pos, dn, dp, n_f, n_g, R, ldv, ldr,
                                   h_side, tps, beta, need_pos)
             : launch_contractions(grid, stream, static_cast<const float*>(V),
                                   F, G, mu_pos, dn, dp, n_f, n_g, R, ldv,
                                   ldr, h_side, tps, beta, need_pos);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const int n = n_f * R;
    const int blocks = imin(cdiv(n, kThreads), 4096);
    contract_finish_kernel<<<blocks, kThreads, 0, stream>>>(
        part_neg, part_pos, F, mu_pos, out_neg, out_pos, n_f, R, ldr, splits,
        need_pos);
  }
  return (int)cudaGetLastError();
}

// Splits of the loss over K, as many as fill the card's block slots in one
// round (a second round of a few blocks would double the time); it writes
// cdiv(M, 64) * splits partial sums.
int pnt_loss_splits(int M, int K, int R, int num_sms) {
  int per_sm = 0;
  if (configure_contract<float, 2, kLoss>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, contract_kernel<float, 2, kLoss>, kTcThreads,
          contract_smem_bytes(R, 2)) != cudaSuccess)
    per_sm = 1;
  const int n_gt = cdiv(K, TBG);
  int s = imax(per_sm, 1) * num_sms / cdiv(M, BF);
  s = s < 1 ? 1 : (s > n_gt ? n_gt : s);
  return cdiv(n_gt, cdiv(n_gt, s));
}

int pnt_loss_partials(int M, int splits) { return cdiv(M, BF) * splits; }

// partials holds pnt_loss_partials(M, splits) floats; out one float.  V
// (M, K; float32, or bfloat16 when v_bf16 is 1), H (M, R) and W (K, R) are
// row-major with 16-byte aligned rows ldv elements (V) and ldr floats (H,
// W) apart.
int pnt_fused_beta_loss(const void* V, const float* H, const float* W,
                        float* partials, float* out, int M, int K, int R,
                        int ldv, int ldr, int splits, float beta, int v_bf16,
                        void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (M < 1 || K < 1 || R < 1 || splits < 1 || ldv % (v_bf16 ? 8 : 4) ||
      ldr % 4 || ldr < R || ldv < K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(M, BF), splits);
  const int tps = cdiv(cdiv(K, TBG), splits);
  const cudaError_t err =
      v_bf16 ? launch_contract<__nv_bfloat16, 2, kLoss>(
                   grid, stream, static_cast<const __nv_bfloat16*>(V), H, W,
                   nullptr, partials, nullptr, M, K, R, ldv, ldr, 1, tps, beta)
             : launch_contract<float, 2, kLoss>(
                   grid, stream, static_cast<const float*>(V), H, W, nullptr,
                   partials, nullptr, M, K, R, ldv, ldr, 1, tps, beta);
  if (err != cudaSuccess) return (int)err;
  loss_finish_kernel<<<1, kThreads, 0, stream>>>(partials, grid.x * grid.y,
                                                 out);
  return (int)cudaGetLastError();
}

}  // extern "C"
