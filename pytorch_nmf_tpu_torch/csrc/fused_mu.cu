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
// What bounds them on the H100: per (64 x 64) tile of (M, K) entries the
// contraction does 64*64*R FMAs for the WH tile plus 64*64*R (twice that
// with the denominator) for the contraction, against 16 KB of V read once.
// At R = 88 that is ~260 FMA per byte of V: far from HBM-bound, so the
// limit is on chip: shared-memory bandwidth and latency.  Each thread keeps
// a 4x4 tile of WH and a 4 x (VEC*RJ) tile of the contraction in registers
// and reads shared memory in vectors; still, the WH product reads one float
// from shared memory per two FMAs, where the FMA rate of the CUDA cores
// (67 TFLOP/s peak) needs about four.  Latency is hidden by occupancy and
// prefetch: tiles are copied with cp.async straight into shared memory (no
// staging registers), and up to 96 rank columns a thread fits 128
// registers, so two blocks share an SM while the next V tile is copied
// during the contraction.  Measured at 5168x1025 R=88 a side-call runs at
// ~14 TFLOP/s, about even with cuBLAS SGEMMs around an elementwise pass
// (PERF.md).  Products are true f32 FMAs on CUDA cores; tensor-core
// variants (3xTF32 mma for f32 accuracy, or opt-in TF32 or bf16) are later,
// measured work.
//
// Design, and what differs from the TPU kernel:
//
// * One kernel serves both sides.  The factor being updated is F (n_f rows),
//   the other factor G (n_g rows), and V is addressed through the strides
//   (sf, sg): H side F=H, G=W, (sf, sg) = (K, 1); W side F=W, G=H,
//   (sf, sg) = (1, K).  WH(f, g) = F[f] . G[g] on both sides.
// * The TPU grid runs in order on one core and carries the accumulator
//   across grid steps.  Here a block owns 64 rows of F and loops over 64-row
//   tiles of G itself, the accumulators in registers.  When the F tiles
//   alone cannot fill the card (W side: K=1025 gives 17 tiles for 132 SMs)
//   the G range is split over gridDim.y blocks, each writing its own
//   (n_f, R) partial slab, and a second pass sums the slabs in a fixed
//   order.  No atomics: the result is reproducible, so the tolerance stop
//   of a fit is too.
// * Any rank: the WH product streams the rank through 64-wide chunks, so
//   shared memory does not grow with R, and a block accumulates at most 256
//   rank columns of the output (gridDim.z covers wider ranks, each block
//   recomputing its WH tile).
// * The beta=1 MU epilogue f * (relu(acc) + eps) / mu_pos runs after the
//   complete reduction: in the main kernel when there is one split, else in
//   the second pass.
// * Ragged edges: rows of F or G past their end, rank columns past R and V
//   outside the matrix load as zero, and the cotangent (or loss term) of
//   every entry outside the matrix is forced to zero, so padding never
//   enters a sum (the beta=0 term 1/(0+eps) would).
//
// The cotangents mirror _cotangent_tiles (pallas_mu.py:76-92) and the loss
// terms _loss_kernel (:318-332): one shared powf(wh+eps, beta-2) for
// fractional beta, 1/(wh+eps) squared at beta=0, no eps at beta=2.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr int kThreads = 256;  // a 16 x 16 grid of (tf, tg) threads
constexpr int BF = 64;         // F rows per block
constexpr int BG = 64;         // G rows per step
constexpr int RC = 64;         // rank chunk of the WH product
constexpr int ZR = 256;        // most rank columns one block accumulates
constexpr int KS = RC + 4;     // row stride of the chunk tiles
constexpr int VS = 64 + 1;     // row stride of the (64, 64) V tile
constexpr int CS = BF + 4;     // row stride of the cotangent tiles [BG][CS]

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// row stride of the (BG, rank-columns) G tile the contraction reads, a
// multiple of 4 for its vector loads
__host__ __device__ inline int z_stride(int R) {
  return 4 * cdiv(imin(ZR, R), 4);
}

// shared floats before the V tile: the two chunk tiles of the WH product,
// reused for the G tile of the contraction once the product is done
__host__ __device__ inline int region_a(int R) {
  return imax(2 * 64 * KS, BG * z_stride(R));
}

__device__ __forceinline__ float relu(float a) {
  return a < 0.f ? 0.f : a;  // NaN passes through, as jax.nn.relu / torch.relu
}

// Tile loads copy global memory straight into shared memory with cp.async
// (no staging registers); entries outside the matrix are zero-filled.
// cp_async_wait() completes every copy this thread issued; a
// __syncthreads() after it publishes them to the block.
constexpr int kPerThread = 64 * 64 / kThreads;  // elements of a 64x64 tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// columns [c0, c0 + stored) of rows [row0, row0 + 64) of a row-major
// (n, R) matrix into dst (row stride ds), stored <= 64; entries outside the
// matrix or at or past column c0 + valid are zero
__device__ __forceinline__ void load_cols(float* dst, int ds,
                                          const float* __restrict__ src,
                                          int row0, int n, int R, int c0,
                                          int valid, int stored = 64) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int row = idx / 64, c = idx % 64;
    if (c < stored) {
      const bool ok = row0 + row < n && c < valid;
      cp_async4(&dst[row * ds + c],
                ok ? src + (size_t)(row0 + row) * R + c0 + c : src, ok);
    }
  }
}

// the (BF, BG) tile of V at (f0, g0), kept in V's own orientation: row o of
// the tile is a run along V's contiguous axis (g on the H side, f on the W
// side), so V(f, g) sits at Vs[f * vsf + g * vsg]
__device__ __forceinline__ void load_v(float* Vs, const float* __restrict__ V,
                                       int f0, int g0, int n_f, int n_g,
                                       long long sf, long long sg) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int o = idx / 64, in = idx % 64;
    const int f = sg == 1 ? o : in, g = sg == 1 ? in : o;
    const bool ok = f0 + f < n_f && g0 + g < n_g;
    cp_async4(&Vs[o * VS + in], ok ? V + (f0 + f) * sf + (g0 + g) * sg : V,
              ok);
  }
}

// wh[i][j] = F[f0 + tf + 16i] . G[g0 + tg + 16j] for this thread's (tf, tg),
// the rank streamed through 64-wide chunks.  Starts and ends with the
// shared chunk tiles free (a __syncthreads() after the last use); waits
// for every copy the thread issued before it, too.
__device__ void wh_tile(float wh[4][4], float* Fc, float* Gc,
                        const float* __restrict__ F,
                        const float* __restrict__ G, int f0, int g0, int n_f,
                        int n_g, int R) {
  const int tf = threadIdx.x / 16, tg = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wh[i][j] = 0.f;
  for (int rc = 0; rc < R; rc += RC) {
    const int valid = imin(RC, R - rc);
    load_cols(Fc, KS, F, f0, n_f, R, rc, valid);
    load_cols(Gc, KS, G, g0, n_g, R, rc, valid);
    cp_async_wait();
    __syncthreads();
    for (int r = 0; r < valid; r += 4) {  // columns up to the next 4 are 0
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Fc[(tf + 16 * i) * KS + r]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&Gc[(tg + 16 * j) * KS + r]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = wh[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          wh[i][j] = s;
        }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cotangents(float v, float wh, float beta,
                                           float& cn, float& cp) {
  if (beta == 2.f) {
    cn = v;
    cp = wh;
  } else if (beta == 1.f) {
    cn = v / (wh + kEps);
    cp = 0.f;
  } else if (beta == 0.f) {
    const float r = 1.f / (wh + kEps);
    cn = r * r * v;
    cp = r;
  } else {
    const float whe = wh + kEps;
    const float p2 = powf(whe, beta - 2.f);
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
  const float t = beta < 0.f ? v + kEps : v;
  const float ie = wh + kEps;
  const float ie_bm1 = powf(ie, beta - 1.f);
  return (powf(t, beta) + (beta - 1.f) * ie_bm1 * ie - beta * t * ie_bm1) /
         (beta * (beta - 1.f));
}

size_t contract_smem_bytes(int R) {
  return sizeof(float) *
         ((size_t)region_a(R) + BF * VS + 2 * BG * CS);
}

size_t loss_smem_bytes() { return sizeof(float) * (2 * 64 * KS + BF * VS); }

template <int VEC> struct VecT;
template <> struct VecT<2> { using T = float2; };
template <> struct VecT<4> { using T = float4; };

// step g of the contraction, with c = VEC (tg + 16 jj):
//   acc[i][VEC jj + q] += C[4 tf + i][g] * Gz[g][c + q]
template <int RJ, int VEC>
__device__ __forceinline__ void contract_step(float an[4][VEC * RJ],
                                              float ap[4][VEC * RJ],
                                              const float* Cn, const float* Cp,
                                              const float* Gz, int g, int zs,
                                              int zw, int tf, int tg,
                                              int need_pos) {
  const float4 cn4 = *reinterpret_cast<const float4*>(&Cn[g * CS + 4 * tf]);
  const float4 cp4 =
      need_pos ? *reinterpret_cast<const float4*>(&Cp[g * CS + 4 * tf])
               : make_float4(0.f, 0.f, 0.f, 0.f);
  const float cn[4] = {cn4.x, cn4.y, cn4.z, cn4.w};
  const float cp[4] = {cp4.x, cp4.y, cp4.z, cp4.w};
#pragma unroll
  for (int jj = 0; jj < RJ; ++jj) {
    const int c = VEC * (tg + 16 * jj);
    typename VecT<VEC>::T bv{};
    if (c < zw)
      bv = *reinterpret_cast<const typename VecT<VEC>::T*>(&Gz[g * zs + c]);
    const float* b = reinterpret_cast<const float*>(&bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        an[i][VEC * jj + q] = fmaf(cn[i], b[q], an[i][VEC * jj + q]);
    if (need_pos) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          ap[i][VEC * jj + q] = fmaf(cp[i], b[q], ap[i][VEC * jj + q]);
    }
  }
}

// out_neg/out_pos: the (n_f, R) outputs when gridDim.y == 1, else the
// (gridDim.y, n_f, R) partial slabs.  mu_pos (R,) selects the beta=1
// epilogue; it is applied here only when there is one split.  Thread
// (tf, tg) accumulates rows f0 + 4tf + i and rank columns
// z0 + VEC(tg + 16jj) + q.  Up to 96 rank columns (float2 groups, VEC = 2)
// a thread fits 128 registers, so two blocks share an SM.
template <int RJ, int VEC>
__global__ void __launch_bounds__(kThreads, VEC == 2 ? 2 : 1)
    contract_kernel(const float* __restrict__ V, const float* __restrict__ F,
                    const float* __restrict__ G,
                    const float* __restrict__ mu_pos,
                    float* __restrict__ out_neg, float* __restrict__ out_pos,
                    int n_f, int n_g, int R, long long sf, long long sg,
                    int tiles_per_split, float beta, int need_pos) {
  extern __shared__ __align__(16) float smem[];
  const int zs = z_stride(R);
  float* Fc = smem;
  float* Gc = smem + 64 * KS;
  float* Gz = smem;  // after the WH product: the G tile of the contraction
  float* Vs = smem + region_a(R);
  float* Cn = Vs + BF * VS;  // cotangents, transposed: [BG][CS]
  float* Cp = Cn + BG * CS;
  const int tf = threadIdx.x / 16, tg = threadIdx.x % 16;
  const int vsf = sg == 1 ? VS : 1, vsg = sg == 1 ? 1 : VS;
  const int f0 = blockIdx.x * BF;
  const int z0 = blockIdx.z * ZR;
  const int zw = imin(ZR, R - z0);
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = imin(t_begin + tiles_per_split, cdiv(n_g, BG));

  float an[4][VEC * RJ], ap[4][VEC * RJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < VEC * RJ; ++j) an[i][j] = ap[i][j] = 0.f;

  // prefetching V costs registers that only the narrow-rank instances have
  // to spare (measured: it spills and slows R=256 by 12%)
  constexpr bool prefetch = VEC == 2;
  if (prefetch && t_begin < t_end)
    load_v(Vs, V, f0, t_begin * BG, n_f, n_g, sf, sg);
  for (int t = t_begin; t < t_end; ++t) {
    const int g0 = t * BG;
    if (!prefetch) load_v(Vs, V, f0, g0, n_f, n_g, sf, sg);
    float wh[4][4];
    wh_tile(wh, Fc, Gc, F, G, f0, g0, n_f, n_g, R);  // completes Vs too
    // the contraction's G tile arrives while the cotangents are computed
    for (int c = 0; c < zw; c += 64)  // zero-fills columns [zw, zs)
      load_cols(Gz + c, zs, G, g0, n_g, R, z0 + c, imin(64, zw - c),
                imin(64, zs - c));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = tf + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = tg + 16 * j;
        const bool ok = f0 + f < n_f && g0 + g < n_g;
        float cn, cp;
        cotangents(Vs[f * vsf + g * vsg], wh[i][j], beta, cn, cp);
        Cn[g * CS + f] = ok ? cn : 0.f;
        if (need_pos) Cp[g * CS + f] = ok ? cp : 0.f;
      }
    }
    cp_async_wait();
    __syncthreads();
    // the next V tile arrives during the contraction
    if (prefetch && t + 1 < t_end)
      load_v(Vs, V, f0, g0 + BG, n_f, n_g, sf, sg);

#pragma unroll 2
    for (int g = 0; g < BG; ++g)
      contract_step<RJ, VEC>(an, ap, Cn, Cp, Gz, g, zs, zw, tf, tg, need_pos);
    __syncthreads();
  }

  const bool epilogue = mu_pos != nullptr && gridDim.y == 1;
  const size_t slab = (size_t)blockIdx.y * n_f * R;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + 4 * tf + i;
    if (f >= n_f) continue;
#pragma unroll
    for (int jj = 0; jj < RJ; ++jj)
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const int c = VEC * (tg + 16 * jj) + q;
        if (c >= zw) continue;
        const size_t o = (size_t)f * R + z0 + c;
        float a = an[i][VEC * jj + q];
        if (epilogue) a = F[o] * ((relu(a) + kEps) / mu_pos[z0 + c]);
        out_neg[slab + o] = a;
        if (need_pos) out_pos[slab + o] = ap[i][VEC * jj + q];
      }
  }
}

// second pass of a split contraction: sum the slabs in order s = 0..S-1,
// then the optional beta=1 epilogue
__global__ void contract_finish_kernel(
    const float* __restrict__ part_neg, const float* __restrict__ part_pos,
    const float* __restrict__ F, const float* __restrict__ mu_pos,
    float* __restrict__ out_neg, float* __restrict__ out_pos, int n_f, int R,
    int splits, int need_pos) {
  const size_t n = (size_t)n_f * R;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += part_neg[s * n + idx];
    if (mu_pos != nullptr) a = F[idx] * ((relu(a) + kEps) / mu_pos[idx % R]);
    out_neg[idx] = a;
    if (need_pos) {
      float p = 0.f;
      for (int s = 0; s < splits; ++s) p += part_pos[s * n + idx];
      out_pos[idx] = p;
    }
  }
}

// fixed-order tree sum of kThreads values in red; the result is red[0]
__device__ void block_sum(float* red) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
}

// H orientation (F = H, G = W); one partial sum per block
__global__ void __launch_bounds__(kThreads, 2)
    loss_kernel(const float* __restrict__ V, const float* __restrict__ H,
                const float* __restrict__ W, float* __restrict__ partials,
                int M, int K, int R, int tiles_per_split, float beta) {
  extern __shared__ __align__(16) float smem[];
  float* Fc = smem;
  float* Gc = smem + 64 * KS;
  float* Vs = smem + 2 * 64 * KS;
  const int tf = threadIdx.x / 16, tg = threadIdx.x % 16;
  const int f0 = blockIdx.x * BF;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = imin(t_begin + tiles_per_split, cdiv(K, BG));

  float sum = 0.f;
  if (t_begin < t_end) load_v(Vs, V, f0, t_begin * BG, M, K, K, 1);
  for (int t = t_begin; t < t_end; ++t) {
    const int g0 = t * BG;
    float wh[4][4];
    wh_tile(wh, Fc, Gc, H, W, f0, g0, M, K, R);  // completes Vs too
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = tf + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = tg + 16 * j;
        if (f0 + f < M && g0 + g < K)
          sum += loss_term(Vs[f * VS + g], wh[i][j], beta);
      }
    }
    __syncthreads();
    if (t + 1 < t_end) load_v(Vs, V, f0, g0 + BG, M, K, K, 1);
  }
  Vs[threadIdx.x] = sum;  // 64 * VS >= kThreads
  __syncthreads();
  block_sum(Vs);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = Vs[0];
}

__global__ void __launch_bounds__(kThreads)
    loss_finish_kernel(const float* __restrict__ partials, int n,
                       float* __restrict__ out) {
  __shared__ float red[kThreads];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partials[i];
  red[threadIdx.x] = s;
  __syncthreads();
  block_sum(red);
  if (threadIdx.x == 0) out[0] = red[0];
}

template <int RJ, int VEC>
cudaError_t launch_contract(dim3 grid, size_t smem, cudaStream_t stream,
                            const float* V, const float* F, const float* G,
                            const float* mu_pos, float* out_neg,
                            float* out_pos, int n_f, int n_g, int R,
                            long long sf, long long sg, int tiles_per_split,
                            float beta, int need_pos) {
  cudaError_t err = cudaFuncSetAttribute(
      contract_kernel<RJ, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  contract_kernel<RJ, VEC><<<grid, kThreads, smem, stream>>>(
      V, F, G, mu_pos, out_neg, out_pos, n_f, n_g, R, sf, sg,
      tiles_per_split, beta, need_pos);
  return cudaGetLastError();
}

// enough splits of the n_g reduction for two blocks per SM, and never a
// split without a tile
int num_splits(int blocks, int n_g, int num_sms) {
  const int n_gt = cdiv(n_g, BG);
  int s = cdiv(2 * num_sms, blocks);
  s = s < 1 ? 1 : (s > n_gt ? n_gt : s);
  return cdiv(n_gt, cdiv(n_gt, s));
}

}  // namespace

extern "C" {

// Splits of the contraction over n_g (the partial slabs it needs).
int pnt_contract_splits(int n_f, int n_g, int R, int num_sms) {
  return num_splits(cdiv(n_f, BF) * cdiv(R, ZR), n_g, num_sms);
}

// Returns a cudaError_t (0 on success).  part_neg/part_pos hold
// (splits, n_f, R) floats when splits > 1 and are unused otherwise;
// out_pos/part_pos are unused when need_pos is 0.
int pnt_fused_contractions(const float* V, const float* F, const float* G,
                           const float* mu_pos, float* out_neg,
                           float* out_pos, float* part_neg, float* part_pos,
                           int n_f, int n_g, int R, long long sf,
                           long long sg, int splits, float beta, int need_pos,
                           void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_f < 1 || n_g < 1 || R < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int tps = cdiv(cdiv(n_g, BG), splits);
  const dim3 grid(cdiv(n_f, BF), splits, cdiv(R, ZR));
  const size_t smem = contract_smem_bytes(R);
  float* dn = splits == 1 ? out_neg : part_neg;
  float* dp = splits == 1 ? out_pos : part_pos;
  cudaError_t err;
#define PNT_CONTRACT(N, VEC)                                               \
  err = launch_contract<N, VEC>(grid, smem, stream, V, F, G, mu_pos, dn, dp, \
                                n_f, n_g, R, sf, sg, tps, beta, need_pos)
  const int zr = imin(R, ZR);  // rank columns of the widest block
  if (zr <= 32) PNT_CONTRACT(1, 2);
  else if (zr <= 64) PNT_CONTRACT(2, 2);
  else if (zr <= 96) PNT_CONTRACT(3, 2);
  else if (zr <= 128) PNT_CONTRACT(2, 4);
  else if (zr <= 192) PNT_CONTRACT(3, 4);
  else PNT_CONTRACT(4, 4);
#undef PNT_CONTRACT
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const int n = n_f * R;
    const int blocks = imin(cdiv(n, kThreads), 4096);
    contract_finish_kernel<<<blocks, kThreads, 0, stream>>>(
        part_neg, part_pos, F, mu_pos, out_neg, out_pos, n_f, R, splits,
        need_pos);
  }
  return (int)cudaGetLastError();
}

// Splits of the loss over K; it writes cdiv(M, 64) * splits partial sums.
int pnt_loss_splits(int M, int K, int num_sms) {
  return num_splits(cdiv(M, BF), K, num_sms);
}

int pnt_loss_partials(int M, int splits) { return cdiv(M, BF) * splits; }

// partials holds pnt_loss_partials(M, splits) floats; out one float.
int pnt_fused_beta_loss(const float* V, const float* H, const float* W,
                        float* partials, float* out, int M, int K, int R,
                        int splits, float beta, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (M < 1 || K < 1 || R < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = loss_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(M, BF), splits);
  loss_kernel<<<grid, kThreads, smem, stream>>>(
      V, H, W, partials, M, K, R, cdiv(cdiv(K, BG), splits), beta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  loss_finish_kernel<<<1, kThreads, 0, stream>>>(partials, grid.x * grid.y,
                                                 out);
  return (int)cudaGetLastError();
}

}  // extern "C"
