// Hoyer sparseness projection of every rank column, all rounds on the device.
//
// Replaces the projection of pytorch_nmf_tpu/ops/projection.py: proj_func
// (:26-70), a lax.while_loop that jit keeps on the TPU, vmapped over the
// rank columns by proj_columns (:88, :101).  It is not a Pallas kernel; the
// port's eager version (ops/projection.py::plain_proj_rows) runs each round
// as about twenty PyTorch launches and reads a "done" flag on the host every
// two rounds, so a projection could not be captured in a CUDA graph and a
// Hoyer fit launched about a thousand kernels an iteration.
//
// pnt_hoyer_proj projects column r of x (R columns, N = outer * inner values
// each) onto {v >= 0 : sum v = k1[r], sum v^2 = k2[r]}.  Column r's value n
// (n = o * inner + i) sits at r * sr + o * so + i: any contiguous tensor
// whose rank axis is its axis a has outer = prod(shape[:a]), inner =
// prod(shape[a+1:]), sr = inner and so = R * inner, so NMFD's W (C, R, T)
// is read where it lies, with no copy of its strided columns.
//
// Design (simple first): one block per column runs the column's rounds
// until no coordinate goes negative or N + 2 rounds have passed, as the
// batched while_loop does.  v lives in the output buffer and the zeroed
// coordinates in a byte mask beside it (both the caller's), so the column
// may be any length.  A round is two passes over the column, each ending
// in a block reduction: the step (v + alpha w) with the count of
// negatives, the count of zeroed coordinates and sum relu(v); then, when a
// coordinate went negative, the fix-up with the next round's sums of w^2,
// w v and v^2.  Each thread keeps the same values in every pass, so passes
// need no barrier beyond the reductions', and it steps its (o, i) position
// with no division per value.
//
// What bounds it: the rounds.  Each reads and writes the column twice
// (v, and the mask's bytes) and does a few operations per value, so a long
// column's time is its rounds times its bytes over the bandwidth one block
// can draw: one block per column puts R SMs to work (R = 88 of 132 at the
// flagship's rank), each loading kU values a thread before using any.  A
// short column's time is its rounds' block reductions.  The bytes-once
// bound is far below either (PERF.md).
//
// Arithmetic mirrors the plain version's, operation by operation, with the
// _rn intrinsics so that no multiply and add are fused: products in the
// input's type, sums in double rounded once to it, the discriminant as XLA
// forms it in the JAX package's jitted loop (b*b exact in double, minus
// 4ac, rounded once; a NaN discriminant taken as 0), relu passing NaN.  So
// columns whose b*b overflows float32 give NaN where the plain version
// does.  float32 and float64 instances.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float divide(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double divide(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// torch.relu: NaN stays NaN
template <typename T>
__device__ __forceinline__ T relu(T x) { return x < T(0) ? T(0) : x; }

// Sums K values over the block; every thread gets the same sums, added in
// a fixed order (warp shuffles, then the warps' partials in warp order).
// blockDim.x is a multiple of 32.
template <int K>
__device__ __forceinline__ void block_sum(double* v, double (*red)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  __syncthreads();  // the previous reduction's reads of red are done
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double t = 0.0;
    for (int w = 0; w < warps; ++w) t += red[w][k];
    v[k] = t;
  }
}

// One term of the round's sums: w^2, w v and v^2, each product rounded to T
template <typename T>
__device__ __forceinline__ void accumulate(double* q, T v, T w) {
  q[0] += (double)mul(w, w);
  q[1] += (double)mul(w, v);
  q[2] += (double)mul(v, v);
}

// Calls use(index, src[index], zero[index]) (z 0 when kZero is false) for
// a thread's values n = tid, tid + blockDim, ... of a column, in that
// order, at base + o * so + i, with (o, i) stepped without a division.
// The loads of U values are issued before any of them is used: one load in
// flight per warp cannot draw a block's share of the bandwidth.
template <int U, bool kZero, typename T, typename Use>
__device__ __forceinline__ void sweep(const T* src, const uint8_t* zero,
                                      int base, int inner, int so, int N,
                                      Use&& use) {
  const int step_o = blockDim.x / inner, step_i = blockDim.x % inner;
  int o = threadIdx.x / inner, i = threadIdx.x % inner;
  auto next = [&]() {
    const int at = base + o * so + i;
    o += step_o;
    i += step_i;
    if (i >= inner) {
      i -= inner;
      ++o;
    }
    return at;
  };
  int n = threadIdx.x;
  for (; n + (long long)(U - 1) * blockDim.x < N; n += U * blockDim.x) {
    int at[U];
    T x[U];
    uint8_t z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) at[u] = next();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x[u] = src[at[u]];
      z[u] = kZero ? zero[at[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) use(at[u], x[u], z[u]);
  }
  for (; n < N; n += blockDim.x) {
    const int at = next();
    use(at, src[at], kZero ? zero[at] : (uint8_t)0);
  }
}

constexpr int kU = 8;
constexpr int kThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads) hoyer_proj_kernel(const T* __restrict__ s, T* v,
                                  uint8_t* zero,
                                  const T* __restrict__ k1s,
                                  const T* __restrict__ k2s, int inner, int N,
                                  int so, int sr) {
  __shared__ double red[32][4];
  const int base = blockIdx.x * sr;
  const T k1 = k1s[blockIdx.x], k2 = k2s[blockIdx.x];
  auto for_s = [&](auto&& use) {
    sweep<kU, false>(s, zero, base, inner, so, N, use);
  };
  auto for_v = [&](auto&& use) {
    sweep<kU, true>(static_cast<const T*>(v), zero, base, inner, so, N, use);
  };

  // v = s + (k1 - sum s) / N, and the first round's sums (no coordinate
  // zeroed yet: w = v - m everywhere)
  double q[3] = {0.0, 0.0, 0.0};
  for_s([&](int, T si, uint8_t) { q[0] += (double)si; });
  block_sum<1>(q, red);
  const T shift0 = divide(sub(k1, (T)q[0]), (T)N);
  T m = divide(k1, (T)N);
  q[0] = 0.0;
  for_s([&](int i, T si, uint8_t) {
    const T vi = add(si, shift0);
    v[i] = vi;
    zero[i] = 0;
    accumulate(q, vi, sub(vi, m));
  });

  const long long rounds = (long long)N + 2;
  for (long long round = 0; round < rounds; ++round) {
    // w = v - m on the active coordinates, v on the zeroed ones
    block_sum<3>(q, red);
    const T a = (T)q[0];
    const T b = mul(T(2), (T)q[1]);
    const T c = sub((T)q[2], k2);
    const T d = (T)__dsub_rn(__dmul_rn((double)b, (double)b),
                             (double)mul(mul(T(4), a), c));
    const T alpha = divide(mul(add(-b, root(d > T(0) ? d : T(0))), T(0.5)), a);

    // v_new = v + alpha w; count its negatives, the zeroed coordinates
    // after them, and sum relu(v_new)
    q[0] = q[1] = q[2] = 0.0;
    for_v([&](int i, T vi, uint8_t z) {
      const T vn = add(vi, mul(alpha, z ? vi : sub(vi, m)));
      const bool neg = vn < T(0);
      v[i] = vn;
      if (neg) zero[i] = 1;
      q[0] += neg;
      q[1] += z || neg;
      q[2] += (double)relu(vn);
    });
    block_sum<3>(q, red);
    if (q[0] == 0.0) break;  // no coordinate went negative: done

    // v = relu(relu(v_new) + (k1 - sum relu(v_new)) / (N - zeros)), and
    // the next round's sums at its m
    const int zeros = (int)q[1];
    const T shift = divide(sub(k1, (T)q[2]), (T)(N - zeros));
    m = divide(k1, (T)(N - zeros));
    q[0] = q[1] = q[2] = 0.0;
    for_v([&](int i, T vo, uint8_t z) {
      const T vi = relu(add(relu(vo), shift));
      v[i] = vi;
      accumulate(q, vi, z ? vi : sub(vi, m));
    });
  }
}

template <typename T>
cudaError_t launch(const void* s, void* v, void* zero, const void* k1,
                   const void* k2, int R, int outer, int inner,
                   cudaStream_t stream) {
  const int N = outer * inner;
  const int threads = N >= kThreads ? kThreads : (N + 31) / 32 * 32;
  hoyer_proj_kernel<T><<<R, threads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(v),
      static_cast<uint8_t*>(zero), static_cast<const T*>(k1),
      static_cast<const T*>(k2), inner, N, R * inner, inner);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  s, v (the result) and zero (a byte
// per value, scratch) are contiguous tensors of one shape whose rank axis
// has R entries, outer values before it and inner after it; k1 and k2 hold
// R values; fewer than 2^31 values in all.  float64 when f64 is 1, else
// float32.  Allocates nothing.
int pnt_hoyer_proj(const void* s, void* v, void* zero, const void* k1,
                   const void* k2, int R, int outer, int inner, int f64,
                   void* stream_ptr) {
  if (R < 1 || outer < 1 || inner < 1 ||
      (long long)R * outer * inner >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return (int)(f64 ? launch<double>(s, v, zero, k1, k2, R, outer, inner, stream)
                   : launch<float>(s, v, zero, k1, k2, R, outer, inner, stream));
}

}  // extern "C"
