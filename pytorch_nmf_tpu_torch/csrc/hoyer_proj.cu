// Hoyer sparseness projection of every rank column, all rounds on the device.
//
// Replaces the projection of pytorch_nmf_tpu/ops/projection.py: proj_func
// (:26-70), a lax.while_loop that jit keeps on the TPU, vmapped over the
// rank columns by proj_columns (:88, :101).  It is not a Pallas kernel; the
// port's eager version (ops/projection.py::plain_proj_rows) runs each round
// as about twenty PyTorch launches and reads a "done" flag on the host every
// two rounds, so a projection could not be captured in a CUDA graph.
//
// pnt_hoyer_proj projects column r of x (R columns, N = outer * inner values
// each) onto {v >= 0 : sum v = k1[r], sum v^2 = k2[r]}.  Column r's value n
// (n = o * inner + i) sits at r * sr + o * so + i: any contiguous tensor
// whose rank axis is its axis a has outer = prod(shape[:a]), inner =
// prod(shape[a+1:]), sr = inner and so = R * inner, so NMFD's W (C, R, T)
// is read where it lies, with no copy of its strided columns.  A column runs
// rounds until no coordinate goes negative or N + 2 rounds have passed, as
// the batched while_loop does; each round is two passes over the column,
// each ending in three sums: the step (v + alpha w) with the count of
// negatives, of zeroed coordinates and sum relu(v); then, when a coordinate
// went negative, the fix-up with the next round's sums of w^2, w v and v^2.
//
// Design: each column stays on chip for all its rounds, read from HBM once
// and written once.  The caller's plan (ops/projection.py::_plan) picks one
// of three regimes from the column's bytes in shared memory (its values in
// the input's type behind a kHeader-byte header of sums; a value's zeroed
// flag rides in its sign bit, since every value a fix-up writes is >= 0 or
// NaN) against the card's opt-in shared memory per block (227 KB on the
// H100):
//
// (a) One CTA, column resident (hoyer_proj_resident<T, false>): the CTA
//     holds the whole column: up to 57,856 float32 or 28,928 float64
//     values.  Threads are sized to the column (about 4 values a thread,
//     32 to 1024), so a 1025-value column's sums cross 9 warps, not 32.
//     Bound by the rounds' latency: two passes a round over few values a
//     thread, each ending in a sum behind two barriers.  The dense fits' W
//     and H, NMFD's H, NMF2D's W and SparsityProj run here.
// (b) A thread-block cluster, column resident (hoyer_proj_resident<T,
//     true>): the smallest cluster (2 to 16 CTAs; above 8 the non-portable
//     size) that holds the column, CTA q the values [q * slice, (q + 1) *
//     slice); one launch of R clusters, which the hardware runs in waves.
//     A sum crosses the cluster through distributed shared memory with no
//     atomics: each CTA writes its partials into its own shared memory,
//     cluster.sync(), and every CTA reads all of them in rank order, so all
//     form the same double sums, the same alpha and the same stop
//     decision.  NMFD's W (410,000 values a column) runs in clusters of 8.
//     Bound by the passes' instruction issue (about 45 instructions per
//     value and round on the SMs the clusters fill), then by the sums'
//     barriers, the CTA's and the cluster's (a quarter of the time).
// (c) Streaming (hoyer_proj_stream): a column longer than 16 CTAs hold;
//     one block per column, v in the output buffer and a byte mask in a
//     caller's scratch buffer, so a round reads and writes the column in
//     HBM twice.  Bound by those bytes over the bandwidth one block draws.
//     No path of the repo reaches it at its shapes.
//
// In (a) and (b) the column is loaded 16 bytes a thread where its runs
// allow it (inner a multiple of 16 / sizeof(T) and both buffers 16-byte
// aligned; NMFD's W), else one value at a time, 8 values in flight a
// thread either way: plain loads rather than TMA bulk copies, because a
// strided column's runs (400 values for NMFD's W, 1 for a dense W) have any
// length and alignment, and each value is loaded once, a small part of the
// time.  The step pass reads the values and stores nothing; the fix-up
// forms v_new again with the same operations and stores the fixed values,
// and the last pass writes v_new (or v, at the round cap) to the output.
// A thread takes two adjacent values at a time.

// Arithmetic mirrors the plain version's, operation by operation, in every
// regime, with the _rn intrinsics so that no multiply and add are fused:
// products in the input's type, sums in double rounded once to it (only
// the order in which the double partials are added differs between
// regimes), the discriminant as XLA forms it in the JAX package's jitted
// loop (b*b exact in double, minus 4ac, rounded once; a NaN discriminant
// taken as 0), relu passing NaN.  So columns whose b*b overflows float32
// give NaN where the plain version does.  float32 and float64 instances.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// One term of the round's sums: w^2, w v and v^2, each product rounded to T
template <typename T>
__device__ __forceinline__ void accumulate(double* q, T v, T w) {
  q[0] += (double)mul(w, w);
  q[1] += (double)mul(w, v);
  q[2] += (double)mul(v, v);
}

// The round's step to the L2 sphere from its sums q = (w^2, w v, v^2)
template <typename T>
__device__ __forceinline__ T step_size(const double* q, T k2) {
  const T a = (T)q[0];
  const T b = mul(T(2), (T)q[1]);
  const T c = sub((T)q[2], k2);
  const T d = (T)__dsub_rn(__dmul_rn((double)b, (double)b),
                           (double)mul(mul(T(4), a), c));
  return divide(mul(add(-b, root(d > T(0) ? d : T(0))), T(0.5)), a);
}

// ---------------------------------------------------------------------------
// Regime (c), streaming: v and the byte mask in the caller's buffers.

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
__global__ void __launch_bounds__(kThreads) hoyer_proj_stream(const T* __restrict__ s, T* v,
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
    const T alpha = step_size(q, k2);

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

// ---------------------------------------------------------------------------
// Regimes (a) and (b): the column (or the CTA's slice of it) in shared
// memory.  Dynamic shared memory: a kHeader-byte header of sums, then the
// slice's values of T (an even count).  ops/projection.py::_smem_bytes
// mirrors resident_smem.

constexpr int kHeader = 1024;
constexpr int kMaxCluster = 16;
constexpr int kInFlight = 8;  // values a thread loads before using any

struct Sums {
  double red[32][3];  // the warps' partials
  double part[2][3];  // this CTA's partials, read by the cluster (two slots)
  double tot[3];      // the column's sums
};
static_assert(sizeof(Sums) <= kHeader, "the header holds the sums");

template <typename T>
size_t resident_smem(int slice) {
  return kHeader + ((size_t)slice + slice % 2) * sizeof(T);
}

// V values of T loaded or stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

// Sums q[0..2] over the column; every thread of every CTA of the cluster
// gets the same sums.  Fixed order: each thread's own values in order, a
// shuffle tree over the warp, the same tree over the warps' partials (warp
// 0), then (a cluster) the CTAs' partials in rank order.  blockDim.x is a
// multiple of 32.
__device__ __forceinline__ double warp_tree(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <bool kCluster>
__device__ __forceinline__ void column_sum(double* q, Sums& sh, int& slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = warp_tree(q[k]);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) sh.red[warp][k] = q[k];
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (int)(blockDim.x >> 5);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double t = warp_tree(in ? sh.red[lane][k] : 0.0);
      if (lane == 0) (kCluster ? sh.part[slot][k] : sh.tot[k]) = t;
    }
  }
  if constexpr (kCluster) {
    // the partials' slot alternates: a CTA writes slot s again two sums
    // later, after the cluster barrier of the sum between, which every CTA
    // reaches only once it has read slot s
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (warp == 0) {
      const int ctas = (int)cluster.num_blocks();
      const double* part = lane < ctas ? cluster.map_shared_rank(&sh.part[slot][0], lane) : nullptr;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const double x = lane < ctas ? part[k] : 0.0;
        double t = 0.0;
        for (int j = 0; j < ctas; ++j) t += __shfl_sync(0xffffffffu, x, j);
        if (lane == 0) sh.tot[k] = t;
      }
    }
    slot ^= 1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = sh.tot[k];
}

// A thread's walk over the slice [lo, hi) of a column's values in global
// memory, V at a time: n = lo + V * threadIdx.x, then every V * blockDim.x;
// next() returns value n's offset and steps (o, i) without a division.
// With V > 1, inner and lo are multiples of V, so V consecutive values lie
// in one run.
template <int V>
struct Walk {
  int n, o, i, step, step_o, step_i;
  const int base, inner, so;
  __device__ Walk(int lo, int base_, int inner_, int so_)
      : base(base_), inner(inner_), so(so_) {
    n = lo + V * threadIdx.x;
    o = n / inner;
    i = n - o * inner;
    step = V * blockDim.x;
    step_o = step / inner;
    step_i = step - step_o * inner;
  }
  __device__ __forceinline__ int next() {
    const int at = base + o * so + i;
    n += step;
    o += step_o;
    i += step_i;
    if (i >= inner) {
      i -= inner;
      ++o;
    }
    return at;
  }
};

// Loads the slice [lo, hi) into vs (value n at vs[n - lo]), kInFlight
// values a thread in flight (the last batch too); returns the thread's sum
// of them in double
template <int V, typename T>
__device__ __forceinline__ double gather(const T* __restrict__ x, T* vs,
                                         int lo, int hi, int base, int inner,
                                         int so) {
  using P = Pack<T, V>;
  constexpr int U = kInFlight / V;
  Walk<V> w(lo, base, inner, so);
  double sum = 0.0;
  while (w.n < hi) {
    int n[U], at[U];
    P p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      n[u] = w.n;
      at[u] = w.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (n[u] < hi) p[u] = *reinterpret_cast<const P*>(x + at[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (n[u] < hi) {
        *reinterpret_cast<P*>(vs + n[u] - lo) = p[u];
#pragma unroll
        for (int e = 0; e < V; ++e) sum += (double)p[u].x[e];
      }
  }
  return sum;
}

// Stores value(j) for the slice's values j = n - lo to the column in x
template <int V, typename T, typename Value>
__device__ __forceinline__ void scatter(T* __restrict__ x, int lo, int hi,
                                        int base, int inner, int so,
                                        Value&& value) {
  using P = Pack<T, V>;
  Walk<V> w(lo, base, inner, so);
  while (w.n < hi) {
    const int j = w.n - lo;
    P p;
#pragma unroll
    for (int e = 0; e < V; ++e) p.x[e] = value(j + e);
    *reinterpret_cast<P*>(x + w.next()) = p;
  }
}

// A stored value of the rounds: v, with its zeroed flag in the sign bit
// once a round's fix-up has written it (every v is then >= 0 or NaN, and a
// zero's sign changes no sum); before that (kFlag false) v as it is, with
// no coordinate zeroed.
template <bool kFlag>
struct Flag {
  static constexpr bool value = kFlag;
};

template <bool kFlag, typename T>
__device__ __forceinline__ T value_of(T x, bool& z) {
  z = kFlag && signbit(x);
  return kFlag ? fabs(x) : x;
}

template <typename T>
__device__ __forceinline__ T flagged(T v, bool z) {
  return z ? -fabs(v) : fabs(v);
}

// Calls x = f(x) for the slice's stored values j < len, two adjacent ones a
// thread at a time (one shared-memory access; vs holds an even count), and
// stores the results when kStore
template <bool kStore, typename T, typename F>
__device__ __forceinline__ void pairs(T* vs, int len, F&& f) {
  using P = Pack<T, 2>;
  for (int j = 2 * threadIdx.x; j < len; j += 2 * blockDim.x) {
    P p = *reinterpret_cast<const P*>(vs + j);
    p.x[0] = f(p.x[0]);
    if (j + 1 < len) p.x[1] = f(p.x[1]);
    if (kStore) *reinterpret_cast<P*>(vs + j) = p;
  }
}

template <typename T, bool kCluster>
__global__ void __launch_bounds__(1024)
    hoyer_proj_resident(const T* __restrict__ s, T* __restrict__ v,
                        const T* __restrict__ k1s, const T* __restrict__ k2s,
                        int inner, int N, int so, int sr, int slice, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  Sums& sh = *reinterpret_cast<Sums*>(smem);
  T* vs = reinterpret_cast<T*>(smem + kHeader);
  int col = blockIdx.x, lo = 0;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    col = blockIdx.x / (int)cluster.num_blocks();
    lo = (int)cluster.block_rank() * slice;
  }
  const int hi = min(N, lo + slice), len = max(hi - lo, 0);
  const int base = col * sr;
  constexpr int kVec = 16 / sizeof(T);
  const T k1 = k1s[col], k2 = k2s[col];
  int slot = 0;

  // v = s + (k1 - sum s) / N, and the first round's sums (no coordinate
  // zeroed yet: w = v - m everywhere)
  double q[3] = {0.0, 0.0, 0.0};
  q[0] = vec ? gather<kVec>(s, vs, lo, hi, base, inner, so)
             : gather<1>(s, vs, lo, hi, base, inner, so);
  column_sum<kCluster>(q, sh, slot);
  const T shift0 = divide(sub(k1, (T)q[0]), (T)N);
  T m = divide(k1, (T)N);
  q[0] = 0.0;
  pairs<true>(vs, len, [&](T x) {
    const T vi = add(x, shift0);
    accumulate(q, vi, sub(vi, m));
    return vi;
  });

  // a round; fin once no coordinate went negative
  bool fin = false, stored_flags = false;
  T alpha = T(0);
  auto round = [&](auto flags) {
    constexpr bool kFlag = decltype(flags)::value;
    // w = v - m on the active coordinates, v on the zeroed ones
    column_sum<kCluster>(q, sh, slot);
    alpha = step_size(q, k2);

    // v_new = v + alpha w (not stored); count its negatives, the zeroed
    // coordinates after them, and sum relu(v_new)
    int negs = 0, zeros = 0;
    double pos = 0.0;
    pairs<false>(vs, len, [&](T x) {
      bool z;
      const T vi = value_of<kFlag>(x, z);
      const T vn = add(vi, mul(alpha, z ? vi : sub(vi, m)));
      const bool neg = vn < T(0);
      negs += neg;
      zeros += z || neg;
      pos += (double)relu(vn);
      return x;
    });
    q[0] = negs;
    q[1] = zeros;
    q[2] = pos;
    column_sum<kCluster>(q, sh, slot);
    if (q[0] == 0.0) {
      fin = true;
      return;
    }

    // v = relu(relu(v_new) + (k1 - sum relu(v_new)) / (N - zeros)), v_new
    // formed again as the step pass formed it, and the next round's sums at
    // its m
    const int zeroed = (int)q[1];
    const T shift = divide(sub(k1, (T)q[2]), (T)(N - zeroed));
    const T m_next = divide(k1, (T)(N - zeroed));
    q[0] = q[1] = q[2] = 0.0;
    pairs<true>(vs, len, [&](T x) {
      bool z;
      const T vo = value_of<kFlag>(x, z);
      const T vn = add(vo, mul(alpha, z ? vo : sub(vo, m)));
      const bool zf = z || vn < T(0);
      const T vi = relu(add(relu(vn), shift));
      accumulate(q, vi, zf ? vi : sub(vi, m_next));
      return flagged(vi, zf);
    });
    m = m_next;
    stored_flags = true;
  };
  const long long rounds = (long long)N + 2;
  for (long long r = 0; r < rounds && !fin; ++r) {
    if (r == 0)
      round(Flag<false>{});
    else
      round(Flag<true>{});
  }

  // the result: v_new of the last round, or v at the round cap
  __syncthreads();
  auto value = [&](int j) {
    bool z;
    const T vo = stored_flags ? value_of<true>(vs[j], z) : value_of<false>(vs[j], z);
    return fin ? add(vo, mul(alpha, z ? vo : sub(vo, m))) : vo;
  };
  if (vec)
    scatter<kVec>(v, lo, hi, base, inner, so, value);
  else
    scatter<1>(v, lo, hi, base, inner, so, value);
  // no CTA leaves while the cluster may still read its partials
  if constexpr (kCluster) cg::this_cluster().sync();
}

template <typename T>
void* resident_kernel(bool cluster) {
  return cluster ? (void*)hoyer_proj_resident<T, true>
                 : (void*)hoyer_proj_resident<T, false>;
}

template <typename T>
cudaError_t launch_resident(const void* s, void* v, const void* k1,
                            const void* k2, int R, int outer, int inner,
                            int threads, int cluster, int slice,
                            cudaStream_t stream) {
  const int N = outer * inner;
  const int vec = inner % (16 / sizeof(T)) == 0 && (uintptr_t)s % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = resident_smem<T>(slice);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cluster > 1
          ? cudaLaunchKernelEx(&cfg, hoyer_proj_resident<T, true>,
                               static_cast<const T*>(s), static_cast<T*>(v),
                               static_cast<const T*>(k1),
                               static_cast<const T*>(k2), inner, N, R * inner,
                               inner, slice, vec)
          : cudaLaunchKernelEx(&cfg, hoyer_proj_resident<T, false>,
                               static_cast<const T*>(s), static_cast<T*>(v),
                               static_cast<const T*>(k1),
                               static_cast<const T*>(k2), inner, N, R * inner,
                               inner, slice, vec);
  const cudaError_t last = cudaGetLastError();  // clear it for the caller
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t launch_stream(const void* s, void* v, void* zero, const void* k1,
                          const void* k2, int R, int outer, int inner,
                          cudaStream_t stream) {
  hoyer_proj_stream<T><<<R, kThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(v),
      static_cast<uint8_t*>(zero), static_cast<const T*>(k1),
      static_cast<const T*>(k2), inner, outer * inner, R * inner, inner);
  return cudaGetLastError();
}

// The checks of a plan that the C side can make; 0 when they pass
int check_plan(int regime, int N, int threads, int cluster, int slice,
               bool zero) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0) return 1;
  switch (regime) {
    case 0:
      return !(cluster == 1 && slice == N);
    case 1:
      return !(cluster >= 2 && cluster <= kMaxCluster && slice % 32 == 0 &&
               (long long)(cluster - 1) * slice < N &&
               (long long)cluster * slice >= N);
    case 2:
      return !(cluster == 1 && threads == kThreads && zero);
  }
  return 1;
}

}  // namespace

extern "C" {

// Sets the resident kernels' attributes on the current device (their
// dynamic shared memory up to the opt-in limit; clusters above 8 CTAs) and
// returns that limit in *smem_optin.  Called once per device, before any
// projection and outside any graph capture.  Returns a cudaError_t.
int pnt_hoyer_proj_setup(int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  void* kernels[4] = {resident_kernel<float>(false), resident_kernel<float>(true),
                      resident_kernel<double>(false), resident_kernel<double>(true)};
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    err = cudaFuncSetAttribute(kernels[k],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_optin);
    if (err == cudaSuccess && k % 2 == 1)
      err = cudaFuncSetAttribute(
          kernels[k], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return (int)err;
}

// Returns a cudaError_t (0 on success).  s, v (the result) and zero (a byte
// per value, scratch: regime 2 only, else null) are contiguous tensors of
// one shape whose rank axis has R entries, outer values before it and inner
// after it; k1 and k2 hold R values; fewer than 2^31 values in all.
// float64 when f64 is 1, else float32.  regime (0: one CTA, 1: a cluster,
// 2: streaming), threads a CTA, cluster (CTAs a column) and slice (values a
// CTA holds) are ops/projection.py::_plan's; a plan the launch cannot take
// is refused with cudaErrorInvalidValue, a launch that fails returns its
// error.  Allocates nothing and reads nothing back to the host.
int pnt_hoyer_proj(const void* s, void* v, void* zero, const void* k1,
                   const void* k2, int R, int outer, int inner, int f64,
                   int regime, int threads, int cluster, int slice,
                   void* stream_ptr) {
  if (R < 1 || outer < 1 || inner < 1 ||
      (long long)R * outer * inner >= (1LL << 31) ||
      (long long)R * cluster >= (1LL << 31) ||
      check_plan(regime, outer * inner, threads, cluster, slice, zero))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (regime == 2)
    return (int)(f64 ? launch_stream<double>(s, v, zero, k1, k2, R, outer, inner, stream)
                     : launch_stream<float>(s, v, zero, k1, k2, R, outer, inner, stream));
  return (int)(f64 ? launch_resident<double>(s, v, k1, k2, R, outer, inner,
                                             threads, cluster, slice, stream)
                   : launch_resident<float>(s, v, k1, k2, R, outer, inner,
                                            threads, cluster, slice, stream));
}

// cudaOccupancyMaxActiveClusters for a plan: how many of its clusters (its
// CTAs, with one CTA a cluster) the card runs at once, in *clusters.
// Returns a cudaError_t.
int pnt_hoyer_proj_occupancy(int regime, int threads, int cluster, int slice,
                             int f64, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* kernel;
  if (regime == 2) {
    kernel = f64 ? (const void*)hoyer_proj_stream<double>
                 : (const void*)hoyer_proj_stream<float>;
  } else {
    cfg.dynamicSmemBytes = f64 ? resident_smem<double>(slice) : resident_smem<float>(slice);
    kernel = f64 ? resident_kernel<double>(regime == 1) : resident_kernel<float>(regime == 1);
  }
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  cudaGetLastError();
  return (int)err;
}

}  // extern "C"
