// TF32 tensor-core rates of the H100 and a check of the wgmma layout that
// csrc/tf32x3.cuh assumes.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/tf32_rates chip_tools/tf32_rates.cu && build/tf32_rates
//
// Prints: mma.sync m16n8k8 TF32 throughput at 4, 8 and 16 warps per SM and
// its dependent latency; one wgmma m64n88k8 TF32 product of small integers
// (exact in TF32) against the host's, with lbo and sbo in both orders; and
// wgmma throughput with one and two warpgroups per SM.
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <cmath>
#include <cuda_runtime.h>
#include "../pytorch_nmf_tpu_torch/csrc/tf32x3.cuh"
using namespace tf32x3;

// d += a * b, one mma.sync m16n8k8 TF32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void mma_tput(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x | 0x3f800000u, 0x3f800000u, 0x3f000000u, 0x3e800000u};
  uint32_t b[2] = {0x3f800000u, 0x3f000000u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(d[j], a, b);
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) for (int q = 0; q < 4; ++q) s += d[j][q];
  if (s == 12345.f) out[0] = s;
}

__global__ void mma_lat(float* out, long long* cyc, int iters) {
  float d[4] = {};
  uint32_t a[4] = {0x3f800000u, 0, 0, 0}, b[2] = {0x3f800000u, 0};
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) mma(d, a, b);
  long long t1 = clock64();
  if (threadIdx.x == 0) { cyc[0] = t1 - t0; out[0] = d[0]; }
}

// element (row, k) of a K-major no-swizzle tile whose 8-row groups hold
// kc core matrices along K: offset in floats
__device__ __host__ inline int off(int row, int k, int kc) {
  return (row / 8) * (kc * 32) + (k / 4) * 32 + (row % 8) * 4 + (k % 4);
}

template <int NT>
__global__ void wg_check(const float* A, const float* B, float* D, int swap) {
  __shared__ __align__(128) float As[64 * 8];
  __shared__ __align__(128) float Bs[8 * NT * 8];
  for (int e = threadIdx.x; e < 64 * 8; e += 128) As[off(e / 8, e % 8, 2)] = A[e];
  for (int e = threadIdx.x; e < 8 * NT * 8; e += 128) Bs[off(e / 8, e % 8, 2)] = B[e];
  fence_async_smem();
  __syncthreads();
  float d[4 * NT];
  for (int i = 0; i < 4 * NT; ++i) d[i] = 0.f;
  const uint32_t lbo = swap ? 256 : 128, sbo = swap ? 128 : 256;
  wgmma_fence();
  wgmma<NT>(d, desc(As, lbo, sbo), desc(Bs, lbo, sbo), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(d);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  for (int n = 0; n < NT; ++n)
    for (int q = 0; q < 4; ++q)
      D[(16 * w + gid + 8 * (q / 2)) * (8 * NT) + 8 * n + 2 * tig + q % 2] = d[4 * n + q];
}

template <int NT>
__global__ void wg_tput(float* out, int iters) {
  __shared__ __align__(128) float As[64 * 32];
  __shared__ __align__(128) float Bs[8 * NT * 32];
  for (int e = threadIdx.x; e < 64 * 32; e += blockDim.x) As[e] = 1.f;
  for (int e = threadIdx.x; e < 8 * NT * 32; e += blockDim.x) Bs[e] = 1.f;
  fence_async_smem();
  __syncthreads();
  float d[4 * NT];
  for (int i = 0; i < 4 * NT; ++i) d[i] = 0.f;
  const int wg = threadIdx.x / 128;
  for (int i = 0; i < iters; ++i) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      for (int t = 0; t < 3; ++t)
        wgmma<NT>(d, desc(As + ks * 64, 128, 1024), desc(Bs + ks * 64, 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_operand(d);
  float s = 0;
  for (int i = 0; i < 4 * NT; ++i) s += d[i];
  if (s == 12345.f) out[wg] = s;
}

int main() {
  float* out; long long* cyc;
  cudaMalloc(&out, 1024); cudaMalloc(&cyc, 64);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  const int iters = 20000;
  for (int warps = 4; warps <= 16; warps *= 2) {
    mma_tput<<<132 * 4, 32 * warps / 4>>>(out, 10);
    cudaEventRecord(e0);
    mma_tput<<<132 * 4, 32 * warps / 4>>>(out, iters);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    double flop = 132.0 * 4 * (warps / 4) * iters * 8 * 2048.0;
    printf("mma.sync tf32 m16n8k8, %d warps/SM: %.1f TFLOP/s\n", warps, flop / ms / 1e9);
  }
  mma_lat<<<1, 32>>>(out, cyc, 1000);
  long long c; cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  printf("mma.sync tf32 dependent latency: %.1f cycles\n", c / 1000.0);

  const int NT = 11, N = 8 * NT;
  std::vector<float> A(64 * 8), B(N * 8), D(64 * N), ref(64 * N);
  for (int m = 0; m < 64; ++m) for (int k = 0; k < 8; ++k) A[m * 8 + k] = (m * 3 + k) % 7 - 3;
  for (int n = 0; n < N; ++n) for (int k = 0; k < 8; ++k) B[n * 8 + k] = (n * 5 + k * 2) % 9 - 4;
  for (int m = 0; m < 64; ++m) for (int n = 0; n < N; ++n) {
    float s = 0;
    for (int k = 0; k < 8; ++k) s += A[m * 8 + k] * B[n * 8 + k];
    ref[m * N + n] = s;
  }
  float *dA, *dB, *dD;
  cudaMalloc(&dA, 4 * A.size()); cudaMalloc(&dB, 4 * B.size()); cudaMalloc(&dD, 4 * D.size());
  cudaMemcpy(dA, A.data(), 4 * A.size(), cudaMemcpyHostToDevice);
  cudaMemcpy(dB, B.data(), 4 * B.size(), cudaMemcpyHostToDevice);
  for (int swap = 0; swap < 2; ++swap) {
    cudaMemset(dD, 0, 4 * D.size());
    wg_check<NT><<<1, 128>>>(dA, dB, dD, swap);
    cudaError_t err = cudaDeviceSynchronize();
    cudaMemcpy(D.data(), dD, 4 * D.size(), cudaMemcpyDeviceToHost);
    double mx = 0; for (size_t i = 0; i < D.size(); ++i) mx = fmax(mx, fabs(D[i] - ref[i]));
    printf("wgmma m64n88k8 tf32 check, %s: err %s, max|D-ref| = %g\n",
           swap ? "lbo=256 sbo=128" : "lbo=128 sbo=256", cudaGetErrorString(err), mx);
  }
  for (int wgs = 1; wgs <= 2; ++wgs) {
    wg_tput<NT><<<132, 128 * wgs>>>(out, 10);
    cudaEventRecord(e0);
    wg_tput<NT><<<132, 128 * wgs>>>(out, 2000);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    double flop = 132.0 * wgs * 2000 * 12 * 2.0 * 64 * N * 8;
    printf("wgmma m64n88k8 tf32, %d warpgroups/SM: %.1f TFLOP/s (%s)\n", wgs, flop / ms / 1e9,
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
