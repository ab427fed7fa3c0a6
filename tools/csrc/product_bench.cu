// Cycle counts of the flagship kernel's ICNN product routines, alone, and
// of the issue rates they draw on; built and driven by
// `tools/product_bench.py`, which compiles a copy of this file beside a
// (possibly patched) copy of `flagship.cu` and of `mma_tf32_trial.cuh`.
//
// - `routine<TP, R>`: one block per SM calls routine R `reps` times on the
//   operands of one TP-point chunk held in shared memory (the weights in
//   global memory, as in the kernel), and block b writes its clock64 cycles
//   to cyc[b]. Block 0's output rows (or its partial row, for the weight
//   grads) come back for checking. Routines: the FP32 build's FMA
//   products, the 3xTF32 trial's and the bf16 build's tensor-core ones
//   (`mm_rows_bf16`, `wgrad_bf16`), each under the kernel's launch bounds,
//   at TP = 64 and 32.
// - `rate<MODE>`: one block per SM issues a long run of one instruction
//   kind with enough independent work to keep the pipe full.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "flagship.cu"
#include "mma_tf32_trial.cuh"

namespace bench {

enum Routine { FWD, BWD, WGRAD, TC_FWD, TC_BWD, TC_WGRAD, BF_FWD, BF_BWD,
               BF_WGRAD };

template <int TP>
constexpr int staging_floats() {
  constexpr int fma = 2 * MM<TP>::SLAB, tc = tf32x3::TcTile<TP>::STAGE;
  constexpr int bf = 2 * MMB<TP>::SLAB;
  return fma > tc ? (fma > bf ? fma : bf) : (tc > bf ? tc : bf);
}

// Shared memory: B (K rows), B2 (M rows), O (M rows), all of stride TP+4,
// then the weight staging. Forward: O(m, p) = sum_c A[m*K + c] B[c][p];
// backward data: O(m, p) = sum_c A[c*M + m] B[c][p]; weight grads:
// part[m*K + k] (+)= sum_p B2[m][p] B[k][p].
template <int TP, int R>
__global__ void __launch_bounds__(NT, 1)
    routine(const float* A, const float* Bg, const float* B2g, float* O_out,
            float* part, long long* cyc, int M, int K, int reps) {
  constexpr int TPS = TP + 4;
  extern __shared__ float4 sm4[];
  float* B = reinterpret_cast<float*>(sm4);
  float* B2 = B + K * TPS;
  float* O = B2 + M * TPS;
  float* As = O + M * TPS;
  for (int i = threadIdx.x; i < K * TPS; i += NT) B[i] = Bg[i];
  for (int i = threadIdx.x; i < M * TPS; i += NT) {
    B2[i] = B2g[i];
    O[i] = 0.f;
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * M * K;
  auto store = [&](int m, int p, float acc) { O[m * TPS + p] = acc; };
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    using namespace tf32x3;
    if constexpr (R == FWD) mm_rows<TP>(M, K, A, K, 1, B, As, store);
    if constexpr (R == BWD) mm_rows<TP>(M, K, A, 1, M, B, As, store);
    if constexpr (R == WGRAD) wgrad_tiled<TP>(M, K, B2, B, out, K, r == 0);
    if constexpr (R == TC_FWD) mm_rows_tc<TP>(M, K, A, K, 1, B, As, store);
    if constexpr (R == TC_BWD) mm_rows_tc<TP>(M, K, A, 1, M, B, As, store);
    if constexpr (R == TC_WGRAD) wgrad_tc<TP>(M, K, B2, B, out, K, r == 0);
    if constexpr (R == BF_FWD) mm_rows_bf16<TP>(M, K, A, K, 1, B, As, store);
    if constexpr (R == BF_BWD) mm_rows_bf16<TP>(M, K, A, 1, M, B, As, store);
    if constexpr (R == BF_WGRAD)
      wgrad_bf16<TP>(M, K, B2, B, out, K, r == 0, As);
    __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < M * TPS; i += NT) O_out[i] = O[i];
}

template <int TP, int R>
int launch_routine(const float* A, const float* B, const float* B2, float* O,
                   float* part, long long* cyc, int M, int K, int reps,
                   int blocks) {
  const int smem = ((K + 2 * M) * (TP + 4) + staging_floats<TP>()) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      routine<TP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  routine<TP, R><<<blocks, NT, smem>>>(A, B, B2, O, part, cyc, M, K, reps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

enum Mode { FFMA, MMA_TF32, MMA_TF32_SPLIT, MMA_BF16, MMA_CHAIN, LDS32,
            LDS128, LDS128_BCAST };

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Per thread and iteration: FFMA 8 x 32 independent FMAs; MMA_* 8
// independent MMAs (MMA_TF32_SPLIT also splits its 6 operand registers, as
// a 3xTF32 step must); MMA_CHAIN one MMA that waits on the last; LDS32 and
// LDS128 8 conflict-free shared loads each; LDS128_BCAST 8 128-bit loads
// of which each half-warp reads one address (two a warp, in distinct
// banks), as the ICNN products read their weights.
template <int MODE>
__global__ void rate(float* out, long long* cyc, int iters, float seed) {
  __shared__ float4 sh4[1024];
  float* sh = reinterpret_cast<float*>(sh4);
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) sh[i] = seed * i;
  const float x = seed * threadIdx.x;
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(x + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(x - i);
  float d[8][4];
  for (int k = 0; k < 8; ++k)
    for (int e = 0; e < 4; ++e) d[k][e] = 0.f;
  float f[32];
  for (int k = 0; k < 32; ++k) f[k] = x * k;
  __syncthreads();
  const int t = threadIdx.x;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if constexpr (MODE == FFMA) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 32; ++k) f[k] = fmaf(f[k], 1.0001f, 0.5f);
    } else if constexpr (MODE == MMA_TF32) {
#pragma unroll
      for (int k = 0; k < 8; ++k) tf32x3::mma_tf32(d[k], a, b);
    } else if constexpr (MODE == MMA_TF32_SPLIT) {
      uint32_t aa[4], bb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) aa[i] = rna(__uint_as_float(a[i]) + it);
#pragma unroll
      for (int i = 0; i < 2; ++i) bb[i] = rna(__uint_as_float(b[i]) - it);
#pragma unroll
      for (int k = 0; k < 8; ++k) tf32x3::mma_tf32(d[k], aa, bb);
    } else if constexpr (MODE == MMA_BF16) {
#pragma unroll
      for (int k = 0; k < 8; ++k) mma_bf16(d[k], a, b);
    } else if constexpr (MODE == MMA_CHAIN) {
      tf32x3::mma_tf32(d[0], a, b);
    } else if constexpr (MODE == LDS32) {
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] += sh[(t + 32 * k + it) & 4095];
    } else if constexpr (MODE == LDS128 || MODE == LDS128_BCAST) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = MODE == LDS128 ? t : 5 * (t >> 4);
        const float4 v = sh4[(i + 32 * k + it) & 1023];
        f[4 * k] += v.x;
        f[4 * k + 1] += v.y;
        f[4 * k + 2] += v.z;
        f[4 * k + 3] += v.w;
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
  float s = 0.f;
  for (int k = 0; k < 8; ++k)
    for (int e = 0; e < 4; ++e) s += d[k][e];
  for (int k = 0; k < 32; ++k) s += f[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int MODE>
int launch_rate(float* out, long long* cyc, int blocks, int threads,
                int iters) {
  rate<MODE><<<blocks, threads>>>(out, cyc, iters, 1e-3f);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

}  // namespace bench

extern "C" {

// Routine `which` (bench::Routine) at a tile of tp (64 or 32) points;
// `part` holds `blocks` partial rows of M*K floats, `O` one block's M rows
// of stride tp+4.
int product_bench_routine(int which, const float* A, const float* B,
                          const float* B2, float* O, float* part,
                          long long* cyc, int M, int K, int reps, int blocks,
                          int tp) {
  using namespace bench;
  auto run = [&](auto tile, auto r) {
    return launch_routine<decltype(tile)::value, decltype(r)::value>(
        A, B, B2, O, part, cyc, M, K, reps, blocks);
  };
  auto at = [&](auto tile) {
    switch (which) {
      case FWD: return run(tile, std::integral_constant<int, FWD>{});
      case BWD: return run(tile, std::integral_constant<int, BWD>{});
      case WGRAD: return run(tile, std::integral_constant<int, WGRAD>{});
      case TC_FWD: return run(tile, std::integral_constant<int, TC_FWD>{});
      case TC_BWD: return run(tile, std::integral_constant<int, TC_BWD>{});
      case TC_WGRAD:
        return run(tile, std::integral_constant<int, TC_WGRAD>{});
      case BF_FWD: return run(tile, std::integral_constant<int, BF_FWD>{});
      case BF_BWD: return run(tile, std::integral_constant<int, BF_BWD>{});
      case BF_WGRAD:
        return run(tile, std::integral_constant<int, BF_WGRAD>{});
    }
    return -1;
  };
  if (tp == 64) return at(std::integral_constant<int, 64>{});
  if (tp == 32) return at(std::integral_constant<int, 32>{});
  return -1;
}

// Issue-rate kernel `mode` (bench::Mode); `out` holds blocks * threads
// floats.
int product_bench_rate(int mode, float* out, long long* cyc, int blocks,
                       int threads, int iters) {
  using namespace bench;
  switch (mode) {
    case FFMA: return launch_rate<FFMA>(out, cyc, blocks, threads, iters);
    case MMA_TF32:
      return launch_rate<MMA_TF32>(out, cyc, blocks, threads, iters);
    case MMA_TF32_SPLIT:
      return launch_rate<MMA_TF32_SPLIT>(out, cyc, blocks, threads, iters);
    case MMA_BF16:
      return launch_rate<MMA_BF16>(out, cyc, blocks, threads, iters);
    case MMA_CHAIN:
      return launch_rate<MMA_CHAIN>(out, cyc, blocks, threads, iters);
    case LDS32: return launch_rate<LDS32>(out, cyc, blocks, threads, iters);
    case LDS128: return launch_rate<LDS128>(out, cyc, blocks, threads, iters);
    case LDS128_BCAST:
      return launch_rate<LDS128_BCAST>(out, cyc, blocks, threads, iters);
  }
  return -1;
}

}  // extern "C"
