// Cycle counts of the ICNN kernels' product routines (K4/K5), alone; built
// and driven by `tools/product_bench.py`, which compiles a copy of this file
// beside a copy of `icnn.cu` (this checkout's, or another one's with
// `--parent`). `icnn.cu` and `flagship.cu` define the same names, so this
// bench is a translation unit of its own.
//
// `routine<TP, R>`: one block per SM calls routine R `reps` times on the
// operands of one TP-point chunk held in shared memory (the weights in
// global memory, as in the kernels), and block b writes its clock64 cycles
// to cyc[b]. Block 0's output rows (or its weight grads) come back for
// checking. ICNN_BENCH_API names the routines' interface: 1 for the
// row-strided routines with per-chunk partial-row updates, 2 for the
// float4 routines (weights staged by cp.async, or resident).

#include <cuda_runtime.h>

#include "icnn.cu"

namespace ibench {

enum Routine { FWD, BWD, WGRAD, FWD_RES, BWD_RES };

#if ICNN_BENCH_API == 1
int staging_floats(int, int) { return slab_floats(64); }
#else
// the slabs, or A resident (FWD_RES, BWD_RES: rows of stride
// res_stride(K), whole passes read)
int staging_floats(int M, int K) {
  return imax(slab_floats(64), rows_read(64, M) * res_stride(K));
}
#endif

// Shared memory: B (K rows), B2 (M rows), O (M rows), all of stride TP+4,
// then the weight staging. Forward: O(m, p) = sum_c A[m*K + c] B[c][p];
// backward data: O(m, p) = sum_c A[c*M + m] B[c][p]; weight grads:
// part[m*K + k] = sum_p B2[m][p] B[k][p] (each call's sum; the first call
// writes, later ones add). FWD_RES and BWD_RES are FWD and BWD with A
// copied into shared memory once, before the timed calls.
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
#if ICNN_BENCH_API != 1
  const int ast = res_stride(K);
  if (R == FWD_RES || R == BWD_RES)
    for (int e = threadIdx.x; e < M * K; e += NT) {
      const int m = e / K, c = e % K;
      As[m * ast + c] = R == FWD_RES ? A[m * K + c] : A[c * M + m];
    }
#endif
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * M * K;
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#if ICNN_BENCH_API == 1
    auto store = [&](int m, int p, float acc) { O[m * TPS + p] = acc; };
    if constexpr (R == FWD) mm_rows<TP>(M, K, A, K, 1, B, As, store);
    if constexpr (R == BWD) mm_rows<TP>(M, K, A, 1, M, B, As, store);
    if constexpr (R == WGRAD) wgrad_tiled<TP>(M, K, B2, B, out, K, r == 0);
#else
    auto store4 = [&](int m, int p0, float4 v) { st4(O + m * TPS + p0, v); };
    if constexpr (R == FWD)
      mm_rows<TP, false>(
          M, K, [&](int m, int c) { return A + m * K + c; }, B, As, 0,
          store4);
    if constexpr (R == BWD)
      mm_rows<TP, false>(
          M, K, [&](int m, int c) { return A + c * M + m; }, B, As, 0,
          store4);
    if constexpr (R == FWD_RES || R == BWD_RES)
      mm_rows<TP, true>(
          M, K, [&](int, int) { return A; }, B, As, ast, store4);
    if constexpr (R == WGRAD) {
      WgradAcc acc;
      for (int m0 = 0; m0 < M; m0 += WG::MT)
        for (int k0 = 0; k0 < K; k0 += WG::KT) {
          acc.zero();
          wgrad_acc<TP>(acc, M, K, m0, k0, B2,
                        [&](int k) { return B + k * TPS; });
          acc.store(M, K, m0, k0, r > 0,
                    [&](int m, int k) { return out + m * K + k; });
        }
    }
#endif
    __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < M * TPS; i += NT) O_out[i] = O[i];
}

template <int TP, int R>
int launch(const float* A, const float* B, const float* B2, float* O,
           float* part, long long* cyc, int M, int K, int reps, int blocks) {
  const int smem = ((K + 2 * M) * (TP + 4) + staging_floats(M, K)) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      routine<TP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  routine<TP, R><<<blocks, NT, smem>>>(A, B, B2, O, part, cyc, M, K, reps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

}  // namespace ibench

extern "C" {

// Routine `which` (ibench::Routine) at TP = 64; `part` holds `blocks`
// weight-grad rows of M*K floats, `O` one block's M rows of stride 68.
int icnn_bench_routine(int which, const float* A, const float* B,
                       const float* B2, float* O, float* part,
                       long long* cyc, int M, int K, int reps, int blocks) {
  using namespace ibench;
  switch (which) {
    case FWD:
      return launch<64, FWD>(A, B, B2, O, part, cyc, M, K, reps, blocks);
    case BWD:
      return launch<64, BWD>(A, B, B2, O, part, cyc, M, K, reps, blocks);
    case WGRAD:
      return launch<64, WGRAD>(A, B, B2, O, part, cyc, M, K, reps, blocks);
#if ICNN_BENCH_API != 1
    case FWD_RES:
      return launch<64, FWD_RES>(A, B, B2, O, part, cyc, M, K, reps, blocks);
    case BWD_RES:
      return launch<64, BWD_RES>(A, B, B2, O, part, cyc, M, K, reps, blocks);
#endif
  }
  return -1;
}

}  // extern "C"
