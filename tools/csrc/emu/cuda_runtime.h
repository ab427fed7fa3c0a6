#pragma once
// The CUDA subset `awesome_tpu_torch/ops/csrc/flagship.cu` uses, emulated on
// the CPU for `tools/flagship_emulate.py`: one block at a time, one
// std::thread per CUDA thread, std::barrier for __syncthreads and for a
// warp's shuffles. Inline PTX (the bf16 build's mma.sync) is not emulated.
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __restrict__
#define __shared__
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
struct uint3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx, blockIdx;
extern uint3 blockDim, gridDim;
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2, cudaDevAttrMaxSharedMemoryPerBlockOptin = 3, cudaDevAttrMultiProcessorCount = 4 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, int) { *n = 1; return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaSetDevice(int) { return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 0; return 0; }
template <class T> int cudaMemcpyToSymbol(T&, const void*, size_t) { return 0; }
template <class T> int cudaMemcpyFromSymbol(void*, T&, size_t) { return 0; }
extern std::barrier<>* g_bar;
extern std::barrier<>* g_wbar[32];
extern float g_wbuf[32][32];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __syncwarp() { g_wbar[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_wbuf[w][l] = v;
  g_wbar[w]->arrive_and_wait();
  const float r = g_wbuf[w][l ^ m];
  g_wbar[w]->arrive_and_wait();
  return r;
}
inline float __ldcg(const float* p) { return *p; }
inline void __stcg(float* p, float v) { *p = v; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline long long clock64() { return 0; }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
using std::min; using std::max;
