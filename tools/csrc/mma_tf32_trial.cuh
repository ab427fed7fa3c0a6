// FP32-accurate ICNN products on Hopper's TF32 tensor cores (3xTF32):
// the `mma.sync` routines measured against the FMA routines of
// `awesome_tpu_torch/ops/csrc/flagship.cu` (`mm_rows`, `wgrad_tiled`), with
// the same contracts. Inside the flagship kernel they made it slower at the
// bench model (`PERF.md`, Findings), so the kernel keeps its FMA routines
// and nothing in the port includes this header; `tools/product_bench.py`
// builds it beside them and times both, alone, on the card.
//
// The TPU kernel whose products these are is
// `awesome_tpu/ops/pallas_flagship.py:_kernel` (and `_kernel_interleaved`):
// the forward W x W times W x TP, its backward-data twin, and the weight
// grads W x TP times TP x W, MXU matmuls at f32 precision there.
//
// The split. A TF32 value keeps 10 mantissa bits. Each FP32 operand x is cut
// into big = rna_tf32(x) and small = rna_tf32(x - big), and each 8-deep
// step of a product is three `mma.sync.m16n8k8` TF32 MMAs into one
// accumulator: big*small, small*big, then big*big. The dropped small*small
// term is ~2^-22 of the product (one pass of TF32 keeps ~3 decimal digits,
// too few for the port's FP32 contract). The step's accumulator starts at
// 0 and is added into the running FP32 sum with an ordinary add: the
// tensor core adds its accumulator input with too few bits to carry a long
// sum (accumulating all steps in the MMA lost the FP32 accuracy of a
// three-layer ICNN's grads on the card). Every sum has a fixed order, so
// two launches are bitwise equal.
//
// Why `mma.sync` and not `wgmma`: `wgmma` wants 64-row tiles in a shared
// layout of its own, and the flagship kernel's shared memory is nearly all
// taken by its activation rows. `mma.sync` takes its fragments from
// registers, loaded from the rows and weight slabs the kernel already has.
//
// Both routines assume blocks of TC_THREADS threads.

#pragma once

#include <cstdint>

namespace tf32x3 {

constexpr int TC_THREADS = 256;              // threads per block
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TC_KB = 8;                     // depth of a weight slab

// Tiling of mm_rows_tc for TP points: the rows are cut into MT m16 tiles
// per pass and the points into TP/8 n8 tiles; warp w takes n8 tiles
// NPW*(w % WN) .. +NPW-1 and m16 tiles w / WN + WM*i. A weight slab is
// k-major, one row of RT values per k, at stride ASTR = RT + 4 (4 mod 16:
// the A fragments' reads fall in distinct banks); the staging region holds
// two slabs, each as a plane of big halves and a plane of small halves.
template <int TP>
struct TcTile {
  static constexpr int NPW = 2;                      // n8 tiles per warp
  static constexpr int WN = TP / 8 / NPW;            // warps along points
  static constexpr int WM = TC_WARPS / WN;           // warps along rows
  static constexpr int MT = TP == 64 ? 9 : 10;       // m16 tiles per pass
  static constexpr int MPW = (MT + WM - 1) / WM;     // m16 tiles per warp
  static constexpr int RT = 16 * MT;                 // rows per pass
  static constexpr int ASTR = RT + 4;                // slab row stride
  static constexpr int SLAB = TC_KB * ASTR;          // floats per plane
  static constexpr int STAGE = 4 * SLAB;             // staging floats
  static_assert(WN * NPW * 8 == TP && WN * WM == TC_WARPS, "tiling");
  static_assert(ASTR % 16 == 4, "slab stride");
};

// x -> (big, small), both TF32 bit patterns: big = x rounded to TF32
// (nearest, ties away), small = the rounded remainder x - big (exact in
// FP32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// Split fragments of one m16n8k8 operand: N registers per lane.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    split_tf32(x, big[i], small[i]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 3xTF32 16x8x8 step of MI A fragments against NJ B fragments:
// d[i][j] = A[i]*B[j], as big*small, then small*big, then big*big, each
// term issued for every tile before the next (consecutive MMAs are
// independent). d starts from 0, not from the running sum: the tensor core
// adds its accumulator input to the step's products with too few bits to
// carry a long sum, so the caller adds d into its FP32 sum with an
// ordinary (round-to-nearest) add.
template <int MI, int NJ>
__device__ __forceinline__ void step_3xtf32(float (&d)[MI][NJ][4],
                                            const Frag<4> (&a)[MI],
                                            const Frag<2> (&b)[NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], a[i].big, b[j].small);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], a[i].small, b[j].big);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], a[i].big, b[j].big);
}

// out(m, p) = sum_c A[m*sr + c*sc] * B[c][p] for m < M, p < TP, handed to
// epi(m, p, acc). A is global (weights), staged through `As`
// (TcTile<TP>::STAGE floats) in 8-deep slabs, double-buffered and already
// split, so each weight is split once per block and not once per warp:
// while one slab is used, the next is fetched into registers, then split
// into the other buffer. B is shared rows of stride TP+4. Fragments take
// the k values of a step in the order 0,2,4,6 | 1,3,5,7 (the same for A
// and B, so the sum is unchanged), which makes the B reads free of bank
// conflicts at row stride 4 mod 32. Every warp computes all of its MPW
// tiles, with no branch between them, so their MMAs interleave; a tile
// past the slab reads the slab's last tile and is dropped. Padding: slab
// entries with m >= M or c >= K load as 0, B rows c >= K as 0, and no
// output with m >= M is handed to epi.
template <int TP, class Epi>
__device__ void mm_rows_tc(int M, int K, const float* __restrict__ A, int sr,
                           int sc, const float* B, float* As, Epi epi) {
  using T = TcTile<TP>;
  constexpr int TPS = TP + 4, KB = TC_KB, NT = TC_THREADS;
  constexpr int LPT = (KB * T::RT + NT - 1) / NT;
  const int t = threadIdx.x, warp = t / 32, g = (t % 32) >> 2, q = t & 3;
  const int n0 = 8 * T::NPW * (warp % T::WN) + g, mw = warp / T::WN;
  const int nslab = (K + KB - 1) / KB;
  const bool rowwise = sc == 1;  // A rows contiguous: fetch along c
  uint32_t* stage = reinterpret_cast<uint32_t*>(As);
  for (int m0 = 0; m0 < M; m0 += T::RT) {
    const int mt_live = min(T::MT, (M - m0 + 15) / 16);
    float pre[LPT];
    auto fetch = [&](int s) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int idx = t + l * NT;
        const int r = rowwise ? idx / KB : idx % T::RT;
        const int cc = rowwise ? idx % KB : idx / T::RT;
        const int m = m0 + r, c = s * KB + cc;
        pre[l] = (idx < KB * T::RT && m < M && c < K)
                     ? __ldcg(A + (size_t)m * sr + (size_t)c * sc)
                     : 0.f;
      }
    };
    auto stash = [&](int s) {  // into buffer s % 2: big plane, small plane
      uint32_t* big = stage + (s & 1) * 2 * T::SLAB;
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int idx = t + l * NT;
        const int r = rowwise ? idx / KB : idx % T::RT;
        const int cc = rowwise ? idx % KB : idx / T::RT;
        if (idx < KB * T::RT)
          split_tf32(pre[l], big[cc * T::ASTR + r],
                     big[T::SLAB + cc * T::ASTR + r]);
      }
    };
    float acc[T::MPW][T::NPW][4];
#pragma unroll
    for (int i = 0; i < T::MPW; ++i)
#pragma unroll
      for (int j = 0; j < T::NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int s = 0; s < nslab; ++s) {
      if (s + 1 < nslab) fetch(s + 1);
      const uint32_t* big = stage + (s & 1) * 2 * T::SLAB;
      const int c = s * KB + 2 * q;  // this lane's k: c and c + 1
      Frag<2> b[T::NPW];
#pragma unroll
      for (int j = 0; j < T::NPW; ++j) {
        const float* bp = B + n0 + 8 * j;
        b[j].set(0, c < K ? bp[c * TPS] : 0.f);
        b[j].set(1, c + 1 < K ? bp[(c + 1) * TPS] : 0.f);
      }
      Frag<4> a[T::MPW];
#pragma unroll
      for (int i = 0; i < T::MPW; ++i) {
        const int tile = min(mw + T::WM * i, T::MT - 1);
        const int o = 2 * q * T::ASTR + g + 16 * tile;
        const int off[4] = {o, o + 8, o + T::ASTR, o + T::ASTR + 8};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[i].big[e] = big[off[e]];
          a[i].small[e] = big[T::SLAB + off[e]];
        }
      }
      float st[T::MPW][T::NPW][4];
      step_3xtf32(st, a, b);
#pragma unroll
      for (int i = 0; i < T::MPW; ++i)
#pragma unroll
        for (int j = 0; j < T::NPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += st[i][j][e];
      if (s + 1 < nslab) stash(s + 1);
      __syncthreads();
    }
    // accumulator e of a tile holds row g + 8*(e/2), point 2q + e%2
#pragma unroll
    for (int i = 0; i < T::MPW; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * (mw + T::WM * i) + g + 8 * (e >> 1);
        if (mw + T::WM * i < mt_live && m < M) {
#pragma unroll
          for (int j = 0; j < T::NPW; ++j)
            epi(m, n0 - g + 8 * j + 2 * q + (e & 1), acc[i][j][e]);
        }
      }
    }
  }
}

// out[m*ld + k] (+)= sum_{p < TP} A[m][p] * B[k][p] for m < M, k < K: the
// weight grads of one chunk added into a block's partial row (`first`
// overwrites). A and B are shared rows of stride TP+4 (4 mod 32: the
// fragments' reads fall in distinct banks). Each m16 row of output tiles
// is cut into segments of at most SEG n8 tiles, of near-equal length,
// which share their A fragments; warp w takes segments w, w + 8, ... Each
// output element is owned by one lane and sums over p in a fixed order;
// then its old value is read and the sum added (the kernel sits at 255
// registers: holding the old values across the MMAs spills).
// Rows m >= M and columns k >= K load as 0 and are not stored.
template <int TP>
__device__ void wgrad_tc(int M, int K, const float* A, const float* B,
                         float* out, int ld, bool first) {
  constexpr int TPS = TP + 4, SEG = 6;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const int q = threadIdx.x & 3;
  const int ntn = (K + 7) / 8, per_row = (ntn + SEG - 1) / SEG;
  const int nseg = ((M + 15) / 16) * per_row;
  for (int sg = warp; sg < nseg; sg += TC_WARPS) {
    const int mt = sg / per_row, part = sg % per_row;
    const int nt0 = part * ntn / per_row;
    const int len = (part + 1) * ntn / per_row - nt0;
    // this lane's rows ma, ma + 8 and columns kb + 8j + {0, 1}; columns at
    // or past kend are outside the segment or the matrix
    const int ma = 16 * mt + g, kb = 8 * nt0 + 2 * q;
    const int kend = min(K, 8 * (nt0 + len));
    const bool mlive[2] = {ma < M, ma + 8 < M};
    float* orow[2] = {out + ma * ld + kb, out + (ma + 8) * ld + kb};
    const float* arow[2] = {A + ma * TPS, A + (ma + 8) * TPS};
    const float* brow = B + (kb - 2 * q + g) * TPS;
    float acc[SEG][4];
#pragma unroll
    for (int j = 0; j < SEG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // not unrolled: unrolled, the depth steps hold too many registers
#pragma unroll 1
    for (int p0 = 0; p0 < TP; p0 += 8) {
      const int p = p0 + q;  // fragment depths q and q + 4
      Frag<4> a[1];
      a[0].set(0, mlive[0] ? arow[0][p] : 0.f);
      a[0].set(1, mlive[1] ? arow[1][p] : 0.f);
      a[0].set(2, mlive[0] ? arow[0][p + 4] : 0.f);
      a[0].set(3, mlive[1] ? arow[1][p + 4] : 0.f);
      Frag<2> b[SEG];
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        const bool live = kb - 2 * q + g + 8 * j < kend;
        b[j].set(0, live ? brow[8 * j * TPS + p] : 0.f);
        b[j].set(1, live ? brow[8 * j * TPS + p + 4] : 0.f);
      }
      float st[1][SEG][4];
      step_3xtf32(st, a, b);
#pragma unroll
      for (int j = 0; j < SEG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += st[0][j][e];
    }
    // the segment's old values: all loads first, so they wait on one
    // memory latency together
    float old[SEG][4];
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, dk = 8 * j + (e & 1);
        old[j][e] = (!first && mlive[r] && kb + dk < kend)
                        ? __ldcg(orow[r] + dk)
                        : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, dk = 8 * j + (e & 1);
        if (mlive[r] && kb + dk < kend)
          __stcg(orow[r] + dk, old[j][e] + acc[j][e]);
      }
    }
  }
}

}  // namespace tf32x3
