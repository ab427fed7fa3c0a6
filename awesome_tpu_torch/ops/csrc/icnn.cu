// ICNN (ConvexNextNet) forward and backward over coordinate points, for
// NVIDIA Hopper (sm_90a), bound with ctypes (plain C entry points at the
// bottom).
//
// Replaces `awesome_tpu/ops/pallas_mlp.py:_icnn_kernel` (the forward, K4)
// and `awesome_tpu/ops/pallas_mlp.py:_icnn_bwd_kernel` (the backward, K5).
// For each image g of a group of G, with weights in (out, in) layout:
//
//   h_0 = relu(Win x + bin)
//   h_l = relu(Wln_l h_{l-1} + bln_l + Wsk_l x)        l = 1..L
//   y   = Wout h_L + bout + Wosk x                      (one output)
//
// x is (N, C) with C in {2, 3}: shared by the group (stride 0) or one set
// per image. The backward takes the upstream g = dL/dy (G, N) and gives
// dx (G, N, C) and every weight's grad summed over the points, in the
// order of `_flat_weights` (`pallas_mlp.py:106`): win, bin, then per layer
// wln, bln, wsk, then wout, bout, wosk. Each image's parameters are one
// flat row of P floats in that order.
//
// What bounds it on an H100. Per point the forward costs
// C*W + L*(W^2 + C*W) + W + C MACs: 17,552 for W=130, L=1, C=2. At 480x640
// (307,200 points) that is ~10.8 GFLOP, ~0.16 ms at the card's 67 TFLOP/s
// FP32. The backward is three passes (recompute, weight grads, data
// grads): ~32.3 GFLOP, ~0.48 ms. A point moves ~24 B (x, g, y, dx), ~7 MB
// a step, ~2 us at 3.35 TB/s: both kernels are bound by FP32 arithmetic.
// The arithmetic is plain FP32 FMAs (no TF32, no tensor cores), as the TPU
// reference pins full f32 on its CPU path.
//
// Design. A block takes one image and a tile of `chunks` chunks of TP
// points (TP = 64, or 32 for wide models); per chunk every activation stays
// in shared memory, rows of TP+4 floats (16-byte aligned). K5 recomputes
// the forward and keeps all L+1 post-relu rows (a relu's mask is
// `post > 0`); it gets no saved activations from K4, as on the TPU.
// - The W x W products (`mm_rows`) read float4s from shared memory: a
//   thread owns 9 rows x 4 points (TP = 64) and per 4 k-steps reads its 9
//   rows' 4 weights and the 4 point rows, 13 float4 loads for 144 FMAs.
// - Resident weights (the main path: one hidden layer, TP = 64). Each
//   block copies Wln once into shared memory, rows of stride
//   `res_stride(W)` (K5 also its transpose, with Wsk's columns after it),
//   and reads it for every chunk: no staging and no barrier inside a
//   product. K5 writes each dz over the activation it masks, so it keeps
//   no dz buffers. Shared memory at W = 130: K4 109,184 B (two blocks per
//   SM), K5 220,080 B (one).
// - Staged weights (L >= 2, or widths whose resident layout does not
//   fit): every product copies its weight in 16-deep slabs of [row][k]
//   (stride 20 floats) by 4-byte cp.async, the next slab landing while
//   the current one is used (one barrier a slab); the forward keeps two
//   W-row buffers, K5 two W-row dz buffers. Shared memory at W = 130, L =
//   2: K4 98,944 B, K5 205,712 B.
// - The weight grads (`wgrad_acc`) step the points by 4: a thread owns 5
//   x 17 outputs and reads 5 + 17 float4s per 340 FMAs. K5 folds its small
//   sums into the products: a hidden layer's dWln, dbln and dWsk are one
//   weight-grad product of dz against [h_{l-1}; x; 1] (W + C + 1 columns),
//   and its dx term Wsk^T dz rides as C more output rows of the
//   backward-data product, whose epilogue adds them into dx. The output
//   layer's and the input layer's grads are a thread per output (float4
//   loads), summed into a block-resident row in shared memory.
// - K4's output layer is the last product's epilogue: each thread sums
//   wout[m] h[m][p] over its rows into its slot of a row-group buffer, then
//   y sums the row groups in order; h_L is never stored.
// - Reduction without atomics. The TPU kernel adds weight grads into
//   VMEM-resident outputs across its sequential grid. Here each block
//   writes its own partial row of P floats to a (G, n_tiles, P) scratch,
//   and a second kernel sums the rows in tile order. A block holds its
//   sums across its chunks and writes the partial row once, at its end:
//   the small grads in shared memory, the hidden layer's weight grads in
//   registers (resident layout, W <= 160, W + C + 1 <= 136: one tile).
//   Otherwise those weight grads are added into the partial row through
//   L2 once a chunk. Each sum runs over the points in order, chunk after
//   chunk, each element always owned by one thread: two launches on the
//   same inputs are bitwise equal.
// - Ragged tail: points n >= N load x = g = 0 and are never written, so
//   they add exactly 0 to every weight grad (the TPU pads with g = 0).

#include <cuda_runtime.h>

// Built with -DICNN_PROFILE, the kernels add the cycles of each phase of
// block (0, 0) into g_phase_cycles (read by icnn_phase_cycles); every
// PHASE(k) then also waits at a barrier, so phases do not overlap. Without
// the define PHASE(k) is empty. `tools/icnn_phases.py` builds this variant
// and prints the breakdown.
#ifdef ICNN_PROFILE
__device__ unsigned long long g_phase_cycles[16];
#define PHASE(k)                                                          \
  do {                                                                    \
    __syncthreads();                                                      \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {         \
      const long long now = clock64();                                    \
      g_phase_cycles[k] += now - phase_t0;                                \
      phase_t0 = now;                                                     \
    }                                                                     \
  } while (0)
#define PHASE_START long long phase_t0 = clock64()
#else
#define PHASE(k) \
  do {           \
  } while (0)
#define PHASE_START \
  do {              \
  } while (0)
#endif

namespace {

constexpr int NT = 256;   // threads per block
constexpr int KB = 16;    // weight-slab depth of the W x W products
constexpr int MAX_C = 4;  // rows kept for the input points

// Thread tiling of the W x W products for TP points.
template <int TP>
struct MM {
  static constexpr int PG = TP / 4;               // point groups (float4)
  static constexpr int MG = NT / PG;              // row groups
  static constexpr int RI = (144 + MG - 1) / MG;  // rows per thread
  static constexpr int RT = MG * RI;              // rows per pass
  static constexpr int AST = KB + 4;              // slab row stride
  static constexpr int SLAB = RT * AST;           // floats per slab
  static constexpr int LPT = KB * RT / NT;        // copies a thread issues
  static_assert(KB * RT % NT == 0 && RT % 8 == 0, "slab copy mapping");
};

// Thread tiling of the weight grads: rows mg + MS*i (i < RI) x columns
// kg + KS*j (j < RJ), a tile of MT x KT.
struct WG {
  static constexpr int RI = 5, RJ = 17, MS = 32, KS = 8;
  static constexpr int MT = MS * RI, KT = KS * RJ;
};

// Offsets in one image's parameter row (`_flat_weights` order).
struct Layout {
  int win, bin, wln0, layer, wout, bout, wosk, P;
};

__host__ __device__ inline Layout layout(int C, int W, int L) {
  Layout o;
  o.win = 0;
  o.bin = W * C;
  o.wln0 = o.bin + W;
  o.layer = W * W + W + W * C;  // wln, bln, wsk of one layer
  o.wout = o.wln0 + L * o.layer;
  o.bout = o.wout + W;
  o.wosk = o.bout + 1;
  o.P = o.wosk + C;
  return o;
}

struct Dims {
  int N, C, W, L, x_gstride, chunks, n_chunks;
};

__host__ __device__ inline int slab_floats(int tp) {
  return tp == 64 ? 2 * MM<64>::SLAB : 2 * MM<32>::SLAB;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Rows a product over M rows reads from its weight: whole passes.
__host__ __device__ inline int rows_read(int tp, int M) {
  const int rt = tp == 64 ? MM<64>::RT : MM<32>::RT;
  return (M + rt - 1) / rt * rt;
}

// Row stride of a weight held whole in shared memory (K columns): K
// rounded up to 4 floats, plus 4 where that is a multiple of 16, so the
// rows one warp reads (2 or 4, one row group apart) fall in distinct banks.
__host__ __device__ inline int res_stride(int K) {
  const int s = (K + 3) & ~3;
  return s % 16 == 0 ? s + 4 : s;
}

// K5's block-resident grad row: wout, bout, wosk, then win, bin.
__host__ __device__ inline int grad_row_floats(int W) {
  return (W * (MAX_C + 2) + 1 + MAX_C + 3) & ~3;
}

// Shared floats of one block: kind 0 the forward, 1 the backward; `res`
// the layout with the weights resident (one hidden layer), else staged.
// A resident product reads whole passes of rows (`rows_read`), past its
// weight into what follows it, which the size covers.
__host__ __device__ inline int smem_floats(int kind, int tp, int W, int L,
                                           bool res) {
  const int tps = tp + 4;
  if (kind == 0) {
    if (!res) return (MAX_C + 2 * W) * tps + slab_floats(tp) + 4 * NT;
    const int n = W * res_stride(W) + (MAX_C + W) * tps + 4 * NT;
    return imax(n, rows_read(tp, W) * res_stride(W));
  }
  if (!res)
    return (2 * MAX_C + 2 + (L + 3) * W) * tps + slab_floats(tp) +
           grad_row_floats(W);
  const int n = (2 * W + MAX_C) * res_stride(W) +
                (2 * MAX_C + 2 + 2 * W) * tps + grad_row_floats(W) + 4 * NT;
  return imax(n, imax(rows_read(tp, W), W + rows_read(tp, W + MAX_C)) *
                     res_stride(W));
}

// K5 holds the hidden layer's weight grads in registers across a block's
// chunks (resident layout only) when one tile covers them.
__host__ __device__ inline bool hold_wgrads(int C, int W) {
  return W <= WG::MT && W + C + 1 <= WG::KT;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// a += s * b, lane by lane
__device__ __forceinline__ void fma4(float4& a, float s, float4 b) {
  a.x = fmaf(s, b.x, a.x);
  a.y = fmaf(s, b.y, a.y);
  a.z = fmaf(s, b.z, a.z);
  a.w = fmaf(s, b.w, a.w);
}

// sum_p a[p] * b[p] over TP points, in order
template <int TP>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float v = 0.f;
#pragma unroll 4
  for (int p = 0; p < TP; p += 4) {
    const float4 x = ld4(a + p), y = ld4(b + p);
    v = fmaf(x.x, y.x, v);
    v = fmaf(x.y, y.y, v);
    v = fmaf(x.z, y.z, v);
    v = fmaf(x.w, y.w, v);
  }
  return v;
}

// Copy one float from global to shared memory, asynchronously (0 if !ok).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// out(m, p) = sum_c A(m, c) * B[c][p] for m < M, p < TP, handed to
// epi(m, p0, v) four points p0..p0+3 at a time. B is shared rows of stride
// TP+4. RES: A is resident in shared memory at `As`, rows of stride `ast`
// (rows up to rows_read(TP, M) are read; those past M are not used).
// Else at(m, c) is the address of A(m, c) in global memory (the weights),
// staged through `As` (2 slabs); the caller separates two such calls by a
// barrier. Each thread owns RI rows (mg + MG*i) x 4 consecutive points and
// sums over c in order. The staged form unrolls neither its copies nor
// its k-steps: unrolled, K5 (and K4 under its 128 registers) spill.
template <int TP, bool RES, class At, class Epi>
__device__ void mm_rows(int M, int K, At at, const float* B, float* As,
                        int ast, Epi epi) {
  using T = MM<TP>;
  constexpr int TPS = TP + 4, RG = T::RT / 8;
  const int t = threadIdx.x, pg = t % T::PG, mg = t / T::PG;
  const int nslab = (K + KB - 1) / KB;
  const int rs = RES ? ast : T::AST;  // A's row stride
  for (int m0 = 0; m0 < M; m0 += T::RT) {
    if (!RES && m0 > 0) __syncthreads();  // the last pass's slabs are read
    // a warp copies 8 rows x 4 columns of a slab: 32 distinct banks
    auto fetch = [&](int s) {
      float* dst = As + (s & 1) * T::SLAB;
#pragma unroll 1
      for (int l = 0; l < T::LPT; ++l) {
        const int idx = t + l * NT, hi = idx >> 5;
        const int r = ((idx >> 2) & 7) + 8 * (hi % RG);
        const int cc = (idx & 3) + 4 * (hi / RG);
        const int m = m0 + r, c = s * KB + cc;
        const bool ok = m < M && c < K;
        cp_async4(dst + r * T::AST + cc, at(ok ? m : 0, ok ? c : 0), ok);
      }
      cp_async_commit();
    };
    float4 acc[T::RI];
#pragma unroll
    for (int i = 0; i < T::RI; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!RES) fetch(0);
    for (int s = 0; s < nslab; ++s) {
      const float* ap;
      if (RES) {
        ap = As + (m0 + mg) * rs + s * KB;
      } else {
        cp_async_wait_all();
        __syncthreads();  // slab s landed; slab s-1 is read by every thread
        if (s + 1 < nslab) fetch(s + 1);
        ap = As + (s & 1) * T::SLAB + mg * T::AST;
      }
      const float* bp = B + s * KB * TPS + 4 * pg;
      const int kmax = min(KB, K - s * KB);
      auto step4 = [&](int kk) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(bp + (kk + j) * TPS);
#pragma unroll
        for (int i = 0; i < T::RI; ++i) {
          const float4 a = ld4(ap + T::MG * i * rs + kk);
          fma4(acc[i], a.x, b[0]);
          fma4(acc[i], a.y, b[1]);
          fma4(acc[i], a.z, b[2]);
          fma4(acc[i], a.w, b[3]);
        }
      };
      if (kmax == KB) {
#pragma unroll (RES ? 4 : 1)
        for (int kk = 0; kk < KB; kk += 4) step4(kk);
      } else {
        int kk = 0;
        for (; kk + 4 <= kmax; kk += 4) step4(kk);
        for (; kk < kmax; ++kk) {
          const float4 b = ld4(bp + kk * TPS);
#pragma unroll
          for (int i = 0; i < T::RI; ++i)
            fma4(acc[i], ap[T::MG * i * rs + kk], b);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < T::RI; ++i) {
      const int m = m0 + mg + T::MG * i;
      if (m < M) epi(m, 4 * pg, acc[i]);
    }
  }
}

// A thread's share of a weight-grad tile, held in registers.
struct WgradAcc {
  float v[WG::RI][WG::RJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WG::RI; ++i)
#pragma unroll
      for (int j = 0; j < WG::RJ; ++j) v[i][j] = 0.f;
  }

  // Write (add: add into) the tile at (m0, k0) of an M x K grad, element
  // (m, k) at out(m, k), a row at a time: a row's loads go out together.
  template <class Out>
  __device__ __forceinline__ void store(int M, int K, int m0, int k0,
                                        bool add, Out out) const {
    const int kg = threadIdx.x % WG::KS, mg = threadIdx.x / WG::KS;
#pragma unroll
    for (int i = 0; i < WG::RI; ++i) {
      const int m = m0 + mg + WG::MS * i;
      if (m >= M) continue;
      float old[WG::RJ];
#pragma unroll
      for (int j = 0; j < WG::RJ; ++j) {
        const int k = k0 + kg + WG::KS * j;
        old[j] = (add && k < K) ? __ldcg(out(m, k)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < WG::RJ; ++j) {
        const int k = k0 + kg + WG::KS * j;
        if (k < K) __stcg(out(m, k), old[j] + v[i][j]);
      }
    }
  }
};

// acc(m, k) += sum_{p < TP} A[m][p] * row(k)[p] over the tile at (m0, k0)
// of an M x K grad, the points in order. A is shared rows of stride TP+4;
// row(k) is the shared row of column k.
template <int TP, class Row>
__device__ __forceinline__ void wgrad_acc(WgradAcc& acc, int M, int K,
                                          int m0, int k0, const float* A,
                                          Row row) {
  constexpr int TPS = TP + 4;
  const int kg = threadIdx.x % WG::KS, mg = threadIdx.x / WG::KS;
  const float* ar[WG::RI];
  const float* br[WG::RJ];
#pragma unroll
  for (int i = 0; i < WG::RI; ++i)
    ar[i] = A + min(m0 + mg + WG::MS * i, M - 1) * TPS;
#pragma unroll
  for (int j = 0; j < WG::RJ; ++j)
    br[j] = row(min(k0 + kg + WG::KS * j, K - 1));
  for (int p = 0; p < TP; p += 4) {
    float4 av[WG::RI];
#pragma unroll
    for (int i = 0; i < WG::RI; ++i) av[i] = ld4(ar[i] + p);
#pragma unroll
    for (int j = 0; j < WG::RJ; ++j) {
      const float4 b = ld4(br[j] + p);
#pragma unroll
      for (int i = 0; i < WG::RI; ++i) {
        float& a = acc.v[i][j];
        a = fmaf(av[i].x, b.x, a);
        a = fmaf(av[i].y, b.y, a);
        a = fmaf(av[i].z, b.z, a);
        a = fmaf(av[i].w, b.w, a);
      }
    }
  }
}

// Load a chunk's points, transposed into rows X[k][p]; points past N load
// as 0 (and g as 0, when G_ is given).
template <int TP>
__device__ void load_chunk(const float* xg, const float* gg, int base,
                           const Dims& d, float* X, float* G_) {
  constexpr int TPS = TP + 4;
  for (int e = threadIdx.x; e < d.C * TP; e += NT) {
    const int k = e / TP, p = e % TP, n = base + p;
    X[k * TPS + p] = n < d.N ? xg[(size_t)n * d.C + k] : 0.f;
  }
  if (G_)
    for (int p = threadIdx.x; p < TP; p += NT) {
      const int n = base + p;
      G_[p] = n < d.N ? gg[n] : 0.f;
    }
}

// h_0 = relu(Win x + bin) into rows H: a thread owns 4 points (its x in
// registers) of the rows mg, mg + MG, ...
template <int TP>
__device__ void input_layer(const float* P, const Layout& o, const Dims& d,
                            const float* X, float* H) {
  using T = MM<TP>;
  constexpr int TPS = TP + 4;
  const int C = d.C, p0 = 4 * (threadIdx.x % T::PG);
  float4 xv[MAX_C];
#pragma unroll
  for (int k = 0; k < MAX_C; ++k)
    if (k < C) xv[k] = ld4(X + k * TPS + p0);
#pragma unroll 3
  for (int m = threadIdx.x / T::PG; m < d.W; m += T::MG) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < C) fma4(v, __ldg(P + o.win + m * C + k), xv[k]);
    const float b = __ldg(P + o.bin + m);
    st4(H + m * TPS + p0,
        make_float4(fmaxf(v.x + b, 0.f), fmaxf(v.y + b, 0.f),
                    fmaxf(v.z + b, 0.f), fmaxf(v.w + b, 0.f)));
  }
}

// h = relu(Wln_l h_in + bln_l + Wsk_l x), handed to out(m, p0, h) four
// points at a time. RES: Wln_l is resident at `As` (row stride
// res_stride(W)); else staged through the slabs at `As`.
template <int TP, bool RES, class Out>
__device__ void hidden_layer(const float* P, const Layout& o, const Dims& d,
                             int l, const float* X, const float* hin,
                             float* As, Out out) {
  constexpr int TPS = TP + 4;
  const int W = d.W, C = d.C;
  const float* wl = P + o.wln0 + (size_t)l * o.layer;
  const float* bl = wl + W * W;
  const float* ws = bl + W;
  mm_rows<TP, RES>(
      W, W, [&](int m, int c) { return wl + m * W + c; }, hin, As,
      res_stride(W),
      [&](int m, int p0, float4 v) {
        for (int k = 0; k < C; ++k)
          fma4(v, __ldg(ws + m * C + k), ld4(X + k * TPS + p0));
        const float b = __ldg(bl + m);
        v.x = fmaxf(v.x + b, 0.f);
        v.y = fmaxf(v.y + b, 0.f);
        v.z = fmaxf(v.z + b, 0.f);
        v.w = fmaxf(v.w + b, 0.f);
        out(m, p0, v);
      });
}

// Copy Wln_0 (W x W, row-major) into rows of stride res_stride(W) at WR,
// and (WT != nullptr) its transpose at WT, followed by Wsk_0's transpose
// (C rows): the resident weights of the products.
__device__ void stage_weights(const float* P, const Layout& o, const Dims& d,
                              float* WR, float* WT) {
  const int W = d.W, C = d.C, ast = res_stride(W);
  const float* wl = P + o.wln0;
  const float* ws = wl + W * W + W;
  for (int e = threadIdx.x; e < W * W; e += NT) {
    const int m = e / W, c = e % W;
    const float v = __ldg(wl + e);
    WR[m * ast + c] = v;
    if (WT) WT[c * ast + m] = v;
  }
  if (WT)
    for (int e = threadIdx.x; e < W * C; e += NT) {
      const int m = e / C, k = e % C;
      WT[(W + k) * ast + m] = __ldg(ws + e);
    }
}

// ---- K4: forward ----
// RES: one hidden layer, its weight resident in shared memory; else every
// layer's weight staged in slabs per chunk.
template <int TP, bool RES>
__global__ void __launch_bounds__(NT, 2)
    icnn_fwd(const float* __restrict__ x, const float* __restrict__ params,
             float* __restrict__ y, Dims d) {
  using T = MM<TP>;
  constexpr int TPS = TP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int W = d.W, C = d.C, L = d.L;
  const Layout o = layout(C, W, L);
  // RES: [Wln_0] X H0 RED; else X H0 H1 [2 slabs] RED
  float* WR = sm;
  float* X = RES ? WR + W * res_stride(W) : sm;  // MAX_C rows: the points
  float* H0 = X + MAX_C * TPS;                     // W rows
  float* H1 = H0 + W * TPS;                        // W rows (staged only)
  float* As = RES ? WR : H1 + W * TPS;
  float* RED = RES ? H1 : As + slab_floats(TP);  // MG x TP: y's row sums
  const int t = threadIdx.x, tile = blockIdx.x, g = blockIdx.y;
  const float* P = params + (size_t)g * o.P;
  const float* wout = P + o.wout;
  const float* xg = x + (size_t)g * d.x_gstride;
  float* yg = y + (size_t)g * d.N;
  if (RES) stage_weights(P, o, d, WR, nullptr);
  PHASE_START;
  const int c0 = tile * d.chunks, c1 = min(c0 + d.chunks, d.n_chunks);
  for (int c = c0; c < c1; ++c) {
    const int base = c * TP;
    load_chunk<TP>(xg, nullptr, base, d, X, nullptr);
    __syncthreads();
    PHASE(0);
    input_layer<TP>(P, o, d, X, H0);
    __syncthreads();
    PHASE(1);
    float *hin = H0, *hout = H1;
    for (int l = 0; l + 1 < L; ++l) {
      hidden_layer<TP, RES>(P, o, d, l, X, hin, As,
                            [&](int m, int p0, float4 h) {
                              st4(hout + m * TPS + p0, h);
                            });
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    PHASE(2);
    // the last layer hands its rows to y: a thread sums wout[m] h[m][p]
    // over its rows in its slot of RED, then y sums the row groups in order
    if (L > 0) {
      float* rp = RED + (t / T::PG) * TP;
      st4(rp + 4 * (t % T::PG), make_float4(0.f, 0.f, 0.f, 0.f));
      hidden_layer<TP, RES>(P, o, d, L - 1, X, hin, As,
                            [&](int m, int p0, float4 h) {
                              float4 a = ld4(rp + p0);
                              fma4(a, __ldg(wout + m), h);
                              st4(rp + p0, a);
                            });
      __syncthreads();
    }
    for (int p = t; p < TP; p += NT) {
      float acc = 0.f;
      if (L > 0) {
        for (int r = 0; r < T::MG; ++r) acc += RED[r * TP + p];
      } else {
        for (int k = 0; k < W; ++k)
          acc = fmaf(__ldg(wout + k), hin[k * TPS + p], acc);
      }
      for (int k = 0; k < C; ++k)
        acc = fmaf(__ldg(P + o.wosk + k), X[k * TPS + p], acc);
      const int n = base + p;
      if (n < d.N) yg[n] = acc + __ldg(P + o.bout);
    }
    __syncthreads();
    PHASE(3);
  }
}

// ---- K5: backward (forward recomputed per chunk) ----
// RES: one hidden layer, Wln_0 resident in shared memory as rows and as
// columns (with Wsk_0's columns after them), each dz written over the
// activation it masks; else every weight staged in slabs per chunk, dz in
// buffers of their own.
template <int TP, bool RES>
__global__ void __launch_bounds__(NT, 1)
    icnn_bwd(const float* __restrict__ x, const float* __restrict__ gy,
             const float* __restrict__ params, float* __restrict__ partials,
             float* __restrict__ dx, Dims d) {
  using T = MM<TP>;
  constexpr int TPS = TP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int W = d.W, C = d.C, L = d.L;
  const Layout o = layout(C, W, L);
  const int ast = res_stride(W);
  // RES: [Wln_0 rows | Wln_0, Wsk_0 columns] X GY ONES DX HB SG RED;
  // else X GY ONES DX HB D0 D1 [2 slabs] SG
  float* WR = sm;
  float* WT = WR + W * ast;
  float* X = RES ? WT + (W + MAX_C) * ast : sm;  // MAX_C rows: the points
  float* GY = X + MAX_C * TPS;                     // 1 row: dL/dy
  float* ONES = GY + TPS;              // 1 row of ones (the bias column)
  float* DX = ONES + TPS;              // MAX_C rows: dL/dx
  float* HB = DX + MAX_C * TPS;        // (L+1)W rows: post-relu activations
  float* D0 = HB + (L + 1) * W * TPS;  // W rows: dz (staged only)
  float* D1 = D0 + W * TPS;            // W rows: dz of the layer below
  float* As = D1 + W * TPS;            // 2 weight slabs (staged only)
  float* SG = RES ? D0 : As + slab_floats(TP);  // grad row: wout, bout,
  float* SGI = SG + W + 1 + C;                  // wosk, then win, bin
  float* RED = RES ? SG + grad_row_floats(W) : As;  // 4 NT: dx's part sums
  const int t = threadIdx.x, tile = blockIdx.x, g = blockIdx.y;
  const float* P = params + (size_t)g * o.P;
  const float* xg = x + (size_t)g * d.x_gstride;
  const float* gg = gy + (size_t)g * d.N;
  float* dxg = dx + (size_t)g * d.N * C;
  float* part = partials + ((size_t)g * gridDim.x + tile) * o.P;
  const bool hold = RES && hold_wgrads(C, W);
  const int KF = W + C + 1;  // columns of a hidden layer's weight grads
  WgradAcc wacc;
  wacc.zero();
  if (RES) stage_weights(P, o, d, WR, WT);
  for (int i = t; i < grad_row_floats(W); i += NT) SG[i] = 0.f;
  for (int p = t; p < TPS; p += NT) ONES[p] = 1.f;
  // layer l's dWln | dWsk | dbln as one W x KF grad
  auto wgrad_at = [&](int l) {
    float* pl = part + o.wln0 + (size_t)l * o.layer;
    return [=](int m, int k) {
      return k < W ? pl + m * W + k
                   : k < W + C ? pl + W * W + W + m * C + (k - W)
                               : pl + W * W + m;
    };
  };
  PHASE_START;
  const int c0 = tile * d.chunks, c1 = min(c0 + d.chunks, d.n_chunks);
  for (int c = c0; c < c1; ++c) {
    const bool first = c == c0;
    const int base = c * TP;
    load_chunk<TP>(xg, gg, base, d, X, GY);
    __syncthreads();
    PHASE(0);

    // recompute the forward, keeping every post-relu row
    input_layer<TP>(P, o, d, X, HB);
    __syncthreads();
    PHASE(1);
    for (int l = 0; l < L; ++l) {
      float* hout = HB + (l + 1) * W * TPS;
      hidden_layer<TP, RES>(P, o, d, l, X, HB + l * W * TPS,
                            RES ? WR : As, [&](int m, int p0, float4 h) {
                              st4(hout + m * TPS + p0, h);
                            });
      __syncthreads();
    }
    PHASE(2);
    float* HL = HB + L * W * TPS;

    // output layer: dWout, dbout, dWosk; dz of the last hidden layer
    for (int r = t; r < W + 1 + C; r += NT)
      SG[r] += dot<TP>(r < W    ? HL + r * TPS
                       : r == W ? ONES
                                : X + (r - W - 1) * TPS,
                       GY);
    float *dz = D0, *dfree = D1;  // dz of the layer's output; a free buffer
    if (RES) {  // dz_L goes over h_L, which the sums above read
      __syncthreads();
      dz = HL;
    }
    {
      const int p0 = 4 * (t % T::PG);
      const float4 g4 = ld4(GY + p0);
      for (int m = t / T::PG; m < W; m += T::MG) {
        const float w = __ldg(P + o.wout + m);
        const float4 h = ld4(HL + m * TPS + p0);
        st4(dz + m * TPS + p0,
            make_float4(h.x > 0.f ? w * g4.x : 0.f, h.y > 0.f ? w * g4.y : 0.f,
                        h.z > 0.f ? w * g4.z : 0.f,
                        h.w > 0.f ? w * g4.w : 0.f));
      }
      for (int k = t / T::PG; k < C; k += T::MG) {
        const float w = __ldg(P + o.wosk + k);
        st4(DX + k * TPS + p0,
            make_float4(w * g4.x, w * g4.y, w * g4.z, w * g4.w));
      }
    }
    __syncthreads();
    PHASE(3);

    // hidden layers, last to first; dz holds dz of layer l's output
    for (int l = L - 1; l >= 0; --l) {
      const float* wl = P + o.wln0 + (size_t)l * o.layer;
      const float* ws = wl + W * W + W;
      float* hin = HB + l * W * TPS;
      // dWln | dWsk | dbln: dz against the rows [h_{l-1}; x; 1]
      auto brow = [&](int k) {
        return k < W ? hin + k * TPS : k < W + C ? X + (k - W) * TPS : ONES;
      };
      if (hold) {
        wgrad_acc<TP>(wacc, W, KF, 0, 0, dz, brow);
      } else {
        for (int m0 = 0; m0 < W; m0 += WG::MT)
          for (int k0 = 0; k0 < KF; k0 += WG::KT) {
            wacc.zero();
            wgrad_acc<TP>(wacc, W, KF, m0, k0, dz, brow);
            wacc.store(W, KF, m0, k0, !first, wgrad_at(l));
          }
      }
      // RES: dz of the layer below goes over h_{l-1}, which the weight
      // grads above read
      float* dnext = dfree;
      if (RES) {
        __syncthreads();
        dnext = hin;
      }
      PHASE(4);
      // dh_{l-1} = Wln^T dz (masked: dz of the layer below), and dx +=
      // Wsk^T dz as C more rows
      mm_rows<TP, RES>(
          W + C, W,
          [&](int k, int m) {
            return k < W ? wl + m * W + k : ws + m * C + (k - W);
          },
          dz, RES ? WT : As, ast, [&](int k, int p0, float4 v) {
            if (k < W) {
              const float4 h = ld4(hin + k * TPS + p0);
              st4(dnext + k * TPS + p0,
                  make_float4(h.x > 0.f ? v.x : 0.f, h.y > 0.f ? v.y : 0.f,
                              h.z > 0.f ? v.z : 0.f, h.w > 0.f ? v.w : 0.f));
            } else {
              float* dr = DX + (k - W) * TPS + p0;
              float4 a = ld4(dr);
              a.x += v.x;
              a.y += v.y;
              a.z += v.z;
              a.w += v.w;
              st4(dr, a);
            }
          });
      __syncthreads();
      PHASE(5);
      dfree = dz;
      dz = dnext;
    }

    // input layer: dWin, dbin (a thread per row), and dx
    for (int m = t; m < W; m += NT) {
      const float* dr = dz + m * TPS;
      for (int k = 0; k < C; ++k) SGI[m * C + k] += dot<TP>(dr, X + k * TPS);
      SGI[W * C + m] += dot<TP>(dr, ONES);
    }
    PHASE(6);
    // dx = DX + Win^T dz_0: the rows in S parts (a thread per part, input
    // and 4 points), each part's sum put in RED, the parts summed in order
    {
      const int S = NT / (C * T::PG), rows = (W + S - 1) / S;
      if (t < S * C * T::PG) {
        const int p0 = 4 * (t % T::PG), k = t / T::PG % C;
        const int s = t / (T::PG * C);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int m = s * rows; m < min(W, (s + 1) * rows); ++m)
          fma4(v, __ldg(P + o.win + m * C + k), ld4(dz + m * TPS + p0));
        st4(RED + (s * C + k) * TP + p0, v);
      }
      __syncthreads();
      for (int e = t; e < C * TP; e += NT) {
        const int k = e / TP, p = e % TP;
        float acc = 0.f;
        for (int s = 0; s < S; ++s) acc += RED[(s * C + k) * TP + p];
        const int n = base + p;
        if (n < d.N) dxg[(size_t)n * C + k] = DX[k * TPS + p] + acc;
      }
    }
    __syncthreads();
    PHASE(7);
  }
  // the block's partial row: the sums it held across its chunks
  for (int i = t; i < W + 1 + C; i += NT) __stcg(part + o.wout + i, SG[i]);
  for (int i = t; i < W * (C + 1); i += NT) __stcg(part + o.win + i, SGI[i]);
  if (hold) wacc.store(W, KF, 0, 0, false, wgrad_at(0));
}

// out[g][q] = sum over tiles, in tile order, of partials[g][tile][q].
__global__ void reduce_tiles(const float* __restrict__ partials,
                             float* __restrict__ out, int n_tiles, int P) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (q >= P) return;
  const float* src = partials + (size_t)g * n_tiles * P + q;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += src[(size_t)t * P];
  out[(size_t)g * P + q] = s;
}

template <class K>
cudaError_t occupancy(K kernel, int smem, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, NT, smem);
}

cudaError_t check_dims(int device, int N, int G, int C, int W, int L,
                       int kind, int tp, int res, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N < 1 || G < 1 || C < 1 || C > MAX_C || W < 1 || L < 0 ||
      (tp != 64 && tp != 32) || (res && (L != 1 || tp != 64)) ||
      smem != smem_floats(kind, tp, W, L, res) * (int)sizeof(float))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int TP, bool RES>
cudaError_t launch_fwd(const float* x, const float* params, float* y,
                       const Dims& d, dim3 grid, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      icnn_fwd<TP, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  icnn_fwd<TP, RES><<<grid, NT, smem, s>>>(x, params, y, d);
  return cudaGetLastError();
}

template <int TP, bool RES>
cudaError_t launch_bwd(const float* x, const float* gy, const float* params,
                       float* partials, float* dx, const Dims& d, dim3 grid,
                       int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      icnn_bwd<TP, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  icnn_bwd<TP, RES><<<grid, NT, smem, s>>>(x, gy, params, partials, dx, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef ICNN_PROFILE
// Copy out (reset = 0) or clear (reset = 1) the per-phase cycle counts.
int icnn_phase_cycles(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[16] = {0};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles,
                                   16 * sizeof(unsigned long long));
}
#endif

// Shared memory one block needs, in bytes (kind 0: K4, 1: K5; res: the
// weights resident, one hidden layer and 64-point chunks only).
int icnn_smem_bytes(int kind, int tp, int W, int L, int res) {
  return smem_floats(kind, tp, W, L, res) * (int)sizeof(float);
}

// The device's opt-in shared memory per block and its SM count.
int icnn_device_limits(int device, int* max_smem, int* sms) {
  cudaError_t err = cudaDeviceGetAttribute(
      max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// Resident blocks per SM (negative: error).
int icnn_blocks_per_sm(int kind, int device, int tp, int res, int smem) {
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err != cudaSuccess) return -(int)err;
  if (res && tp != 64) return -(int)cudaErrorInvalidValue;
  if (kind == 0)
    err = tp == 32 ? occupancy(icnn_fwd<32, false>, smem, &n)
          : res    ? occupancy(icnn_fwd<64, true>, smem, &n)
                   : occupancy(icnn_fwd<64, false>, smem, &n);
  else
    err = tp == 32 ? occupancy(icnn_bwd<32, false>, smem, &n)
          : res    ? occupancy(icnn_bwd<64, true>, smem, &n)
                   : occupancy(icnn_bwd<64, false>, smem, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// K4: x (N, C) shared (x_gstride 0) or (G, N, C) (x_gstride N*C), params
// (G, P) -> y (G, N). Returns cudaGetLastError() of the launch.
int icnn_forward(const float* x, const float* params, float* y, int device,
                 int N, int G, int C, int W, int L, int x_gstride, int tp,
                 int res, int smem, int chunks, int n_tiles, void* stream) {
  cudaError_t err = check_dims(device, N, G, C, W, L, 0, tp, res, smem);
  if (err != cudaSuccess) return (int)err;
  const Dims d{N, C, W, L, x_gstride, chunks, (N + tp - 1) / tp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, G);
  if (tp == 32)
    err = launch_fwd<32, false>(x, params, y, d, grid, smem, s);
  else if (res)
    err = launch_fwd<64, true>(x, params, y, d, grid, smem, s);
  else
    err = launch_fwd<64, false>(x, params, y, d, grid, smem, s);
  return (int)err;
}

// K5: x as in icnn_forward, gy (G, N) -> dparams (G, P) (through partials
// (G, n_tiles, P)) and dx (G, N, C). Returns cudaGetLastError() of the
// launches.
int icnn_backward(const float* x, const float* gy, const float* params,
                  float* partials, float* dparams, float* dx, int device,
                  int N, int G, int C, int W, int L, int x_gstride, int tp,
                  int res, int smem, int chunks, int n_tiles, void* stream) {
  cudaError_t err = check_dims(device, N, G, C, W, L, 1, tp, res, smem);
  if (err != cudaSuccess) return (int)err;
  const Dims d{N, C, W, L, x_gstride, chunks, (N + tp - 1) / tp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, G);
  if (tp == 32)
    err = launch_bwd<32, false>(x, gy, params, partials, dx, d, grid, smem,
                                s);
  else if (res)
    err = launch_bwd<64, true>(x, gy, params, partials, dx, d, grid, smem, s);
  else
    err = launch_bwd<64, false>(x, gy, params, partials, dx, d, grid, smem,
                                s);
  if (err != cudaSuccess) return (int)err;
  const int P = layout(C, W, L).P;
  reduce_tiles<<<dim3((P + 255) / 256, G), 256, 0, s>>>(partials, dparams,
                                                       n_tiles, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
