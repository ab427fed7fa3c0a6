// Fused loss and gradient of the flagship prior fit, for NVIDIA Hopper
// (sm_90a), bound with ctypes (plain C entry points at the bottom).
//
// Replaces `awesome_tpu/ops/pallas_flagship.py:_kernel` (group = 1, and the
// grouped form, group = G > 1, as the grid's second axis). One launch
// computes, for each image g,
//
//   loss_g = sum_n w[g,n] * (sigmoid(f_g(x_n)) - t[g,n])^2
//
// and its gradient with respect to every packed parameter of f_g:
// translate -> folded MinMax -> n_flows x (merged s|t layer 1 (2H x 2),
// relu, block-diagonal layer 2 (4 x 2H), tanh, affine coupling, ActNorm)
// -> inverse norm -> ICNN (input layer, L blocks relu(Wln h + Wsk x + b),
// output Wout h + Wosk x + b). The backward pass is written by hand; the
// off-block grads of the merged layer 2 are masked to 0.
//
// What bounds it on an H100. Per point and step the work is about three
// passes (forward, backward data, backward weights) over the model's
// matrices: ~3 * (F*(2H*2 + 4*2H) + W*2 + L*W*(W+2) + (W+2)) MACs. For the
// bench model (F=12, H=32, W=130, L=2) that is ~118k MAC = ~236k FLOP per
// point, ~72 GFLOP per step at 480x640 (307,200 points). The inputs are
// 16 B per point plus ~160 KB of weights, so the kernel is bound by
// arithmetic, not by memory. ~86% of the MACs are the ICNN's three W x W
// products per layer. Two bounds at 480x640:
// - all of it as FP32 FMAs at the card's 67 TFLOP/s: ~1.08 ms;
// - the products on the TF32 tensor cores, three MMAs each for FP32
//   accuracy (3xTF32) at 495 TFLOP/s, the rest as FP32 FMAs: ~0.53 ms.
// The FP32 build's arithmetic is plain FP32 FMAs (the TPU reference pins
// full f32), at ~7x the first bound. A 3xTF32 `mma.sync` design of the
// products kept FP32 accuracy but made the kernel 1-2% slower (`PERF.md`,
// Findings; its routines are in `tools/csrc/mma_tf32_trial.cuh`, and
// `tools/product_bench.py` times them beside the routines here). The FMA
// products are bound by the shared-memory loads of their inner loop (one
// scalar load per 4 FFMAs), then by streaming the weights through shared
// memory again for every chunk, not by arithmetic; 3xTF32 cuts the first
// but doubles the second. (`wgmma` wants 64-row tiles in a shared layout
// of its own, for which the rows below leave no room.) The flow is ~12% of
// the MACs but a long chain of small steps, each a few FMAs per point
// followed by a reduction over points. The bf16 build's products run on
// the bf16 tensor cores (below); what bounds them there is no longer the
// arithmetic but moving their operands: the weights streamed from L2 per
// chunk and slab, the FP32 activation rows read and packed per fragment,
// and the weight grads' read-modify-write of the partial row per chunk.
//
// Design.
// - A block takes one image g and a tile of `chunks` chunks of TP points
//   (TP = 64, or 32 for wide models). Per chunk it keeps every activation
//   in shared memory, rows of TP+4 floats (16-byte aligned rows): the
//   coupling inputs z, the pre-ActNorm z and the post-tanh s|t of every
//   flow (8F rows), the ICNN's post-relu activations ((L+1)*W rows) and two
//   W-row gradient buffers. The flow's hidden layer h (2H rows) is NOT
//   saved per flow: the backward recomputes it from the saved coupling
//   input (as `_kernel_interleaved` does), in the rows the ICNN uses, which
//   are free by then. Bench model at TP=64: (24 + 8*12 + 5*130) rows * 68
//   * 4 B + 2 weight slabs of 16 x 145 floats = 228,000 B of the 227 KB
//   (232,448 B) a block may use (the bf16 build's slabs are 144 rows of
//   16 bf16 at a 48 B stride: 223,264 B); one block per SM. The slab space
//   holds one flow step's weights while the flow runs.
// - The FP32 build's ICNN products are register-tiled FMA loops of the
//   kernel's own. Forward and backward-data (W x W times W x TP): 16-column
//   slabs of the weight matrix are staged through shared memory (the next
//   slab is fetched into registers while the current one is used); each
//   thread owns 9 rows x 4 points and reads its 4 points as one float4.
//   Weight grads (W x TP times TP x W, the sum over the chunk's points):
//   each thread owns 5 x 17 outputs; the row strides make both operands'
//   reads free of bank conflicts. The bf16 build's are `mma.sync` routines
//   with the same staging and contracts (`mm_rows_bf16`, `wgrad_bf16`).
// - Every other sum over points (biases, ActNorm, the flow's weights, the
//   ICNN's skip and input weights, the loss) is a thread per output,
//   summing the chunk's points in order.
// - Partial rows and weight slabs go through L2 only (ld/st.cg), so L1
//   keeps the ~22 KB of flow weights and small vectors the point loops
//   read.
// - Reduction without atomics. TPU grid steps run in order and add into
//   one VMEM-resident output; CUDA blocks run in no order. So each block
//   writes its own partial row of (P + 1) floats (grads, then loss) to a
//   (G, n_tiles, P + 1) scratch; within the block the chunks add into it in
//   order, each element always owned by the same thread. A second small
//   kernel sums the partials over tiles in tile order. Every sum has a
//   fixed order, so two launches on the same inputs are bitwise equal.
// - Ragged tail: points n >= N load as x = t = w = 0, so they add exactly 0
//   to the loss and to every gradient (the TPU pads with weight 0).
// - Coupling masks: flow i keeps channel i % 2, which is
//   `binary_counting_masks(2, F)` (checked in Python before any launch).
// - Points: shared by the images of a launch (image stride 0), or one set
//   per image (stride 2N), as under the JAX package's vmap over images.
//
// The bf16 build (`use_bf16` of `make_flagship_loss_grad`, template
// parameter BF16). As `pallas_flagship.py:mm` does, every operand of every
// matrix product (the 15 `mm`/`mmw` sites of `_kernel`) is rounded to its
// nearest bf16 value (ties to even) and the products are summed in FP32;
// biases, activations, exp/tanh/sigmoid, the plain sums over points (bias
// and ActNorm grads, the loss) and the params stay FP32. A rounded value
// is used only as a product operand, never stored where other code reads
// it. The ICNN's three W x W products (forward, backward data, weight
// grads) run on the bf16 tensor cores, `mma.sync.m16n8k16` with FP32
// sums (`mm_rows_bf16`, `wgrad_bf16`): the weights are rounded as they are
// staged into shared memory, two to a 32-bit word, and the FP32 activation
// rows (which the relu masks and the plain sums read) are rounded and
// packed in pairs (`cvt.rn.bf16x2.f32`) as each fragment is loaded. A
// product of two bf16 values is exact in FP32, so these are the products
// the rounded-operand reference computes, summed in another order. The
// flow's small products (K = 2 or M = 4, shapes a 16-deep MMA mostly
// wastes) and the ICNN's skip, input and output layers stay FP32 FMAs on
// operands rounded where they are loaded (`op`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// Built with -DFLAGSHIP_PROFILE, the kernel adds the cycles of each phase of
// block (0, 0) into g_phase_cycles (read by flagship_phase_cycles); every
// PHASE(k) then also waits at a barrier, so phases do not overlap. Without
// the define PHASE(k) is empty. `tools/flagship_phases.py` builds this
// variant and prints the breakdown.
#ifdef FLAGSHIP_PROFILE
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
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int NT = 256;  // threads per block
constexpr int KB = 16;  // weight-slab depth of the ICNN products

enum Field { WT, BT, W1, B1, W2, B2, AN_S, AN_T, WIN, BIN, WLN, BLN, WSK,
             WOUT, BOUT, WOSK, N_FIELDS };

struct Offsets {
  int f[N_FIELDS];  // offset of each packed buffer in a per-image row
  int P;            // row length; the loss sits at index P of a partial row
};

struct Consts {
  float pre_a[2], pre_b[2], post_a[2], post_b[2];
};

struct Dims {
  int N, F, H, W, L, use_tanh, use_sigmoid, chunks, n_chunks;
  int xs;  // floats between two images' points: 0 (shared) or 2N
};

// A product operand: v rounded to the nearest bf16 in the bf16 build, v
// itself in the FP32 build.
template <bool BF16>
__device__ __forceinline__ float op(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Thread tiling of the forward/backward-data products for TP points.
template <int TP>
struct MM {
  static constexpr int PG = TP / 4;                 // point groups (float4)
  static constexpr int MG = NT / PG;                // row groups
  static constexpr int RI = (144 + MG - 1) / MG;    // rows per thread
  static constexpr int RT = MG * RI;                // rows per pass
  static constexpr int ASTR = RT + 1;               // slab row stride
  static constexpr int SLAB = KB * ASTR;            // floats per slab
};

// Tiling of the bf16 build's forward/backward-data products for TP points
// (mm_rows_bf16): the points are cut into PT m16 tiles and a pass's rows
// into n8 tiles; warp w takes point tile w % PT and row tiles w / PT +
// WR*i (i < NPW). A weight slab holds one row of KB bf16 per output row, at
// a stride of ASTR bf16 (48 B: the 8 rows an ldmatrix phase reads fall in
// distinct banks); its pairs of values are staged PAIRS per thread.
template <int TP>
struct MMB {
  static constexpr int PT = TP / 16;                 // point tiles (m16)
  static constexpr int WR = NT / 32 / PT;            // warps per point tile
  static constexpr int NPW = TP == 64 ? 9 : 5;       // row tiles per warp
  static constexpr int RT = 8 * WR * NPW;            // rows per pass
  static constexpr int ASTR = 24;                    // slab row stride, bf16
  static constexpr int SLAB = RT * ASTR / 2;         // words per slab
  static constexpr int PAIRS = (RT * KB / 2 + NT - 1) / NT;
  static_assert(PT * WR * 32 == NT && RT >= 144, "tiling");
};

__host__ __device__ inline int smem_rows(int F, int H, int W, int L) {
  int icnn = (L + 3) * W, flow = 4 * H;
  return 24 + 8 * F + (icnn > flow ? icnn : flow);
}

// The region after the rows holds the ICNN's two weight slabs (FP32, or
// bf16 in the bf16 build), or one flow step's weights (w1, b1, w2, b2:
// 14H + 4 floats).
__host__ __device__ inline int stage_floats(int tp, bool bf16, int H) {
  const int slab = bf16 ? 2 * (tp == 64 ? MMB<64>::SLAB : MMB<32>::SLAB)
                        : 2 * (tp == 64 ? MM<64>::SLAB : MM<32>::SLAB);
  return slab > 14 * H + 4 ? slab : 14 * H + 4;
}

__host__ __device__ inline int smem_floats(int tp, bool bf16, int F, int H,
                                           int W, int L) {
  return smem_rows(F, H, W, L) * (tp + 4) + stage_floats(tp, bf16, H);
}

// Add v into a partial-row element (write it on the block's first chunk).
// Partial rows bypass L1 (ld/st.cg), which keeps L1 for the weights.
__device__ __forceinline__ void put(float* dst, float v, bool first) {
  __stcg(dst, first ? v : __ldcg(dst) + v);
}

// out(m, p) = sum_c A[m*sr + c*sc] * B[c][p] for m < M, p < TP, handed to
// epi(m, p, acc). A is global (weights), staged in KB-deep slabs through
// `As` (2 slabs); B is shared rows of stride TP+4. Each thread owns RI rows
// (mg + MG*i) x 4 consecutive points. FP32 build.
template <int TP, class Epi>
__device__ void mm_rows(int M, int K, const float* __restrict__ A, int sr,
                        int sc, const float* B, float* As, Epi epi) {
  using T = MM<TP>;
  constexpr int TPS = TP + 4;
  constexpr int LPT = (KB * T::RT + NT - 1) / NT;
  const int t = threadIdx.x, pg = t % T::PG, mg = t / T::PG;
  const int nslab = (K + KB - 1) / KB;
  const bool rowwise = sc == 1;  // A rows contiguous: fetch along c
  for (int m0 = 0; m0 < M; m0 += T::RT) {
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
    auto stash = [&](float* dst) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int idx = t + l * NT;
        const int r = rowwise ? idx / KB : idx % T::RT;
        const int cc = rowwise ? idx % KB : idx / T::RT;
        if (idx < KB * T::RT) dst[cc * T::ASTR + r] = pre[l];
      }
    };
    float acc[T::RI][4];
#pragma unroll
    for (int i = 0; i < T::RI; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    fetch(0);
    stash(As);
    __syncthreads();
    for (int s = 0; s < nslab; ++s) {
      const float* cur = As + (s & 1) * T::SLAB;
      if (s + 1 < nslab) fetch(s + 1);
      const int kmax = min(KB, K - s * KB);
      const float* bp = B + s * KB * TPS + 4 * pg;
      for (int cc = 0; cc < kmax; ++cc) {
        const float4 b = *reinterpret_cast<const float4*>(bp + cc * TPS);
        const float* ap = cur + cc * T::ASTR + mg;
#pragma unroll
        for (int i = 0; i < T::RI; ++i) {
          const float a = ap[T::MG * i];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
      if (s + 1 < nslab) stash(As + ((s + 1) & 1) * T::SLAB);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < T::RI; ++i) {
      const int m = m0 + mg + T::MG * i;
      if (m < M) {
#pragma unroll
        for (int q = 0; q < 4; ++q) epi(m, 4 * pg + q, acc[i][q]);
      }
    }
  }
}

// G(m, k) (+)= sum_{p < TP} A[m][p] * B[k][p] for m < M, k < K, written to
// out[m*ld + k]. A and B are shared rows of stride TP+4; each thread owns
// rows mg + 32i (i < 5) x cols kg + 8j (j < 17); the sum over p runs in
// order. FP32 build.
template <int TP>
__device__ void wgrad_tiled(int M, int K, const float* A, const float* B,
                            float* out, int ld, bool first) {
  constexpr int TPS = TP + 4, RI = 5, RJ = 17, MS = 32, KS = 8;
  const int kg = threadIdx.x % KS, mg = threadIdx.x / KS;
  for (int m0 = 0; m0 < M; m0 += MS * RI) {
    for (int k0 = 0; k0 < K; k0 += KS * RJ) {
      const float* ar[RI];
      const float* br[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        ar[i] = A + min(m0 + mg + MS * i, M - 1) * TPS;
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        br[j] = B + min(k0 + kg + KS * j, K - 1) * TPS;
      float acc[RI][RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;
      for (int p = 0; p < TP; ++p) {
        float av[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) av[i] = ar[i][p];
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const float bv = br[j][p];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
        }
      }
      // add into the partial row a row at a time: the 17 loads of a row
      // go out together, so the row waits on one memory latency
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int m = m0 + mg + MS * i;
        if (m >= M) continue;
        float old[RJ];
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int k = k0 + kg + KS * j;
          old[j] = (first || k >= K) ? 0.f : __ldcg(out + m * ld + k);
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int k = k0 + kg + KS * j;
          if (k < K) __stcg(out + m * ld + k, old[j] + acc[i][j]);
        }
      }
    }
  }
}

// ---- the bf16 build's ICNN products, on the bf16 tensor cores ----

// One 32-bit register of two bf16 values, each rounded to the nearest (ties
// to even), lo in the low half where an MMA fragment wants the lower index
// (one cvt.rn.bf16x2.f32).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b: one m16n8k16 product of bf16 fragments, summed in FP32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix of four (x4) or two (x2) 8x8 bf16 matrices: lane l gives the
// shared address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// mm_rows of the bf16 build (the same contract): out(m, p) = sum_c
// A[m*sr + c*sc] * B[c][p] on the bf16 tensor cores, the points as the
// product's m16 rows and the output rows as its n8 columns. A is staged in
// KB-deep slabs through `As` (2 slabs of MMB<TP>::SLAB words), rounded to
// bf16 as it is stashed, two values a 32-bit store, one row of the slab per
// output row (the backward-data site's transposed A is staged transposed);
// the next slab is fetched into registers while the current one is used.
// Per slab (one k16 step) a warp loads its activation fragment once, 8
// scalar loads from the FP32 rows B (stride TP+4: distinct banks) packed in
// pairs, and its weight fragments with ldmatrix, two row tiles an x4.
// Padding adds exact zeros: slab entries with m >= M or c >= K and rows
// c >= K of B (they belong to other buffers) load as 0. Every row tile of
// the pass is computed, live or not: a branch around an MMA cost ~10% of
// the routine's cycles. No output with m >= M goes to epi.
template <int TP, class Epi>
__device__ void mm_rows_bf16(int M, int K, const float* __restrict__ A,
                             int sr, int sc, const float* B, float* As,
                             Epi epi) {
  using T = MMB<TP>;
  constexpr int TPS = TP + 4, SW = T::ASTR / 2, KP = KB / 2;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane >> 2, q = lane & 3;
  const int p0 = 16 * (warp % T::PT), wr = warp / T::PT;
  const int nslab = (K + KB - 1) / KB;
  const bool rowwise = sc == 1;  // A rows contiguous: fetch along c
  uint32_t* stage = reinterpret_cast<uint32_t*>(As);
  // this lane's ldmatrix row for row tiles (i, i + 1): matrix lane / 8 is
  // tile i + lane / 16, reduction half (lane / 8) % 2
  const uint32_t lm =
      static_cast<uint32_t>(__cvta_generic_to_shared(stage)) +
      4 * ((8 * (wr + T::WR * (lane >> 4)) + (lane & 7)) * SW +
           KP / 2 * ((lane >> 3) & 1));
  const float* bp = B + p0 + g;
  for (int m0 = 0; m0 < M; m0 += T::RT) {
    float pre[2 * T::PAIRS];
    auto fetch = [&](int s) {
#pragma unroll
      for (int l = 0; l < T::PAIRS; ++l) {
        const int idx = t + l * NT;
        const int r = rowwise ? idx / KP : idx % T::RT;
        const int cp = rowwise ? idx % KP : idx / T::RT;
        const int m = m0 + r, c = s * KB + 2 * cp;
        const bool in = idx < KP * T::RT && m < M;
        const float* a = A + (size_t)m * sr + (size_t)c * sc;
        pre[2 * l] = in && c < K ? __ldcg(a) : 0.f;
        pre[2 * l + 1] = in && c + 1 < K ? __ldcg(a + sc) : 0.f;
      }
    };
    auto stash = [&](int s) {
      uint32_t* dst = stage + (s & 1) * T::SLAB;
#pragma unroll
      for (int l = 0; l < T::PAIRS; ++l) {
        const int idx = t + l * NT;
        const int r = rowwise ? idx / KP : idx % T::RT;
        const int cp = rowwise ? idx % KP : idx / T::RT;
        if (idx < KP * T::RT)
          dst[r * SW + cp] = bf16x2(pre[2 * l], pre[2 * l + 1]);
      }
    };
    float acc[T::NPW][4];
#pragma unroll
    for (int i = 0; i < T::NPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int s = 0; s < nslab; ++s) {
      if (s + 1 < nslab) fetch(s + 1);
      // points p0 + g (+ 8) x reductions c, c + 1 (+ 8); a row at or past
      // K is read at K - 1 and replaced by 0 (a select, no branch)
      const int c = s * KB + 2 * q;
      auto row = [&](int cc, int dp) {
        const float v = bp[min(cc, K - 1) * TPS + dp];
        return cc < K ? v : 0.f;
      };
      const uint32_t a[4] = {bf16x2(row(c, 0), row(c + 1, 0)),
                             bf16x2(row(c, 8), row(c + 1, 8)),
                             bf16x2(row(c + 8, 0), row(c + 9, 0)),
                             bf16x2(row(c + 8, 8), row(c + 9, 8))};
      const uint32_t base = lm + 4 * (s & 1) * T::SLAB;
#pragma unroll
      for (int i = 0; i < T::NPW; i += 2) {
        uint32_t b[4];
        const uint32_t addr = base + 4 * 8 * T::WR * i * SW;
        if (i + 1 < T::NPW) {
          ldsm_x4(addr, b);
        } else {
          ldsm_x2(addr, b);
        }
        mma_bf16(acc[i], a, b[0], b[1]);
        if (i + 1 < T::NPW) mma_bf16(acc[i + 1], a, b[2], b[3]);
      }
      if (s + 1 < nslab) stash(s + 1);
      __syncthreads();
    }
    // accumulator e of row tile i: point p0 + g + 8*(e/2), row 2q + e%2
#pragma unroll
    for (int i = 0; i < T::NPW; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * (wr + T::WR * i) + 2 * q + (e & 1);
        if (m < M) epi(m, p0 + g + 8 * (e >> 1), acc[i][e]);
      }
    }
  }
}

// Row `row` of the FP32 shared rows S (stride TP+4), points p .. p+3, or
// zeros for a row at or past R (the padding of a tile): row R - 1 is read
// and replaced by a select, not a branch.
template <int TP>
__device__ __forceinline__ float4 row4(const float* S, int row, int R,
                                       int p) {
  const float4 v =
      *reinterpret_cast<const float4*>(S + min(row, R - 1) * (TP + 4) + p);
  const bool in = row < R;
  return make_float4(in ? v.x : 0.f, in ? v.y : 0.f, in ? v.z : 0.f,
                     in ? v.w : 0.f);
}

// wgrad_tiled of the bf16 build (the same contract): out[m*ld + k] (+)=
// sum_{p < TP} A[m][p] * B[k][p] on the bf16 tensor cores, the points as
// the product's depth (TP/16 k16 steps). The output's m16 x n8 tiles are
// cut into blocks of MB x NB tiles; warp w takes blocks w, w + 8, ... A
// block computes all its tiles, also those past M or K (no branch around an
// MMA), and stores only the live ones. Per step a block loads the A
// fragment of each of its row tiles and the B fragment of each of its
// column tiles once, as float4s from the FP32 rows (stride TP+4), rounded
// and packed in pairs. A lane's depth slots 2q, 2q+1, 2q+8, 2q+9 of step j
// take the points 32*(j/2) + 8q + 4*(j%2) + 0..3, the same for both
// operands, so every point is summed once; with that order the float4
// reads fall in distinct banks. Rows m >= M of A and k >= K of B load as
// 0, and are not stored. Each output element is owned by one lane, its sum
// in a fixed order, then added to the partial row once per chunk through
// L2 (ld/st.cg). For that add a block's rows go through `scratch` (a
// warp's 8 x WS floats at a time; shared, and free until this returns: it
// ends on a barrier): in the MMA's layout a row of a tile is 4 lanes'
// pairs, so a warp-wide access would touch each 32 B sector twice;
// transposed, each load and store is one row of NB*8 consecutive floats.
template <int TP>
__device__ void wgrad_bf16(int M, int K, const float* A, const float* B,
                           float* out, int ld, bool first, float* scratch) {
  constexpr int MB = 3, NB = 4, WS = 8 * NB + 8;  // WS = 8 mod 32: float2
  static_assert(NT / 32 * 8 * WS <= 2 * MMB<TP>::SLAB, "scratch");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, q = lane & 3;
  float* sw = scratch + warp * 8 * WS;
  const int mtn = (M + 15) / 16, ntn = (K + 7) / 8;
  const int mgs = (mtn + MB - 1) / MB, ngs = (ntn + NB - 1) / NB;
  for (int blk = warp; blk < mgs * ngs; blk += NT / 32) {
    const int mt0 = MB * (blk / ngs), nt0 = NB * (blk % ngs);
    const int mlen = min(MB, mtn - mt0), nlen = min(NB, ntn - nt0);
    float acc[MB][NB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // unrolled further, the steps' fragments spill in the kernel
#pragma unroll 2
    for (int st = 0; st < TP / 16; ++st) {
      const int p = 32 * (st / 2) + 8 * q + 4 * (st % 2);
      uint32_t a[MB][4], b[NB][2];
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const int m = 16 * (mt0 + i) + g;
        const float4 lo = row4<TP>(A, m, M, p);
        const float4 hi = row4<TP>(A, m + 8, M, p);
        a[i][0] = bf16x2(lo.x, lo.y);
        a[i][1] = bf16x2(hi.x, hi.y);
        a[i][2] = bf16x2(lo.z, lo.w);
        a[i][3] = bf16x2(hi.z, hi.w);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float4 v = row4<TP>(B, 8 * (nt0 + j) + g, K, p);
        b[j][0] = bf16x2(v.x, v.y);
        b[j][1] = bf16x2(v.z, v.w);
      }
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    // accumulator e of tile (i, j): row g + 8*(e/2), column 2q + e%2. Per
    // row tile, lane l takes column 8*nt0 + l of its 16 rows: the old
    // values are loaded first, then the sums come through the scratch (8
    // rows at a time), then each row is added and stored.
    const int k = 8 * nt0 + lane;
    const bool kin = lane < 8 * nlen && k < K;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      if (i >= mlen) continue;
      const int m0 = 16 * (mt0 + i);
      float old[16], v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r)
        old[r] = (!first && kin && m0 + r < M) ? __ldcg(out + (m0 + r) * ld + k)
                                               : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          *reinterpret_cast<float2*>(sw + g * WS + 8 * j + 2 * q) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 8; ++r) v[8 * h + r] = sw[r * WS + lane];
        __syncwarp();
      }
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (kin && m0 + r < M) __stcg(out + (m0 + r) * ld + k, old[r] + v[r]);
    }
  }
  __syncthreads();  // every warp is done with its scratch
}

// For rows r < R of S (shared, stride TP+4) and NW weight rows wv[j]
// (shared rows, or nullptr for all-ones):
//   out[j][r * ld[j]] (+)= sum_p S[r][p] * wv[j][p]
// One thread per output (r, j), summing over the points in order; a warp
// covers 32/NW rows, whose reads fall in distinct banks. `hmask` > 0
// multiplies output (j, r) by the merged-layer-2 block mask
// ((j < 2) == (r < hmask)). A product (a weight row) is a matrix product
// of the JAX kernel and rounds its operands in the bf16 build; a plain sum
// (all-ones) does not.
template <int TP, int NW, bool BF16>
__device__ void rowdots(int R, const float* S, const float* const* wv,
                        float* const* out, const int* ld, bool first,
                        int hmask = 0) {
  constexpr int TPS = TP + 4;
  for (int o = threadIdx.x; o < R * NW; o += NT) {
    const int r = o / NW, j = o % NW;
    const float* sr = S + r * TPS;
    const float* w = nullptr;
    float* dst = nullptr;
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) {  // constant indices: no local memory
      if (jj == j) {
        w = wv[jj];
        dst = out[jj] + r * ld[jj];
      }
    }
    float v = 0.f;
    if (w) {
#pragma unroll 16
      for (int p = 0; p < TP; ++p)
        v = fmaf(op<BF16>(sr[p]), op<BF16>(w[p]), v);
    } else {
#pragma unroll 16
      for (int p = 0; p < TP; ++p) v += sr[p];
    }
    if (hmask > 0 && (j < 2) != (r < hmask)) v *= 0.f;
    put(dst, v, first);
  }
}

// The flow's hidden layer h = relu(w1 @ zm + b1), one element (j, p), from
// the staged w1 and b1. In the bf16 build w1 is staged rounded and the
// caller passes zm rounded.
__device__ __forceinline__ float flow_h(const float* w1, const float* b1,
                                        int j, float zm0, float zm1) {
  return fmaxf(fmaf(w1[2 * j + 1], zm1, w1[2 * j] * zm0) + b1[j], 0.f);
}

// Copy flow step i's w1, b1, w2, b2 into shared memory at `fw`. The staged
// w1 and w2 feed products only, so the bf16 build stages them rounded; the
// biases stay FP32.
template <bool BF16>
__device__ __forceinline__ void stage_flow(float* fw, const float* w1,
                                           const float* b1, const float* w2,
                                           const float* b2, int i, int H2) {
  const float* src[4] = {w1 + i * H2 * 2, b1 + i * H2, w2 + i * 4 * H2,
                         b2 + i * 4};
  const int len[4] = {H2 * 2, H2, 4 * H2, 4};
  int pos = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool product = k == 0 || k == 2;
    for (int e = threadIdx.x; e < len[k]; e += NT)
      fw[pos + e] = product ? op<BF16>(src[k][e]) : src[k][e];
    pos += len[k];
  }
}

template <int TP, bool BF16>
__global__ void __launch_bounds__(NT, 1)
    flagship_fwd_bwd(const float* __restrict__ x, const float* __restrict__ tgt,
                     const float* __restrict__ wpt,
                     const float* __restrict__ params,
                     float* __restrict__ partials, Offsets off, Consts cs,
                     Dims d) {
  constexpr int TPS = TP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int F = d.F, H2 = 2 * d.H, W = d.W, L = d.L, N = d.N;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, g = blockIdx.y;

  // shared layout, in rows of TPS floats
  float* XS = sm;              // 2: points
  float* TG = XS + 2 * TPS;    // 1: targets
  float* WP = TG + TPS;        // 1: point weights
  float* ZC = WP + TPS;        // 2: current z
  float* XD = ZC + 2 * TPS;    // 2: ICNN input (inverse-normed flow output)
  float* DXD = XD + 2 * TPS;   // 2: dL/dxd
  float* GZ = DXD + 2 * TPS;   // 2: dL/dz through the flow
  float* ZM = GZ + 2 * TPS;    // 2: masked coupling input
  float* CT = ZM + 2 * TPS;    // 4: per-point terms of small sums
  float* DST = CT + 4 * TPS;   // 4: dL/d(s|t) before the tanh
  float* GY = DST + 4 * TPS;   // 1: dL/dy
  float* LS = GY + TPS;        // 1: per-point loss
  float* ZIN = LS + TPS;       // 2F: coupling inputs
  float* ZPRE = ZIN + 2 * F * TPS;  // 2F: pre-ActNorm z
  float* ST = ZPRE + 2 * F * TPS;   // 4F: post-tanh s|t
  float* U = ST + 4 * F * TPS;      // union: ICNN rows, or flow rows
  float* D0 = U;                    // W: ICNN grad buffers
  float* D1 = D0 + W * TPS;         // W
  float* HB = D1 + W * TPS;         // (L+1)W: ICNN post-relu activations
  float* HF = U;                    // 2H: flow hidden layer
  float* DHA = U + H2 * TPS;        // 2H: its grad
  float* AS = sm + smem_rows(F, d.H, W, L) * TPS;  // 2 weight slabs, or
  float* FW1 = AS;                                  // one flow step's
  float* FB1 = FW1 + H2 * 2;                        // w1, b1, w2, b2
  float* FW2 = FB1 + H2;
  float* FB2 = FW2 + 4 * H2;

  const float* X = x + (size_t)g * d.xs;
  const float* P = params + (size_t)g * off.P;
  float* part = partials + ((size_t)g * gridDim.x + tile) * (off.P + 1);
  const float *wt = P + off.f[WT], *bt = P + off.f[BT];
  const float *w1 = P + off.f[W1], *b1 = P + off.f[B1];
  const float *w2 = P + off.f[W2], *b2 = P + off.f[B2];
  const float *an_s = P + off.f[AN_S], *an_t = P + off.f[AN_T];
  const float *win = P + off.f[WIN], *bin = P + off.f[BIN];
  const float *wln = P + off.f[WLN], *bln = P + off.f[BLN];
  const float *wsk = P + off.f[WSK], *wout = P + off.f[WOUT];
  const float *bout = P + off.f[BOUT], *wosk = P + off.f[WOSK];
  const float* ONE = nullptr;  // an all-ones weight row in rowdots

#ifdef FLAGSHIP_PROFILE
  long long phase_t0 = clock64();
#endif
  const int c0 = tile * d.chunks;
  const int c1 = min(c0 + d.chunks, d.n_chunks);
  for (int c = c0; c < c1; ++c) {
    const bool first = c == c0;
    const int base = c * TP;

    // ---- load, translate, pre-norm ----
    for (int p = tid; p < TP; p += NT) {
      const int n = base + p;
      const bool v = n < N;
      const float x0 = v ? X[2 * n] : 0.f, x1 = v ? X[2 * n + 1] : 0.f;
      XS[p] = x0;
      XS[TPS + p] = x1;
      TG[p] = v ? tgt[(size_t)g * N + n] : 0.f;
      WP[p] = v ? wpt[(size_t)g * N + n] : 0.f;
      ZC[p] = (x0 * wt[0] + bt[0]) * cs.pre_a[0] + cs.pre_b[0];
      ZC[TPS + p] = (x1 * wt[1] + bt[1]) * cs.pre_a[1] + cs.pre_b[1];
    }
    stage_flow<BF16>(AS, w1, b1, w2, b2, 0, H2);
    __syncthreads();
    PHASE(0);

    // ---- forward: flow ----
    for (int i = 0; i < F; ++i) {
      const int keep = i & 1;
      const float bm0 = keep == 0 ? 1.f : 0.f, bm1 = 1.f - bm0;
      // s|t = w2 @ relu(w1 @ zm + b1) + b2, h formed on the fly: each of
      // the 4 output rows of a point recomputes the point's h
      for (int e = tid; e < 4 * TP; e += NT) {
        const int r = e / TP, p = e % TP;
        const float zm0 = op<BF16>(ZC[p] * bm0);
        const float zm1 = op<BF16>(ZC[TPS + p] * bm1);
        float acc = 0.f;
        for (int j = 0; j < H2; ++j)
          acc = fmaf(FW2[r * H2 + j],
                     op<BF16>(flow_h(FW1, FB1, j, zm0, zm1)), acc);
        float v = acc + FB2[r];
        if (d.use_tanh) v = tanhf(v);
        ST[(4 * i + r) * TPS + p] = v;
      }
      for (int e = tid; e < 2 * TP; e += NT) {
        const int k = e / TP, p = e % TP;
        ZIN[(2 * i + k) * TPS + p] = ZC[k * TPS + p];
      }
      __syncthreads();
      PHASE(1);
      for (int e = tid; e < 2 * TP; e += NT) {
        const int k = e / TP, p = e % TP;
        const float b = k == keep ? 1.f : 0.f;
        const float z = ZC[k * TPS + p];
        const float s = ST[(4 * i + k) * TPS + p];
        const float t = ST[(4 * i + 2 + k) * TPS + p];
        const float zn = z * b + (1.f - b) * (z * expf(s) + t);
        ZPRE[(2 * i + k) * TPS + p] = zn;
        ZC[k * TPS + p] = zn * expf(an_s[2 * i + k]) + an_t[2 * i + k];
      }
      if (i + 1 < F) stage_flow<BF16>(AS, w1, b1, w2, b2, i + 1, H2);
      __syncthreads();
      PHASE(2);
    }

    // ---- forward: inverse norm, ICNN ----
    for (int e = tid; e < 2 * TP; e += NT) {
      const int k = e / TP, p = e % TP;
      XD[k * TPS + p] = ZC[k * TPS + p] * cs.post_a[k] + cs.post_b[k];
    }
    __syncthreads();
    for (int e = tid; e < W * TP; e += NT) {
      const int m = e / TP, p = e % TP;
      const float v = fmaf(op<BF16>(win[2 * m + 1]), op<BF16>(XD[TPS + p]),
                           op<BF16>(win[2 * m]) * op<BF16>(XD[p]));
      HB[m * TPS + p] = fmaxf(v + bin[m], 0.f);
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const float* ws = wsk + l * W * 2;
      const float* bl = bln + l * W;
      float* hout = HB + (l + 1) * W * TPS;
      auto epi = [&](int m, int p, float acc) {
        acc = fmaf(op<BF16>(ws[2 * m]), op<BF16>(XD[p]), acc);
        acc = fmaf(op<BF16>(ws[2 * m + 1]), op<BF16>(XD[TPS + p]), acc);
        hout[m * TPS + p] = fmaxf(acc + bl[m], 0.f);
      };
      const float* wl = wln + (size_t)l * W * W;
      if constexpr (BF16)
        mm_rows_bf16<TP>(W, W, wl, W, 1, HB + l * W * TPS, AS, epi);
      else
        mm_rows<TP>(W, W, wl, W, 1, HB + l * W * TPS, AS, epi);
      __syncthreads();
      PHASE(3);
    }
    const float* HL = HB + L * W * TPS;

    // ---- loss and dL/dy ----
    for (int p = tid; p < TP; p += NT) {
      float acc = 0.f;
      for (int k = 0; k < W; ++k)
        acc = fmaf(op<BF16>(wout[k]), op<BF16>(HL[k * TPS + p]), acc);
      acc = fmaf(op<BF16>(wosk[0]), op<BF16>(XD[p]), acc);
      acc = fmaf(op<BF16>(wosk[1]), op<BF16>(XD[TPS + p]), acc);
      const float y = acc + bout[0];
      const float w = WP[p];
      float e, gy;
      if (d.use_sigmoid) {
        const float pr = 1.f / (1.f + expf(-y));
        e = pr - TG[p];
        gy = w * 2.f * e * pr * (1.f - pr);
      } else {
        e = y - TG[p];
        gy = w * 2.f * e;
      }
      LS[p] = w * e * e;
      GY[p] = gy;
    }
    __syncthreads();
    PHASE(4);

    // ---- backward: ICNN output layer ----
    {
      const float* w1v[1] = {ONE};
      float* o_loss[1] = {part + off.P};
      float* o_bout[1] = {part + off.f[BOUT]};
      const int ld1[1] = {1};
      rowdots<TP, 1, BF16>(1, LS, w1v, o_loss, ld1, first);
      rowdots<TP, 1, BF16>(1, GY, w1v, o_bout, ld1, first);
      const float* wgy[1] = {GY};
      float* o_wout[1] = {part + off.f[WOUT]};
      float* o_wosk[1] = {part + off.f[WOSK]};
      rowdots<TP, 1, BF16>(W, HL, wgy, o_wout, ld1, first);
      rowdots<TP, 1, BF16>(2, XD, wgy, o_wosk, ld1, first);
    }
    for (int e = tid; e < W * TP; e += NT) {
      const int m = e / TP, p = e % TP;
      D0[m * TPS + p] =
          HL[m * TPS + p] > 0.f ? op<BF16>(wout[m]) * op<BF16>(GY[p]) : 0.f;
    }
    for (int e = tid; e < 2 * TP; e += NT) {
      const int k = e / TP, p = e % TP;
      DXD[k * TPS + p] = op<BF16>(wosk[k]) * op<BF16>(GY[p]);
    }
    __syncthreads();
    PHASE(5);

    // ---- backward: ICNN blocks; D0 holds dz of layer l+1 ----
    const float* wx[3] = {XD, XD + TPS, ONE};
    const int ldx[3] = {2, 2, 1};
    for (int l = L - 1; l >= 0; --l) {
      const float* wl = wln + (size_t)l * W * W;
      const float* ws = wsk + l * W * 2;
      const float* hin = HB + l * W * TPS;
      float* gwl = part + off.f[WLN] + (size_t)l * W * W;
      if constexpr (BF16)
        wgrad_bf16<TP>(W, W, D0, hin, gwl, W, first, AS);
      else
        wgrad_tiled<TP>(W, W, D0, hin, gwl, W, first);
      PHASE(6);
      float* o_skip[3] = {part + off.f[WSK] + l * W * 2,
                          part + off.f[WSK] + l * W * 2 + 1,
                          part + off.f[BLN] + l * W};
      rowdots<TP, 3, BF16>(W, D0, wx, o_skip, ldx, first);
      for (int e = tid; e < 2 * TP; e += NT) {
        const int k = e / TP, p = e % TP;
        float acc = 0.f;
        for (int m = 0; m < W; ++m)
          acc = fmaf(op<BF16>(__ldg(ws + 2 * m + k)),
                     op<BF16>(D0[m * TPS + p]), acc);
        DXD[k * TPS + p] += acc;
      }
      PHASE(7);
      float* dnext = D1;
      auto mask = [&](int k, int p, float acc) {
        dnext[k * TPS + p] = hin[k * TPS + p] > 0.f ? acc : 0.f;
      };
      if constexpr (BF16)
        mm_rows_bf16<TP>(W, W, wl, 1, W, D0, AS, mask);
      else
        mm_rows<TP>(W, W, wl, 1, W, D0, AS, mask);
      __syncthreads();
      PHASE(8);
      float* tmp = D0;
      D0 = D1;
      D1 = tmp;
    }
    // D0 holds dz of the input layer
    {
      float* o_in[3] = {part + off.f[WIN], part + off.f[WIN] + 1,
                        part + off.f[BIN]};
      rowdots<TP, 3, BF16>(W, D0, wx, o_in, ldx, first);
    }
    for (int e = tid; e < 2 * TP; e += NT) {
      const int k = e / TP, p = e % TP;
      float acc = 0.f;
      for (int m = 0; m < W; ++m)
        acc = fmaf(op<BF16>(__ldg(win + 2 * m + k)),
                   op<BF16>(D0[m * TPS + p]), acc);
      const float dxd = DXD[k * TPS + p] + acc;
      GZ[k * TPS + p] = dxd * cs.post_a[k];
    }
    __syncthreads();
    PHASE(9);

    // ---- backward: flow (h recomputed from the saved coupling input) ----
    for (int i = F - 1; i >= 0; --i) {
      const int keep = i & 1;
      stage_flow<BF16>(AS, w1, b1, w2, b2, i, H2);
      for (int e = tid; e < 2 * TP; e += NT) {
        const int k = e / TP, p = e % TP;
        const float b = k == keep ? 1.f : 0.f, inv_b = 1.f - b;
        const float es_an = expf(an_s[2 * i + k]);
        float gz = GZ[k * TPS + p];
        CT[k * TPS + p] = gz * ZPRE[(2 * i + k) * TPS + p] * es_an;
        CT[(2 + k) * TPS + p] = gz;
        gz = gz * es_an;
        const float zin = ZIN[(2 * i + k) * TPS + p];
        ZM[k * TPS + p] = op<BF16>(zin * b);  // read by products only
        const float s = ST[(4 * i + k) * TPS + p];
        const float t = ST[(4 * i + 2 + k) * TPS + p];
        float ds = inv_b * gz * zin * expf(s);
        float dt = inv_b * gz;
        if (d.use_tanh) {
          ds = ds * (1.f - s * s);
          dt = dt * (1.f - t * t);
        }
        DST[k * TPS + p] = ds;
        DST[(2 + k) * TPS + p] = dt;
        GZ[k * TPS + p] = gz;
      }
      __syncthreads();
      PHASE(10);
      {
        const float* w1v[1] = {ONE};
        const int ld1[1] = {1};
        float* o_s[1] = {part + off.f[AN_S] + 2 * i};
        float* o_t[1] = {part + off.f[AN_T] + 2 * i};
        float* o_b2[1] = {part + off.f[B2] + 4 * i};
        rowdots<TP, 1, BF16>(2, CT, w1v, o_s, ld1, first);
        rowdots<TP, 1, BF16>(2, CT + 2 * TPS, w1v, o_t, ld1, first);
        rowdots<TP, 1, BF16>(4, DST, w1v, o_b2, ld1, first);
      }
      for (int e = tid; e < H2 * TP; e += NT) {
        const int j = e / TP, p = e % TP;
        const float h = flow_h(FW1, FB1, j, ZM[p], ZM[TPS + p]);
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc = fmaf(FW2[r * H2 + j], op<BF16>(DST[r * TPS + p]), acc);
        HF[j * TPS + p] = h;
        DHA[j * TPS + p] = h > 0.f ? acc : 0.f;
      }
      __syncthreads();
      PHASE(11);
      {
        const float* wd[4] = {DST, DST + TPS, DST + 2 * TPS, DST + 3 * TPS};
        float* o_w2[4];
        int ldw2[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o_w2[r] = part + off.f[W2] + i * 4 * H2 + r * H2;
          ldw2[r] = 1;
        }
        rowdots<TP, 4, BF16>(H2, HF, wd, o_w2, ldw2, first, d.H);
      }
      {
        const float* wz[3] = {ZM, ZM + TPS, ONE};
        float* o_w1[3] = {part + off.f[W1] + i * H2 * 2,
                          part + off.f[W1] + i * H2 * 2 + 1,
                          part + off.f[B1] + i * H2};
        const int ldw1[3] = {2, 2, 1};
        rowdots<TP, 3, BF16>(H2, DHA, wz, o_w1, ldw1, first);
      }
      for (int e = tid; e < 2 * TP; e += NT) {
        const int k = e / TP, p = e % TP;
        float dzm = 0.f;
        for (int j = 0; j < H2; ++j)
          dzm = fmaf(FW1[2 * j + k], op<BF16>(DHA[j * TPS + p]), dzm);
        const float b = k == keep ? 1.f : 0.f, inv_b = 1.f - b;
        const float gz = GZ[k * TPS + p];
        const float es = expf(ST[(4 * i + k) * TPS + p]);
        GZ[k * TPS + p] = b * gz + inv_b * gz * es + b * dzm;
      }
      __syncthreads();
      PHASE(12);
    }

    // ---- backward: pre-norm affine and translation ----
    for (int e = tid; e < 2 * TP; e += NT) {
      const int k = e / TP, p = e % TP;
      const float dx1 = GZ[k * TPS + p] * cs.pre_a[k];
      CT[k * TPS + p] = dx1 * XS[k * TPS + p];
      CT[(2 + k) * TPS + p] = dx1;
    }
    __syncthreads();
    {
      const float* w1v[1] = {ONE};
      const int ld1[1] = {1};
      float* o_wt[1] = {part + off.f[WT]};
      float* o_bt[1] = {part + off.f[BT]};
      rowdots<TP, 1, BF16>(2, CT, w1v, o_wt, ld1, first);
      rowdots<TP, 1, BF16>(2, CT + 2 * TPS, w1v, o_bt, ld1, first);
    }
    __syncthreads();
    PHASE(13);
  }
}

// out[g][q] = sum over tiles, in tile order, of partials[g][tile][q].
__global__ void reduce_tiles(const float* __restrict__ partials,
                             float* __restrict__ out, int n_tiles, int P1) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (q >= P1) return;
  const float* src = partials + (size_t)g * n_tiles * P1 + q;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += src[(size_t)t * P1];
  out[(size_t)g * P1 + q] = s;
}

template <int TP, bool BF16>
cudaError_t launch(const float* x, const float* tgt, const float* wpt,
                   const float* params, float* partials, float* out,
                   const Offsets& off, const Consts& cs, const Dims& d, int G,
                   int smem, int n_tiles, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flagship_fwd_bwd<TP, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  flagship_fwd_bwd<TP, BF16><<<dim3(n_tiles, G), NT, smem, stream>>>(
      x, tgt, wpt, params, partials, off, cs, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P1 = off.P + 1;
  reduce_tiles<<<dim3((P1 + 255) / 256, G), 256, 0, stream>>>(partials, out,
                                                               n_tiles, P1);
  return cudaGetLastError();
}

template <int TP, bool BF16>
cudaError_t occupancy(int smem, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      flagship_fwd_bwd<TP, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, flagship_fwd_bwd<TP, BF16>, NT, smem);
}

// The instantiation for a tile of tp points and the build (FP32 or bf16).
template <class Fn>
cudaError_t dispatch(int tp, int bf16, Fn fn) {
  if (tp == 64)
    return bf16 ? fn(std::integral_constant<int, 64>{}, std::true_type{})
                : fn(std::integral_constant<int, 64>{}, std::false_type{});
  if (tp == 32)
    return bf16 ? fn(std::integral_constant<int, 32>{}, std::true_type{})
                : fn(std::integral_constant<int, 32>{}, std::false_type{});
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#ifdef FLAGSHIP_PROFILE
// Copy out (reset = 0) or clear (reset = 1) the per-phase cycle counts.
int flagship_phase_cycles(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[16] = {0};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles,
                                   16 * sizeof(unsigned long long));
}
#endif

// Shared memory one block needs, in bytes, at a tile of tp points in the
// FP32 (bf16 = 0) or the bf16 build.
int flagship_smem_bytes(int tp, int bf16, int F, int H, int W, int L) {
  return smem_floats(tp, bf16 != 0, F, H, W, L) * (int)sizeof(float);
}

// The device's opt-in shared memory per block and its SM count.
int flagship_device_limits(int device, int* max_smem, int* sms) {
  cudaError_t err = cudaDeviceGetAttribute(
      max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// Resident blocks per SM at this tile, build and shared memory (negative:
// error).
int flagship_blocks_per_sm(int device, int tp, int bf16, int smem) {
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess)
    err = dispatch(tp, bf16, [&](auto t, auto b) {
      return occupancy<decltype(t)::value, decltype(b)::value>(smem, &n);
    });
  return err == cudaSuccess ? n : -(int)err;
}

// One fused loss+grad: x (N,2) shared, or (G,N,2) with per_image_points,
// tgt and wpt (G,N), params (G,P) -> out (G, P+1) (grads, then the loss),
// through partials (G, n_tiles, P+1). offsets: 16 field offsets then P;
// consts: pre_a, pre_b, post_a, post_b (2 each); bf16: the bf16 build.
// Returns cudaGetLastError() of the launches.
int flagship_loss_grad(const float* x, const float* tgt, const float* wpt,
                       const float* params, float* partials, float* out,
                       const int* offsets, const float* consts, int device,
                       int N, int G, int per_image_points, int F, int H, int W,
                       int L, int use_tanh, int use_sigmoid, int bf16, int tp,
                       int smem, int chunks, int n_tiles, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N < 1 || G < 1 || L < 1 ||
      smem != flagship_smem_bytes(tp, bf16, F, H, W, L))
    return (int)cudaErrorInvalidValue;
  Offsets off;
  for (int k = 0; k < N_FIELDS; ++k) off.f[k] = offsets[k];
  off.P = offsets[N_FIELDS];
  Consts cs;
  for (int k = 0; k < 2; ++k) {
    cs.pre_a[k] = consts[k];
    cs.pre_b[k] = consts[2 + k];
    cs.post_a[k] = consts[4 + k];
    cs.post_b[k] = consts[6 + k];
  }
  const int n_chunks = (N + tp - 1) / tp;
  Dims d{N, F, H, W, L, use_tanh, use_sigmoid, chunks, n_chunks,
         per_image_points ? 2 * N : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(tp, bf16, [&](auto t, auto b) {
    return launch<decltype(t)::value, decltype(b)::value>(
        x, tgt, wpt, params, partials, out, off, cs, d, G, smem, n_tiles, s);
  });
}

}  // extern "C"
