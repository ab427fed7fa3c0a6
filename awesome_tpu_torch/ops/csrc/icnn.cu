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
// Design. It follows the ICNN part of `flagship.cu` (K1), as a separate,
// simple kernel: the flagship kernel and its times do not change.
// - A block takes one image and a tile of `chunks` chunks of TP points
//   (TP = 64, or 32 for wide models). Per chunk every activation stays in
//   shared memory, rows of TP+4 floats: the forward keeps two W-row
//   buffers (ping-pong); the backward recomputes the forward and keeps all
//   L+1 post-relu rows (a relu's mask is `post > 0`), plus two W-row
//   gradient buffers. K5 gets no saved activations from K4, as on the TPU.
// - Weights are read through L2 (ld.cg), not held whole in shared memory:
//   the W x W products stage 16-column slabs of the weight matrix through
//   shared memory (two slabs, 2 x 16 x 145 floats = 18,560 B at TP = 64),
//   each thread owning 9 rows x 4 points. Bytes per block at TP = 64:
//   forward (4 + 2W) rows x 272 B + slabs = 90,368 B for W = 130 (two
//   blocks per SM); backward (9 + (L+3)W) rows x 272 B + slabs = 179,248 +
//   18,560 = 197,808 B for W = 130, L = 2 (one block per SM).
// - Weight grads of the W x W layers are register-tiled (5 x 17 outputs a
//   thread). Every other sum over points (biases, skip and input weights,
//   the output layer) is a thread per output, summing in point order.
// - Reduction without atomics. The TPU kernel adds weight grads into
//   VMEM-resident outputs across its sequential grid. Here each block
//   writes its own partial row of P floats to a (G, n_tiles, P) scratch
//   (its chunks add into it in order, each element always owned by one
//   thread), and a second kernel sums the rows in tile order. Two launches
//   on the same inputs are bitwise equal.
// - Ragged tail: points n >= N load x = g = 0 and are never written, so
//   they add exactly 0 to every weight grad (the TPU pads with g = 0).

#include <cuda_runtime.h>

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
  static constexpr int ASTR = RT + 1;             // slab row stride
  static constexpr int SLAB = KB * ASTR;          // floats per slab
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

// Shared floats of one block: kind 0 the forward, 1 the backward.
__host__ __device__ inline int smem_floats(int kind, int tp, int W, int L) {
  const int rows = kind == 0 ? MAX_C + 2 * W : 2 * MAX_C + 1 + (L + 3) * W;
  return rows * (tp + 4) + slab_floats(tp);
}

// Add v into a partial-row element (write it on the block's first chunk).
__device__ __forceinline__ void put(float* dst, float v, bool first) {
  __stcg(dst, first ? v : __ldcg(dst) + v);
}

// out(m, p) = sum_c A[m*sr + c*sc] * B[c][p] for m < M, p < TP, handed to
// epi(m, p, acc). A is global (weights), staged in KB-deep slabs through
// `As` (2 slabs); B is shared rows of stride TP+4. Each thread owns RI rows
// (mg + MG*i) x 4 consecutive points.
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
// order.
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

// out[r] (+)= sum_p S[r][p] * w[p] for r < R (w == nullptr: all ones); a
// thread per output, summing the chunk's points in order.
template <int TP>
__device__ void rowdot(int R, const float* S, const float* w, float* out,
                       bool first) {
  constexpr int TPS = TP + 4;
  for (int r = threadIdx.x; r < R; r += NT) {
    const float* sr = S + r * TPS;
    float v = 0.f;
    if (w) {
#pragma unroll 16
      for (int p = 0; p < TP; ++p) v = fmaf(sr[p], w[p], v);
    } else {
#pragma unroll 16
      for (int p = 0; p < TP; ++p) v += sr[p];
    }
    put(out + r, v, first);
  }
}

// The grads of a layer's input-side weights from its dz rows D (R rows):
//   dw[r*C + k] (+)= sum_p D[r][p] * X[k][p],   db[r] (+)= sum_p D[r][p].
// A thread per output, summing the chunk's points in order.
template <int TP>
__device__ void xgrads(int R, int C, const float* D, const float* X,
                       float* dw, float* db, bool first) {
  constexpr int TPS = TP + 4;
  const int nw = C + 1;
  for (int o = threadIdx.x; o < R * nw; o += NT) {
    const int r = o / nw, k = o % nw;
    const float* dr = D + r * TPS;
    float v = 0.f;
    if (k < C) {
      const float* xr = X + k * TPS;
#pragma unroll 16
      for (int p = 0; p < TP; ++p) v = fmaf(dr[p], xr[p], v);
      put(dw + r * C + k, v, first);
    } else {
#pragma unroll 16
      for (int p = 0; p < TP; ++p) v += dr[p];
      put(db + r, v, first);
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

// h_0 = relu(Win x + bin) into rows H.
template <int TP>
__device__ void input_layer(const float* P, const Layout& o, const Dims& d,
                            const float* X, float* H) {
  constexpr int TPS = TP + 4;
  for (int e = threadIdx.x; e < d.W * TP; e += NT) {
    const int m = e / TP, p = e % TP;
    float v = 0.f;
    for (int k = 0; k < d.C; ++k)
      v = fmaf(__ldg(P + o.win + m * d.C + k), X[k * TPS + p], v);
    H[m * TPS + p] = fmaxf(v + __ldg(P + o.bin + m), 0.f);
  }
}

// h_out = relu(Wln_l h_in + bln_l + Wsk_l x).
template <int TP>
__device__ void hidden_layer(const float* P, const Layout& o, const Dims& d,
                             int l, const float* X, const float* hin,
                             float* hout, float* As) {
  constexpr int TPS = TP + 4;
  const int W = d.W, C = d.C;
  const float* wl = P + o.wln0 + (size_t)l * o.layer;
  const float* bl = wl + W * W;
  const float* ws = bl + W;
  mm_rows<TP>(W, W, wl, W, 1, hin, As, [&](int m, int p, float acc) {
    for (int k = 0; k < C; ++k)
      acc = fmaf(__ldg(ws + m * C + k), X[k * TPS + p], acc);
    hout[m * TPS + p] = fmaxf(acc + __ldg(bl + m), 0.f);
  });
}

// ---- K4: forward ----
template <int TP>
__global__ void __launch_bounds__(NT, 2)
    icnn_fwd(const float* __restrict__ x, const float* __restrict__ params,
             float* __restrict__ y, Dims d) {
  constexpr int TPS = TP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int W = d.W, C = d.C;
  const Layout o = layout(C, W, d.L);
  float* X = sm;                 // MAX_C rows: the chunk's points
  float* H0 = X + MAX_C * TPS;   // W rows
  float* H1 = H0 + W * TPS;      // W rows
  float* As = H1 + W * TPS;      // 2 weight slabs
  const int tile = blockIdx.x, g = blockIdx.y;
  const float* P = params + (size_t)g * o.P;
  const float* xg = x + (size_t)g * d.x_gstride;
  float* yg = y + (size_t)g * d.N;
  const int c0 = tile * d.chunks, c1 = min(c0 + d.chunks, d.n_chunks);
  for (int c = c0; c < c1; ++c) {
    const int base = c * TP;
    load_chunk<TP>(xg, nullptr, base, d, X, nullptr);
    __syncthreads();
    input_layer<TP>(P, o, d, X, H0);
    __syncthreads();
    float *hin = H0, *hout = H1;
    for (int l = 0; l < d.L; ++l) {
      hidden_layer<TP>(P, o, d, l, X, hin, hout, As);
      __syncthreads();
      float* t = hin;
      hin = hout;
      hout = t;
    }
    for (int p = threadIdx.x; p < TP; p += NT) {
      float acc = 0.f;
      for (int k = 0; k < W; ++k)
        acc = fmaf(__ldg(P + o.wout + k), hin[k * TPS + p], acc);
      for (int k = 0; k < C; ++k)
        acc = fmaf(__ldg(P + o.wosk + k), X[k * TPS + p], acc);
      const int n = base + p;
      if (n < d.N) yg[n] = acc + __ldg(P + o.bout);
    }
    __syncthreads();
  }
}

// ---- K5: backward (forward recomputed per chunk) ----
template <int TP>
__global__ void __launch_bounds__(NT, 1)
    icnn_bwd(const float* __restrict__ x, const float* __restrict__ gy,
             const float* __restrict__ params, float* __restrict__ partials,
             float* __restrict__ dx, Dims d) {
  constexpr int TPS = TP + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int W = d.W, C = d.C, L = d.L;
  const Layout o = layout(C, W, L);
  float* X = sm;                   // MAX_C rows: the chunk's points
  float* GY = X + MAX_C * TPS;     // 1 row: dL/dy
  float* DX = GY + TPS;            // MAX_C rows: dL/dx
  float* HB = DX + MAX_C * TPS;    // (L+1)W rows: post-relu activations
  float* D0 = HB + (L + 1) * W * TPS;  // W rows: dz
  float* D1 = D0 + W * TPS;            // W rows: dz of the layer below
  float* As = D1 + W * TPS;            // 2 weight slabs
  const int tile = blockIdx.x, g = blockIdx.y;
  const float* P = params + (size_t)g * o.P;
  const float* xg = x + (size_t)g * d.x_gstride;
  const float* gg = gy + (size_t)g * d.N;
  float* dxg = dx + (size_t)g * d.N * C;
  float* part = partials + ((size_t)g * gridDim.x + tile) * o.P;
  const int c0 = tile * d.chunks, c1 = min(c0 + d.chunks, d.n_chunks);
  for (int c = c0; c < c1; ++c) {
    const bool first = c == c0;
    const int base = c * TP;
    load_chunk<TP>(xg, gg, base, d, X, GY);
    __syncthreads();

    // recompute the forward, keeping every post-relu row
    input_layer<TP>(P, o, d, X, HB);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      hidden_layer<TP>(P, o, d, l, X, HB + l * W * TPS,
                       HB + (l + 1) * W * TPS, As);
      __syncthreads();
    }
    const float* HL = HB + L * W * TPS;

    // output layer: dWout, dbout, dWosk; dz of the last hidden layer
    rowdot<TP>(W, HL, GY, part + o.wout, first);
    rowdot<TP>(1, GY, nullptr, part + o.bout, first);
    rowdot<TP>(C, X, GY, part + o.wosk, first);
    for (int e = threadIdx.x; e < W * TP; e += NT) {
      const int m = e / TP, p = e % TP;
      D0[m * TPS + p] =
          HL[m * TPS + p] > 0.f ? __ldg(P + o.wout + m) * GY[p] : 0.f;
    }
    for (int e = threadIdx.x; e < C * TP; e += NT) {
      const int k = e / TP, p = e % TP;
      DX[k * TPS + p] = __ldg(P + o.wosk + k) * GY[p];
    }
    __syncthreads();

    // hidden layers, last to first; D0 holds dz of layer l's output
    for (int l = L - 1; l >= 0; --l) {
      const float* wl = P + o.wln0 + (size_t)l * o.layer;
      const float* ws = wl + W * W + W;
      float* pl = part + o.wln0 + (size_t)l * o.layer;
      const float* hin = HB + l * W * TPS;
      wgrad_tiled<TP>(W, W, D0, hin, pl, W, first);
      xgrads<TP>(W, C, D0, X, pl + W * W + W, pl + W * W, first);
      for (int e = threadIdx.x; e < C * TP; e += NT) {
        const int k = e / TP, p = e % TP;
        float acc = 0.f;
        for (int m = 0; m < W; ++m)
          acc = fmaf(__ldg(ws + m * C + k), D0[m * TPS + p], acc);
        DX[k * TPS + p] += acc;
      }
      float* dnext = D1;
      mm_rows<TP>(W, W, wl, 1, W, D0, As, [&](int k, int p, float acc) {
        dnext[k * TPS + p] = hin[k * TPS + p] > 0.f ? acc : 0.f;
      });
      __syncthreads();
      float* t = D0;
      D0 = D1;
      D1 = t;
    }

    // input layer: dWin, dbin, and dx
    xgrads<TP>(W, C, D0, X, part + o.win, part + o.bin, first);
    for (int e = threadIdx.x; e < C * TP; e += NT) {
      const int k = e / TP, p = e % TP;
      float acc = 0.f;
      for (int m = 0; m < W; ++m)
        acc = fmaf(__ldg(P + o.win + m * C + k), D0[m * TPS + p], acc);
      const int n = base + p;
      if (n < d.N) dxg[(size_t)n * C + k] = DX[k * TPS + p] + acc;
    }
    __syncthreads();
  }
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
                       int kind, int tp, int smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N < 1 || G < 1 || C < 1 || C > MAX_C || W < 1 || L < 0 ||
      (tp != 64 && tp != 32) ||
      smem != smem_floats(kind, tp, W, L) * (int)sizeof(float))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (kind 0: K4, 1: K5).
int icnn_smem_bytes(int kind, int tp, int W, int L) {
  return smem_floats(kind, tp, W, L) * (int)sizeof(float);
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
int icnn_blocks_per_sm(int kind, int device, int tp, int smem) {
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess) {
    if (kind == 0 && tp == 64)
      err = occupancy(icnn_fwd<64>, smem, &n);
    else if (kind == 0 && tp == 32)
      err = occupancy(icnn_fwd<32>, smem, &n);
    else if (kind == 1 && tp == 64)
      err = occupancy(icnn_bwd<64>, smem, &n);
    else if (kind == 1 && tp == 32)
      err = occupancy(icnn_bwd<32>, smem, &n);
    else
      err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? n : -(int)err;
}

// K4: x (N, C) shared (x_gstride 0) or (G, N, C) (x_gstride N*C), params
// (G, P) -> y (G, N). Returns cudaGetLastError() of the launch.
int icnn_forward(const float* x, const float* params, float* y, int device,
                 int N, int G, int C, int W, int L, int x_gstride, int tp,
                 int smem, int chunks, int n_tiles, void* stream) {
  cudaError_t err = check_dims(device, N, G, C, W, L, 0, tp, smem);
  if (err != cudaSuccess) return (int)err;
  const Dims d{N, C, W, L, x_gstride, chunks, (N + tp - 1) / tp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, G);
  if (tp == 64) {
    err = cudaFuncSetAttribute(
        icnn_fwd<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      icnn_fwd<64><<<grid, NT, smem, s>>>(x, params, y, d);
  } else {
    err = cudaFuncSetAttribute(
        icnn_fwd<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      icnn_fwd<32><<<grid, NT, smem, s>>>(x, params, y, d);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K5: x as in icnn_forward, gy (G, N) -> dparams (G, P) (through partials
// (G, n_tiles, P)) and dx (G, N, C). Returns cudaGetLastError() of the
// launches.
int icnn_backward(const float* x, const float* gy, const float* params,
                  float* partials, float* dparams, float* dx, int device,
                  int N, int G, int C, int W, int L, int x_gstride, int tp,
                  int smem, int chunks, int n_tiles, void* stream) {
  cudaError_t err = check_dims(device, N, G, C, W, L, 1, tp, smem);
  if (err != cudaSuccess) return (int)err;
  const Dims d{N, C, W, L, x_gstride, chunks, (N + tp - 1) / tp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, G);
  if (tp == 64) {
    err = cudaFuncSetAttribute(
        icnn_bwd<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      icnn_bwd<64><<<grid, NT, smem, s>>>(x, gy, params, partials, dx, d);
  } else {
    err = cudaFuncSetAttribute(
        icnn_bwd<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      icnn_bwd<32><<<grid, NT, smem, s>>>(x, gy, params, partials, dx, d);
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = layout(C, W, L).P;
  reduce_tiles<<<dim3((P + 255) / 256, G), 256, 0, s>>>(partials, dparams,
                                                       n_tiles, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
