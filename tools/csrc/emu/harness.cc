// Runs the FP32 build of flagship_fwd_bwd on the CPU, block by block, then
// sums the partial rows over tiles as reduce_tiles does.
//   harness IN OUT
// IN: 32 int32 (N, G, per_image_points, F, H, W, L, use_tanh, use_sigmoid,
// tp, chunks, n_tiles, P, the 16 field offsets, 3 unused), 8 float32 norm
// constants (pre_a, pre_b, post_a, post_b), then x, targets, weights and
// the (G, P) params as float32. OUT: the (G, P + 1) float32 result.
// kernel.cc is flagship.cu with its inline PTX and launch syntax removed.
#include <cstdio>
#include <thread>
#include <vector>

#include "kernel.cc"

thread_local uint3 threadIdx, blockIdx;
uint3 blockDim, gridDim;
std::barrier<>* g_bar;
std::barrier<>* g_wbar[32];
float g_wbuf[32][32];
namespace {
float4 smem4[1 << 16];
}

template <int TP>
void run(const float* x, const float* tgt, const float* wpt, const float* prm,
         float* partials, Offsets off, Consts cs, Dims d, int G, int n_tiles) {
  gridDim = {unsigned(n_tiles), unsigned(G), 1};
  const FlowLayout fl = flow_layout(TP, d.F, d.H, d.W, d.L);
  for (int g = 0; g < G; ++g)
    for (int t = 0; t < n_tiles; ++t) {
      std::barrier<> bar(NT);
      g_bar = &bar;
      for (int w = 0; w < NT / 32; ++w) g_wbar[w] = new std::barrier<>(32);
      std::memset(smem4, 0x7f, sizeof(smem4));  // no zeros to rely on
      std::vector<std::thread> th;
      for (int i = 0; i < NT; ++i)
        th.emplace_back([=] {
          threadIdx = {unsigned(i), 0, 0};
          blockIdx = {unsigned(t), unsigned(g), 0};
          flagship_fwd_bwd<TP, false>(x, tgt, wpt, prm, partials, off, cs, d,
                                      fl);
        });
      for (auto& h : th) h.join();
      for (int w = 0; w < NT / 32; ++w) delete g_wbar[w];
    }
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  int h[32];
  float c8[8];
  size_t got = fread(h, 4, 32, f) + fread(c8, 4, 8, f);
  const int N = h[0], G = h[1], per = h[2], F = h[3], H = h[4], W = h[5],
            L = h[6], tp = h[9], n_tiles = h[11], P = h[12];
  Offsets off;
  for (int k = 0; k < N_FIELDS; ++k) off.f[k] = h[13 + k];
  off.P = P;
  Consts cs;
  for (int k = 0; k < 2; ++k) {
    cs.pre_a[k] = c8[k];
    cs.pre_b[k] = c8[2 + k];
    cs.post_a[k] = c8[4 + k];
    cs.post_b[k] = c8[6 + k];
  }
  std::vector<float> x((per ? (size_t)G : 1) * N * 2), tg((size_t)G * N),
      wp((size_t)G * N), prm((size_t)G * P);
  for (auto* v : {&x, &tg, &wp, &prm}) got += fread(v->data(), 4, v->size(), f);
  fclose(f);
  if (got != 40 + x.size() + tg.size() + wp.size() + prm.size() ||
      (tp != 64 && tp != 32) ||
      smem_floats(tp, false, F, H, W, L) > (int)(sizeof(smem4) / 4))
    return 2;
  std::vector<float> part((size_t)G * n_tiles * (P + 1), NAN);
  Dims d{N, F, H, W, L, h[7], h[8], h[10], (N + tp - 1) / tp, per ? 2 * N : 0};
  if (tp == 64)
    run<64>(x.data(), tg.data(), wp.data(), prm.data(), part.data(), off, cs,
            d, G, n_tiles);
  else
    run<32>(x.data(), tg.data(), wp.data(), prm.data(), part.data(), off, cs,
            d, G, n_tiles);
  std::vector<float> out((size_t)G * (P + 1));
  for (int g = 0; g < G; ++g)
    for (int q = 0; q < P + 1; ++q) {
      float s = 0.f;
      for (int t = 0; t < n_tiles; ++t)
        s += part[((size_t)g * n_tiles + t) * (P + 1) + q];
      out[(size_t)g * (P + 1) + q] = s;
    }
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return 0;
}
