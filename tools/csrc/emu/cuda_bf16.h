#pragma once
// bf16 conversions (round to nearest even) for the CPU emulation.
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 a, b; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = uint32_t(b.v) << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }
