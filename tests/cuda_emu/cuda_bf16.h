// A host stand-in for cuda_bf16.h: bf16 as its 16 bits, and the one
// conversion the kernels use, float -> bf16 rounded to nearest even (the
// operands are finite).
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t bits;
  memcpy(&bits, &f, 4);
  return {(uint16_t)((bits + 0x7fffu + ((bits >> 16) & 1u)) >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
