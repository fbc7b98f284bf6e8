// A host stand-in for cuda_bf16.h: the bf16 kernels compile but are not
// emulated (their ldmatrix and mma.sync bodies abort).
#pragma once
#include <cstdint>
#include <cstdlib>
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { abort(); }
