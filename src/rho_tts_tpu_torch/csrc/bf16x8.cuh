// Eight bf16 values in one 16-byte word, to and from f32: the loads and
// stores of the talker block's elementwise kernels (add_rms_norm.cu,
// rope_qk.cu, silu_mul.cu). Rounding to bf16 is to nearest even, as
// PyTorch's casts round.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16x8 {

__device__ __forceinline__ uint4 load(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void to_float(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 from_float(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Eight f32 values at p, 16-byte aligned
__device__ __forceinline__ void load_f32(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace bf16x8
