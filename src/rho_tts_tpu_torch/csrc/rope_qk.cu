// Rotary position embedding of q and k in one launch for Hopper (sm_90a),
// bound through a plain C interface (ops/cuda/rope_qk.py loads it with
// ctypes).
//
// Replaces no TPU kernel: the JAX package writes the rotation as jnp code
// (rho_tts_tpu/models/transformer.py `apply_rope`) and XLA fuses it. Eager
// PyTorch ran it as ten launches for q and ten for k (two casts, four
// products, a difference, a sum, a concatenation, a cast); this kernel
// rotates both. For q (b, t, hq, d) and k (b, t, hk, d), bf16, read through
// their strides (views of the QKV projection's output), and the f32 tables
// cos, sin (b, t, d/2):
//   out[:d/2] = x1 cos - x2 sin,   out[d/2:] = x2 cos + x1 sin
// with x1, x2 the halves of a head in f32, each product, difference and sum
// rounded on its own (no FMA contraction, as PyTorch's separate launches
// round), then one rounding to bf16: the plain version's bits
// (ops/cuda/rope_qk.py `reference_rotate`). Written contiguous:
// qo (b, t, hq, d), ko (b, t, hk, d).
//
// Bound on the H100: bytes, 4 B a value of q and k plus the tables (a
// decode step of 8 rows at the 1.7B's 24 heads of 128: 49 KB + 4 KB), so
// the launch itself bounds it at decode sizes; a 2,048-row prefill moves
// 25 MB (7.5 us at 3.35 TB/s).
//
// Design: a thread owns 8 pairs of one head: 16 bytes of each half and 32
// bytes of each table. Threads of a head are adjacent, heads of a token
// adjacent (q's, then k's). No shared memory, no atomics; nothing read
// from the host changes between steps (graph capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x8.cuh"
#include "hopper_gemm.cuh"  // DeviceGuard

namespace {

constexpr int kThreads = 256;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const float* cos;
  const float* sin;
  __nv_bfloat16* qo;
  __nv_bfloat16* ko;
  int b, t, hq, hk, d;
  long long sq_b, sq_t, sq_h;  // element strides
  long long sk_b, sk_t, sk_h;
  long long sc_b, sc_t;  // of cos and sin (b, t, d/2)
};

__global__ void __launch_bounds__(kThreads) rope_qk_kernel(const Args a) {
  const int chunks = a.d / 16;  // threads a head
  const int heads = a.hq + a.hk;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(a.b) * a.t * heads * chunks) return;
  const int c = static_cast<int>(idx % chunks);
  const long long row = idx / chunks;
  const int h = static_cast<int>(row % heads);
  const long long bt = row / heads;
  const long long ti = bt % a.t;
  const long long bi = bt / a.t;
  const __nv_bfloat16* src;
  __nv_bfloat16* dst;
  if (h < a.hq) {
    src = a.q + bi * a.sq_b + ti * a.sq_t + h * a.sq_h;
    dst = a.qo + (bt * a.hq + h) * a.d;
  } else {
    src = a.k + bi * a.sk_b + ti * a.sk_t + (h - a.hq) * a.sk_h;
    dst = a.ko + (bt * a.hk + (h - a.hq)) * a.d;
  }
  const int half = a.d / 2;
  float x1[8], x2[8], cs[8], sn[8];
  bf16x8::to_float(bf16x8::load(src + c * 8), x1);
  bf16x8::to_float(bf16x8::load(src + half + c * 8), x2);
  const long long tab = bi * a.sc_b + ti * a.sc_t + c * 8;
  bf16x8::load_f32(a.cos + tab, cs);
  bf16x8::load_f32(a.sin + tab, sn);
  float o1[8], o2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o1[j] = __fsub_rn(__fmul_rn(x1[j], cs[j]), __fmul_rn(x2[j], sn[j]));
    o2[j] = __fadd_rn(__fmul_rn(x2[j], cs[j]), __fmul_rn(x1[j], sn[j]));
  }
  bf16x8::store(dst + c * 8, bf16x8::from_float(o1));
  bf16x8::store(dst + half + c * 8, bf16x8::from_float(o2));
}

}  // namespace

// q (b, t, hq, d) and k (b, t, hk, d) bf16 at element strides (s*_b, s*_t,
// s*_h, 1), cos and sin (b, t, d/2) f32 at strides (sc_b, sc_t, 1) ->
// qo, ko bf16 contiguous. d a multiple of 16; every pointer 16-byte aligned,
// the q and k strides multiples of 8, the tables' of 4. Launches on
// `device`, restoring the caller's current device. Returns the launch's
// cudaError_t (then cudaGetLastError's).
extern "C" int rho_rope_qk(const void* q, const void* k, const void* cos, const void* sin,
                           void* qo, void* ko, int b, int t, int hq, int hk, int d,
                           long long sq_b, long long sq_t, long long sq_h, long long sk_b,
                           long long sk_t, long long sk_h, long long sc_b, long long sc_t,
                           int device, void* stream) {
  const void* ptrs[6] = {q, k, cos, sin, qo, ko};
  for (const void* p : ptrs)
    if (!bf16x8::aligned16(p)) return cudaErrorInvalidValue;
  if (b < 1 || t < 1 || hq < 1 || hk < 1 || d < 16 || d % 16 != 0 || sq_b % 8 || sq_t % 8 ||
      sq_h % 8 || sk_b % 8 || sk_t % 8 || sk_h % 8 || sc_b % 4 || sc_t % 4)
    return cudaErrorInvalidValue;
  const long long threads = static_cast<long long>(b) * t * (hq + hk) * (d / 16);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const float*>(cos), static_cast<const float*>(sin),
               static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko),
               b, t, hq, hk, d, sq_b, sq_t, sq_h, sk_b, sk_t, sk_h, sc_b, sc_t};
  rope_qk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
