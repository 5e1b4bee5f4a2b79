// Residual add + RMSNorm of the talker block for Hopper (sm_90a), bound
// through a plain C interface (ops/cuda/add_rms_norm.py loads it with ctypes).
//
// Replaces no TPU kernel: the JAX package writes rms_norm and the residual
// adds as jnp code (rho_tts_tpu/models/transformer.py) and XLA fuses them.
// Eager PyTorch ran each norm as eight launches (cast, square, mean, + eps,
// rsqrt, two products, cast) and each residual add as one more; this kernel
// is both in one launch. For rows of x (bf16, read through two strides:
// (rows, groups, d)), an optional delta (bf16, contiguous), a scale on it
// (a talker's residual multiplier, 1 by default) and the f32 weight (d):
//   res = bf16(x + scale * delta)                  (the new residual stream)
//   out = bf16(float(res) * rsqrt(mean(float(res)^2) + eps) * weight)
// in the plain version's order (ops/cuda/add_rms_norm.py
// `reference_rms_norm`): each product and sum rounded on its own in f32, the
// mean as the sum times 1/d, rsqrtf as PyTorch's rsqrt calls it; scale *
// delta rounded before the sum, which a scale of 1 leaves exact. Only the
// order of the mean's sum differs from PyTorch's reduction (each lane's
// values, then across lanes), so `out` can differ from the plain chain by
// one bf16 unit where two f32 sums round apart.
//
// Bound on the H100: bytes, ~4 B a value in and 4 out (2 K x 2048 rows of a
// prefill: 33.6 MB, 10 us at 3.35 TB/s); a decode step's 8 rows move 96 KB,
// so the launch itself (~2-3 us) bounds it there.
//
// Design: a group of L lanes owns a row, L = d / 8 rounded up to a power
// of two, at most 256 (a whole block: a decode step's 8 rows of 2,048 go to
// 8 blocks on 8 SMs, not through one SM's load path), V = 1 up to d = 2,048
// and up to 4 at d = 8,192 (the Mamba mixer's gated norm). Each lane loads V
// 16-byte vectors of x, delta and the weight at once (the lane's i-th
// vector is the row's (lane + i L)-th, so a warp's loads are whole lines),
// keeps them in registers as f32, sums its squares; the group adds its
// lanes' sums in a fixed order: by shuffles inside a warp, then through
// shared memory across the row's warps. The same lanes scale and store.
// A block of 256 threads holds 256 / L rows; nothing is shared between
// blocks, no atomics: a launch repeats bit for bit. Nothing here reads a
// host value that changes between steps, so the launch can be captured in
// a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16x8.cuh"
#include "hopper_gemm.cuh"  // DeviceGuard

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 8192;

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* delta;  // null: no add, res not written
  const float* w;
  __nv_bfloat16* res;
  __nv_bfloat16* out;
  long long rows, groups;  // x is (rows, groups, d)
  long long sx_r, sx_g;    // its strides, in elements
  int d;
  float inv_d, eps, scale;
};

template <int L, int V>
__global__ void __launch_bounds__(kThreads) add_rms_norm_kernel(const Args a) {
  const int lane = threadIdx.x % L;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  // Every thread takes part in the shuffles and the barrier below: no early exit.
  const bool live = row < a.rows * a.groups;
  const long long r = live ? row / a.groups : 0;
  const long long g = live ? row % a.groups : 0;
  const __nv_bfloat16* xr = a.x + r * a.sx_r + g * a.sx_g;
  const long long o = row * a.d;  // res and out are contiguous
  const int nvec = a.d / 8;

  float v[V][8], w[V][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + i * L;
    if (live && c < nvec) {
      float dv[8];
      bf16x8::to_float(bf16x8::load(xr + c * 8), v[i]);
      if (a.delta != nullptr) bf16x8::to_float(bf16x8::load(a.delta + o + c * 8), dv);
      bf16x8::load_f32(a.w + c * 8, w[i]);
      if (a.delta != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = __fadd_rn(v[i][j], __fmul_rn(dv[j], a.scale));
        const uint4 rounded = bf16x8::from_float(v[i]);
        bf16x8::store(a.res + o + c * 8, rounded);
        bf16x8::to_float(rounded, v[i]);  // the norm reads the rounded stream
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[i][j], v[i][j]));
    }
  }
  constexpr int kWarpLanes = L < 32 ? L : 32;
#pragma unroll
  for (int off = kWarpLanes / 2; off > 0; off /= 2)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if constexpr (L > 32) {  // the row's warps, added in order
    __shared__ float part[kThreads / 32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    const int first = (threadIdx.x / L) * (L / 32);
    ss = part[first];
#pragma unroll
    for (int k = 1; k < L / 32; ++k) ss = __fadd_rn(ss, part[first + k]);
  }
  const float scale = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + i * L;
    if (live && c < nvec) {
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = __fmul_rn(__fmul_rn(v[i][j], scale), w[i][j]);
      bf16x8::store(a.out + o + c * 8, bf16x8::from_float(y));
    }
  }
}

template <int L, int V>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const long long n = a.rows * a.groups;
  const long long blocks = (n + kThreads / L - 1) / (kThreads / L);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  add_rms_norm_kernel<L, V><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, cudaStream_t st) {
  const int nvec = a.d / 8;
  if (nvec <= 1) return launch<1, 1>(a, st);
  if (nvec <= 2) return launch<2, 1>(a, st);
  if (nvec <= 4) return launch<4, 1>(a, st);
  if (nvec <= 8) return launch<8, 1>(a, st);
  if (nvec <= 16) return launch<16, 1>(a, st);
  if (nvec <= 32) return launch<32, 1>(a, st);
  if (nvec <= 64) return launch<64, 1>(a, st);
  if (nvec <= 128) return launch<128, 1>(a, st);
  if (nvec <= 256) return launch<256, 1>(a, st);
  if (nvec <= 512) return launch<256, 2>(a, st);
  return launch<256, 4>(a, st);
}

}  // namespace

// x (rows, groups, d) bf16 at element strides (sx_r, sx_g, 1), delta (rows,
// groups, d) bf16 contiguous or null, w (d) f32, scale on delta -> res (the
// same, bf16 contiguous; written only with a delta) and out (bf16
// contiguous). d a multiple of 8 up to 8192; x, delta, w, res and out 16-byte aligned,
// the strides multiples of 8. Launches on `device`, restoring the caller's
// current device. Returns the launch's cudaError_t (then cudaGetLastError's).
extern "C" int rho_add_rms_norm(const void* x, const void* delta, const void* w, void* res,
                                void* out, long long rows, long long groups, long long sx_r,
                                long long sx_g, int d, float eps, float scale, int device,
                                void* stream) {
  if (rows < 1 || groups < 1 || d < 8 || d > kMaxD || d % 8 != 0 || sx_r % 8 != 0 ||
      sx_g % 8 != 0 || !bf16x8::aligned16(x) || !bf16x8::aligned16(w) ||
      !bf16x8::aligned16(out) ||
      (delta != nullptr && (!bf16x8::aligned16(delta) || !bf16x8::aligned16(res))))
    return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(delta),
               static_cast<const float*>(w), static_cast<__nv_bfloat16*>(res),
               static_cast<__nv_bfloat16*>(out), rows, groups, sx_r, sx_g, d,
               1.0f / static_cast<float>(d), eps, scale};
  return dispatch(a, static_cast<cudaStream_t>(stream));
}
