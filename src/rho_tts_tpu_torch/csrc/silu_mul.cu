// SwiGLU's activation, silu(gate) * up, in one launch for Hopper (sm_90a),
// bound through a plain C interface (ops/cuda/silu_mul.py loads it with
// ctypes).
//
// Replaces no TPU kernel: the JAX package writes jax.nn.silu(gate) * up as
// jnp code (rho_tts_tpu/models/transformer.py, the MLP) and XLA fuses it.
// Eager PyTorch ran five launches (two casts,
// silu, the product, a cast); this kernel is one. For gate and up (n
// values, bf16, contiguous):
//   out = bf16(silu(float(gate)) * float(up)),  silu(g) = g / (1 + expf(-g))
// the formula, rounding and math-library call of PyTorch's silu on the card
// (ActivationSiluKernel.cu, in f32), each step rounded on its own: the
// plain version's bits (ops/cuda/silu_mul.py `reference_silu_mul`).
//
// Bound on the H100: bytes, 6 B a value (a decode step at the 1.7B's ffn
// of 6,144 and 8 rows: 295 KB, 0.09 us at 3.35 TB/s, so the launch bounds
// it; a 2,048-row prefill: 75.5 MB, 22.5 us).
//
// Design: a thread owns 8 adjacent values, 16-byte loads and store. No
// shared memory, no atomics; nothing read from the host changes between
// steps (graph capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16x8.cuh"
#include "hopper_gemm.cuh"  // DeviceGuard

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    silu_mul_kernel(const __nv_bfloat16* gate, const __nv_bfloat16* up, __nv_bfloat16* out,
                    long long vectors) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= vectors) return;
  float g[8], u[8], y[8];
  bf16x8::to_float(bf16x8::load(gate + i * 8), g);
  bf16x8::to_float(bf16x8::load(up + i * 8), u);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    y[j] = __fmul_rn(__fdiv_rn(g[j], __fadd_rn(1.0f, expf(-g[j]))), u[j]);
  bf16x8::store(out + i * 8, bf16x8::from_float(y));
}

}  // namespace

// gate, up (n) bf16 -> out (n) bf16, all contiguous and 16-byte aligned, n
// a multiple of 8. Launches on `device`, restoring the caller's current
// device. Returns the launch's cudaError_t (then cudaGetLastError's).
extern "C" int rho_silu_mul(const void* gate, const void* up, void* out, long long n, int device,
                            void* stream) {
  if (n < 8 || n % 8 != 0 || !bf16x8::aligned16(gate) || !bf16x8::aligned16(up) ||
      !bf16x8::aligned16(out))
    return cudaErrorInvalidValue;
  const long long blocks = (n / 8 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  silu_mul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gate), static_cast<const __nv_bfloat16*>(up),
      static_cast<__nv_bfloat16*>(out), n / 8);
  return cudaGetLastError();
}
