// The Mamba-2 mixer's decode step for Hopper (sm_90a), bound through a plain
// C interface (ops/cuda/ssm_step.py loads it with ctypes).
//
// Replaces no TPU kernel: the JAX package has no state-space layer. One
// launch a Mamba layer a decode step does everything between the layer's
// in_proj (a cuBLAS GEMV) and its gated norm (add_rms_norm): for each row,
// from the in_proj output [z | xBC | dt] (bf16), the causal depthwise
// convolution's state (rows, taps - 1, conv_dim) f32 and the scan's state
// S (rows, heads, P, N) f32:
//   xBC   = silu(conv(state, xBC) + b)      the state rolled by one position
//   x, B, C = split(xBC, [heads * P, N, N])  (one group: B, C shared by heads)
//   dt    = softplus(dt + dt_bias), A = -exp(A_log)         per head
//   S_h   = exp(dt_h A_h) S_h + (dt_h x_h) B^T              (P x N), in place
//   out_h = (S_h C + D_h x_h) * silu(z_h)                   bf16
// Each product and sum is rounded on its own in f32 in the plain version's
// order (ops/cuda/ssm_step.py `reference_ssm_step`), so S's update matches
// it wherever expf / log1pf do; y's sum over N runs in another order.
//
// Bound on the H100: bytes. S is read once and written once in f32: at the
// published widths (128 heads x 64 x 128) 4.19 MB a row each way, 67 MB a
// step of 8 rows, 20 us at 3.35 TB/s; the rest (in_proj output, weights,
// conv state, output) is ~1% of that.
//
// Design: a block per (head, row), 256 threads. Every block computes the
// convolution of the 256 B and C channels (each thread one channel) and of
// its head's P x channels, into shared memory; then 8 threads own a row of
// S_h (N = 128 floats: four 16-byte loads each, the 8 threads' loads one
// 128-byte line), update it in registers, store it, and add their products
// with C by shuffles. Its x channels' convolution state belongs to the block
// alone and is rolled in place; the B and C channels' state is read by every
// block of the row, so the row's last block to have read it (a ticket a row,
// counted with atomicAdd after the block's reads and reset by that block)
// rolls it. No host value is read: the launch can be captured in a CUDA
// graph; the tickets live in a buffer that the wrapper keeps per stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"  // DeviceGuard

namespace {

constexpr int kThreads = 256;
constexpr int kN = 128;      // the state size: 2 kN = kThreads B and C channels
constexpr int kLanes = 8;    // threads of one row of S_h (kN / 16 floats each)
constexpr int kMaxTaps = 4;

struct Args {
  const __nv_bfloat16* in;  // (rows, 2 di + 2 N + heads) at row stride s_row
  long long s_row;
  float* conv_state;        // (rows, taps - 1, cd)
  float* ssm;               // (rows, heads, P, N)
  const __nv_bfloat16* conv_w;  // (cd, taps)
  const __nv_bfloat16* conv_b;  // (cd)
  const float* dt_bias;     // (heads)
  const float* a_log;       // (heads)
  const float* d;           // (heads)
  __nv_bfloat16* out;       // (rows, di)
  unsigned* tickets;        // (rows), zero between launches
  int heads, di, cd, taps;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

// The convolution of channel c of this row: hist[0 .. taps-2] the state (the
// oldest first), hist[taps-1] the new input; returns silu(sum + bias).
__device__ __forceinline__ float conv_channel(const Args& a, const float* cst,
                                              const __nv_bfloat16* xbc, int c,
                                              float (&hist)[kMaxTaps]) {
  const int km1 = a.taps - 1;
#pragma unroll
  for (int i = 0; i < kMaxTaps - 1; ++i)
    if (i < km1) hist[i] = cst[static_cast<long long>(i) * a.cd + c];
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i)
    if (i == km1) hist[i] = __bfloat162float(xbc[c]);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i)
    if (i < a.taps)
      acc = __fadd_rn(acc, __fmul_rn(hist[i], __bfloat162float(a.conv_w[c * a.taps + i])));
  return silu(__fadd_rn(acc, __bfloat162float(a.conv_b[c])));
}

// Roll channel c's state by one position: the oldest drops, the new input enters.
__device__ __forceinline__ void roll_channel(const Args& a, float* cst, int c,
                                             const float (&hist)[kMaxTaps]) {
#pragma unroll
  for (int i = 0; i < kMaxTaps - 1; ++i)
    if (i < a.taps - 1) cst[static_cast<long long>(i) * a.cd + c] = hist[i + 1];
}

template <int P>
__global__ void __launch_bounds__(kThreads) ssm_step_kernel(const Args a) {
  const int head = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  __shared__ __align__(16) float bs[kN];
  __shared__ __align__(16) float cs[kN];
  __shared__ float xs[P];
  __shared__ float s_dt, s_da;
  __shared__ int s_last;

  const __nv_bfloat16* in = a.in + row * a.s_row;
  const __nv_bfloat16* xbc = in + a.di;
  float* cst = a.conv_state + static_cast<long long>(row) * (a.taps - 1) * a.cd;

  // B and C: channel di + tid; its history kept for the row's last block.
  float bc_hist[kMaxTaps];
  const float bc = conv_channel(a, cst, xbc, a.di + tid, bc_hist);
  if (tid < kN) bs[tid] = bc; else cs[tid - kN] = bc;
  if (tid < P) {  // this head's x channels: the state is this block's alone
    float hist[kMaxTaps];
    const int c = head * P + tid;
    xs[tid] = conv_channel(a, cst, xbc, c, hist);
    roll_channel(a, cst, c, hist);
  }
  if (tid == kThreads - 1) {
    const float dt = softplus(__fadd_rn(__bfloat162float(xbc[a.cd + head]), a.dt_bias[head]));
    s_dt = dt;
    s_da = expf(__fmul_rn(dt, -expf(a.a_log[head])));
  }
  __syncthreads();  // every read of the B and C state of this block is done
  if (tid == 0) s_last = atomicAdd(&a.tickets[row], 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {  // the row's other blocks have read it: roll it
    roll_channel(a, cst, a.di + tid, bc_hist);
    if (tid == 0) a.tickets[row] = 0;
  }

  const int q = tid % kLanes, pr = tid / kLanes;
  float* S = a.ssm + (static_cast<long long>(row) * a.heads + head) * P * kN;
  const float dt = s_dt, da = s_da, dh = a.d[head];
#pragma unroll
  for (int pass = 0; pass < P / (kThreads / kLanes); ++pass) {
    const int p = pr + pass * (kThreads / kLanes);
    const float xp = xs[p];
    const float dtx = __fmul_rn(dt, xp);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kN / (4 * kLanes); ++k) {
      const int n0 = k * 4 * kLanes + 4 * q;
      float4* sp = reinterpret_cast<float4*>(S + p * kN + n0);
      float4 s = *sp;
      const float4 b = *reinterpret_cast<const float4*>(bs + n0);
      const float4 c = *reinterpret_cast<const float4*>(cs + n0);
      s.x = __fadd_rn(__fmul_rn(s.x, da), __fmul_rn(dtx, b.x));
      s.y = __fadd_rn(__fmul_rn(s.y, da), __fmul_rn(dtx, b.y));
      s.z = __fadd_rn(__fmul_rn(s.z, da), __fmul_rn(dtx, b.z));
      s.w = __fadd_rn(__fmul_rn(s.w, da), __fmul_rn(dtx, b.w));
      *sp = s;
      acc = __fadd_rn(acc, __fmul_rn(s.x, c.x));
      acc = __fadd_rn(acc, __fmul_rn(s.y, c.y));
      acc = __fadd_rn(acc, __fmul_rn(s.z, c.z));
      acc = __fadd_rn(acc, __fmul_rn(s.w, c.w));
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (q == 0) {
      const int ch = head * P + p;
      const float y = __fadd_rn(acc, __fmul_rn(dh, xp));
      a.out[static_cast<long long>(row) * a.di + ch] =
          __float2bfloat16(__fmul_rn(y, silu(__bfloat162float(in[ch]))));
    }
  }
}

template <int P>
cudaError_t launch(const Args& a, int rows, cudaStream_t st) {
  ssm_step_kernel<P><<<dim3(a.heads, rows), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// in (rows, 2 di + 2 N + heads) bf16 at row stride s_row (its last dim
// contiguous): z, xBC, dt. conv_state (rows, taps - 1, di + 2 N) f32 and
// ssm (rows, heads, p, N) f32 contiguous, both advanced in place; conv_w
// (di + 2 N, taps) and conv_b (di + 2 N) bf16; dt_bias, a_log, d (heads) f32;
// out (rows, di) bf16. N = 128, p in {32, 64, 128}, di = heads p, taps 2-4,
// rows at most 65535; ssm 16-byte aligned; tickets (rows) u32, zero before
// the launch, left zero. Launches on `device`, restoring the caller's current
// device. Returns the launch's cudaError_t (then cudaGetLastError's).
extern "C" int rho_ssm_step(const void* in, long long s_row, void* conv_state, void* ssm,
                            const void* conv_w, const void* conv_b, const void* dt_bias,
                            const void* a_log, const void* d, void* out, void* tickets, int rows,
                            int heads, int p, int n, int taps, int device, void* stream) {
  if (rows < 1 || rows > 65535 || heads < 1 || n != kN || taps < 2 || taps > kMaxTaps ||
      tickets == nullptr || reinterpret_cast<uintptr_t>(ssm) % 16 != 0)
    return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  const int di = heads * p;
  const Args a{static_cast<const __nv_bfloat16*>(in), s_row, static_cast<float*>(conv_state),
               static_cast<float*>(ssm), static_cast<const __nv_bfloat16*>(conv_w),
               static_cast<const __nv_bfloat16*>(conv_b), static_cast<const float*>(dt_bias),
               static_cast<const float*>(a_log), static_cast<const float*>(d),
               static_cast<__nv_bfloat16*>(out), static_cast<unsigned*>(tickets), heads, di,
               di + 2 * n, taps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 32: return launch<32>(a, rows, st);
    case 64: return launch<64>(a, rows, st);
    case 128: return launch<128>(a, rows, st);
    default: return cudaErrorInvalidValue;
  }
}
