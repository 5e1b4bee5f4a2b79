// Prefill GQA attention for Hopper (sm_90a), bound through a plain C
// interface (ops/cuda/attention.py loads it with ctypes).
//
// Replaces: rho_tts_tpu/ops/pallas/attention.py fused_gqa_attention
// (_attention_kernel). Same function: softmax(q k^T / sqrt(D)) v with query
// head h reading KV head h / group, an int8/bool key-validity mask ANDed with
// a causal term at the global query position q_offset + row, f32 scores,
// -1e30 fill for masked keys, division by max(denom, 1e-30), output in q's
// dtype.
//
// Bound on the H100 at the main-path shape (B=5, T=S=128, Hq=16, Hkv=8,
// D=128, bf16): the bytes. q+k+v+o are ~7.9 MB, ~2.3 us at 3.35 TB/s, while
// the 0.34 GFLOP of causal products are ~0.3 us of bf16 tensor-core time.
// Launch overhead exceeds both.
//
// Design: one block per (64-query tile, query head, batch row). 256 threads:
// four threads per query row, each holding an interleaved quarter of the
// head dimension (d = lane + 4*i) of q and of the f32 output accumulator.
// The block walks the keys in tiles of 32, staged in shared memory as f32
// (coalesced loads through the caller's strides: the (B,T,H,D) and
// (B,S,Hkv,D) layouts are read in place, no transpose and no KV copy for
// GQA), and keeps an online softmax in f32. Each score is a 4-lane partial
// dot reduced with two shuffles. The products run on the SIMT cores; the
// tensor cores (wgmma) and TMA staging are later work.
//
// Fully masked rows (left-padded prompt rows): masked in-range keys get the
// finite -1e30 fill, exactly as the reference, so such a row averages V over
// all S keys instead of producing NaN; keys past S are skipped entirely. The
// kernel therefore visits every key tile, also past the causal diagonal:
// skipping those tiles would change what a fully masked row averages over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;              // query rows per block
constexpr int kBlockK = 32;              // keys per shared-memory tile
constexpr int kLanes = 4;                // threads per query row
constexpr int kThreads = kBlockQ * kLanes;
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         T* __restrict__ o, int t_len, int s_len, int group,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_st, long long o_sh,
                         long long m_sb, int q_offset, int causal, float scale) {
  constexpr int kDpt = D / kLanes;  // head dims per thread
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];
  __shared__ uint8_t ms[kBlockK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int t = blockIdx.x * kBlockQ + row;
  const bool row_ok = t < t_len;
  const long long qpos = static_cast<long long>(q_offset) + t;

  float qr[kDpt];
  float acc[kDpt];
  const T* qp = q + b * q_sb + static_cast<long long>(t) * q_st + h * q_sh;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    qr[i] = row_ok ? to_f32(qp[lane + kLanes * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const uint8_t* mb = mask + b * m_sb;

  for (int s0 = 0; s0 < s_len; s0 += kBlockK) {
    const int n = min(kBlockK, s_len - s0);
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int d = e % D;
      float kx = 0.f, vx = 0.f;
      if (j < n) {
        kx = to_f32(kb[static_cast<long long>(s0 + j) * k_ss + d]);
        vx = to_f32(vb[static_cast<long long>(s0 + j) * v_ss + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    if (tid < kBlockK) ms[tid] = (tid < n) ? mb[s0 + tid] : 0;
    __syncthreads();

    float sc[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) part = fmaf(qr[i], ks[j][lane + kLanes * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float s;
      if (j >= n) {
        s = -INFINITY;  // past S: no key there
      } else {
        const bool valid = ms[j] != 0 && (!causal || s0 + j <= qpos);
        s = valid ? part * scale : kMaskFill;
      }
      sc[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    // tile_max is finite: every tile holds at least one in-range key.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) acc[i] = fmaf(p, vs[j][lane + kLanes * i], acc[i]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = o + b * o_sb + static_cast<long long>(t) * o_st + h * o_sh;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) store(op + lane + kLanes * i, acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   int b, int t, int s, int hq, int hkv, const long long* st, int q_offset,
                   int causal, cudaStream_t stream) {
  const dim3 grid((t + kBlockQ - 1) / kBlockQ, hq, b);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  prefill_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(o), t, s, hq / hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], q_offset, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const void* mask,
                       void* o, int b, int t, int s, int hq, int hkv, const long long* st,
                       int q_offset, int causal, cudaStream_t stream) {
  switch (d) {
#define RHO_CASE(DD) \
  case DD:           \
    return launch<T, DD>(q, k, v, mask, o, b, t, s, hq, hkv, st, q_offset, causal, stream);
    RHO_CASE(16) RHO_CASE(32) RHO_CASE(48) RHO_CASE(64)
    RHO_CASE(80) RHO_CASE(96) RHO_CASE(112) RHO_CASE(128)
#undef RHO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// strides (in elements): q_sb q_st q_sh  k_sb k_ss k_sh  v_sb v_ss v_sh
// o_sb o_st o_sh  mask_sb; the head dimension and the mask's key dimension
// are contiguous. Returns the cudaError_t of the launch.
extern "C" int rho_prefill_attention(const void* q, const void* k, const void* v,
                                     const void* mask, void* o, int dtype, int b, int t, int s,
                                     int hq, int hkv, int d, const long long* strides,
                                     int q_offset, int causal, void* stream) {
  if (b <= 0 || t <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, mask, o, b, t, s, hq, hkv, strides, q_offset, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, mask, o, b, t, s, hq, hkv, strides, q_offset,
                                     causal, st);
  return cudaErrorInvalidValue;
}
