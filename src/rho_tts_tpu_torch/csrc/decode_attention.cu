// Single-token (decode) GQA attention over the KV cache for Hopper (sm_90a),
// bound through a plain C interface (ops/cuda/decode_attention.py loads it
// with ctypes).
//
// Replaces: rho_tts_tpu/ops/pallas/decode_attention.py decode_gqa_attention
// (_decode_kernel). Same function: one query token per row, (B,1,Hq,D),
// against the cache slab (B,S,Hkv,D) read in place; the caller gives the
// complete (B,S) validity mask; masked keys get the finite -1e30 fill and the
// result is divided by max(denom, 1e-30). K and V are converted to f32 as
// they are loaded (f32, bf16 or float8 e4m3 storage) and the probabilities
// stay f32, as in the Pallas kernel. JAX's default einsum path instead casts
// the probabilities to bf16 for f8 caches (transformer._kv_compute_dtype);
// this kernel matches the Pallas kernel and reference_decode_attention, not
// that path. The port's default cache is bf16, where the two agree.
//
// Bound on the H100 at the main-path shape (B=5, S=384, Hkv=8, D=128, bf16
// cache): the bytes. K+V are 2*5*384*8*128*2 B ~ 7.9 MB per layer, ~2.3 us
// at 3.35 TB/s; the products are ~16 MFLOP. Launch overhead exceeds both.
//
// Design: one block per (KV head, batch row) holds that head's G = Hq/Hkv
// queries. Its four warps take every fourth key; within a warp each lane
// holds dims lane + 32*i of q, of the key and value rows it loads (one
// coalesced row read per key) and of the f32 output accumulator. Each score
// is a warp-shuffle reduction; each warp keeps an online softmax per query,
// and the four partial states are merged through shared memory at the end.
// 40 blocks underfill the 132 SMs at the main-path shape: a split-S
// (flash-decoding) pass over more blocks is later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;      // query heads per KV head
constexpr int kMaxD = 128;    // head dimension
constexpr int kMaxDpl = kMaxD / 32;
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const uint8_t* __restrict__ mask,
                        TQ* __restrict__ o, int s_len, int d_len, int group,
                        long long q_sb, long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_sh, long long m_sb, float scale) {
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][kMaxD];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[kMaxG][kMaxDpl];
  float acc[kMaxG][kMaxDpl];
  float m[kMaxG];
  float l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    const TQ* qp = q + b * q_sb + (hk * group + g) * q_sh;
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < group && d < d_len) ? to_f32(qp[d]) : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const TKV* kb = k + b * k_sb + hk * k_sh;
  const TKV* vb = v + b * v_sb + hk * v_sh;
  const uint8_t* mb = mask + b * m_sb;

  for (int j = warp; j < s_len; j += kWarps) {
    float kr[kMaxDpl], vr[kMaxDpl];
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < d_len ? to_f32(kb[static_cast<long long>(j) * k_ss + d]) : 0.f;
      vr[i] = d < d_len ? to_f32(vb[static_cast<long long>(j) * v_ss + d]) : 0.f;
    }
    const bool valid = mb[j] != 0;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= group) break;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) part = fmaf(qr[g][i], kr[i], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      const float s = valid ? part * scale : kMaskFill;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) acc[g][i] = fmaf(p, vr[i], acc[g][i] * alpha);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= group) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int d = lane + 32 * i;
      if (d < d_len) sm_acc[warp][g][d] = acc[g][i];
    }
  }
  __syncthreads();

  // Merge the warps' partial softmax states. A warp that saw no key holds
  // m = -inf, l = 0 and drops out through exp(-inf) = 0.
  for (int e = threadIdx.x; e < group * d_len; e += kThreads) {
    const int g = e / d_len;
    const int d = e % d_len;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    store(o + b * o_sb + (hk * group + g) * o_sh + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   int b, int s, int hq, int hkv, int d, const long long* st,
                   cudaStream_t stream) {
  const dim3 grid(hkv, b);
  const float scale = 1.f / sqrtf(static_cast<float>(d));
  decode_attention_kernel<TQ, TKV><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const uint8_t*>(mask), static_cast<TQ*>(o), s, d, hq / hkv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                        const void* mask, void* o, int b, int s, int hq, int hkv, int d,
                        const long long* st, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(q, k, v, mask, o, b, s, hq, hkv, d, st, stream);
    case 1: return launch<TQ, __nv_bfloat16>(q, k, v, mask, o, b, s, hq, hkv, d, st, stream);
    case 2: return launch<TQ, __nv_fp8_e4m3>(q, k, v, mask, o, b, s, hq, hkv, d, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q and o share it).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = float8 e4m3.
// strides (in elements): q_sb q_sh  k_sb k_ss k_sh  v_sb v_ss v_sh  o_sb o_sh
// mask_sb; the head dimension and the mask's key dimension are contiguous.
// Returns the cudaError_t of the launch.
extern "C" int rho_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, int q_dtype, int kv_dtype, int b,
                                    int s, int hq, int hkv, int d, const long long* strides,
                                    void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxG || d <= 0 ||
      d > kMaxD)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k, v, mask, o, b, s, hq, hkv, d, strides, st);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, mask, o, b, s, hq, hkv, d, strides, st);
  return cudaErrorInvalidValue;
}
