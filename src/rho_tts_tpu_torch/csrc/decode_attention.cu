// Single-token (decode) GQA attention over the KV cache for Hopper (sm_90a),
// bound through a plain C interface (ops/cuda/decode_attention.py loads it
// with ctypes).
//
// Replaces: rho_tts_tpu/ops/pallas/decode_attention.py decode_gqa_attention
// (_decode_kernel). Same function: one query token per row, (B,1,Hq,D),
// against the cache slab (B,S,Hkv,D) read in place; query head h reads KV
// head h / G; the caller gives the complete (B,S) validity mask; masked keys
// get the finite -1e30 fill and the result is divided by max(denom, 1e-30),
// so a row with no valid key averages V over all S keys. K and V are
// converted to f32 as they are used (f32, bf16 or float8 e4m3 storage) and
// the probabilities stay f32, as in the Pallas kernel. JAX's default einsum
// path instead casts the probabilities to bf16 for f8 caches
// (transformer._kv_compute_dtype); this kernel matches the Pallas kernel and
// reference_decode_attention, not that path. The port's default cache is
// bf16, where the two agree.
//
// Bound on the H100 at the main-path shape (B=5, S=384, Hkv=8, D=128, bf16
// cache): the bytes of K and V. 2*5*384*8*128*2 B ~ 7.9 MB per layer, ~2.3 us
// at 3.35 TB/s, less where masked slots need not be read; the products are
// ~16 MFLOP.
//
// Design: split-S (flash-decoding). The grid is (splits, Hkv, B); the
// wrapper picks `splits` so that the grid holds at least two blocks per SM
// (8 splits of 48 keys, 320 blocks, at the main-path shape). A block of four
// warps owns one slice of at most 64 keys of one (KV head, row) and the G =
// Hq/Hkv queries of that head:
//   1. It reads its row's whole (S,) mask (a few hundred bytes) and q.
//   2. It issues its whole K/V slice at once as 16-byte cp.async copies into
//      shared memory (up to 2 x 64 rows in flight per block; ~7.9 MB across
//      the card at the main-path shape). Masked keys of a row that has a
//      valid key are zero-filled without reading memory: their probability
//      exp(-1e30 - m) is exactly 0. A slice with no valid key in such a row
//      reads nothing and leaves the empty state (m = -inf). A row with no
//      valid key at all reads every key with the -1e30 fill, as the
//      reference does.
//   3. Scores: a row of K is LPR = 8..32 lanes of 16 bytes; each lane dots
//      its chunk with q (f32) and the row's lanes reduce by shuffles. Then
//      the slice's max, exp and sum per query (f32), and P.V with one head
//      dimension per thread.
//   4. With one split the block writes the output. Otherwise it writes its
//      (m, l, acc[G][D]) to a workspace; the last block of the (KV head, row)
//      to finish (an atomic ticket, reset by that block) merges the splits in
//      split order. Every sum has a fixed order, so the same inputs give the
//      same bits on every launch.
// Inputs whose K/V rows are not 16-byte aligned take the same path with
// scalar loads.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxD = 128;     // head dimension
constexpr int kMaxSlice = 64;  // keys per block
constexpr int kMaskPass = 4;   // mask bytes a thread loads at once
constexpr int kMergeBatch = 8;  // splits whose states the merge loads at once
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ __nv_fp8_e4m3 zero<__nv_fp8_e4m3>() { return __nv_fp8_e4m3(0.f); }

// 16-byte global -> shared copy; src_bytes = 0 fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  void* o;
  float* work;        // splits > 1: per (row, KV head, split) acc[G][D], m[G], l[G]
  unsigned* tickets;  // splits > 1: one per (row, KV head), zero between launches
  int s_len, d_len, group, slice, splits, vec;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, m_sb;
  float scale;
};

// kG: the group size rounded up to 2 or kMaxG, so that the loops over the
// queries unroll fully and their shuffles interleave.
template <typename TQ, typename TKV, int kG>
__global__ void __launch_bounds__(kThreads) split_decode_kernel(const DecodeArgs a) {
  constexpr int kCh = 16 / static_cast<int>(sizeof(TKV));  // values per 16-byte chunk
  constexpr int kLpr = kMaxD / kCh;                          // lanes per key row
  constexpr int kRpw = 32 / kLpr;                            // key rows per warp pass
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float qs[kMaxG][kMaxD];
  __shared__ uint8_t ms[kMaxSlice];
  __shared__ float sm_m[kMaxG];
  __shared__ float sm_l[kMaxG];
  __shared__ bool s_last;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = a.group;
  const int d_len = a.d_len;
  const int slice = a.slice;
  const int s0 = split * slice;
  const int n = min(slice, a.s_len - s0);
  TKV* ks = reinterpret_cast<TKV*>(smem);                    // [slice][kMaxD]
  TKV* vs = ks + slice * kMaxD;                              // [slice][kMaxD]
  float* ps = reinterpret_cast<float*>(vs + slice * kMaxD);  // [G][slice]
  const long long unit = (static_cast<long long>(b) * gridDim.y + hk) * a.splits;
  const long long unit_floats = static_cast<long long>(group) * (d_len + 2);

  // q in f32 (kMaxD == kThreads: one head dimension per thread), and the
  // row's mask: any valid key in the row, and in the slice. Each pass issues
  // all its loads before it uses any.
  static_assert(kMaxD == kThreads, "q staging takes one dimension per thread");
  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb + hk * group * a.q_sh;
  float qv[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) qv[g] = g < group && tid < d_len ? to_f32(qb[g * a.q_sh + tid]) : 0.f;
#pragma unroll
  for (int g = 0; g < kG; ++g) qs[g][tid] = qv[g];
  const uint8_t* mb = a.mask + b * a.m_sb;
  int any = 0;
  for (int j0 = 0; j0 < a.s_len; j0 += kMaskPass * kThreads) {
    uint8_t mv[kMaskPass];
#pragma unroll
    for (int u = 0; u < kMaskPass; ++u) {
      const int j = j0 + u * kThreads + tid;
      mv[u] = j < a.s_len ? mb[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kMaskPass; ++u) {
      const int j = j0 + u * kThreads + tid;
      any |= mv[u];
      if (j >= s0 && j < s0 + n) ms[j - s0] = mv[u] != 0;
    }
  }
  const bool row_any = __syncthreads_or(any);
  const bool slice_any = __syncthreads_or(tid < n && ms[tid]);

  if (row_any && !slice_any) {
    // Every key of the slice is masked and the row has a valid key elsewhere:
    // the reference's contribution from here is exactly 0.
    if (tid < group) a.work[(unit + split) * unit_floats + group * d_len + tid] = -INFINITY;
  } else {
    const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + hk * a.k_sh + s0 * a.k_ss;
    const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + hk * a.v_sh + s0 * a.v_ss;
    if (a.vec) {
      for (int c = tid; c < 2 * n * kLpr; c += kThreads) {
        const bool is_v = c >= n * kLpr;
        const int cc = is_v ? c - n * kLpr : c;
        const int j = cc / kLpr;
        const int p = cc % kLpr;
        const bool need = (!row_any || ms[j]) && p * kCh < d_len;
        const TKV* src = is_v ? vb + j * a.v_ss : kb + j * a.k_ss;
        cp_async16((is_v ? vs : ks) + j * kMaxD + p * kCh, need ? src + p * kCh : src,
                   need ? 16 : 0);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_all;\n" ::);
    } else {
      for (int e = tid; e < 2 * n * kMaxD; e += kThreads) {
        const bool is_v = e >= n * kMaxD;
        const int ee = is_v ? e - n * kMaxD : e;
        const int j = ee / kMaxD;
        const int d = ee % kMaxD;
        const bool need = (!row_any || ms[j]) && d < d_len;
        const TKV* src = is_v ? vb + j * a.v_ss : kb + j * a.k_ss;
        (is_v ? vs : ks)[j * kMaxD + d] = need ? src[d] : zero<TKV>();
      }
    }
    __syncthreads();

    // Scores, f32: the lanes of a row group hold 16-byte chunks of one key.
    const int rg = lane / kLpr;
    const int p = lane % kLpr;
#pragma unroll 2
    for (int j0 = warp * kRpw; j0 < n; j0 += kWarps * kRpw) {
      const int j = j0 + rg;
      float kf[kCh];
      if (j < n) {
        const uint4 chunk = *reinterpret_cast<const uint4*>(ks + j * kMaxD + p * kCh);
        const TKV* e = reinterpret_cast<const TKV*>(&chunk);
#pragma unroll
        for (int c = 0; c < kCh; ++c) kf[c] = to_f32(e[c]);
      } else {
#pragma unroll
        for (int c = 0; c < kCh; ++c) kf[c] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= group) continue;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < kCh; ++c) part = fmaf(qs[g][p * kCh + c], kf[c], part);
#pragma unroll
        for (int off = kLpr / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (p == 0 && j < n) ps[g * slice + j] = ms[j] ? part * a.scale : kMaskFill;
      }
    }
    __syncthreads();

    // The slice's softmax state per query: max, exp, sum (f32).
    for (int g = warp; g < group; g += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[g * slice + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(ps[g * slice + j] - mx);
        ps[g * slice + j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        sm_m[g] = mx;
        sm_l[g] = sum;
      }
    }
    __syncthreads();

    // P.V: one head dimension per thread, all G queries.
    float* wk = a.work + (unit + split) * unit_floats;
    for (int d = tid; d < d_len; d += kThreads) {
      float acc[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g] = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float vv = to_f32(vs[j * kMaxD + d]);
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < group) acc[g] = fmaf(ps[g * slice + j], vv, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= group) break;
        if (a.splits == 1)
          store(static_cast<TQ*>(a.o) + b * a.o_sb + (hk * group + g) * a.o_sh + d,
                acc[g] / fmaxf(sm_l[g], 1e-30f));
        else
          wk[g * d_len + d] = acc[g];
      }
    }
    if (a.splits > 1 && tid < group) {
      wk[group * d_len + tid] = sm_m[tid];
      wk[group * d_len + group + tid] = sm_l[tid];
    }
  }
  if (a.splits == 1) return;

  // The last block of this (row, KV head) to finish merges the splits.
  __threadfence();
  __syncthreads();
  const long long ticket = static_cast<long long>(b) * gridDim.y + hk;
  if (tid == 0)
    s_last = atomicAdd(&a.tickets[ticket], 1u) == static_cast<unsigned>(a.splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Merge in split order: per batch of kBatch splits, the batch's max, then
  // the rescaled sums in split order. A thread owns kOut outputs; the states
  // of a batch for all of them are loaded at once.
  constexpr int kOut = kG * kMaxD / kThreads;
  constexpr int kBatch = 16 / kOut;
  const float* w0 = a.work + unit * unit_floats;
  float mx[kOut], den[kOut], num[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    mx[i] = -INFINITY;
    den[i] = num[i] = 0.f;
  }
  for (int sp0 = 0; sp0 < a.splits; sp0 += kBatch) {
    float m[kOut][kBatch], l[kOut][kBatch], x[kOut][kBatch];
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int e = tid + i * kThreads;
      const int g = e / d_len;
      const bool out_ok = e < group * d_len;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float* w = w0 + (sp0 + u) * unit_floats;
        const bool ok = out_ok && sp0 + u < a.splits;
        m[i][u] = ok ? __ldcg(w + group * d_len + g) : -INFINITY;
        l[i][u] = ok ? __ldcg(w + group * d_len + group + g) : 0.f;
        x[i][u] = ok ? __ldcg(w + e) : 0.f;  // acc[g][d] at g * d_len + d == e
      }
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      float mn = mx[i];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) mn = fmaxf(mn, m[i][u]);
      if (mn == -INFINITY) continue;  // only skipped slices so far
      const float c_old = expf(mx[i] - mn);
      den[i] *= c_old;
      num[i] *= c_old;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (m[i][u] == -INFINITY) continue;  // a skipped slice (or past the last)
        const float c = expf(m[i][u] - mn);
        den[i] += l[i][u] * c;
        num[i] += x[i][u] * c;
      }
      mx[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int e = tid + i * kThreads;
    if (e < group * d_len)
      store(static_cast<TQ*>(a.o) + b * a.o_sb + (hk * group + e / d_len) * a.o_sh + e % d_len,
            num[i] / fmaxf(den[i], 1e-30f));
  }
  if (tid == 0) a.tickets[ticket] = 0u;  // ready for the next launch
}

template <typename TKV>
bool rows_aligned(const DecodeArgs& a) {
  constexpr long long ch = 16 / sizeof(TKV);
  return reinterpret_cast<uintptr_t>(a.k) % 16 == 0 && reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
         a.d_len % ch == 0 && a.k_sb % ch == 0 && a.k_ss % ch == 0 && a.k_sh % ch == 0 &&
         a.v_sb % ch == 0 && a.v_ss % ch == 0 && a.v_sh % ch == 0;
}

template <typename TQ, typename TKV, int kG>
cudaError_t launch(DecodeArgs a, int b, int hkv, cudaStream_t stream) {
  a.vec = rows_aligned<TKV>(a);
  const int smem = a.slice * (2 * kMaxD * static_cast<int>(sizeof(TKV)) + kMaxG * 4);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        split_decode_kernel<TQ, TKV, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(a.splits, hkv, b);
  split_decode_kernel<TQ, TKV, kG><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_g(const DecodeArgs& a, int b, int hkv, cudaStream_t stream) {
  return a.group <= 2 ? launch<TQ, TKV, 2>(a, b, hkv, stream)
                      : launch<TQ, TKV, kMaxG>(a, b, hkv, stream);
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const DecodeArgs& a, int b, int hkv, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_g<TQ, float>(a, b, hkv, stream);
    case 1: return dispatch_g<TQ, __nv_bfloat16>(a, b, hkv, stream);
    case 2: return dispatch_g<TQ, __nv_fp8_e4m3>(a, b, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of workspace and tickets a launch with these sizes needs (both 0
// for one split).
extern "C" void rho_decode_workspace(int b, int hq, int hkv, int d, int splits,
                                     long long* work_floats, long long* tickets) {
  const long long units = static_cast<long long>(b) * hkv;
  *work_floats = splits > 1 ? units * splits * (hq / hkv) * (d + 2LL) : 0;
  *tickets = splits > 1 ? units : 0;
}

// q_dtype: 0 = float32, 1 = bfloat16 (q and o share it).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = float8 e4m3.
// strides (in elements): q_sb q_sh  k_sb k_ss k_sh  v_sb v_ss v_sh  o_sb o_sh
// mask_sb; the head dimension and the mask's key dimension are contiguous.
// splits x slice covers S, each split non-empty, slice <= 64; work/tickets as
// rho_decode_workspace says (tickets zeroed before the first launch; each
// launch leaves them zero). scale multiplies the scores; 0 means
// 1 / sqrt(d). Launches on `device`, restoring the caller's current device.
// Returns the cudaError_t of the launch.
extern "C" int rho_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, void* work, void* tickets,
                                    int q_dtype, int kv_dtype, int b, int s, int hq, int hkv,
                                    int d, int splits, int slice, const long long* st,
                                    float scale, int device, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxG || d <= 0 ||
      d > kMaxD || slice <= 0 || slice > kMaxSlice || splits <= 0 ||
      static_cast<long long>(splits - 1) * slice >= s || static_cast<long long>(splits) * slice < s ||
      (splits > 1 && (work == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc != cudaSuccess) return rc;
  if (current != device && (rc = cudaSetDevice(device)) != cudaSuccess) return rc;
  DecodeArgs a{q, k, v, static_cast<const uint8_t*>(mask), o, static_cast<float*>(work),
               static_cast<unsigned*>(tickets), s, d, hq / hkv, slice, splits, 0,
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
               scale > 0.f ? scale : 1.f / sqrtf(static_cast<float>(d))};
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    rc = dispatch_kv<float>(kv_dtype, a, b, hkv, stream_);
  else if (q_dtype == 1)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, a, b, hkv, stream_);
  else
    rc = cudaErrorInvalidValue;
  if (current != device) cudaSetDevice(current);
  return rc;
}
