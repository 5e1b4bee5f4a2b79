// Prefill GQA attention for Hopper (sm_90a), bound through a plain C
// interface (ops/cuda/attention.py loads it with ctypes).
//
// Replaces: rho_tts_tpu/ops/pallas/attention.py fused_gqa_attention
// (_attention_kernel). Same function: softmax(q k^T / sqrt(D)) v with query
// head h reading KV head h / group, an int8/bool key-validity mask ANDed with
// a causal term at the global query position q_offset + row, f32 scores,
// -1e30 fill for masked keys, f32 probabilities, division by
// max(denom, 1e-30), output in q's dtype. A row with no valid key (a
// left-padded prompt row) averages V over all S keys instead of giving NaN.
//
// Bound on the H100 at the main-path shape (B=5, T=S=128, Hq=16, Hkv=8,
// D=128, bf16): the bytes. q+k+v+o are ~7.9 MB, ~2.3 us at 3.35 TB/s, while
// the 0.34 GFLOP of causal products are ~0.35 us of bf16 tensor-core time;
// beyond the bytes, latency.
//
// bf16 (tc_prefill_kernel): one block per (64-query tile, query head, batch
// row), four warps of 16 query rows each; 160 blocks at the main-path shape,
// all resident at once (two fit on an SM). The Q tile and 64-key K/V tiles
// are copied by 16-byte cp.async straight from the caller's (B,T,Hq,D) and
// (B,S,Hkv,D) layouts (no transpose, no KV copy for GQA) into shared memory,
// K/V in a double-buffered ring, so the next tile's copy overlaps this
// tile's products. Rows are padded by 16 bytes, so ldmatrix reads are free
// of bank conflicts. Per tile and warp:
//   S = Q K^T with mma.sync m16n8k16 (bf16 x bf16 -> f32; the products are
//   exact in f32), Q's fragments held in registers; scale, mask and an online
//   softmax in f32 on the accumulator fragments; then O += P V with V's
//   fragments from ldmatrix.trans. P enters the tensor cores as a hi + lo
//   pair of bf16 (hi = bf16(p), lo = bf16(p - hi); two products into one f32
//   accumulator), so each probability carries ~16 bits, not bf16's 8: the
//   reference keeps probabilities in f32. The denominator sums the f32 p.
// Causal skip: key tiles wholly past the causal diagonal of the block's last
// query row are skipped when the batch row has a valid key at or before the
// block's first query position: every query row of the block then has a
// valid key, so the skipped keys' exp(-1e30 - m) is exactly 0. A block that
// holds a row with no valid key visits every key tile, as the reference
// averages over all S keys.
//
// f32 inputs (the tiny preset and the tests) and bf16 inputs not 16-byte
// aligned take simt_prefill_kernel: four threads per query row, f32
// products on the SIMT cores, key tiles of 32 staged in shared memory as f32;
// it visits every key tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  void* o;
  int t_len, s_len, group, q_offset, causal;
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_st, o_sh, m_sb;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTcBlockQ = 64;  // query rows per block: 4 warps x 16
constexpr int kTcBlockK = 64;  // keys per ring stage
constexpr int kTcThreads = 128;
constexpr int kTcPad = 8;      // bf16 of padding per shared-memory row

template <int D>
constexpr int tc_smem_bytes() {
  return (kTcBlockQ + 4 * kTcBlockK) * (D + kTcPad) * 2 + 2 * kTcBlockK;
}

// 16-byte global -> shared copy; src_bytes = 0 fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Not volatile: a pure register operation, which the compiler may schedule
// between independent accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> the bf16 pair hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y).
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) tc_prefill_kernel(const PrefillArgs a) {
  constexpr int kRow = D + kTcPad;  // bf16 per shared-memory row
  constexpr int kChunks = D / 8;    // 16-byte chunks per row
  constexpr int kNt = kTcBlockK / 8;  // score n-tiles of 8 keys
  constexpr int kDt = D / 8;          // output n-tiles of 8 dims
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][kRow]
  __nv_bfloat16* ks = qs + kTcBlockQ * kRow;                    // [2][BK][kRow]
  __nv_bfloat16* vs = ks + 2 * kTcBlockK * kRow;                // [2][BK][kRow]
  uint8_t* msk = reinterpret_cast<uint8_t*>(vs + 2 * kTcBlockK * kRow);  // [2][BK]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / a.group;
  const int t0 = blockIdx.x * kTcBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int s_len = a.s_len;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const uint8_t* mb = a.mask + b * a.m_sb;

  auto load_kv = [&](int tile, int stage) {
    const int kt0 = tile * kTcBlockK;
    for (int c = tid; c < kTcBlockK * kChunks; c += kTcThreads) {
      const int j = c / kChunks;
      const int ch = (c % kChunks) * 8;
      const bool ok = kt0 + j < s_len;
      const long long key = ok ? kt0 + j : 0;
      const int off = (stage * kTcBlockK + j) * kRow + ch;
      cp_async16(ks + off, kb + key * a.k_ss + ch, ok ? 16 : 0);
      cp_async16(vs + off, vb + key * a.v_ss + ch, ok ? 16 : 0);
    }
  };

  // Q and the first key tile in flight first.
  for (int c = tid; c < kTcBlockQ * kChunks; c += kTcThreads) {
    const int r = c / kChunks;
    const int ch = (c % kChunks) * 8;
    const bool ok = t0 + r < a.t_len;
    cp_async16(qs + r * kRow + ch, qb + (ok ? t0 + r : 0) * a.q_st + ch, ok ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();

  // The mask of the first two tiles (stages 0 and 1 hold keys 0..127), and
  // whether the row has a valid key at or before the block's first query.
  const int qpos0 = a.q_offset + t0;
  const int scan_end = min(s_len, max(2 * kTcBlockK, a.causal ? qpos0 + 1 : 0));
  int has = 0;
  for (int j = tid; j < scan_end; j += kTcThreads) {
    const uint8_t mv = mb[j];
    if (j < 2 * kTcBlockK) msk[j] = mv;
    has |= mv != 0 && j <= qpos0;
  }
  const bool skip = __syncthreads_or(has) && a.causal;
  const int t_last = min(t0 + kTcBlockQ, a.t_len) - 1;
  const int key_end = skip ? min(s_len, a.q_offset + t_last + 1) : s_len;
  const int n_tiles = (key_end + kTcBlockK - 1) / kTcBlockK;

  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  const int g = lane / 4;
  const int tq = lane % 4;
  const int row_a = t0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const int qpos_a = a.q_offset + row_a;
  const int qpos_b = a.q_offset + row_b;

  uint32_t qf[D / 16][4];
  float oacc[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    const int kt0 = tile * kTcBlockK;
    cp_async_wait_1();
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kRow + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kst = ks + stage * kTcBlockK * kRow;
    const __nv_bfloat16* vst = vs + stage * kTcBlockK * kRow;
    const uint8_t* mst = msk + stage * kTcBlockK;

    // S = Q K^T (f32).
    float sc[kNt][4];
#pragma unroll
    for (int i = 0; i < kNt; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kRow + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Scale, mask, online softmax (f32). Elements 0,1 are row_a, 2,3 row_b.
    // Scores and fill are kept in log2 units, so exp2f gives exp(s - m):
    // the same probabilities to a few ulp, for fewer instructions than expf.
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < kNt; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = i * 8 + 2 * tq + (e & 1);
        const int key = kt0 + jl;
        float s;
        if (key >= s_len) {
          s = -INFINITY;  // past S: no key there
        } else {
          const bool valid = mst[jl] != 0 && (!a.causal || key <= (e < 2 ? qpos_a : qpos_b));
          s = valid ? sc[i][e] * (a.scale * kLog2e) : kMaskFill * kLog2e;
        }
        sc[i][e] = s;
        if (e < 2)
          mx_a = fmaxf(mx_a, s);
        else
          mx_b = fmaxf(mx_b, s);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // Finite: every tile holds at least one in-range key.
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a);
    const float alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < kNt; ++i) {
      sc[i][0] = exp2f(sc[i][0] - mn_a);
      sc[i][1] = exp2f(sc[i][1] - mn_a);
      sc[i][2] = exp2f(sc[i][2] - mn_b);
      sc[i][3] = exp2f(sc[i][3] - mn_b);
      sum_a += sc[i][0] + sc[i][1];
      sum_b += sc[i][2] + sc[i][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < kDt; ++i) {
      oacc[i][0] *= alpha_a;
      oacc[i][1] *= alpha_a;
      oacc[i][2] *= alpha_b;
      oacc[i][3] *= alpha_b;
    }

    // O += P V, P as hi + lo bf16.
#pragma unroll
    for (int kk = 0; kk < kTcBlockK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vst + (kk * 16 + (lane & 15)) * kRow + dp * 16 + (lane >> 4) * 8);
        mma_bf16(oacc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(oacc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }

    __syncthreads();  // this stage has been consumed: refill it with tile + 2
    if (tile + 2 < n_tiles) {
      load_kv(tile + 2, stage);
      const int key = (tile + 2) * kTcBlockK + tid;
      if (tid < kTcBlockK) msk[stage * kTcBlockK + tid] = key < s_len ? mb[key] : 0;
    }
    cp_async_commit();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < kDt; ++i) {
    const int col = i * 8 + 2 * tq;
    if (row_a < a.t_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * a.o_st + col) =
          __floats2bfloat162_rn(oacc[i][0] * inv_a, oacc[i][1] * inv_a);
    if (row_b < a.t_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_b * a.o_st + col) =
          __floats2bfloat162_rn(oacc[i][2] * inv_b, oacc[i][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// f32 (and unaligned bf16): SIMT
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;              // query rows per block
constexpr int kBlockK = 32;              // keys per shared-memory tile
constexpr int kLanes = 4;                // threads per query row
constexpr int kThreads = kBlockQ * kLanes;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) simt_prefill_kernel(const PrefillArgs a) {
  constexpr int kDpt = D / kLanes;  // head dims per thread
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];
  __shared__ uint8_t ms[kBlockK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / a.group;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int t = blockIdx.x * kBlockQ + row;
  const bool row_ok = t < a.t_len;
  const long long qpos = static_cast<long long>(a.q_offset) + t;

  float qr[kDpt];
  float acc[kDpt];
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + static_cast<long long>(t) * a.q_st +
                h * a.q_sh;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    qr[i] = row_ok ? to_f32(qp[lane + kLanes * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const uint8_t* mb = a.mask + b * a.m_sb;

  for (int s0 = 0; s0 < a.s_len; s0 += kBlockK) {
    const int n = min(kBlockK, a.s_len - s0);
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int d = e % D;
      float kx = 0.f, vx = 0.f;
      if (j < n) {
        kx = to_f32(kb[static_cast<long long>(s0 + j) * a.k_ss + d]);
        vx = to_f32(vb[static_cast<long long>(s0 + j) * a.v_ss + d]);
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
        const bool valid = ms[j] != 0 && (!a.causal || s0 + j <= qpos);
        s = valid ? part * a.scale : kMaskFill;
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
    T* op = static_cast<T*>(a.o) + b * a.o_sb + static_cast<long long>(t) * a.o_st + h * a.o_sh;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) store(op + lane + kLanes * i, acc[i] * inv);
  }
}

bool tc_aligned(const PrefillArgs& a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  const long long strides =
      a.q_sb | a.q_st | a.q_sh | a.k_sb | a.k_ss | a.k_sh | a.v_sb | a.v_ss | a.v_sh;
  return ptrs % 16 == 0 && strides % 8 == 0;
}

template <typename T, int D>
cudaError_t launch(const PrefillArgs& a, int b, int hq, cudaStream_t stream) {
  if (sizeof(T) == 2 && tc_aligned(a)) {
    constexpr int smem = tc_smem_bytes<D>();
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          tc_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return rc;
    }
    const dim3 grid((a.t_len + kTcBlockQ - 1) / kTcBlockQ, hq, b);
    tc_prefill_kernel<D><<<grid, kTcThreads, smem, stream>>>(a);
  } else {
    const dim3 grid((a.t_len + kBlockQ - 1) / kBlockQ, hq, b);
    simt_prefill_kernel<T, D><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const PrefillArgs& a, int b, int hq, cudaStream_t stream) {
  switch (d) {
#define RHO_CASE(DD) \
  case DD:           \
    return launch<T, DD>(a, b, hq, stream);
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
// are contiguous; o is contiguous. scale multiplies the scores; 0 means
// 1 / sqrt(d). Launches on `device`, restoring the caller's current device.
// Returns the cudaError_t of the launch.
extern "C" int rho_prefill_attention(const void* q, const void* k, const void* v,
                                     const void* mask, void* o, int dtype, int b, int t, int s,
                                     int hq, int hkv, int d, const long long* st, int q_offset,
                                     int causal, float scale, int device, void* stream) {
  if (b <= 0 || t <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc != cudaSuccess) return rc;
  if (current != device && (rc = cudaSetDevice(device)) != cudaSuccess) return rc;
  const PrefillArgs a{q, k, v, static_cast<const uint8_t*>(mask), o, t, s, hq / hkv, q_offset,
                      causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                      st[9], st[10], st[11], st[12],
                      scale > 0.f ? scale : 1.f / sqrtf(static_cast<float>(d))};
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rc = dispatch_d<float>(d, a, b, hq, stream_);
  else if (dtype == 1)
    rc = dispatch_d<__nv_bfloat16>(d, a, b, hq, stream_);
  else
    rc = cudaErrorInvalidValue;
  if (current != device) cudaSetDevice(current);
  return rc;
}
