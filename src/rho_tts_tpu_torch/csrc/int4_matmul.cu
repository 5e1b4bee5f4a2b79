// Weight-only int4 matmul for Hopper (sm_90a), bound through a plain C
// interface (ops/cuda/int4_matmul.py loads it with ctypes).
//
// Replaces: rho_tts_tpu/ops/pallas/int4_matmul.py _int4_matmul_call
// (_kernel). Same function: x (M,K) times the half-split packed weight
// q4 (K/2,N) int8, where byte (i,n) holds row i in its low nibble and row
// i + K/2 in its high nibble, both signed: lo = (b << 28) >> 28, hi = b >> 4.
// out = (sum_i x[m,i]*lo[i,n] + x[m,i+K/2]*hi[i,n]) * s[n], both halves in
// ONE f32 accumulator, then one rounding to x's dtype (f32 or bf16). The
// weight is unpacked in registers and never written to memory.
//
// Bound on the H100: at decode (M = 5) the packed bytes, read once (6.3 MB
// for (K,N) = (2048,6144): 1.9 us at 3.35 TB/s); at prefill (M = 640) the
// bf16 operations (16.1 G for that shape: 16.3 us at 989 TFLOP/s).
//
// Two paths behind one entry point; the wrapper plans both:
// * GEMV, for M <= 16 and for f32 x at any M (decode). A block owns a tile
//   of ct = 64 or 128 columns, 8 or 16 rows of x and one K-split of the
//   packed rows; the K-splits of a column tile form one thread block
//   cluster (<= 8 blocks). A block first issues its whole packed slice as
//   16-byte cp.async copies into shared memory (the whole matrix is in
//   flight across the card), in four commit groups, only then stages its
//   slice of x. bf16 x (gemv_mma_kernel) runs the products on the tensor
//   cores, mma.sync m16n8k16 with the weight as A (a thread's four A rows
//   are four adjacent columns: one 32-bit load per packed row gives both
//   nibble halves of two m16 tiles, made bf16 by 0x4300 | nibble and one
//   subtract) and x as B; a group's products start as soon as it lands.
//   f32 x (gemv_f32_kernel) keeps exact f32 products on the CUDA cores, 16
//   columns (one 16-byte chunk) a thread, nibbles made floats by the 2^23
//   magic number. Either way the warps' sums are added in a fixed order in
//   shared memory, then the cluster's blocks merge their partial tiles in
//   split order through distributed shared memory, apply s and round once.
//   No workspace, no atomics: every sum has a fixed order, so a launch
//   repeats bit for bit.
// * mma_kernel, for bf16 x with M > 16 (prefill): out^T = W^T x^T on
//   wgmma, A and B swapped. 128 output columns (two 64-row wgmma tiles) by
//   BT = 64 or 128 tokens a block; one producer warp keeps a 4-stage ring
//   of 64 packed rows fed by TMA (the packed tile and both x halves, at
//   columns i0 and K/2 + i0 of x seen as (M, 2, K/2), each half-box
//   zero-filled past K/2 and M); one consumer warpgroup unpacks each
//   thread's packed bytes straight into bf16 A fragments (as the GEMV
//   does) and issues the lo and hi products into one f32 accumulator per
//   tile, x being the K-major B operand in 128-byte-swizzled shared memory.
//   A step's unpacking overlaps the two previous steps' products, and a
//   stage's slot is released once the next stage's products are under way.
//   The epilogue applies s, rounds once and stores through shared memory,
//   coalesced.

#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// GEMV: M <= 16, or f32 x
// ---------------------------------------------------------------------------

constexpr int kGvThreads = 128;   // threads of a block of the f32 GEMV
constexpr int kGmThreads = 256;   // threads of a block of the tensor-core GEMV
constexpr int kGvChunkRows = 512;  // packed rows a block stages at once
constexpr int kGvGroups = 4;       // cp.async commit groups of a chunk (at most 4)
constexpr int kGvMaxCluster = 8;
constexpr int kGvF32Rows = 8;      // rows of x a block of the f32 kernel
constexpr int kGvXBatch = 16;      // x loads a thread has in flight while staging
constexpr float kMagic = 8388616.f;  // 2^23 + 8

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most `pending` (0..3) of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

struct GemvArgs {
  const void* x;
  const int8_t* q4;
  const float* s;
  void* out;
  int m_len, kh, n_len, ct, slice, vec;
  int xvec;  // x's slices can be copied 16 bytes at a time (x is 16-byte aligned)
};

// Copies packed rows [r_lo, r_hi) of the chunk at qrow (row stride n_len
// bytes, the tile's ct columns) into wsm (row stride wrow bytes).
__device__ __forceinline__ void copy_rows(const GemvArgs& a, const int8_t* qrow, int n0,
                                          int8_t* wsm, int wrow, int r_lo, int r_hi) {
  const int tpr = a.ct / 16;
  for (int c = r_lo * tpr + threadIdx.x; c < r_hi * tpr; c += blockDim.x) {
    const int r = c / tpr;
    const int ch = c % tpr;
    const int col = n0 + ch * 16;
    const int8_t* src = qrow + static_cast<long long>(r) * a.n_len + ch * 16;
    int8_t* dst = wsm + r * wrow + ch * 16;
    if (a.vec) {
      const bool ok = col < a.n_len;
      cp_async16(dst, ok ? src : a.q4, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bool ok = col + 4 * p < a.n_len;
        cp_async4(dst + 4 * p, ok ? src + 4 * p : a.q4, ok ? 4 : 0);
      }
    }
  }
}

// The cluster's K-splits, merged in split order through distributed shared
// memory: each block finishes a share of the rows x ct tile in `part`,
// applies s and rounds once.
template <typename TX>
__device__ __forceinline__ void merge_splits(cg::cluster_group& cluster, float* part, int rows,
                                             const GemvArgs& a, int m0, int n0) {
  const int split = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int ct = a.ct;
  cluster.sync();
  const int threads = blockDim.x;
  for (int e = split * threads + threadIdx.x; e < rows * ct; e += splits * threads) {
    float v[kGvMaxCluster];
#pragma unroll
    for (int r = 0; r < kGvMaxCluster; ++r)
      v[r] = r < splits ? cluster.map_shared_rank(part, r)[e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kGvMaxCluster; ++r)
      if (r < splits) sum += v[r];
    const int m = m0 + e / ct;
    const int n = n0 + e % ct;
    if (m < a.m_len && n < a.n_len)
      store(static_cast<TX*>(a.out) + static_cast<long long>(m) * a.n_len + n, sum * a.s[n]);
  }
  cluster.sync();  // no block leaves while another reads its part
}

// (byte c of p, byte c of q) as the two 16-bit halves of a word.
__device__ __forceinline__ uint32_t pair_bytes(uint32_t p, uint32_t q, int c) {
  return __byte_perm(p, q, c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12));
}

// Two signed nibbles (bits 0-3 of each 16-bit half) as bf16x2:
// bf16(128 + v + 8) from 0x4300 | (v ^ 8), minus 136, exact.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t h) {
  const uint32_t biased = (h & 0x000F000Fu) ^ 0x43084308u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // * 1.0 - 136.0
  return out;
}

// The bf16 A fragments (low and high nibble halves) of two m16 tiles whose
// rows g, g+8 are this thread's columns col + 2 tau + h, from the words of
// packed rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row step (columns col..col+3).
__device__ __forceinline__ void unpack_fragments(uint32_t w0, uint32_t w1, uint32_t w8,
                                                 uint32_t w9, uint32_t (&lo)[2][4],
                                                 uint32_t (&hi)[2][4]) {
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t p01 = pair_bytes(w0, w1, 2 * tau + h);
      const uint32_t p89 = pair_bytes(w8, w9, 2 * tau + h);
      lo[tau][h] = nibbles_bf16x2(p01);
      lo[tau][2 + h] = nibbles_bf16x2(p89);
      hi[tau][h] = nibbles_bf16x2(p01 >> 4);
      hi[tau][2 + h] = nibbles_bf16x2(p89 >> 4);
    }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }

// Both halves of x for `span` rows of the slice from row i0 on, zero past
// M and past `cr` rows, by plain loads: each thread issues kGvXBatch loads
// before it stores any.
template <int kTok>
__device__ __forceinline__ void stage_x_loads(const GemvArgs& a, const __nv_bfloat16* xb,
                                              __nv_bfloat16* xs, int xrow, int span, int cr,
                                              int m0, int i0) {
  const long long k_len = 2LL * a.kh;
  const int threads = blockDim.x;
  for (int e0 = threadIdx.x; e0 < 2 * kTok * span; e0 += threads * kGvXBatch) {
    __nv_bfloat16 v[kGvXBatch];
#pragma unroll
    for (int u = 0; u < kGvXBatch; ++u) {
      const int e = e0 + u * threads;
      const int r = e % span;
      const int row = e / span;  // h * kTok + token
      const int tok = row % kTok;
      v[u] = __float2bfloat16(0.f);
      if (e < 2 * kTok * span && r < cr && m0 + tok < a.m_len)
        v[u] = xb[(m0 + tok) * k_len + (row / kTok) * a.kh + i0 + r];
    }
#pragma unroll
    for (int u = 0; u < kGvXBatch; ++u) {
      const int e = e0 + u * threads;
      if (e < 2 * kTok * span) xs[(e / span) * xrow + e % span] = v[u];
    }
  }
}

// bf16 x: the products on the tensor cores (mma.sync m16n8k16, f32
// accumulators), the weight as A (output columns x k), x as B (k x 8 NT
// tokens, zero past M and past the slice). A warp owns 32 columns (two m16
// tiles, its four A rows per thread four adjacent columns) and every
// (8 / (ct / 32))-th 16-row step: the eight warps are ct / 32 column groups
// by 8 / (ct / 32) row groups. The chunk's copies go out in kGvGroups commit
// groups (x's in the first); the products of a group start as soon as it
// has landed. Shared memory: part[8 NT][ct] f32, packed rows [cap][ct + 16]
// (padded against bank conflicts), x [2][8 NT][cap + 8] bf16, the row
// groups' sums [row groups][8 NT][ct] f32.
template <int NT>
__global__ void __launch_bounds__(kGmThreads) gemv_mma_kernel(const GemvArgs a) {
  constexpr int kTok = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ct = a.ct;
  const int wrow = ct + 16;
  const int col_groups = ct / 32;
  const int row_groups = kGmThreads / 32 / col_groups;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rgi = warp / col_groups;
  const int col = 32 * (warp % col_groups) + 4 * g;
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x * ct;
  const int m0 = blockIdx.z * kTok;
  const int i0 = split * a.slice;
  const int rows = max(0, min(a.slice, a.kh - i0));
  const int cap = min(round16(a.slice), kGvChunkRows);
  const int xrow = cap + 8;
  const long long k_len = 2LL * a.kh;

  float* part = reinterpret_cast<float*>(smem);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + kTok * ct * 4);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(wsm + cap * wrow);
  float* red = reinterpret_cast<float*>(xs + 2 * kTok * xrow);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x);

  float c[2][NT][4];
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[tau][j][e] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += cap) {
    const int cr = min(cap, rows - r0);
    const int steps = (cr + 15) / 16;
    const int per = (steps + kGvGroups - 1) / kGvGroups;  // 16-row steps of a commit group
    // 1. The packed chunk, in kGvGroups commit groups after x's copies.
    const int8_t* qrow = a.q4 + static_cast<long long>(i0 + r0) * a.n_len + n0;
    // 2. Both halves of x for the chunk's steps, zero past M and the slice:
    // 4-byte asynchronous copies in the first commit group where x's rows
    // allow them, else loads, kGvXBatch in flight a thread.
    const int span = steps * 16;
    if (a.xvec) {
      for (int e = tid; e < 2 * kTok * span / 8; e += kGmThreads) {
        const int row = e / (span / 8);  // h * kTok + token
        const int r = 8 * (e % (span / 8));
        const int tok = row % kTok;
        const bool ok = r < cr && m0 + tok < a.m_len;
        const __nv_bfloat16* src =
            ok ? xb + (m0 + tok) * k_len + (row / kTok) * a.kh + i0 + r0 + r : xb;
        cp_async16(xs + row * xrow + r, src, ok ? 16 : 0);
      }
    } else {
      stage_x_loads<kTok>(a, xb, xs, xrow, span, cr, m0, i0 + r0);
    }
#pragma unroll
    for (int q = 0; q < kGvGroups; ++q) {
      copy_rows(a, qrow, n0, wsm, wrow, min(cr, q * per * 16), min(cr, (q + 1) * per * 16));
      cp_async_commit();
    }
    // 3. Each group's steps once it has landed.
#pragma unroll
    for (int q = 0; q < kGvGroups; ++q) {
      cp_async_wait_pending(kGvGroups - 1 - q);
      __syncthreads();
      const int s_hi = min(steps, (q + 1) * per);
      for (int kk = q * per + rgi; kk < s_hi; kk += row_groups) {
        const int r = kk * 16 + 2 * t;
        const int8_t* wp = wsm + r * wrow + col;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + wrow);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wp + 8 * wrow);
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wp + 9 * wrow);
        uint32_t lo[2][4], hi[2][4];
        unpack_fragments(w0, w1, w8, w9, lo, hi);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* xl = xs + (8 * j + g) * xrow + r;
          const __nv_bfloat16* xh = xl + kTok * xrow;
          const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(xl);
          const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(xl + 8);
          const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(xh);
          const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(xh + 8);
#pragma unroll
          for (int tau = 0; tau < 2; ++tau) {
            mma_bf16(c[tau][j], lo[tau], bl0, bl1);
            mma_bf16(c[tau][j], hi[tau], bh0, bh1);
          }
        }
      }
    }
    __syncthreads();  // the chunk's buffers are reused
  }

  // The warps' sums: fragment element (h, u) of tile tau, token tile j is
  // (column col + 2 tau + h, token 8j + 2t + u); row groups add in order.
  float* dst = row_groups == 1 ? part : red + rgi * kTok * ct;
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          dst[(8 * j + 2 * t + u) * ct + col + 2 * tau + h] = c[tau][j][2 * h + u];
  __syncthreads();
  if (row_groups > 1)
    for (int e = tid; e < kTok * ct; e += kGmThreads) {
      float sum = 0.f;
      for (int rg = 0; rg < row_groups; ++rg) sum += red[rg * kTok * ct + e];
      part[e] = sum;
    }
  merge_splits<__nv_bfloat16>(cluster, part, kTok, a, m0, n0);
}

// The signed nibbles at bit `shift` (0: low, 4: high) of w's four bytes as
// floats: offset binary v + 8 in the mantissa of 2^23, minus 2^23 + 8.
__device__ __forceinline__ void nibbles_f32(uint32_t w, int shift, float (&v)[4]) {
  const uint32_t u = ((w >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - kMagic;
}

// f32 x: exact f32 products on the CUDA cores, 16 columns (one 16-byte
// chunk of a packed row) and 8 rows of x a thread. Shared memory: part[8][ct]
// f32, then the chunk's packed bytes [cap][ct] and x halves [cap][8] f32,
// later the row groups' sums [groups][8][ct].
__global__ void __launch_bounds__(kGvThreads) gemv_f32_kernel(const GemvArgs a) {
  constexpr int MR = kGvF32Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ct = a.ct;
  const int tpr = ct / 16;  // threads per packed row
  const int groups = kGvThreads / tpr;
  const int tid = threadIdx.x;
  const int cc = tid % tpr;
  const int rg = tid / tpr;
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x * ct;
  const int m0 = blockIdx.z * MR;
  const int i0 = split * a.slice;
  const int rows = max(0, min(a.slice, a.kh - i0));
  const int cap = min(a.slice, kGvChunkRows);
  const long long k_len = 2LL * a.kh;

  float* part = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + MR * ct * 4;
  int8_t* wsm = reinterpret_cast<int8_t*>(work);
  float* xs_lo = reinterpret_cast<float*>(work + cap * ct);
  float* xs_hi = xs_lo + cap * MR;
  float* red = reinterpret_cast<float*>(work);
  const float* xb = static_cast<const float*>(a.x);

  float acc[MR][16];
#pragma unroll
  for (int mm = 0; mm < MR; ++mm)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[mm][c] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += cap) {
    const int cr = min(cap, rows - r0);
    copy_rows(a, a.q4 + static_cast<long long>(i0 + r0) * a.n_len + n0, n0, wsm, ct, 0, cr);
    cp_async_commit();
    for (int e0 = tid; e0 < cr * MR; e0 += kGvThreads * kGvXBatch) {
      float lo[kGvXBatch], hi[kGvXBatch];
#pragma unroll
      for (int u = 0; u < kGvXBatch; ++u) {
        const int e = e0 + u * kGvThreads;
        const int m = m0 + e / cr;
        lo[u] = hi[u] = 0.f;
        if (e < cr * MR && m < a.m_len) {
          const float* xr = xb + m * k_len + i0 + r0 + e % cr;
          lo[u] = xr[0];
          hi[u] = xr[a.kh];
        }
      }
#pragma unroll
      for (int u = 0; u < kGvXBatch; ++u) {
        const int e = e0 + u * kGvThreads;
        if (e < cr * MR) {
          xs_lo[(e % cr) * MR + e / cr] = lo[u];
          xs_hi[(e % cr) * MR + e / cr] = hi[u];
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int r = rg; r < cr; r += groups) {
      const uint4 w = *reinterpret_cast<const uint4*>(wsm + r * ct + cc * 16);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      float xl[MR], xh[MR];
#pragma unroll
      for (int mm = 0; mm < MR; ++mm) {
        xl[mm] = xs_lo[r * MR + mm];
        xh[mm] = xs_hi[r * MR + mm];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float lo[4], hi[4];
        nibbles_f32(words[q], 0, lo);
        nibbles_f32(words[q], 4, hi);
#pragma unroll
        for (int mm = 0; mm < MR; ++mm)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[mm][4 * q + k] = fmaf(xh[mm], hi[k], fmaf(xl[mm], lo[k], acc[mm][4 * q + k]));
      }
    }
    __syncthreads();  // the chunk's buffers are reused
  }

#pragma unroll
  for (int mm = 0; mm < MR; ++mm)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(red + (rg * MR + mm) * ct + cc * 16 + 4 * q) =
          make_float4(acc[mm][4 * q], acc[mm][4 * q + 1], acc[mm][4 * q + 2], acc[mm][4 * q + 3]);
  __syncthreads();
  for (int e = tid; e < MR * ct; e += kGvThreads) {
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) sum += red[g * MR * ct + e];
    part[e] = sum;
  }
  merge_splits<float>(cluster, part, MR, a, m0, n0);
}

template <typename K>
cudaError_t launch_cluster(K kernel, int threads, const GemvArgs& a, int splits, int tok_rows,
                           int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = hopper::allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (rc != cudaSuccess) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(a.n_len, a.ct), splits, cdiv(a.m_len, tok_rows));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

cudaError_t launch_gemv(int x_dtype, const GemvArgs& a, int splits, cudaStream_t st) {
  if (x_dtype == 0) {
    constexpr int MR = kGvF32Rows;
    const int cap = std::min(a.slice, kGvChunkRows);
    const int work = std::max(cap * (a.ct + 8 * MR), 8192 * MR);  // 8192 * MR: the row groups' sums
    return launch_cluster(gemv_f32_kernel, kGvThreads, a, splits, MR, MR * a.ct * 4 + work, st);
  }
  const int nt = a.m_len > 8 ? 2 : 1;
  const int cap = std::min(round16(a.slice), kGvChunkRows);
  const int tok = 8 * nt;
  const int row_groups = kGmThreads / 32 / (a.ct / 32);
  const int smem = tok * a.ct * 4 + cap * (a.ct + 16) + 2 * tok * (cap + 8) * 2 +
                   (row_groups > 1 ? row_groups * tok * a.ct * 4 : 0);
  return nt == 1 ? launch_cluster(gemv_mma_kernel<1>, kGmThreads, a, splits, tok, smem, st)
                 : launch_cluster(gemv_mma_kernel<2>, kGmThreads, a, splits, tok, smem, st);
}

// ---------------------------------------------------------------------------
// bf16 prefill: TMA ring + wgmma, out^T = W^T x^T
// ---------------------------------------------------------------------------

constexpr int kMmCols = 128;  // output columns a block: two 64-row wgmma tiles
constexpr int kMmK = 64;      // packed rows a stage: 128 bytes of each x half
constexpr int kMmStages = 4;
constexpr int kMmConsumers = 128;  // one warpgroup
constexpr int kMmThreads = kMmConsumers + 32;  // + the producer warp
constexpr int kMmOutRow = kMmCols * 2 + 16;  // padded bf16 staging row, bytes

template <int BT>
struct MmLayout {
  static constexpr int kW = kMmK * kMmCols;  // packed tile, 128-byte rows
  static constexpr int kX = BT * 128;        // one x half: BT rows of 64 bf16
  static constexpr int kStage = kW + 2 * kX;
  static constexpr int kBars = kMmStages * kStage;
  static constexpr int kSmem = kBars + 2 * kMmStages * 8 + 1024;  // + 1024-byte alignment
  static_assert(kStage % 1024 == 0, "stages must keep the 128-byte swizzle's alignment");
  static_assert(BT * kMmOutRow <= kBars, "the output tile is staged in the ring");
};

template <int BT>
__global__ void __launch_bounds__(kMmThreads)
mma_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int m_len, int kh,
           int n_len) {
  using L = MmLayout<BT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kMmStages;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kMmCols;
  const int m0 = blockIdx.y * BT;
  const int k_tiles = (kh + kMmK - 1) / kMmK;

  if (tid == 0) {
    for (int st = 0; st < kMmStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kMmConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kMmConsumers) {
    // Producer: one thread keeps the ring full.
    if (tid == kMmConsumers) {
      hopper::prefetch_tensor_map(&wmap);
      hopper::prefetch_tensor_map(&xmap);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % kMmStages;
        hopper::mbar_wait(&empty[st], ((kt / kMmStages) & 1) ^ 1);
        unsigned char* stage = smem + st * L::kStage;
        hopper::mbar_arrive_expect_tx(&full[st], L::kStage);
        hopper::tma_load_2d(stage, &wmap, &full[st], n0, kt * kMmK);
        hopper::tma_load_3d(stage + L::kW, &xmap, &full[st], kt * kMmK, 0, m0);
        hopper::tma_load_3d(stage + L::kW + L::kX, &xmap, &full[st], kt * kMmK, 1, m0);
      }
    }
    return;
  }

  // Consumer warpgroup. Tile tau's wgmma row 16w + g + 8h is output column
  // col + 2 tau + h: the thread's four rows are its four columns col..col+3.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int col = 32 * warp + 4 * g;
  // Packed rows 16kk + {2t, 2t+1, 2t+8, 2t+9} give the k pairs of the A
  // fragments; a row's swizzle depends on row & 7 only, so the four byte
  // offsets are the same in every 16-row step but for 16 * 128 bytes.
  const int off[4] = {hopper::swz128(2 * t, col), hopper::swz128(2 * t + 1, col),
                      hopper::swz128(2 * t + 8, col), hopper::swz128(2 * t + 9, col)};
  float acc0[BT / 2], acc1[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc0[i] = acc1[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % kMmStages;
    hopper::mbar_wait(&full[st], (kt / kMmStages) & 1);
    const unsigned char* stage = smem + st * L::kStage;
    const uint64_t dlo = hopper::desc_sw128(stage + L::kW);
    const uint64_t dhi = hopper::desc_sw128(stage + L::kW + L::kX);
#pragma unroll
    for (int kk = 0; kk < kMmK / 16; ++kk) {
      // The unpacking overlaps the two previous steps' products, whose A
      // registers are other ones (a step's are reused four steps later).
      const unsigned char* wk = stage + kk * 16 * 128;
      uint32_t lo[2][4], hi[2][4];
      unpack_fragments(*reinterpret_cast<const uint32_t*>(wk + off[0]),
                       *reinterpret_cast<const uint32_t*>(wk + off[1]),
                       *reinterpret_cast<const uint32_t*>(wk + off[2]),
                       *reinterpret_cast<const uint32_t*>(wk + off[3]), lo, hi);
      // At most the previous step's group stays in flight. Once kk = 1 has
      // waited, every group of the previous stage is done and its slot goes
      // back to the producer.
      hopper::wgmma_wait<1>();
      if (kk == 1 && kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % kMmStages]);
      hopper::wgmma_fence();
      hopper::Wgmma<BT>::bf16(acc0, lo[0], dlo + 2 * kk);
      hopper::Wgmma<BT>::bf16(acc1, lo[1], dlo + 2 * kk);
      hopper::Wgmma<BT>::bf16(acc0, hi[0], dhi + 2 * kk);
      hopper::Wgmma<BT>::bf16(acc1, hi[1], dhi + 2 * kk);
      hopper::wgmma_commit();
    }
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    hopper::fence_operand(acc0[i]);
    hopper::fence_operand(acc1[i]);
  }

  // Epilogue: acc * s[n], one rounding, staged in the ring for coalesced stores.
  float sc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) sc[c] = n0 + col + c < n_len ? s[n0 + col + c] : 0.f;
  hopper::named_barrier_sync(1, kMmConsumers);  // every consumer is done with the ring
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int tok = 8 * j + 2 * t + u;
      const __nv_bfloat162 v01 =
          __floats2bfloat162_rn(acc0[4 * j + u] * sc[0], acc0[4 * j + 2 + u] * sc[1]);
      const __nv_bfloat162 v23 =
          __floats2bfloat162_rn(acc1[4 * j + u] * sc[2], acc1[4 * j + 2 + u] * sc[3]);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&v01);
      v.y = *reinterpret_cast<const uint32_t*>(&v23);
      *reinterpret_cast<uint2*>(smem + tok * kMmOutRow + col * 2) = v;
    }
  hopper::named_barrier_sync(1, kMmConsumers);
  for (int c = tid; c < BT * 16; c += kMmConsumers) {
    const int row = c / 16;
    const int m = m0 + row;
    const int n = n0 + (c % 16) * 8;
    if (m < m_len && n < n_len)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * n_len + n) =
          *reinterpret_cast<const uint4*>(smem + row * kMmOutRow + (c % 16) * 16);
  }
}

template <int BT>
cudaError_t launch_mma(const void* x, const void* q4, const float* s, void* out, int m, int kh,
                       int n, cudaStream_t st) {
  using L = MmLayout<BT>;
  CUtensorMap wmap, xmap;
  // q4 (kh, N) bytes: boxes of 64 packed rows x 128 columns.
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(kh)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(n)};
  const cuuint32_t wbox[2] = {kMmCols, kMmK};
  // x (M, K) bf16 seen as (M, 2, kh): a box is 64 columns of one half of BT rows.
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(kh), 2, static_cast<cuuint64_t>(m)};
  const cuuint64_t xstrides[2] = {static_cast<cuuint64_t>(kh) * 2,
                                  static_cast<cuuint64_t>(kh) * 4};
  const cuuint32_t xbox[3] = {kMmK, 1, BT};
  if (!hopper::encode_sw128(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q4, wdims, wstrides, wbox) ||
      !hopper::encode_sw128(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, xdims, xstrides, xbox))
    return cudaErrorInvalidValue;
  const cudaError_t rc =
      hopper::allow_smem(reinterpret_cast<const void*>(mma_kernel<BT>), L::kSmem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(cdiv(n, kMmCols), cdiv(m, BT));
  mma_kernel<BT><<<grid, kMmThreads, L::kSmem, st>>>(wmap, xmap, s,
                                                     static_cast<__nv_bfloat16*>(out), m, kh, n);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (M, 2*kh) and out (M,N) in x_dtype (0 = float32, 1 = bfloat16), q4
// (kh,N) int8, s (N,) f32, all contiguous, x and q4 16-byte aligned;
// N % 4 == 0. The plan comes from the wrapper (ops/cuda/int4_matmul.py):
// bt = 64 or 128 takes the wgmma path (bf16 x, kh % 8 == 0, N % 16 == 0)
// with blocks of bt tokens by 128 columns; bt = 0 the GEMV
// with column tile ct (64 or 128), `cluster` K-splits (1-8) of `slice`
// packed rows, every split non-empty. Launches on `device`, restoring the
// caller's current device. Returns the launch's cudaError_t.
extern "C" int rho_int4_matmul(const void* x, const void* q4, const void* s, void* out,
                               int x_dtype, int m, int kh, int n, int bt, int ct, int cluster,
                               int slice, int device, void* stream) {
  if (m <= 0 || kh <= 0 || n <= 0 || n % 4 != 0 || (x_dtype != 0 && x_dtype != 1) ||
      !aligned16(x) || !aligned16(q4))
    return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  if (bt != 0) {
    if (x_dtype != 1 || kh % 8 != 0 || n % 16 != 0) return cudaErrorInvalidValue;
    if (bt == 64) return launch_mma<64>(x, q4, sc, out, m, kh, n, st);
    if (bt == 128) return launch_mma<128>(x, q4, sc, out, m, kh, n, st);
    return cudaErrorInvalidValue;
  }
  if ((ct != 64 && ct != 128) || cluster < 1 || cluster > kGvMaxCluster || slice <= 0 ||
      static_cast<long long>(cluster - 1) * slice >= kh ||
      static_cast<long long>(cluster) * slice < kh)
    return cudaErrorInvalidValue;
  const GemvArgs a{x, static_cast<const int8_t*>(q4), sc, out, m, kh, n, ct, slice,
                   n % 16 == 0 ? 1 : 0,
                   kh % 16 == 0 && slice % 16 == 0};
  return launch_gemv(x_dtype, a, cluster, st);
}
