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
// Bound on the H100 at the Qwen cells' shape (B=8, S=448, Hkv=8, G=2,
// D=128, bf16 cache): the bytes of the valid K and V, ~280 keys a row:
// 2*8*280*8*128*2 B ~ 9.2 MB a layer, ~2.7 us at 3.35 TB/s; the products
// are ~9 MFLOP. What holds a launch far above that is latency: the DRAM
// round trips each block waits for one after another, and the merge of the
// blocks' partial softmax states.
//
// Design: each (row, KV head) is one thread block cluster of C blocks
// (C in {1, 2, 4, 8}: the wrapper's plan_clusters, about two blocks an SM
// and, for short blocks, no more than fit on the card at once; the
// registers are capped so that the Qwen cells' 512 blocks do). The grid is
// (C, Hkv, B); block r of a cluster owns the keys [r*S/C, (r+1)*S/C) and the
// G = Hq/Hkv queries of its head. A block of four warps:
//   1. Reads q and its range's mask bytes: within a decode step the mask was
//      just written, so this is an L2 hit. (Issuing the first tile's K/V
//      before the mask, masked keys and all, was measured slower at every
//      cell's shape on an H100: those reads cost more bandwidth than the
//      round trip they hide.)
//   2. Issues its tiles of 32 keys as 16-byte cp.async copies into a ring
//      in shared memory (up to 64 KB of tiles in flight), reading only the
//      valid keys: masked keys are zero-filled without a read, a tile with
//      no valid key is neither copied nor computed.
//   3. Walks its tiles with an online softmax (f32). In the scores a warp
//      dots a quarter of the head dimension of every key of the tile with
//      q, a key a lane (the 16-byte pieces of a row are permuted by key, so
//      the lanes' loads hit distinct banks; no shuffles), and the quarters
//      are added in order; a warp a query takes the tile's max, exp and
//      sum, a key a lane; in P.V a thread accumulates 8 dimensions over the
//      keys of its key group (16-byte loads). The next tile is issued as
//      soon as the stage of the previous one is free.
//   4. Sums the key groups in order, then stores its state (m, l and its
//      acc at the outputs another block finishes) straight into that
//      block's shared memory through distributed shared memory. One cluster
//      barrier; then each block finishes its share of the G*D outputs from
//      its own memory alone: every rank's state in rank order, max,
//      rescaled sums in that fixed order, division by max(l, 1e-30). No
//      global workspace, ticket, atomic or fence, and no second barrier (no
//      block reads another's memory): the same inputs give the same bits on
//      every launch.
// A row with no valid key at all is known after the cluster barrier (no
// block saw one): then every block sums V over its keys (the -1e30 fill
// gives every key the weight exp(0) = 1), stores that state, one more
// cluster barrier, and the same merge. Every other launch pays no barrier
// before its loads.
// C = 1 launches no cluster: the block finishes alone. Inputs whose K/V rows
// are not 16-byte aligned take the same path with scalar loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"  // DeviceGuard, allow_smem

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;            // query heads per KV head
constexpr int kMaxD = 128;          // head dimension
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kTile = 32;           // keys a tile: a key a lane
constexpr int kRingBytes = 64 * 1024;  // K/V tiles in flight a block, at most
constexpr int kMaxStages = 8;
constexpr int kMaskPass = 4;        // mask bytes a thread loads at once
constexpr int kMaxBlockKeys = 65536;  // mask bytes a block holds
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most n of this thread's copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  void* o;
  int q_f32;  // q and o: float32, else bfloat16
  int s_len, d_len, group, stages, ring_bytes, vec;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, m_sb;
  float scale;
};

// The tile layout of one KV storage type and head-dimension bound kD: in
// the scores a warp takes kD / 4 dimensions of every key of a tile, a key a
// lane; in P.V a thread takes 8 dimensions of the keys of its key group.
template <typename TKV, int kD>
struct Shape {
  static constexpr int kCh = 16 / static_cast<int>(sizeof(TKV));  // values a 16-byte copy
  static constexpr int kCpr = kD / kCh;                            // copies a key row
  static constexpr int kCpw = kCpr / kWarps;                       // copies a warp scores
  static constexpr int kSwz = (kCpr < 8 ? kCpr : 8) - 1;           // copy index ^ (row & kSwz)
  static constexpr int kVt = kD / 8;                               // threads a key row in P.V
  static constexpr int kKg = kThreads / kVt;                       // key groups of P.V
  static constexpr int kStageElems = kTile * kD;                   // K (or V) of a tile
  static constexpr int kStageBytes = 2 * kStageElems * static_cast<int>(sizeof(TKV));
  static constexpr int kStages =
      kRingBytes / kStageBytes < kMaxStages ? kRingBytes / kStageBytes : kMaxStages;
  static_assert(kTile == 32 && kCpw >= 1 && kVt <= 32 && kTile % kKg == 0 && kStages >= 2,
                "layout");
};

// Where 16-byte copy p of key row j lies in a stage: the copies of a row
// are permuted by j, so that 32 lanes reading copy p of 32 rows (the
// scores) or 16 threads reading the copies of one row (P.V) hit distinct
// shared-memory banks.
template <typename TKV, int kD>
__device__ __forceinline__ int slot(int j, int p) {
  using Sh = Shape<TKV, kD>;
  return j * kD + (p ^ (j & Sh::kSwz)) * Sh::kCh;
}

// The key groups' sums of P.V, [kKg][kG][kD] f32, in the ring's place once
// the walk is over.
template <int kG>
constexpr int red_bytes() { return kThreads * 8 * kG * 4; }

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float (&x)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(e[i]);
}

// One 16-byte copy's values in f32.
__device__ __forceinline__ void load_copy(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load_copy(const __nv_bfloat16* p, float (&x)[8]) { load8(p, x); }
__device__ __forceinline__ void load_copy(const __nv_fp8_e4m3* p, float (&x)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(e[i]);
}

// Dimensions d0 .. d0 + 7 (d0 a multiple of 8) of key row j of a stage.
template <typename TKV, int kD>
__device__ __forceinline__ void load_dims(const TKV* tile, int j, int d0, float (&x)[8]) {
  constexpr int kCh = Shape<TKV, kD>::kCh;
  if constexpr (kCh >= 8) {
    load8(tile + slot<TKV, kD>(j, d0 / kCh) + d0 % kCh, x);
  } else {
    float lo[4], hi[4];
    load_copy(tile + slot<TKV, kD>(j, d0 / kCh), lo);
    load_copy(tile + slot<TKV, kD>(j, d0 / kCh + 1), hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = lo[e];
      x[4 + e] = hi[e];
    }
  }
}

__device__ __forceinline__ float load_q(const DecodeArgs& a, long long i) {
  return a.q_f32 ? static_cast<const float*>(a.q)[i]
                 : __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i]);
}

__device__ __forceinline__ void store_o(const DecodeArgs& a, long long i, float x) {
  if (a.q_f32)
    static_cast<float*>(a.o)[i] = x;
  else
    static_cast<__nv_bfloat16*>(a.o)[i] = __float2bfloat16(x);
}

// Blocks an SM holds at once, by group: at G <= 2 the 512 blocks of the
// Qwen cells' clusters of 8 (64 pairs of row and KV head) all fit on 132
// SMs, so no cluster waits for another to leave (registers <= 96).
constexpr int min_blocks(int g) { return g <= 2 ? 5 : g <= 4 ? 4 : 2; }

// kG: the group size rounded up to 1, 2, 4 or 8, so that the loops over the
// queries unroll fully; kD: the head dimension's bound, 64 or 128.
template <typename TKV, int kG, int kD>
__global__ void __launch_bounds__(kThreads, min_blocks(kG))
    split_decode_kernel(const DecodeArgs a) {
  using Sh = Shape<TKV, kD>;
  constexpr int kCh = Sh::kCh;
  constexpr int kCpr = Sh::kCpr;
  constexpr int kVt = Sh::kVt;
  constexpr int kKg = Sh::kKg;
  constexpr int kGpw = (kG + kWarps - 1) / kWarps;  // queries a warp's softmax takes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float qs[kG][kD];
  __shared__ float sp[kWarps][kG][kTile];  // a tile's scores, a warp's dimensions each
  __shared__ float ps[kG][kTile];  // a tile's probabilities
  __shared__ float alpha_s[kG];    // a tile's rescale of the running sums
  __shared__ float st_m[kG];       // the block's m and l
  __shared__ float st_l[kG];
  // What every rank of the cluster stored here: its m, l, whether it saw a
  // valid key, and its acc at the outputs this block finishes.
  __shared__ float rx_m[kMaxCluster][kG];
  __shared__ float rx_l[kMaxCluster][kG];
  __shared__ int rx_any[kMaxCluster];
  __shared__ __align__(16) float rx_acc[kG * kD + kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;
  const int n_blocks = gridDim.x;  // the cluster (C = 1: a block alone)
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = tid % kVt;   // the thread's 8 dimensions: c*8 ..
  const int kg = tid / kVt;  // its key group in P.V
  const int group = a.group;
  const int d_len = a.d_len;
  const int stages = a.stages;
  const int lo = static_cast<int>(static_cast<long long>(rank) * a.s_len / n_blocks);
  const int n = static_cast<int>(static_cast<long long>(rank + 1) * a.s_len / n_blocks) - lo;
  const int tiles = (n + kTile - 1) / kTile;
  const int max_keys = (a.s_len + n_blocks - 1) / n_blocks;
  TKV* ring = reinterpret_cast<TKV*>(smem);    // [stages][K, V][kTile][kD]
  float* red = reinterpret_cast<float*>(smem);  // after the walk: [kKg][kG][kD]
  uint8_t* ms = smem + a.ring_bytes;            // [n] the block's mask
  uint8_t* tile_any = ms + round16(max_keys);   // [tiles]
  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + hk * a.k_sh + lo * a.k_ss;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + hk * a.v_sh + lo * a.v_ss;
  const uint8_t* mb = a.mask + b * a.m_sb + lo;

  // Copies the valid keys of tile t, K and V, into its stage as one copy
  // group (the masked keys, the keys past the block and the dimensions past
  // d_len are zero-filled without a read).
  auto issue = [&](int t) {
    TKV* ks = ring + (t % stages) * 2 * Sh::kStageElems;
    const int t0 = t * kTile;
    const int nt = min(kTile, n - t0);
    for (int part = 0; part < 2; ++part) {
      TKV* dst = ks + part * Sh::kStageElems;
      const TKV* base = part ? vb : kb;
      const long long ss = part ? a.v_ss : a.k_ss;
      if (a.vec) {
        for (int i = tid; i < kTile * kCpr; i += kThreads) {
          const int j = i / kCpr;
          const int p = i % kCpr;
          const bool need = j < nt && p * kCh < d_len && ms[t0 + j];
          cp_async16(dst + slot<TKV, kD>(j, p), need ? base + (t0 + j) * ss + p * kCh : base,
                     need ? 16 : 0);
        }
      } else {
        for (int i = tid; i < kTile * kD; i += kThreads) {
          const int j = i / kD;
          const int d = i % kD;
          const bool need = j < nt && d < d_len && ms[t0 + j];
          dst[slot<TKV, kD>(j, d / kCh) + d % kCh] = need ? base[(t0 + j) * ss + d] : zero<TKV>();
        }
      }
    }
    cp_async_commit();
  };

  // 1. q and the block's mask bytes (within a step the mask was just
  // written: an L2 hit).
  const long long q0 = b * a.q_sb + hk * group * a.q_sh + tid;
  float qv[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) qv[g] = g < group && tid < d_len ? load_q(a, q0 + g * a.q_sh) : 0.f;
  for (int j0 = 0; j0 < n; j0 += kMaskPass * kThreads) {
    uint8_t mv[kMaskPass];
#pragma unroll
    for (int u = 0; u < kMaskPass; ++u) {
      const int j = j0 + u * kThreads + tid;
      mv[u] = j < n ? mb[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kMaskPass; ++u) {
      const int j = j0 + u * kThreads + tid;
      if (j < n) ms[j] = mv[u] != 0;
    }
  }
  if (tid < kD) {
#pragma unroll
    for (int g = 0; g < kG; ++g) qs[g][tid] = qv[g];
  }
  __syncthreads();

  // 2. Which tiles hold a valid key; then the ring's first tiles, valid
  // keys only. Tile t's copies are copy group t.
  int any = 0;
  for (int t = warp; t < tiles; t += kWarps) {
    const int j = t * kTile + lane;
    const bool tile_has = __any_sync(0xffffffffu, j < n && ms[j]);
    if (lane == 0) tile_any[t] = tile_has;
    any |= tile_has;
  }
  const bool block_any = __syncthreads_or(any);
  int next = 0;
  for (; next < min(stages, tiles); ++next) {
    if (tile_any[next]) {
      issue(next);
    } else {
      cp_async_commit();
    }
  }
  // 3. The tiles, with an online softmax.
  float acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  float m_run[kGpw], l_run[kGpw];
#pragma unroll
  for (int i = 0; i < kGpw; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait(next - t - 1);  // tile t's copies are done
    __syncthreads();              // ... for every thread; tile t - 1 is consumed
    if (t >= 1 && next < tiles) {  // refill the stage of tile t - 1
      if (tile_any[next]) {
        issue(next);
      } else {
        cp_async_commit();
      }
      ++next;
    }
    if (!tile_any[t]) continue;  // the same for every thread
    const TKV* ks = ring + (t % stages) * 2 * Sh::kStageElems;
    const TKV* vs = ks + Sh::kStageElems;
    const uint8_t* mt = ms + t * kTile;
    const int nt = min(kTile, n - t * kTile);

    // Scores, f32: warp w dots dimensions [w*kD/4, (w+1)*kD/4) of key
    // `lane` with q (the keys past the tile are zeros).
    {
      float part[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) part[g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < Sh::kCpw; ++cc) {
        const int p = warp * Sh::kCpw + cc;
        float kf[kCh];
        load_copy(ks + slot<TKV, kD>(lane, p), kf);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (g >= group) continue;
#pragma unroll
          for (int e4 = 0; e4 < kCh / 4; ++e4) {
            const float4 qv = reinterpret_cast<const float4*>(&qs[g][p * kCh])[e4];
            part[g] = fmaf(qv.x, kf[4 * e4], part[g]);
            part[g] = fmaf(qv.y, kf[4 * e4 + 1], part[g]);
            part[g] = fmaf(qv.z, kf[4 * e4 + 2], part[g]);
            part[g] = fmaf(qv.w, kf[4 * e4 + 3], part[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) sp[warp][g][lane] = part[g];
    }
    __syncthreads();

    // The tile's max, exp and sum per query: a warp a query, a key a lane;
    // masked keys are selected away.
#pragma unroll
    for (int i = 0; i < kGpw; ++i) {
      const int g = warp + i * kWarps;
      if (g >= group) break;
      const bool valid = lane < nt && mt[lane];
      const float sc =
          valid ? (sp[0][g][lane] + sp[1][g][lane] + sp[2][g][lane] + sp[3][g][lane]) * a.scale
                : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);  // finite: the tile has a valid key
      const float e = valid ? expf(sc - m_new) : 0.f;
      const float al = expf(m_run[i] - m_new);  // 0 while the block has seen nothing
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * al + sum;
      m_run[i] = m_new;
      ps[g][lane] = e;
      if (lane == 0) alpha_s[g] = al;
    }
    __syncthreads();

    // P.V: 8 dimensions a thread, every query, the keys of its key group.
    // A masked key's V was zero-filled and its probability is 0.
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= group) continue;
      const float al = alpha_s[g];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= al;
    }
#pragma unroll
    for (int i = 0; i < kTile / kKg; ++i) {
      const int j = kg + i * kKg;
      if (j >= nt) break;
      float vv[8];
      load_dims<TKV, kD>(vs, j, c * 8, vv);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= group) continue;
        const float p = ps[g][j];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
  }

  // 4. The block's state: acc summed over the key groups in order (in the
  // ring's place), stored with m, l and whether the block saw a valid key
  // into the shared memory of the rank that finishes each output: output
  // i = g * kD + d belongs to rank i % C, at slot i / C. Then one cluster
  // barrier, after which every block reads only its own memory.
  constexpr int kE = kG * kD;
  const int per = (kE + n_blocks - 1) / n_blocks;  // outputs a rank finishes
  auto send = [&](const float (&x)[kG][8]) {
    float* r = red + kg * kE + c * 8;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      reinterpret_cast<float4*>(r + g * kD)[0] = make_float4(x[g][0], x[g][1], x[g][2], x[g][3]);
      reinterpret_cast<float4*>(r + g * kD)[1] = make_float4(x[g][4], x[g][5], x[g][6], x[g][7]);
    }
    __syncthreads();  // red written; st_m and st_l too
    for (int i = tid; i < kE; i += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kKg; ++q) sum += red[q * kE + i];
      const int owner = i % n_blocks;
      float* dst = n_blocks > 1 ? cluster.map_shared_rank(&rx_acc[0], owner) : &rx_acc[0];
      dst[rank * per + i / n_blocks] = sum;
    }
    if (tid < n_blocks * kG) {
      const int owner = tid / kG;
      const int g = tid % kG;
      float* dm = n_blocks > 1 ? cluster.map_shared_rank(&rx_m[0][0], owner) : &rx_m[0][0];
      float* dl = n_blocks > 1 ? cluster.map_shared_rank(&rx_l[0][0], owner) : &rx_l[0][0];
      dm[rank * kG + g] = st_m[g];
      dl[rank * kG + g] = st_l[g];
    }
    if (n_blocks > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  cp_async_wait(0);
  __syncthreads();  // the ring is consumed
#pragma unroll
  for (int i = 0; i < kGpw; ++i) {
    const int g = warp + i * kWarps;
    if (g < kG && lane == 0) {
      st_m[g] = m_run[i];
      st_l[g] = l_run[i];
    }
  }
  if (tid < n_blocks) {
    int* dst = n_blocks > 1 ? cluster.map_shared_rank(&rx_any[0], tid) : &rx_any[0];
    dst[rank] = block_any;
  }
  send(acc);

  bool row_any = false;
  for (int r = 0; r < n_blocks; ++r) row_any |= rx_any[r] != 0;
  if (!row_any) {
    // No block saw a valid key: every key weighs exp(-1e30 - (-1e30)) = 1.
    // Every block takes this path, and nothing stored above is read before
    // it is stored again.
    float sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] = 0.f;
    for (int j = kg; j < n; j += kKg)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c * 8 + e < d_len) sum[e] += to_f32(vb[j * a.v_ss + c * 8 + e]);
    float x[kG][8];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) x[g][e] = sum[e];
    if (tid < kG) {
      st_m[tid] = kMaskFill;
      st_l[tid] = static_cast<float>(n);
    }
    send(x);
  }

  // 5. The merge: this block's outputs, every rank's state in rank order.
  for (int slot = tid; slot < per; slot += kThreads) {
    const int i = slot * n_blocks + rank;
    const int g = i / kD;
    const int d = i % kD;
    if (i >= kE || g >= group || d >= d_len) continue;
    float m[kMaxCluster], l[kMaxCluster], x[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const bool in = r < n_blocks;
      m[r] = in ? rx_m[r][g] : -INFINITY;
      l[r] = in ? rx_l[r][g] : 0.f;
      x[r] = in ? rx_acc[r * per + slot] : 0.f;
      mx = fmaxf(mx, m[r]);
    }
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (m[r] == -INFINITY) continue;  // a block with no valid key (or past the cluster)
      const float w = expf(m[r] - mx);
      den += l[r] * w;
      num += x[r] * w;
    }
    store_o(a, b * a.o_sb + (hk * group + g) * a.o_sh + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename TKV>
bool rows_aligned(const DecodeArgs& a) {
  constexpr long long ch = 16 / sizeof(TKV);
  return reinterpret_cast<uintptr_t>(a.k) % 16 == 0 && reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
         a.d_len % ch == 0 && a.k_sb % ch == 0 && a.k_ss % ch == 0 && a.k_sh % ch == 0 &&
         a.v_sb % ch == 0 && a.v_ss % ch == 0 && a.v_sh % ch == 0;
}

// The ring, the shared memory and the launch configuration of a grid of
// `clusters` x hkv x b blocks over S keys; `attr` holds the cluster shape.
template <typename TKV, int kG, int kD>
cudaLaunchConfig_t configure(DecodeArgs& a, int b, int hkv, int clusters, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  using Sh = Shape<TKV, kD>;
  const int max_keys = (a.s_len + clusters - 1) / clusters;
  const int tiles = (max_keys + kTile - 1) / kTile;
  a.stages = tiles < Sh::kStages ? tiles : Sh::kStages;
  a.ring_bytes = a.stages * Sh::kStageBytes > red_bytes<kG>() ? a.stages * Sh::kStageBytes
                                                                : red_bytes<kG>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, hkv, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.ring_bytes + round16(max_keys) + round16(tiles);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clusters > 1 ? 1 : 0;  // one block: no cluster
  return cfg;
}

template <typename TKV, int kG, int kD>
cudaError_t prepare(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return hopper::allow_smem(reinterpret_cast<const void*>(split_decode_kernel<TKV, kG, kD>), smem);
}

struct Launch {
  DecodeArgs a;
  int b, hkv, clusters;
  cudaStream_t stream;
  template <typename TKV, int kG, int kD>
  int run() const {
    DecodeArgs args = a;
    args.vec = rows_aligned<TKV>(args);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = configure<TKV, kG, kD>(args, b, hkv, clusters, stream, attr);
    cudaError_t rc = prepare<TKV, kG, kD>(static_cast<int>(cfg.dynamicSmemBytes));
    if (rc != cudaSuccess) return rc;
    rc = cudaLaunchKernelEx(&cfg, split_decode_kernel<TKV, kG, kD>, args);
    if (rc != cudaSuccess) return rc;
    return cudaGetLastError();
  }
};

// How many clusters of this shape fit on the device at once.
struct Fit {
  DecodeArgs a;
  int clusters;
  template <typename TKV, int kG, int kD>
  int run() const {
    DecodeArgs args = a;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = configure<TKV, kG, kD>(args, 1, 1, clusters, nullptr, attr);
    if (prepare<TKV, kG, kD>(static_cast<int>(cfg.dynamicSmemBytes)) != cudaSuccess) return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, split_decode_kernel<TKV, kG, kD>, &cfg) != cudaSuccess)
      return -1;
    return n;
  }
};

// f.run<TKV, kG, kD>() for a KV storage type, group and head dimension.
template <typename TKV, int kG, typename F>
int visit_d(int d, const F& f) {
  return d <= 64 ? f.template run<TKV, kG, 64>() : f.template run<TKV, kG, kMaxD>();
}

template <typename TKV, typename F>
int visit_g(int group, int d, const F& f) {
  if (group <= 1) return visit_d<TKV, 1>(d, f);
  if (group <= 2) return visit_d<TKV, 2>(d, f);
  if (group <= 4) return visit_d<TKV, 4>(d, f);
  return visit_d<TKV, kMaxG>(d, f);
}

template <typename F>
int visit(int kv_dtype, int group, int d, const F& f) {
  switch (kv_dtype) {
    case 0: return visit_g<float>(group, d, f);
    case 1: return visit_g<__nv_bfloat16>(group, d, f);
    case 2: return visit_g<__nv_fp8_e4m3>(group, d, f);
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(int s, int hq, int hkv, int d, int clusters) {
  return s > 0 && hkv > 0 && hq % hkv == 0 && hq / hkv <= kMaxG && d > 0 && d <= kMaxD &&
         clusters >= 1 && clusters <= kMaxCluster && clusters <= s &&
         (s + clusters - 1) / clusters <= kMaxBlockKeys;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q and o share it).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = float8 e4m3.
// strides (in elements): q_sb q_sh  k_sb k_ss k_sh  v_sb v_ss v_sh  o_sb o_sh
// mask_sb; the head dimension and the mask's key dimension are contiguous.
// clusters: the blocks of one (row, KV head), 1 to 8 and at most S, each
// holding at most 65,536 keys. scale multiplies the scores; 0 means
// 1 / sqrt(d). Launches on `device`, restoring the caller's current device.
// Returns the cudaError_t of the launch.
extern "C" int rho_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* o, int q_dtype, int kv_dtype, int b,
                                    int s, int hq, int hkv, int d, int clusters,
                                    const long long* st, float scale, int device, void* stream) {
  if (b <= 0 || !shape_ok(s, hq, hkv, d, clusters) || q_dtype < 0 || q_dtype > 1)
    return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  const DecodeArgs a{q, k, v, static_cast<const uint8_t*>(mask), o, q_dtype == 0,
                     s, d, hq / hkv, 0, 0, 0,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
                     scale > 0.f ? scale : 1.f / sqrtf(static_cast<float>(d))};
  return visit(kv_dtype, a.group, d, Launch{a, b, hkv, clusters, static_cast<cudaStream_t>(stream)});
}

// The most clusters of `clusters` blocks over S keys that fit on `device`
// at once (cudaOccupancyMaxActiveClusters), or -1 if they cannot launch.
extern "C" int rho_decode_clusters(int kv_dtype, int s, int hq, int hkv, int d, int clusters,
                                   int device) {
  if (!shape_ok(s, hq, hkv, d, clusters) || clusters < 2 || kv_dtype < 0 || kv_dtype > 2)
    return -1;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return -1;
  DecodeArgs a = {};
  a.s_len = s;
  a.d_len = d;
  a.group = hq / hkv;
  return visit(kv_dtype, a.group, d, Fit{a, clusters});
}
