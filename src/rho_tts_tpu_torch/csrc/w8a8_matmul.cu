// w8a8 matmul with a fused rescale epilogue for Hopper (sm_90a), bound
// through a plain C interface (ops/cuda/w8a8_matmul.py loads it with ctypes).
//
// Replaces: rho_tts_tpu/ops/pallas/w8a8_matmul.py w8a8_matmul_kernel
// (_kernel). Same function: int8 activations xq (M,K) times int8 weights
// q (K,N), both row-major, with an exact int32 accumulation; then
// out = (float(acc) * sx[m]) * ws[n] in f32, in that order, rounded once to
// the output dtype (f32 or bf16). The integer sum is exact and the two f32
// multiplies are the plain version's, so the result is bit-identical to
// reference_w8a8_matmul.
//
// Bound on the H100 at the prefill shapes (M = 640; K,N up to 2048,6144):
// the operations. 2*M*K*N = 16.1 G int8 ops for (2048,6144) take 8.1 us at
// 1979 TOP/s; its 21.8 MB of bytes take 6.5 us at 3.35 TB/s.
//
// wgmma_kernel (N % 16 == 0, the model's shapes): out^T = q^T xq^T on s8
// wgmma (m64nBTk32, s32 accumulators), A and B swapped. For 8-bit inputs
// wgmma reads shared-memory operands K-major only, and q is N-major (its
// layout is the JAX package's, which checkpoints and the int8 decode path
// keep), so the transpose stays in the kernel: q is wgmma's A from
// registers. A block owns 128 output columns (two 64-row tiles) by BT = 64
// or 128 tokens; one producer warp keeps a 4-stage ring fed by TMA (a
// 128 k x 128 n tile of q, a BT x 128 k tile of xq, both 128-byte swizzled
// and zero-filled past K, N and M); one consumer warpgroup gathers each A
// register's four k-consecutive bytes with __byte_perm from four 32-bit
// shared loads (a 4x4 byte transpose) and issues the products, xq being
// the K-major B operand read by wgmma from shared memory; a stage's
// products all finish before its slot goes back to the producer (waiting
// per step instead measured slower). Output column
// rho of a tile is mapped so that a thread's four A rows are four adjacent
// columns of q. The epilogue applies the plain version's two multiplies,
// rounds once and stores through shared memory, coalesced.
//
// mma_kernel (any N % 4 == 0 that TMA cannot take): 64x64 output tiles of
// four warps, each a 32x32 sub-tile of mma.sync.m16n8k32 s8 products; each
// K step of 64 stages the A tile row-major and the B tile transposed (the
// 4x4 byte blocks by __byte_perm) in padded shared rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;              // bytes of K per stage
constexpr int kRow = kBK + 16;       // padded shared row, bytes
constexpr int kThreads = 128;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ q, const float* __restrict__ ws, TO* __restrict__ out,
            int m_len, int k_len, int n_len) {
  __shared__ __align__(16) uint8_t as[kBM * kRow];
  __shared__ __align__(16) uint8_t bs[kBN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // groupID of the mma fragment layouts
  const int t = lane % 4;  // thread in group
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < k_len; k0 += kBK) {
    // A: 64 rows x 64 bytes as 16-byte chunks, two per thread.
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = tid + p * kThreads;
      const int row = c / 4;
      const int col = (c % 4) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < m_len && k0 + col < k_len)
        v = *reinterpret_cast<const uint4*>(xq + static_cast<long long>(m0 + row) * k_len + k0 + col);
      *reinterpret_cast<uint4*>(as + row * kRow + col) = v;
    }
    // B: 64 k x 64 n bytes as 4x4 byte blocks, two per thread, transposed
    // into bs[n][k].
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int blk = tid + p * kThreads;
      const int kb = (blk / 16) * 4;
      const int nb = (blk % 16) * 4;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + kb + i;
        r[i] = (k < k_len && n0 + nb < n_len)
                   ? *reinterpret_cast<const uint32_t*>(q + static_cast<long long>(k) * n_len + n0 + nb)
                   : 0u;
      }
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      *reinterpret_cast<uint32_t*>(bs + (nb + 0) * kRow + kb) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(bs + (nb + 1) * kRow + kb) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(bs + (nb + 2) * kRow + kb) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(bs + (nb + 3) * kRow + kb) = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* base = as + (wm * 32 + i * 16 + g) * kRow + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(base);
        af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* base = bs + (wn * 32 + j * 8 + g) * kRow + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // Epilogue: (float(acc) * sx[m]) * ws[n], one rounding to the output type.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + h * 8;
      if (m >= m_len) continue;
      const float sm = sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + t * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= n_len) continue;
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), sm), ws[n + e]);
          store(out + static_cast<long long>(m) * n_len + n + e, v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// TMA ring + s8 wgmma, out^T = q^T xq^T
// ---------------------------------------------------------------------------

constexpr int kWgCols = 128;  // output columns a block: two 64-row wgmma tiles
constexpr int kWgK = 128;     // bytes of K a stage
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 128;
constexpr int kWgThreads = kWgConsumers + 32;

template <int BT, typename TO>
struct WgLayout {
  static constexpr int kW = kWgK * kWgCols;  // q tile: 128 k rows of 128 n bytes
  static constexpr int kX = BT * kWgK;       // xq tile: BT rows of 128 k bytes
  static constexpr int kStage = kW + kX;
  static constexpr int kBars = kWgStages * kStage;
  static constexpr int kSmem = kBars + 2 * kWgStages * 8 + 1024;
  static constexpr int kOutRow = kWgCols * static_cast<int>(sizeof(TO)) + 16;  // padded
  static_assert(kStage % 1024 == 0, "stages must keep the 128-byte swizzle's alignment");
  static_assert(BT * kOutRow <= kBars, "the output tile is staged in the ring");
};

// Four rows' 32-bit words (bytes = columns c0..c3) -> for column c the word
// of its four bytes in row order: a 4x4 byte transpose.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

template <int BT, typename TO>
__global__ void __launch_bounds__(kWgThreads)
wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap xmap,
             const float* __restrict__ sx, const float* __restrict__ ws, TO* __restrict__ out,
             int m_len, int k_len, int n_len) {
  using L = WgLayout<BT, TO>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kWgStages;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kWgCols;
  const int m0 = blockIdx.y * BT;
  const int k_tiles = (k_len + kWgK - 1) / kWgK;

  if (tid == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kWgConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {
    if (tid == kWgConsumers) {
      hopper::prefetch_tensor_map(&qmap);
      hopper::prefetch_tensor_map(&xmap);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % kWgStages;
        hopper::mbar_wait(&empty[st], ((kt / kWgStages) & 1) ^ 1);
        unsigned char* stage = smem + st * L::kStage;
        hopper::mbar_arrive_expect_tx(&full[st], L::kStage);
        hopper::tma_load_2d(stage, &qmap, &full[st], n0, kt * kWgK);
        hopper::tma_load_2d(stage + L::kW, &xmap, &full[st], kt * kWgK, m0);
      }
    }
    return;
  }

  // Tile tau's wgmma row 16w + g + 8h is output column col + 2 tau + h.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int col = 32 * warp + 4 * g;
  // k rows 32kk + 4t + i and 32kk + 16 + 4t + i: a row's swizzle depends on
  // row & 7 only, so the eight byte offsets are the same in every step but
  // for 32 * 128 bytes.
  int off[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    off[i] = hopper::swz128(4 * t + i, col);
    off[4 + i] = hopper::swz128(16 + 4 * t + i, col);
  }
  int acc0[BT / 2], acc1[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc0[i] = acc1[i] = 0;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % kWgStages;
    hopper::mbar_wait(&full[st], (kt / kWgStages) & 1);
    const unsigned char* stage = smem + st * L::kStage;
    const uint64_t dx = hopper::desc_sw128(stage + L::kW);
#pragma unroll
    for (int kk = 0; kk < kWgK / 32; ++kk) {
      uint32_t c0[4], c1[4];
      uint32_t r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(stage + kk * 32 * 128 + off[i]);
      transpose4(r[0], r[1], r[2], r[3], c0);
      transpose4(r[4], r[5], r[6], r[7], c1);
      const uint32_t a0[4] = {c0[0], c0[1], c1[0], c1[1]};
      const uint32_t a1[4] = {c0[2], c0[3], c1[2], c1[3]};
      hopper::wgmma_fence();
      hopper::Wgmma<BT>::s8(acc0, a0, dx + 2 * kk);
      hopper::Wgmma<BT>::s8(acc1, a1, dx + 2 * kk);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      hopper::fence_operand(acc0[i]);
      hopper::fence_operand(acc1[i]);
    }
    hopper::mbar_arrive(&empty[st]);
  }

  // Epilogue: (float(acc) * sx[m]) * ws[n], one rounding, staged in the ring.
  float wn[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wn[c] = n0 + col + c < n_len ? ws[n0 + col + c] : 0.f;
  hopper::named_barrier_sync(1, kWgConsumers);
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int tok = 8 * j + 2 * t + u;
      const float sm = m0 + tok < m_len ? sx[m0 + tok] : 0.f;
      const int a[4] = {acc0[4 * j + u], acc0[4 * j + 2 + u], acc1[4 * j + u], acc1[4 * j + 2 + u]};
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = __fmul_rn(__fmul_rn(__int2float_rn(a[c]), sm), wn[c]);
      store4(reinterpret_cast<TO*>(smem + tok * L::kOutRow) + col, v);
    }
  hopper::named_barrier_sync(1, kWgConsumers);
  constexpr int kChunks = kWgCols * static_cast<int>(sizeof(TO)) / 16;  // 16-byte chunks a row
  constexpr int kPer = 16 / static_cast<int>(sizeof(TO));
  for (int c = tid; c < BT * kChunks; c += kWgConsumers) {
    const int row = c / kChunks;
    const int m = m0 + row;
    const int n = n0 + (c % kChunks) * kPer;
    if (m < m_len && n < n_len)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * n_len + n) =
          *reinterpret_cast<const uint4*>(smem + row * L::kOutRow + (c % kChunks) * 16);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int BT, typename TO>
cudaError_t launch_wgmma(const void* xq, const float* sx, const void* q, const float* ws,
                         void* out, int m, int k, int n, cudaStream_t st) {
  using L = WgLayout<BT, TO>;
  CUtensorMap qmap, xmap;
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(n)};
  const cuuint32_t qbox[2] = {kWgCols, kWgK};
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t xbox[2] = {kWgK, BT};
  if (!hopper::encode_sw128(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstrides, qbox) ||
      !hopper::encode_sw128(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xdims, xstrides, xbox))
    return cudaErrorInvalidValue;
  const cudaError_t rc =
      hopper::allow_smem(reinterpret_cast<const void*>(wgmma_kernel<BT, TO>), L::kSmem);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(cdiv(n, kWgCols), cdiv(m, BT));
  wgmma_kernel<BT, TO><<<grid, kWgThreads, L::kSmem, st>>>(qmap, xmap, sx, ws,
                                                           static_cast<TO*>(out), m, k, n);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_bt(int bt, const void* xq, const float* sx, const void* q, const float* ws,
                        void* out, int m, int k, int n, cudaStream_t st) {
  if (bt == 64) return launch_wgmma<64, TO>(xq, sx, q, ws, out, m, k, n, st);
  if (bt == 128) return launch_wgmma<128, TO>(xq, sx, q, ws, out, m, k, n, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// xq (M,K) int8, sx (M,) f32, q (K,N) int8, ws (N,) f32, out (M,N), all
// contiguous; K % 16 == 0, N % 4 == 0, xq and q 16-byte aligned.
// out_dtype: 0 = float32, 1 = bfloat16. bt = 64 or 128 (from the wrapper's
// plan) takes the wgmma path, which needs N % 16 == 0; bt = 0 the mma.sync
// path. Launches on `device`, restoring the caller's current device.
// Returns the launch's cudaError_t.
extern "C" int rho_w8a8_matmul(const void* xq, const void* sx, const void* q, const void* ws,
                               void* out, int out_dtype, int m, int k, int n, int bt, int device,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || n % 4 != 0 || !aligned16(xq) ||
      !aligned16(q) || (out_dtype != 0 && out_dtype != 1))
    return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(q);
  const float* sa = static_cast<const float*>(sx);
  const float* sb = static_cast<const float*>(ws);
  if (bt != 0) {
    if (n % 16 != 0) return cudaErrorInvalidValue;
    return out_dtype == 0 ? dispatch_bt<float>(bt, a, sa, b, sb, out, m, k, n, st)
                          : dispatch_bt<__nv_bfloat16>(bt, a, sa, b, sb, out, m, k, n, st);
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (out_dtype == 0)
    mma_kernel<float><<<grid, kThreads, 0, st>>>(a, sa, b, sb, static_cast<float*>(out), m, k, n);
  else
    mma_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a, sa, b, sb,
                                                          static_cast<__nv_bfloat16*>(out), m, k, n);
  return cudaGetLastError();
}
