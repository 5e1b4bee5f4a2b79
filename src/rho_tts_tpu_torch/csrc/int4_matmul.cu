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
// Two paths behind one entry point:
// * gemv_kernel, for small M (decode) and for f32 x: each block owns 128
//   columns, up to 8 rows of x and a slice of the packed rows (split K, so
//   that even N = 2048 gives ~264 blocks for 132 SMs). Each warp streams
//   its packed rows as one coalesced 128-byte read per row (4 bytes, 4
//   columns a thread) against x held in shared memory; the 8 warps'
//   partial sums are added in shared memory in a fixed order. With split
//   K, every block writes its partial sums to a workspace and the last
//   block of a column tile to finish (an atomic ticket) adds the slices in
//   slice order, applies the scale and writes the output. The order of
//   every sum is fixed, so the result does not change from run to run.
// * mma_kernel, for bf16 x with M > 16 (prefill): 64x64 output tiles of
//   four warps, each a 32x32 sub-tile of mma.sync.m16n8k16 bf16 products
//   with f32 accumulators. Per stage of 32 packed rows it stages both x
//   halves and the packed bytes in shared memory; every byte yields the B
//   fragments of the low half and of the high half, and both products go
//   into the same accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int lo_nibble(int b) {
  return static_cast<int>(static_cast<unsigned>(b) << 28) >> 28;
}
__device__ __forceinline__ int hi_nibble(int b) { return b >> 4; }

// ---------------------------------------------------------------------------
// Small M / f32: split-K GEMV
// ---------------------------------------------------------------------------

constexpr int kGvWarps = 8;
constexpr int kGvThreads = kGvWarps * 32;
constexpr int kGvCols = 128;   // columns per block: 32 lanes x 4
constexpr int kGvRows = 8;     // rows of x per block
constexpr int kGvMaxSlice = 512;  // packed rows per block at most
constexpr int kGvUnroll = 4;

template <typename TX>
__global__ void __launch_bounds__(kGvThreads)
gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q4, const float* __restrict__ s,
            TX* __restrict__ out, float* __restrict__ work, unsigned* __restrict__ tickets,
            int m_len, int kh, int n_len, int slice, int splits) {
  // x staging during the main loop, the warps' partial sums after it.
  __shared__ __align__(16) float smem[kGvWarps * kGvRows * kGvCols];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * kGvCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kGvRows;
  const int i0 = split * slice;
  const int rows = min(slice, kh - i0);  // packed rows of this block
  const int k_len = 2 * kh;

  // xs_lo[r][mm] = x[m0+mm, i0+r], xs_hi[r][mm] = x[m0+mm, kh+i0+r], f32.
  float* xs_lo = smem;
  float* xs_hi = smem + slice * kGvRows;
  for (int e = tid; e < rows * kGvRows; e += kGvThreads) {
    const int mm = e / rows;
    const int r = e % rows;
    const int m = m0 + mm;
    float lo = 0.f, hi = 0.f;
    if (m < m_len) {
      const TX* xr = x + static_cast<long long>(m) * k_len;
      lo = to_f32(xr[i0 + r]);
      hi = to_f32(xr[kh + i0 + r]);
    }
    xs_lo[r * kGvRows + mm] = lo;
    xs_hi[r * kGvRows + mm] = hi;
  }
  __syncthreads();

  const int n = n0 + lane * 4;
  const bool col_ok = n < n_len;  // n_len % 4 == 0: all four or none
  float acc[kGvRows][4];
#pragma unroll
  for (int mm = 0; mm < kGvRows; ++mm)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mm][c] = 0.f;

  const int8_t* qcol = q4 + static_cast<long long>(i0) * n_len + n;
  for (int r0 = warp; r0 < rows; r0 += kGvWarps * kGvUnroll) {
    uint32_t w[kGvUnroll];
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int r = r0 + u * kGvWarps;
      w[u] = (col_ok && r < rows)
                 ? __ldg(reinterpret_cast<const uint32_t*>(qcol + static_cast<long long>(r) * n_len))
                 : 0u;
    }
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int r = r0 + u * kGvWarps;
      if (r >= rows) break;
      float lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = static_cast<int>(static_cast<int8_t>((w[u] >> (8 * c)) & 0xffu));
        lo[c] = static_cast<float>(lo_nibble(b));
        hi[c] = static_cast<float>(hi_nibble(b));
      }
      const float4 xl0 = *reinterpret_cast<const float4*>(xs_lo + r * kGvRows);
      const float4 xl1 = *reinterpret_cast<const float4*>(xs_lo + r * kGvRows + 4);
      const float4 xh0 = *reinterpret_cast<const float4*>(xs_hi + r * kGvRows);
      const float4 xh1 = *reinterpret_cast<const float4*>(xs_hi + r * kGvRows + 4);
      const float xl[kGvRows] = {xl0.x, xl0.y, xl0.z, xl0.w, xl1.x, xl1.y, xl1.z, xl1.w};
      const float xh[kGvRows] = {xh0.x, xh0.y, xh0.z, xh0.w, xh1.x, xh1.y, xh1.z, xh1.w};
#pragma unroll
      for (int mm = 0; mm < kGvRows; ++mm)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[mm][c] = fmaf(xh[mm], hi[c], fmaf(xl[mm], lo[c], acc[mm][c]));
    }
  }
  __syncthreads();  // x staging is dead: reuse smem for the partial sums

  // red[warp][mm][col]
#pragma unroll
  for (int mm = 0; mm < kGvRows; ++mm)
    *reinterpret_cast<float4*>(smem + (warp * kGvRows + mm) * kGvCols + lane * 4) =
        make_float4(acc[mm][0], acc[mm][1], acc[mm][2], acc[mm][3]);
  __syncthreads();

  // Each thread owns kGvRows * kGvCols / kGvThreads = 4 outputs of the tile.
  float part[4];
  int em[4], en[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = tid + j * kGvThreads;
    em[j] = e / kGvCols;
    en[j] = e % kGvCols;
    float sum = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kGvWarps; ++w8) sum += smem[(w8 * kGvRows + em[j]) * kGvCols + en[j]];
    part[j] = sum;
  }

  const long long mn = static_cast<long long>(m_len) * n_len;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + em[j], nn = n0 + en[j];
      if (m < m_len && nn < n_len)
        store(out + static_cast<long long>(m) * n_len + nn, part[j] * s[nn]);
    }
    return;
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + em[j], nn = n0 + en[j];
    if (m < m_len && nn < n_len) work[split * mn + static_cast<long long>(m) * n_len + nn] = part[j];
  }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) s_last = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + em[j], nn = n0 + en[j];
    if (m >= m_len || nn >= n_len) continue;
    const float* p = work + static_cast<long long>(m) * n_len + nn;
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) sum += __ldcg(p + sp * mn);
    store(out + static_cast<long long>(m) * n_len + nn, sum * s[nn]);
  }
  if (tid == 0) tickets[tile] = 0u;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// bf16 prefill: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmBM = 64;
constexpr int kMmBN = 64;
constexpr int kMmBK = 32;            // packed rows per stage
constexpr int kMmXRow = kMmBK + 8;   // padded bf16 row of the x tiles
constexpr int kMmWRow = kMmBN + 16;  // padded byte row of the weight tile
constexpr int kMmThreads = 128;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(int a, int b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(a), static_cast<float>(b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kMmThreads)
mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int m_len, int kh,
           int n_len) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kMmBM * kMmXRow];  // [half][row][k]
  __shared__ __align__(16) int8_t wsm[kMmBK * kMmWRow];           // [packed row][n]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.y * kMmBM;
  const int n0 = blockIdx.x * kMmBN;
  const long long k_len = 2LL * kh;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int i0 = 0; i0 < kh; i0 += kMmBK) {
    // x tiles: 2 halves x 64 rows x 32 bf16 as 16-byte chunks, 4 per thread.
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = tid + p * kMmThreads;
      const int half = c / 256;
      const int row = (c % 256) / 4;
      const int col = (c % 4) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < m_len && i0 + col < kh)
        v = *reinterpret_cast<const uint4*>(x + (m0 + row) * k_len + half * kh + i0 + col);
      *reinterpret_cast<uint4*>(&xs[half][row * kMmXRow + col]) = v;
    }
    // weight tile: 32 packed rows x 64 bytes, one 16-byte chunk per thread.
    {
      const int row = tid / 4;
      const int col = (tid % 4) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (i0 + row < kh && n0 + col < n_len)
        v = *reinterpret_cast<const uint4*>(q4 + static_cast<long long>(i0 + row) * n_len + n0 + col);
      *reinterpret_cast<uint4*>(wsm + row * kMmWRow + col) = v;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kMmBK; ks += 16) {
      uint32_t a[2][2][4];  // [half][m16 tile][reg]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* base = &xs[h][(wm * 32 + i * 16 + g) * kMmXRow + ks + 2 * t];
          a[h][i][0] = *reinterpret_cast<const uint32_t*>(base);
          a[h][i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kMmXRow);
          a[h][i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          a[h][i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kMmXRow + 8);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        const int8_t* wp = wsm + (ks + 2 * t) * kMmWRow + col;
        const int b0 = wp[0];
        const int b1 = wp[kMmWRow];
        const int b8 = wp[8 * kMmWRow];
        const int b9 = wp[9 * kMmWRow];
        const uint32_t blo[2] = {pack_bf16(lo_nibble(b0), lo_nibble(b1)),
                                 pack_bf16(lo_nibble(b8), lo_nibble(b9))};
        const uint32_t bhi[2] = {pack_bf16(hi_nibble(b0), hi_nibble(b1)),
                                 pack_bf16(hi_nibble(b8), hi_nibble(b9))};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], a[0][i], blo);
          mma_bf16(acc[i][j], a[1][i], bhi);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + h * 8;
      if (m >= m_len) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= n_len) continue;  // n_len % 16 == 0: n and n + 1 together
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][j][h * 2] * s[n],
                                                       acc[i][j][h * 2 + 1] * s[n + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(m) * n_len + n) = v;
      }
    }
}

constexpr int kTargetBlocks = 264;  // two per SM on the H100's 132

bool uses_mma(int x_dtype, int m, int kh, int n) {
  return x_dtype == 1 && m > 16 && kh % 8 == 0 && n % 16 == 0;
}

int gemv_splits(int m, int kh, int n) {
  const int tiles = ((n + kGvCols - 1) / kGvCols) * ((m + kGvRows - 1) / kGvRows);
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  const int min_splits = (kh + kGvMaxSlice - 1) / kGvMaxSlice;
  const int max_splits = (kh + 31) / 32;  // keep >= 32 packed rows a block
  if (splits > max_splits) splits = max_splits;
  if (splits < min_splits) splits = min_splits;
  return splits < 1 ? 1 : splits;
}

}  // namespace

// Workspace a launch needs for (x_dtype, m, kh, n): the f32 partial sums
// (in floats) and the tickets (one unsigned per column tile), both 0 when
// the product runs on the tensor-core path or in one slice.
extern "C" void rho_int4_workspace(int x_dtype, int m, int kh, int n, long long* work_floats,
                                   long long* tickets) {
  const int splits = uses_mma(x_dtype, m, kh, n) ? 1 : gemv_splits(m, kh, n);
  const long long tiles = static_cast<long long>((n + kGvCols - 1) / kGvCols) *
                          ((m + kGvRows - 1) / kGvRows);
  *work_floats = splits > 1 ? static_cast<long long>(splits) * m * n : 0;
  *tickets = splits > 1 ? tiles : 0;
}

// x (M, 2*kh) and out (M,N) in x_dtype (0 = float32, 1 = bfloat16), q4
// (kh,N) int8, s (N,) f32, all contiguous; N % 4 == 0, q4 16-byte aligned.
// work/tickets: as rho_int4_workspace says (tickets zeroed before the first
// launch; each launch leaves them zero). Returns the launch's cudaError_t.
extern "C" int rho_int4_matmul(const void* x, const void* q4, const void* s, void* out,
                               void* work, void* tickets, int x_dtype, int m, int kh, int n,
                               void* stream) {
  if (m <= 0 || kh <= 0 || n <= 0 || n % 4 != 0 || (x_dtype != 0 && x_dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(q4);
  const float* sc = static_cast<const float*>(s);
  if (uses_mma(x_dtype, m, kh, n)) {
    const dim3 grid((n + kMmBN - 1) / kMmBN, (m + kMmBM - 1) / kMmBM);
    mma_kernel<<<grid, kMmThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), w, sc,
                                            static_cast<__nv_bfloat16*>(out), m, kh, n);
    return cudaGetLastError();
  }
  const int splits = gemv_splits(m, kh, n);
  const int slice = (kh + splits - 1) / splits;
  if (slice > kGvMaxSlice || (splits > 1 && (work == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((n + kGvCols - 1) / kGvCols, splits, (m + kGvRows - 1) / kGvRows);
  float* wk = static_cast<float*>(work);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (x_dtype == 0)
    gemv_kernel<float><<<grid, kGvThreads, 0, st>>>(static_cast<const float*>(x), w, sc,
                                                     static_cast<float*>(out), wk, tk, m, kh, n,
                                                     slice, splits);
  else
    gemv_kernel<__nv_bfloat16><<<grid, kGvThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, sc, static_cast<__nv_bfloat16*>(out), wk, tk,
        m, kh, n, slice, splits);
  return cudaGetLastError();
}
