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
// Design (simple first): 64x64 output tiles, one block of four warps each,
// every warp a 32x32 sub-tile of 2x4 mma.sync.m16n8k32 s8 tensor-core
// products with int32 accumulators in registers. Each K step of 64 stages
// the A tile row-major and the B tile transposed (n-major, k contiguous,
// which is the "col" operand layout of the instruction) in shared memory;
// the transpose is done in registers on 4x4 byte blocks with __byte_perm.
// Rows are padded to 80 bytes so the fragment loads hit 32 distinct banks.
// The rescale and the cast are fused into the epilogue. Ragged M and N are
// masked; K must be a multiple of 16 (zero-filled to the tile). No
// double buffering, no wgmma or TMA yet: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
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

}  // namespace

// xq (M,K) int8, sx (M,) f32, q (K,N) int8, ws (N,) f32, out (M,N), all
// contiguous; K % 16 == 0, N % 4 == 0, xq and q 16-byte aligned.
// out_dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int rho_w8a8_matmul(const void* xq, const void* sx, const void* q, const void* ws,
                               void* out, int out_dtype, int m, int k, int n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || n % 4 != 0) return cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(q);
  const float* sa = static_cast<const float*>(sx);
  const float* sb = static_cast<const float*>(ws);
  if (out_dtype == 0)
    w8a8_kernel<float><<<grid, kThreads, 0, st>>>(a, sa, b, sb, static_cast<float*>(out), m, k, n);
  else if (out_dtype == 1)
    w8a8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a, sa, b, sb,
                                                           static_cast<__nv_bfloat16*>(out), m, k, n);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
