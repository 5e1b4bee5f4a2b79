// Weight-only int8 GEMV for Hopper (sm_90a), bound through a plain C
// interface (ops/cuda/int8_gemv.py loads it with ctypes).
//
// Replaces no TPU kernel. The JAX package computes x @ q.astype(x.dtype)
// and the scale with XLA, which fuses the int8 -> bf16 convert into the dot
// (rho_tts_tpu/models/quantization.py), so no weight copy exists there.
// Eager PyTorch wrote a bf16 copy of every weight on every call; this
// kernel is the port's own route for the int8 matmuls of few rows (the
// decode step): x (M,K) bf16, M <= 64, times q (K,N) int8 in its stored
// layout, with the per-output-channel f32 scale s (N):
// out = (sum_k x[m,k] * q[k,n]) * s[n], one f32 accumulation, one rounding
// to bf16. The weight is converted in registers and never written.
//
// Bound on the H100: reading the weight once (12.6 MB for (K,N) =
// (2048,6144): 3.8 us at 3.35 TB/s). At M = 64 the product is 128
// operations a weight byte, below the ~295 at which bf16 tensor cores and
// not memory would bound it.
//
// Design:
// * A and B swapped: out^T = q^T x^T on mma.sync m16n8k16 (bf16, f32
//   accumulators). Output columns fill the 16-row side and 8 rows of x the
//   8 side, so no tensor-core work goes to padding rows; up to 8 tiles of 8
//   rows run inside the block on the same converted weights.
// * A block owns 128 output columns and one K-split of `slice` rows; the
//   K-splits of a column tile form one thread block cluster (<= 8 blocks),
//   and the grid is one wave. Each warp takes every 8th (or SG-th) 16-row
//   step of the slice, and for a step a thread loads rows 2t, 2t+1, 2t+8
//   and 2t+9 of 2*TJ adjacent columns straight from global memory into
//   registers (16 bytes a row at 8 rows of x: four full 128-byte lines a
//   warp instruction), with x's matching k pairs. The loads of U steps go
//   out before any of them is used, so every warp keeps U * 2 KB in flight.
//   (A TMA ring of 32-row stages into shared memory ran slower than these
//   loads at every decode shape on an H100.)
// * m16 tile j's rows g and g+8 are two adjacent columns of thread g, so the
//   thread's own bytes are its A fragments: a byte permute pairs one
//   column's bytes of two rows in the two bf16 halves of a word, and
//   v = (0x4300 | v & 0x7F) - (0x4300 | v & 0x80), both terms bf16 in
//   [128, 256), gives v exactly (two lop3 and one bf16x2 FMA a pair).
// * The warps' sums are added in a fixed order in shared memory, the
//   cluster's splits merged in split order through distributed shared
//   memory (each block pulls its share of the tile from every split between
//   two cluster barriers), s applied and the sum rounded once. No atomics,
//   no workspace: a launch repeats bit for bit. A grid of one split is no
//   cluster and finishes its tiles alone.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 128;           // output columns a block
constexpr int kStep = 16;            // weight rows a step (one mma k)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxTiles = 8;         // 8-row tiles of x: M <= 64

// TJ: m16 tiles of a thread (its 2*TJ adjacent columns), fewer as the rows
// of x grow so that a thread holds at most 64 accumulators; P = 8 / TJ warps
// cover a step's 128 columns; the SG = TJ groups of P warps take every
// SG-th step; U steps' loads go out together.
template <int NT>
struct Tiling {
  static constexpr int TJ = NT <= 2 ? 8 : (NT <= 4 ? 4 : 2);
  static constexpr int P = 8 / TJ;
  static constexpr int SG = kWarps / P;
  static constexpr int U = NT == 1 ? 4 : 2;
  static constexpr int kTok = 8 * NT;
  static constexpr int kAcc = 4 * NT * TJ;  // accumulators a thread
  // Each warp's accumulators, a lane's kAcc + 1 floats apart (conflict-free stores)
  static constexpr int kRed = kWarps * 32 * (kAcc + 1) * 4;
  static constexpr int kPart = kTok * kCols * 4;  // the block's partial tile
  static constexpr int kSmem = kRed + kPart + kCols * 4;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Args {
  const __nv_bfloat16* x;
  const int8_t* q;
  const float* s;
  __nv_bfloat16* out;
  int m, k, n, slice;
};

// Read-only loads that bypass L1 (each weight byte is read once).
template <int TJ>
__device__ __forceinline__ void load_row(const int8_t* p, bool ok, uint32_t (&w)[TJ / 2]) {
#pragma unroll
  for (int i = 0; i < TJ / 2; ++i) w[i] = 0u;
  if (!ok) return;
  if constexpr (TJ == 8) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "l"(p));
  } else if constexpr (TJ == 4) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1])
                 : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(w[0]) : "l"(p));
  }
}

__device__ __forceinline__ uint32_t load_x(const __nv_bfloat16* p, bool ok) {
  uint32_t v = 0u;
  if (ok) asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// Byte b of lo and byte b of hi (two int8 weights of one column in
// consecutive rows) as bf16x2, lo in the low half: exact.
__device__ __forceinline__ uint32_t pair_bf16x2(uint32_t lo, uint32_t hi, int b) {
  const uint32_t p = __byte_perm(lo, hi, b | ((b + 4) << 8));  // bytes 0 and 2
  const uint32_t big = (p & 0x007F007Fu) | 0x43004300u;        // 128 + (v & 127)
  const uint32_t sign = (p & 0x00800080u) | 0x43004300u;       // 128 + (v & 128)
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(sign), "r"(0xBF80BF80u), "r"(big));  // big - sign
  return out;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory: the warps' sums, the block's partial tile [8 NT][128] f32,
// the tile's scales.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? 2 : 1) int8_gemv_kernel(const Args a) {
  using T = Tiling<NT>;
  constexpr int TJ = T::TJ;
  constexpr int kTok = T::kTok;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + T::kRed);
  float* scale = part + kTok * kCols;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.x * kCols;
  const int i0 = split * a.slice;
  const int row_end = min(a.k, i0 + a.slice);
  const int steps = max(0, cdiv(row_end - i0, kStep));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pc = warp % T::P;  // the warp's column pass
  const int sg = warp / T::P;  // the warp's step group
  const int g = lane / 4;
  const int t = lane % 4;
  const int cb = pc * 16 * TJ + 2 * TJ * g;  // the thread's first column in the tile
  const bool col_ok = n0 + cb < a.n;         // N % 16 == 0: the 2*TJ bytes lie in or out
  const int8_t* qcol = a.q + n0 + cb;

  if (tid < kCols) scale[tid] = n0 + tid < a.n ? a.s[n0 + tid] : 0.f;  // read long before use

  float acc[NT][TJ][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;

  for (int s0 = sg; s0 < steps; s0 += T::U * T::SG) {
    uint32_t w[T::U][4][TJ / 2];
    uint32_t b[T::U][NT][2];
    // Every load of the U steps first: rows past the split or K read as 0.
#pragma unroll
    for (int u = 0; u < T::U; ++u) {
      const int r0 = i0 + (s0 + u * T::SG) * kStep;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int row = r0 + 2 * t + (d & 1) + 8 * (d >> 1);
        load_row<TJ>(qcol + static_cast<long long>(row) * a.n, col_ok && row < row_end, w[u][d]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = 8 * nt + g;
        const __nv_bfloat16* xr = a.x + static_cast<long long>(m) * a.k + r0 + 2 * t;
        b[u][nt][0] = load_x(xr, m < a.m && r0 + 2 * t < row_end);
        b[u][nt][1] = load_x(xr + 8, m < a.m && r0 + 2 * t + 8 < row_end);
      }
    }
#pragma unroll
    for (int u = 0; u < T::U; ++u)
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        // Tile j: row g is column cb + 2j, row g + 8 column cb + 2j + 1.
        const int qd = j / 2;
        const int byte = 2 * (j % 2);
        uint32_t af[4];
        af[0] = pair_bf16x2(w[u][0][qd], w[u][1][qd], byte);
        af[1] = pair_bf16x2(w[u][0][qd], w[u][1][qd], byte + 1);
        af[2] = pair_bf16x2(w[u][2][qd], w[u][3][qd], byte);
        af[3] = pair_bf16x2(w[u][2][qd], w[u][3][qd], byte + 1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][j], af, b[u][nt][0], b[u][nt][1]);
      }
  }

  {
    float* dst = red + (warp * 32 + lane) * (T::kAcc + 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < TJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(nt * TJ + j) * 4 + e] = acc[nt][j][e];
  }
  __syncthreads();
  // Accumulator e = 2h + u of tile j, x tile nt of lane (g, t) in warp
  // (pc, sg) is (row 8 nt + 2t + u, column pc * 16 TJ + 2 TJ g + 2j + h);
  // the step groups add in order. A block that holds all of K finishes its
  // tile here; the others leave their part for the cluster's merge.
  for (int e = tid; e < kTok * kCols; e += kThreads) {
    const int tok = e / kCols;
    const int col = e % kCols;
    const int cc = col % (16 * TJ);
    const int lane_e = 4 * (cc / (2 * TJ)) + (tok % 8) / 2;
    const int reg = ((tok / 8) * TJ + (cc % (2 * TJ)) / 2) * 4 + 2 * (cc % 2) + tok % 2;
    const float* src = red + ((col / (16 * TJ)) * 32 + lane_e) * (T::kAcc + 1) + reg;
    float sum = 0.f;
    for (int r = 0; r < T::SG; ++r) sum += src[r * T::P * 32 * (T::kAcc + 1)];
    if (splits == 1) {
      if (tok < a.m && n0 + col < a.n)
        a.out[static_cast<long long>(tok) * a.n + n0 + col] = __float2bfloat16(sum * scale[col]);
    } else {
      part[e] = sum;
    }
  }
  if (splits == 1) return;

  // The cluster's K-splits, merged in split order; each block finishes a
  // share of the tile, applies s and rounds once.
  cluster.sync();
  for (int e = split * kThreads + tid; e < kTok * kCols; e += splits * kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      v[r] = r < splits ? cluster.map_shared_rank(part, r)[e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < splits) sum += v[r];
    const int m = e / kCols;
    const int n = n0 + e % kCols;
    if (m < a.m && n < a.n)
      a.out[static_cast<long long>(m) * a.n + n] = __float2bfloat16(sum * scale[e % kCols]);
  }
  cluster.sync();  // no block leaves while another reads its part
}

// The launch configuration of a grid of `col_tiles` x `splits` blocks, one
// cluster a column tile; `attr` holds the cluster shape.
cudaLaunchConfig_t launch_config(int col_tiles, int splits, int smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, splits, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: a block alone, no cluster
  return cfg;
}

template <int NT>
cudaError_t prepare() {
  const int smem = Tiling<NT>::kSmem;
  if (smem <= 48 * 1024) return cudaSuccess;
  return hopper::allow_smem(reinterpret_cast<const void*>(int8_gemv_kernel<NT>), smem);
}

template <int NT>
int max_clusters(int splits) {
  if (prepare<NT>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(splits, splits, Tiling<NT>::kSmem, nullptr, attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, int8_gemv_kernel<NT>, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

template <int NT>
cudaError_t launch(const Args& a, int splits, cudaStream_t st) {
  cudaError_t rc = prepare<NT>();
  if (rc != cudaSuccess) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cdiv(a.n, kCols), splits, Tiling<NT>::kSmem, st, attr);
  rc = cudaLaunchKernelEx(&cfg, int8_gemv_kernel<NT>, a);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (M,K) bf16 and out (M,N) bf16, q (K,N) int8, s (N) f32, all contiguous,
// x and q 16-byte aligned; 1 <= M <= 64, K % 8 == 0, N % 16 == 0. The plan
// comes from the wrapper (ops/cuda/int8_gemv.py `plan`): `splits` K-splits
// (1-8, the cluster) of `slice` rows (a multiple of 16, every split
// non-empty). Launches on `device`, restoring the caller's current device.
// Returns the launch's cudaError_t (then cudaGetLastError's).
extern "C" int rho_int8_gemv(const void* x, const void* q, const void* s, void* out, int m,
                             int k, int n, int splits, int slice, int device, void* stream) {
  if (m < 1 || m > 8 * kMaxTiles || k <= 0 || n <= 0 || k % 8 != 0 || n % 16 != 0 ||
      !aligned16(x) || !aligned16(q) || splits < 1 || splits > kMaxCluster || slice <= 0 ||
      slice % kStep != 0 || static_cast<long long>(splits - 1) * slice >= k ||
      static_cast<long long>(splits) * slice < k)
    return cudaErrorInvalidValue;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return guard.rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
               static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), m, k, n, slice};
  switch ((m + 7) / 8) {
    case 1: return launch<1>(a, splits, st);
    case 2: return launch<2>(a, splits, st);
    case 3: return launch<3>(a, splits, st);
    case 4: return launch<4>(a, splits, st);
    case 5: return launch<5>(a, splits, st);
    case 6: return launch<6>(a, splits, st);
    case 7: return launch<7>(a, splits, st);
    default: return launch<8>(a, splits, st);
  }
}

// The most clusters of `splits` blocks for M rows that fit on `device` at
// once (cudaOccupancyMaxActiveClusters), or -1 if they cannot launch.
extern "C" int rho_int8_gemv_clusters(int m, int splits, int device) {
  if (m < 1 || m > 8 * kMaxTiles || splits < 1 || splits > kMaxCluster) return -1;
  hopper::DeviceGuard guard(device);
  if (guard.rc != cudaSuccess) return -1;
  switch ((m + 7) / 8) {
    case 1: return max_clusters<1>(splits);
    case 2: return max_clusters<2>(splits);
    case 3: return max_clusters<3>(splits);
    case 4: return max_clusters<4>(splits);
    case 5: return max_clusters<5>(splits);
    case 6: return max_clusters<6>(splits);
    case 7: return max_clusters<7>(splits);
    default: return max_clusters<8>(splits);
  }
}
