// Routed experts of one decode step (T == 1) for Hopper (sm_90a), bound
// through a plain C interface (ops/cuda/moe_experts.py loads it with ctypes).
//
// No TPU kernel: the JAX package has no expert layer. Function: for `rows`
// tokens x (rows, H) bf16, each routed to `topk` experts idx (rows, topk)
// int64 with weights w (rows, topk) f32, and expert weights
// w_gate / w_up (E, H, F), w_down (E, F, H) bf16 (the port's (in, out)
// layout), two launches:
//   1. gate/up: act[s] = silu(x[s / topk] . w_gate[e]) * (x[s / topk] . w_up[e])
//      for every slot s = (row, j) with e = idx[s], in f32, stored bf16;
//   2. down:    partial[s] = w[s] * (act[s] . w_down[e]), f32.
// The caller sums partial over the topk slots of each row in a fixed order,
// so the result has the same bits on every launch (no atomics).
//
// Bound on the H100 at LFM2-8B-A1B's shapes (H 2048, F 1792, 32 experts,
// top-4, 8 rows): the bytes of the experts that some row chose, ~21 of 32
// with uniform routing, 21 x 22.0 MB ~ 462 MB a layer (~138 us at 3.35 TB/s);
// the products are ~0.7 GFLOP a layer.
//
// Design: the grid is (column tiles of the output, experts). A block scans
// idx in windows of 512 slots (64 rows of top-8; one window at the decode
// step's sizes) and finds, with warp ballots, the window's slots routed to
// its expert, in slot order; a block whose expert no row chose returns
// before it reads a byte of that expert, so untouched experts are never read.
// The gate/up launch's first column tile also writes whether its expert was
// chosen (0 or 1) into `touched` (E,), every expert every launch, so the
// caller needs no zeroing to count the distinct experts of a step.
// Otherwise it copies the x (or act) rows of up to 8 of its slots into
// shared memory and streams its expert's weight tile (all H (or F) rows of
// 64 gate + 64 up columns, or 128 down columns) once, 16 bytes a thread and
// four loads in flight, each weight used for all of those slots (8 f32
// accumulators a slot a thread). 16 lanes split the contraction; the block
// reduces them in a fixed order through shared memory and writes its columns
// of each slot. An expert chosen by more than 8 slots of a window takes
// further passes over the same tile (rows > 8 only), and each window with
// a slot of the expert one more (rows > 128 at top-4).
// Nothing here reads a host value that changes from step to step, so the
// launches can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColThreads = 16;               // threads across a block's 128 columns
constexpr int kLanes = kThreads / kColThreads;  // lanes along the contraction
constexpr int kVec = 8;                       // bf16 per 16-byte load
constexpr int kCols = kColThreads * kVec;     // 128 output columns (64 gate + 64 up)
constexpr int kUnroll = 4;                    // weight loads in flight per thread
constexpr int kRows = 8;                      // slots per pass
constexpr int kWindow = 512;                  // slots of idx scanned at a time

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

struct Args {
  const __nv_bfloat16* x;   // gated: (rows, K) tokens; down: (rows * topk, K) act
  const long long* idx;     // (rows * topk) experts
  const float* weight;      // (rows * topk) routing weights (down only)
  const __nv_bfloat16* w0;  // gated: w_gate; down: w_down. (E, K, N)
  const __nv_bfloat16* w1;  // gated: w_up
  void* out;                // gated: act (rows * topk, N) bf16; down: partial f32
  int* touched;             // gated, optional: (E,) 1 where some slot chose the expert
  int slots;                // rows * topk
  int topk;
  int k;                    // contraction
  int n;                    // output columns of one expert
};

// kGated: the gate/up launch (64 columns of each of two matrices a block,
// SiLU(gate) * up stored bf16); else the down launch (128 columns of one
// matrix, scaled by the slot's routing weight, stored f32).
template <bool kGated>
__global__ void __launch_bounds__(kThreads, 2) moe_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_slots[kWindow];
  __shared__ int s_n;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane32 = tid & 31;
  const int expert = blockIdx.y;
  const int tile_cols = kGated ? kCols / 2 : kCols;
  const int n0 = blockIdx.x * tile_cols;

  const int ct = tid % kColThreads;
  const int lane = tid / kColThreads;
  const __nv_bfloat16* w = (kGated && ct >= kColThreads / 2) ? a.w1 : a.w0;
  const int col = kGated ? (ct % (kColThreads / 2)) * kVec : ct * kVec;
  const __nv_bfloat16* wp =
      w + static_cast<long long>(expert) * a.k * a.n + n0 + col + static_cast<long long>(lane) * a.n;
  const long long w_step = static_cast<long long>(kLanes) * a.n;

  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  const int k_vecs = a.k / kVec;
  int chosen = 0;

  for (int w0 = 0; w0 < a.slots; w0 += kWindow) {
    // 1. The window's slots of this expert, in slot order.
    if (warp == 0) {
      const int w1 = min(a.slots, w0 + kWindow);
      int count = 0;
      for (int base = w0; base < w1; base += 32) {
        const int s = base + lane32;
        const bool hit = s < w1 && a.idx[s] == expert;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) s_slots[count + __popc(m & ((1u << lane32) - 1u))] = s;
        count += __popc(m);
      }
      if (lane32 == 0) s_n = count;
    }
    __syncthreads();
    const int n_slots = s_n;
    __syncthreads();  // every thread has read s_n before the next window writes it
    chosen |= n_slots;
    // A window no row of which chose this expert reads none of its weights.

    for (int p = 0; p < n_slots; p += kRows) {
      const int nr = min(kRows, n_slots - p);
      // 2. The pass's x (act) rows into shared memory, bf16.
      for (int i = tid; i < nr * k_vecs; i += kThreads) {
        const int r = i / k_vecs, j = i - r * k_vecs;
        const int slot = s_slots[p + r];
        const long long row = kGated ? slot / a.topk : slot;
        reinterpret_cast<uint4*>(xs)[r * k_vecs + j] =
            reinterpret_cast<const uint4*>(a.x + row * a.k)[j];
      }
      __syncthreads();

      // 3. Stream the weight tile once; every weight meets every row of the pass.
      float acc[kRows][kVec];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[r][c] = 0.f;
      const __nv_bfloat16* wq = wp;
      for (int kb = 0; kb < a.k; kb += kLanes * kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = __ldg(reinterpret_cast<const uint4*>(wq + u * w_step));
        wq += kUnroll * w_step;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = kb + u * kLanes + lane;
          float wf[kVec] = {bf_lo(v[u].x), bf_hi(v[u].x), bf_lo(v[u].y), bf_hi(v[u].y),
                            bf_lo(v[u].z), bf_hi(v[u].z), bf_lo(v[u].w), bf_hi(v[u].w)};
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) {
              const float xv = __uint_as_float(static_cast<uint32_t>(xs[r * a.k + kk]) << 16);
#pragma unroll
              for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
            }
          }
        }
      }
      __syncthreads();  // every thread is done with xs: the buffer becomes `red`

      // 4. Reduce the 16 lanes in a fixed order: the two of a warp by a shuffle,
      //    then the 8 warps through shared memory.
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float v = acc[r][c] + __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
          if (lane32 < 16 && r < nr) red[(warp * kRows + r) * kCols + ct * kVec + c] = v;
        }
      }
      __syncthreads();
      for (int o = tid; o < nr * tile_cols; o += kThreads) {
        const int r = o / tile_cols, c = o - r * tile_cols;
        const int slot = s_slots[p + r];
        float g = 0.f, u = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) {
          g += red[(wi * kRows + r) * kCols + c];
          if (kGated) u += red[(wi * kRows + r) * kCols + kCols / 2 + c];
        }
        const long long at = static_cast<long long>(slot) * a.n + n0 + c;
        if (kGated) {
          static_cast<__nv_bfloat16*>(a.out)[at] = __float2bfloat16(g / (1.f + expf(-g)) * u);
        } else {
          static_cast<float*>(a.out)[at] = a.weight[slot] * g;
        }
      }
      __syncthreads();  // before the next pass overwrites the buffer
    }
  }
  if (kGated && a.touched != nullptr && blockIdx.x == 0 && tid == 0)
    a.touched[expert] = chosen != 0;
}

template <bool kGated>
cudaError_t launch(const Args& a, int experts, cudaStream_t stream) {
  const int smem_x = kRows * a.k * 2;
  const int smem_red = kWarps * kRows * kCols * 4;
  const int smem = smem_x > smem_red ? smem_x : smem_red;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(moe_kernel<kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  const int tile_cols = kGated ? kCols / 2 : kCols;
  const dim3 grid(a.n / tile_cols, experts);
  moe_kernel<kGated><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t run(bool gated, const void* x, const void* idx, const void* weight, const void* w0,
                const void* w1, void* out, int* touched, int rows, int topk, int experts, int k,
                int n, int device, void* stream) {
  const int tile_cols = gated ? kCols / 2 : kCols;
  if (rows <= 0 || topk <= 0 || static_cast<long long>(rows) * topk > (1 << 30) || experts <= 0 ||
      k <= 0 || k % (kLanes * kUnroll) != 0 || n <= 0 || n % tile_cols != 0 ||
      kRows * k * 2 > 200 * 1024 || !aligned(x) || !aligned(w0) || (gated && !aligned(w1)))
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc != cudaSuccess) return rc;
  if (current != device && (rc = cudaSetDevice(device)) != cudaSuccess) return rc;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const long long*>(idx),
               static_cast<const float*>(weight), static_cast<const __nv_bfloat16*>(w0),
               static_cast<const __nv_bfloat16*>(w1), out, touched, rows * topk, topk, k, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = gated ? launch<true>(a, experts, st) : launch<false>(a, experts, st);
  if (current != device) cudaSetDevice(current);
  return rc;
}

}  // namespace

// x (rows, hidden) bf16, idx (rows, topk) int64, w_gate / w_up (experts,
// hidden, ffn) bf16 -> act (rows * topk, ffn) bf16, and, where `touched` is
// not null, touched (experts,) int32: 1 for each expert some slot chose, 0
// for the others. hidden a multiple of 64, ffn of 64; x and the weights
// 16-byte aligned, rows and weights contiguous. Launches on `device`,
// restoring the caller's current device. Returns the cudaError_t of the
// launch.
extern "C" int rho_moe_gate_up(const void* x, const void* idx, const void* w_gate,
                               const void* w_up, void* act, void* touched, int rows, int topk,
                               int experts, int hidden, int ffn, int device, void* stream) {
  return run(true, x, idx, nullptr, w_gate, w_up, act, static_cast<int*>(touched), rows, topk,
             experts, hidden, ffn, device, stream);
}

// act (rows * topk, ffn) bf16, idx (rows, topk) int64, weight (rows, topk)
// f32, w_down (experts, ffn, hidden) bf16 -> partial (rows * topk, hidden)
// f32, each slot's output times its routing weight. ffn a multiple of 64,
// hidden of 128.
extern "C" int rho_moe_down(const void* act, const void* idx, const void* weight,
                            const void* w_down, void* partial, int rows, int topk, int experts,
                            int ffn, int hidden, int device, void* stream) {
  return run(false, act, idx, weight, w_down, nullptr, partial, nullptr, rows, topk, experts, ffn,
             hidden, device, stream);
}
