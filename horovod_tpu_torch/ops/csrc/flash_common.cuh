// Shared pieces of the flash-attention kernels for Hopper (sm_90a).
//
// Layout: q/k/v/o and their gradients are [B, T, H, width] contiguous,
// read in place (no [B*H, T, D] transpose); lse and corr are [B, H, Tq]
// fp32. One block of 4 warps owns a tile of its own sequence (q rows for the
// forward and dq kernels, k rows for dk/dv) and streams the other sequence
// through shared memory in tiles of BN rows. Each warp owns a quarter of
// the tile's rows, so the softmax bookkeeping of a row never leaves its
// warp.
//
// Widths: a kernel is instantiated at a head width D in {32, 64, 128, 192,
// 256} and takes q/k of any width d <= D and v/do/o of any width dv <= D:
// the columns from d (or dv) up to D read as zeros, which change neither
// q.k^T nor the log-sum-exp, and are never written. The wrapper picks the
// smallest D >= max(d, dv).
//
// Types: fp32 stays full fp32 (scalar FMA, no TF32), which is what the
// reference's fp32 tolerances need; the fp32 kernels use the helpers below.
// bf16 and fp16 take the tensor cores: all their kernels run on TMA and
// wgmma (flash_sm90.cuh), products in the input type with fp32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hvdflash {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float NEG_INF = -1e30f;  // the reference's NEG_INF, not -inf
constexpr int BM = 64;             // rows of the block's own tile (wgmma M)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// The fp32 kernels: rows of a streamed tile, the element padding of a
// shared-memory row (staggers banks for the scalar loops), and rows of the
// block's own tile: 64, or 32 above D = 128, where a 64-row tile and its
// fp32 accumulator would not fit a block's 227 KB of shared memory.
constexpr int F32_BN = 32;
constexpr int F32_PAD = 1;
__host__ __device__ constexpr int f32_bm(int d) { return d > 128 ? 32 : 64; }

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Copy rows [row0, row0 + ROWS) of one (batch, head) slice into shared
// memory (row stride LD, D columns); rows at or past t_len and columns at
// or past `width` are zero. `src` points at element (b, 0, h, 0); `rs` is
// the row stride H * width.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int t_len, size_t rs,
                                          int width) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int t = row0 + r;
    dst[r * LD + c] =
        t < t_len && c < width ? src[(size_t)t * rs + c] : 0.f;
  }
}

// One block-wide store of a fp32 shared-memory tile (row stride LD) into
// rows [row0, row0 + ROWS) and columns [0, width) of a [B, T, H, width]
// slice, skipping rows >= t_len; each row is divided by
// max(row_div[r], 1e-30) when row_div is given.
template <int ROWS, int LD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float* src, int row0,
                                           int t_len, size_t rs, int width,
                                           const float* row_div) {
  for (int i = threadIdx.x; i < ROWS * width; i += THREADS) {
    const int r = i / width, c = i % width;
    const int t = row0 + r;
    if (t >= t_len) continue;
    float x = src[r * LD + c];
    if (row_div != nullptr) x = x / fmaxf(row_div[r], 1e-30f);
    dst[(size_t)t * rs + c] = x;
  }
}

// ---- warp-level tile products on shared memory ---------------------------
// warp_mm_abT: C[WR x N] = A[WR x K] . B[N x K]^T   (C fp32, overwritten)
// warp_mm_ab_acc: C[WR x N] += A[WR x K] . B[K x N] (C fp32, accumulated)
// A and B are row-major element tiles; LDx are row strides in elements; WR
// is the warp's rows.

template <int N, int K, int LDA, int LDB, int LDC, int WR>
__device__ __forceinline__ void warp_mm_abT(float* C, const float* A,
                                            const float* B) {
  static_assert(N % 32 == 0, "N must be a multiple of 32");
  constexpr int NC = N / 32;
  const int lane = threadIdx.x & 31;
  float acc[WR][NC];
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float b[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) b[j] = B[(lane + 32 * j) * LDB + kk];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const float a = A[r * LDA + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(a, b[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) C[r * LDC + lane + 32 * j] = acc[r][j];
}

template <int N, int K, int LDA, int LDB, int LDC, int WR>
__device__ __forceinline__ void warp_mm_ab_acc(float* C, const float* A,
                                               const float* B) {
  static_assert(N % 32 == 0, "N must be a multiple of 32");
  constexpr int NC = N / 32;
  const int lane = threadIdx.x & 31;
  float acc[WR][NC];
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = C[r * LDC + lane + 32 * j];
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float b[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) b[j] = B[kk * LDB + lane + 32 * j];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const float a = A[r * LDA + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(a, b[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < WR; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) C[r * LDC + lane + 32 * j] = acc[r][j];
}

// Sum or max of a row's partial value over the `lanes` neighbouring lanes
// that share the row (lanes = 2 or 4, consecutive lane ids).
__device__ __forceinline__ float row_max(float x, int lanes) {
  for (int o = 1; o < lanes; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x, int lanes) {
  for (int o = 1; o < lanes; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Number of streamed k tiles a causal q tile [q0, q0 + bm) can see: the
// reference's _causal_num_k (flash_attention.py:61-67) at this kernel's tile
// sizes. Tiles entirely in the future are never loaded.
__device__ __forceinline__ int causal_num_k(float q_off, float k_off, int q0,
                                            int bn, int num_k, int bm = BM) {
  const float max_q_pos = q_off + (float)(q0 + bm - 1);
  const float eff = floorf((max_q_pos - k_off) / (float)bn) + 1.f;
  return (int)fminf(fmaxf(eff, 0.f), (float)num_k);
}

// End (exclusive) of the keys that q row `row` weighs under causal masking
// when the reference tiles by block_q x block_k: block_k times the
// reference's _causal_num_k for the row's q block. It decides only rows
// with no visible key, whose o is the mean of v over these keys. block_k
// <= 0 stands for no reference tiling: every key up to Tk counts.
__device__ __forceinline__ int ref_kv_end(float q_off, float k_off, int row,
                                          int block_q, int block_k, int Tk) {
  if (block_k <= 0) return Tk;
  const float max_q_pos = q_off + (float)((row / block_q + 1) * block_q - 1);
  const float eff = floorf((max_q_pos - k_off) / (float)block_k) + 1.f;
  const int tiles = (int)fminf(fmaxf(eff, 0.f), (float)(Tk / block_k));
  return min(Tk, tiles * block_k);
}

// k tiles of bn rows a causal forward q tile [q0, q0 + bm) visits: its own
// causal count, and further, to its last row's ref_kv_end, only when the
// tile holds a row with no visible key (q_off + q0 < k_off).
__device__ __forceinline__ int fwd_num_k(float q_off, float k_off, int q0,
                                         int bn, int Tq, int Tk, int block_q,
                                         int block_k, int bm = BM) {
  int n = causal_num_k(q_off, k_off, q0, bn, (Tk + bn - 1) / bn, bm);
  if (block_k > 0 && q_off + (float)q0 < k_off) {
    const int last = min(q0 + bm, Tq) - 1;
    const int end = ref_kv_end(q_off, k_off, last, block_q, block_k, Tk);
    n = max(n, (end + bn - 1) / bn);
  }
  return n;
}

// Raise a kernel's dynamic shared-memory cap to what its launch asks for.
template <typename Kernel>
__host__ cudaError_t prepare(Kernel kernel, int smem_bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// What the card makes of a kernel at its launch configuration: info[0]
// registers per thread, info[1] local-memory (spill) bytes per thread,
// info[2] dynamic shared memory per block, info[3] resident blocks per SM.
template <typename Kernel>
__host__ int kernel_info(Kernel kernel, int threads, int smem_bytes,
                         int* info) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = prepare(kernel, smem_bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = smem_bytes;
  info[3] = blocks;
  return 0;
}

}  // namespace hvdflash

// Dispatch on (dtype, head_dim): dtype 0 = fp32, 1 = bf16, 2 = fp16;
// head_dim is the instantiated width D (ops/flash_attention.py's
// _KERNEL_DTYPES and _KERNEL_HEAD_DIMS name the same cases, lint HVL104).
#define HVD_FLASH_CASE(code, T, W, dtype, head_dim, FN, ...) \
  if ((dtype) == code && (head_dim) == W) return FN<T, W>(__VA_ARGS__)
#define HVD_FLASH_DISPATCH(dtype, head_dim, FN, ...)                          \
  do {                                                                        \
    HVD_FLASH_CASE(0, float, 32, dtype, head_dim, FN, __VA_ARGS__);           \
    HVD_FLASH_CASE(0, float, 64, dtype, head_dim, FN, __VA_ARGS__);           \
    HVD_FLASH_CASE(0, float, 128, dtype, head_dim, FN, __VA_ARGS__);          \
    HVD_FLASH_CASE(0, float, 192, dtype, head_dim, FN, __VA_ARGS__);          \
    HVD_FLASH_CASE(0, float, 256, dtype, head_dim, FN, __VA_ARGS__);          \
    HVD_FLASH_CASE(1, hvdflash::bf16, 32, dtype, head_dim, FN, __VA_ARGS__);  \
    HVD_FLASH_CASE(1, hvdflash::bf16, 64, dtype, head_dim, FN, __VA_ARGS__);  \
    HVD_FLASH_CASE(1, hvdflash::bf16, 128, dtype, head_dim, FN, __VA_ARGS__); \
    HVD_FLASH_CASE(1, hvdflash::bf16, 192, dtype, head_dim, FN, __VA_ARGS__); \
    HVD_FLASH_CASE(1, hvdflash::bf16, 256, dtype, head_dim, FN, __VA_ARGS__); \
    HVD_FLASH_CASE(2, hvdflash::f16, 32, dtype, head_dim, FN, __VA_ARGS__);   \
    HVD_FLASH_CASE(2, hvdflash::f16, 64, dtype, head_dim, FN, __VA_ARGS__);   \
    HVD_FLASH_CASE(2, hvdflash::f16, 128, dtype, head_dim, FN, __VA_ARGS__);  \
    HVD_FLASH_CASE(2, hvdflash::f16, 192, dtype, head_dim, FN, __VA_ARGS__);  \
    HVD_FLASH_CASE(2, hvdflash::f16, 256, dtype, head_dim, FN, __VA_ARGS__);  \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)
