// Hopper (sm_90a) building blocks of the flash kernels' bf16 and fp16
// paths: TMA tile loads completing on mbarriers, and warpgroup matrix
// products (wgmma) with fp32 accumulators in registers. Every helper that
// touches the 16-bit type takes it as T (bf16 or f16): the two differ only
// in wgmma's type suffix, the tensor map's data type and the pack of two
// floats.
//
// Shared-memory tiles. A [rows x D] 16-bit tile arrives by TMA as D / PW
// panels of [rows x PW] (PW = min(D, 64) elements, so a panel row is 64 or
// 128 bytes), each swizzled by the TMA in the pattern of its row width. A
// tensor narrower than D (width w < D) arrives zero-filled past column w:
// the TMA fills what lies outside the tensor. A panel is the canonical
// wgmma layout for either operand order:
//   K-major (the product's depth runs along the row, as for Q.K^T):
//     rows in groups of 8 at stride SBO = 8 * row bytes; a k16 slice starts
//     32 bytes further along the row;
//   MN-major (the depth runs down the rows, as V is read by P.V):
//     8-row groups at stride SBO = 8 * row bytes, and LBO = the panel size
//     from one PW-wide block of columns to the next; a k16 slice starts
//     16 rows further down.
// Every panel starts on a 1024-byte boundary, which the swizzle needs.
//
// Accumulator layout of m64nN (fp32), thread t of the warpgroup, warp
// w = t / 32, lane l: d[4j + e] holds row 16w + l/4 + 8 * (e / 2), column
// 8j + 2 * (l % 4) + e % 2. The register A operand of m64k16 has the same
// layout in 16-bit pairs, so a score tile turns into the A operand of the
// next product without leaving registers (to_a_frag). Columns [64p, 64p +
// 64) of an m64nN accumulator are d[32p .. 32p + 31]: a product wider than
// 128 runs as one m64n64 product per 64-column panel (rs_panels).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace hvdflash {
namespace sm90 {

constexpr int WG = 128;  // threads of a warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to a 1024-byte boundary (launches
// ask for 1024 bytes more than they use).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of TMA traffic on this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
  __syncwarp();  // the warp leaves together, as wgmma's .aligned needs
}

// ---- TMA -----------------------------------------------------------------

// One box of a 4-D tensor map (D, H, T, B) at coordinates (c0, h, t, b)
// into shared memory; completion is counted on `bar`. Rows past T arrive
// as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(h), "r"(t), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// A [ROWS x D] tile of one (batch, head) slice, rows [t0, t0 + ROWS) and
// columns [c0, c0 + D), as D / PW panels; columns past the tensor's width
// arrive as zeros (a panel wholly past it too), and the caller's mbarrier
// expects ROWS * D * 2 bytes whatever the width.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int h, int t0, int b, int c0 = 0) {
  constexpr int PW = D < 64 ? D : 64;
#pragma unroll
  for (int p = 0; p < D / PW; ++p)
    tma_load(dst + p * ROWS * PW * 2, map, bar, c0 + p * PW, h, t0, b);
}

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}

// Shared-memory matrix descriptor of a swizzled panel with rows of RB bytes
// (64 or 128: the swizzle span), starting at shared address `addr`.
template <int RB>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  static_assert(RB == 64 || RB == 128, "panel rows are 64 or 128 bytes");
  constexpr uint64_t layout = RB == 128 ? 1 : 2;  // SWIZZLE_128B / _64B
  return desc_field(addr) | (desc_field(lbo) << 16) |
         (desc_field(8 * RB) << 32) | (layout << 62);
}

// K-major operand: k16 slice `kk` of a [ROWS x D] tile (depth along D).
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  constexpr int PW = D < 64 ? D : 64, RB = PW * 2;
  const int col = kk * 16;
  return make_desc<RB>(tile + (col / PW) * ROWS * RB + (col % PW) * 2, 16);
}

// MN-major operand: k16 slice `kk` of a [ROWS x D] tile (depth along the
// rows, D the product's N).
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  constexpr int PW = D < 64 ? D : 64, RB = PW * 2;
  return make_desc<RB>(tile + kk * 16 * RB, ROWS * RB);
}

// Two floats as a pair of T, rounded to nearest even.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Columns [16 kk, 16 kk + 16) of an m64nN fp32 accumulator as the A
// fragment (in T) of an m64k16 product.
template <typename T, int N>
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&d)[N], int kk) {
  const int j = 8 * kk;
  a[0] = pack2<T>(d[j + 0], d[j + 1]);
  a[1] = pack2<T>(d[j + 2], d[j + 3]);
  a[2] = pack2<T>(d[j + 4], d[j + 5]);
  a[3] = pack2<T>(d[j + 6], d[j + 7]);
}

// The wgmma instructions, written once for both 16-bit types: TY is the
// type suffix ("bf16" or "f16"). ACC8(o) binds accumulator registers
// d[OFF + o .. OFF + o + 7].
#define HVD_ACC8(o)                                                       \
  "+f"(d[OFF + (o) + 0]), "+f"(d[OFF + (o) + 1]), "+f"(d[OFF + (o) + 2]), \
      "+f"(d[OFF + (o) + 3]), "+f"(d[OFF + (o) + 4]),                     \
      "+f"(d[OFF + (o) + 5]), "+f"(d[OFF + (o) + 6]), "+f"(d[OFF + (o) + 7])
#define HVD_REGS16                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HVD_REGS32                                                        \
  HVD_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "  \
             "%27, %28, %29, %30, %31"
#define HVD_REGS64                                                        \
  HVD_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
             "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
             "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d[64 x 32] = A[64 x 16] . B[16 x 32] (+ d when accumulate), A and B
// K-major in shared memory.
#define HVD_WGMMA_SS_N32(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY    \
               " {" HVD_REGS16 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"         \
               : HVD_ACC8(0), HVD_ACC8(8)                                 \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
// d[64 x 64], the same.
#define HVD_WGMMA_SS_N64(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " {" HVD_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"         \
               : HVD_ACC8(0), HVD_ACC8(8), HVD_ACC8(16), HVD_ACC8(24)     \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
// d[64 x N] += A[64 x 16] . B[16 x N], A from registers (a fragment in the
// accumulator layout), B MN-major in shared memory (transpose bit set).
#define HVD_WGMMA_RS_N32(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY    \
               " {" HVD_REGS16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, "  \
               "1;\n}\n"                                                  \
               : HVD_ACC8(0), HVD_ACC8(8)                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
                 "n"(1))
#define HVD_WGMMA_RS_N64(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " {" HVD_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, "  \
               "1;\n}\n"                                                  \
               : HVD_ACC8(0), HVD_ACC8(8), HVD_ACC8(16), HVD_ACC8(24)     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
                 "n"(1))
#define HVD_WGMMA_RS_N128(TY)                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
               " {" HVD_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, "  \
               "1;\n}\n"                                                  \
               : HVD_ACC8(0), HVD_ACC8(8), HVD_ACC8(16), HVD_ACC8(24),    \
                 HVD_ACC8(32), HVD_ACC8(40), HVD_ACC8(48), HVD_ACC8(56)   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
                 "n"(1))

template <typename T>
__host__ __device__ constexpr bool is_f16() {
  return std::is_same<T, f16>::value;
}

// S-type products: d[64 x 32] or d[64 x 64] from two K-major operands.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  constexpr int OFF = 0;
  if constexpr (is_f16<T>()) HVD_WGMMA_SS_N32("f16");
  else HVD_WGMMA_SS_N32("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  constexpr int OFF = 0;
  if constexpr (is_f16<T>()) HVD_WGMMA_SS_N64("f16");
  else HVD_WGMMA_SS_N64("bf16");
}

// O-type products into columns [OFF / 2 * ... ) of an accumulator d: the
// n32, n64 and n128 forms on d[OFF ..].
template <typename T, int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[N],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  if constexpr (is_f16<T>()) HVD_WGMMA_RS_N32("f16");
  else HVD_WGMMA_RS_N32("bf16");
}
template <typename T, int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[N],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  if constexpr (is_f16<T>()) HVD_WGMMA_RS_N64("f16");
  else HVD_WGMMA_RS_N64("bf16");
}
template <typename T, int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  if constexpr (is_f16<T>()) HVD_WGMMA_RS_N128("f16");
  else HVD_WGMMA_RS_N128("bf16");
}

// Above N = 128: one m64n64 product per 64-column panel P of the B tile,
// into accumulator columns [64 P, 64 P + 64).
template <typename T, int D, int ROWS, int P = 0>
__device__ __forceinline__ void rs_panels(float (&d)[D / 2],
                                          const uint32_t (&a)[4],
                                          uint32_t tile, int kk) {
  if constexpr (P < D / 64) {
    wgmma_rs_n64<T, 32 * P>(
        d, a, make_desc<128>(tile + P * ROWS * 128 + kk * 16 * 128,
                             ROWS * 128));
    rs_panels<T, D, ROWS, P + 1>(d, a, tile, kk);
  }
}

// d[64 x D] += A[64 x 16] . B[16 x D]: k16 slice `kk` of the [ROWS x D]
// tile at `tile` (MN-major) against the register fragment a.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t tile, int kk) {
  if constexpr (D == 32)
    wgmma_rs_n32<T, 0>(d, a, desc_mnmajor<D, ROWS>(tile, kk));
  else if constexpr (D == 64)
    wgmma_rs_n64<T, 0>(d, a, desc_mnmajor<D, ROWS>(tile, kk));
  else if constexpr (D == 128)
    wgmma_rs_n128<T, 0>(d, a, desc_mnmajor<D, ROWS>(tile, kk));
  else
    rs_panels<T, D, ROWS>(d, a, tile, kk);
}

// ---- the wide kernels' ring ------------------------------------------------
// Above head width 256 a block owns one WIDE_C-column chunk of its output
// (blockIdx.z) and runs a sequence of steps, each on one stage of a
// two-stage TMA ring: a step holds an A tile (the block's own 64 rows) and
// a B tile (BN streamed rows), both WIDE_C columns of one chunk, or a B
// tile alone. Step `it` uses stage it & 1; its loads are issued at the
// start of step it - 1, whose stage the __syncthreads ending step it - 2
// released. WIDE_C = 256 keeps the register shape of the d 256
// instantiations: a 64 x 256 fp32 accumulator and 32-column score tiles.
struct WideSm90 {
  static constexpr int C = WIDE_C;
  static constexpr int BN = 32;                 // rows of a B tile
  static constexpr int AT = BM * C * 2;         // bytes of an A tile
  static constexpr int BT = BN * C * 2;         // bytes of a B tile
  static constexpr int STAGE = AT + BT;         // A, then B
  static constexpr int STAGES = 2;
  static constexpr int ROWS = STAGES * STAGE;   // lse, corr of a q tile
  static constexpr int BAR = ROWS + 2 * BN * 4;
  static constexpr int BYTES = BAR + 8 * STAGES + 1024;  // + alignment
};

// Issue step `it`'s loads (one thread): columns [c0, c0 + C) of rows
// [a_t0, a_t0 + 64) of map_a (none when map_a is null) and of rows
// [b_t0, b_t0 + BN) of map_b.
__device__ __forceinline__ void wide_load(unsigned char* smem, uint64_t* bar,
                                          int it, const CUtensorMap* map_a,
                                          int a_t0, const CUtensorMap* map_b,
                                          int b_t0, int c0, int h, int b) {
  using L = WideSm90;
  unsigned char* st = smem + (it & 1) * L::STAGE;
  uint64_t* br = &bar[it & 1];
  mbar_expect(br, (map_a != nullptr ? L::AT : 0) + L::BT);
  if (map_a != nullptr) tma_tile<L::C, BM>(st, map_a, br, h, a_t0, b, c0);
  tma_tile<L::C, L::BN>(st + L::AT, map_b, br, h, b_t0, b, c0);
}

// acc (+)= A . B^T over the chunk in the stage at shared address `st`
// (both tiles K-major); `first` overwrites acc. Each 64 columns of the
// reduction are summed by wgmma into a fresh accumulator and added to acc
// in fp32: wgmma's own accumulation over a long reduction drifts (over
// d 768 in one accumulator, dq in rows that see one key read 4.4e-6 from
// float64 against the plain version's 1.1e-6; partial sums of 64 columns
// read 0.8e-6, PERF.md §6).
template <typename T>
__device__ __forceinline__ void wide_ss(float (&acc)[WideSm90::BN / 2],
                                        uint32_t st, bool first) {
  using L = WideSm90;
  constexpr int PS = 4;  // k16 slices of one partial sum: 64 columns
#pragma unroll
  for (int p = 0; p < L::C / 16 / PS; ++p) {
    float part[L::BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = p * PS; kk < (p + 1) * PS; ++kk)
      wgmma_ss<T>(part, desc_kmajor<L::C, BM>(st, kk),
                  desc_kmajor<L::C, L::BN>(st + L::AT, kk), kk > p * PS);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < L::BN / 2; ++i)
      acc[i] = first && p == 0 ? part[i] : acc[i] + part[i];
  }
}

// acc[64 x C] += F . B over the B tile in the stage at `st` (MN-major),
// F the BN-column fragments f.
template <typename T>
__device__ __forceinline__ void wide_rs(float (&acc)[WideSm90::C / 2],
                                        const uint32_t (&f)[WideSm90::BN / 16]
                                                           [4],
                                        uint32_t st) {
  using L = WideSm90;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk)
    wgmma_rs<T, L::C, L::BN>(acc, f[kk], st + L::AT, kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a [B, T, H, W] 16-bit tensor read in place, as the 4-D
// array (W, H, T, B), with a box of one head's [ROWS x PW] panel of a
// D-wide tile (PW = min(D, 64)); W above D is read in D-column chunks
// (tma_tile's c0). Rows past T and columns past W read as zeros and never
// reach into the next head or batch. W * 2 bytes must be a multiple of 16
// (the TMA's stride rule).
template <typename T>
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B,
                            int Tlen, int H, int W, int D, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if ((W * 2) % 16 != 0) return cudaErrorInvalidValue;
  const int pw = D < 64 ? D : 64;
  cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Tlen,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                           (cuuint64_t)Tlen * H * W * 2};
  cuuint32_t box[4] = {(cuuint32_t)pw, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult rc = encode(
      map,
      is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace hvdflash
