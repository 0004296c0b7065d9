// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel.
//
// Replaces the Pallas kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (horovod_tpu/ops/flash_attention.py:118-152 and :155-201, launched by
// `_flash_bwd` at :276 and :294). Both recompute the probabilities from the
// saved log-sum-exp, p = exp(s - lse), zero on dead rows (lse <= NEG_INF/2)
// and on causally masked pairs, and use corr = dlse - rowsum(do * o)
// (computed by the caller) so that the lse output is differentiable too:
//   ds = p * (do . v^T + corr) * scale
//   dq = ds . k                      (dq kernel: one block per q tile)
//   dv = p^T . do,  dk = ds^T . q    (dk/dv kernel: one block per k tile)
// No atomics: each block owns its output rows, so results do not depend on
// scheduling order.
//
// What bounds them on an H100: at the GPT-2-small shape (B=8, T=1024, H=12,
// D=64, bf16, causal) dq needs ~19.3 GFLOP (three products over the causally
// visible pairs) against ~64 MB (q, k, v, do, lse, corr read once, dq
// written once), and dk/dv ~26 GFLOP against ~76 MB, intensities of ~300 and
// ~340 FLOP/byte, right at or above the ~295 bf16 ridge: the tensor cores
// bound them, with memory close behind. The causal tile skipping of the
// reference is kept in both.
//
// dq, bf16/fp16 (flash_bwd_dq_sm90<T, D>): one warpgroup owns 64 q rows.
// Q and dO arrive once by TMA on one mbarrier and stay in shared memory;
// each thread reads its two rows' lse and corr once, into registers. K/V
// tiles of 64 rows (32 above D = 128: dQ alone takes 128 fp32 a thread at
// D = 256) stream through a two-stage TMA ring, tile k+1 loading while tile
// k computes. Per k tile, S = Q.K^T and dP = dO.V^T run on wgmma into
// registers; ds is formed on the accumulator fragments (exp2 with scale and
// log2(e) in one FMA) and cast to k's type in place as the register A
// operand of dQ += dS.K (K read MN-major through the transpose bit). dQ
// stays in registers over the whole k loop and reaches device memory once,
// in the input type. Shared memory: 48 KB of tiles at D=64, plus barriers
// and 1 KB of alignment; 122 registers a thread with no spill, so four
// blocks fit an SM, bound by registers. At D=128 the 64-row K/V tiles still
// fit: S, dP and dQ take 128 fp32 a thread, 157 registers, two blocks per
// SM.
//
// dk/dv, bf16/fp16 (flash_bwd_dkv_sm90<T, D>): one warpgroup owns 64 k
// rows. K and V arrive once by TMA and stay in shared memory; Q/dO tiles
// (64 rows, 32 from D=128) stream through a two-stage TMA ring guarded by
// mbarriers, their lse/corr slices through the same two stages by plain
// loads one tile ahead. Per q tile, S^T = K.Q^T and dP^T = V.dO^T run on
// wgmma into registers; p and ds are formed on the accumulator fragments
// (exp2 with scale and log2(e) in one FMA) and cast to the input type in
// place, which makes them the register A operands of dV += P^T.dO and
// dK += dS^T.Q (dO and Q read MN-major through the transpose bit). dK and
// dV accumulate in registers over the whole q loop and reach device memory
// once. Shared memory: 50 KB at D=64, against 125 KB for the WMMA version
// it replaces (one block per SM then, three now, bound by 160 registers a
// thread).
// Above D = 128 the two 64 x D fp32 accumulators (256 registers a thread
// at D = 256) do not fit one thread's 255: the grid doubles along z, and a
// block of z = 0 accumulates only dV, one of z = 1 only dK (which alone
// needs dP^T). Both recompute S^T: 5 products a pair instead of 4.
//
// fp32, dq and dk/dv (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): the
// block's own tile (64 rows, 32 above D = 128) is loaded once and kept in
// shared memory, the other side is streamed through shared memory one
// 32-row tile at a time, products run on scalar fp32 FMA (no TF32) and the
// accumulators stay in shared memory.
//
// Widths: q/k/dq/dk are d wide and v/do/dv dv wide, each at most the
// instantiated D; the columns past them read as zeros (flash_common.cuh).
//
// Wide (any d and dv; *_wide_sm90<T> and the fp32 *_wide_kernel): a block
// owns one WIDE_C-column chunk of one output, picked by the grid's z, and
// streams the reductions over d and dv in WIDE_C-column chunks: S over
// q's and k's d-chunks, dP over do's and v's dv-chunks. dq: z runs over
// dq's d-chunks; per k tile, S and dP, then dQ_z += dS.K_z on k's chunk z.
// dk/dv: z runs over dV's dv-chunks, then dK's d-chunks (the SPLIT above,
// generalised); per q tile, S^T, and for dK also dP^T, then dV_z +=
// P^T.dO_z or dK_z += dS^T.Q_z. Each block recomputes the scores its
// chunk needs.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace hvdflash {

// ---- dq, fp32: scalar kernel -----------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int BMF = f32_bm(D);  // q rows of the block
  static constexpr int WR = BMF / WARPS;
  static constexpr int LPR = 32 / WR;
  static constexpr int BN = F32_BN;
  static constexpr int LDE = D + F32_PAD;
  static constexpr int LDS = BN + 4;
  static constexpr int LDP = BN + F32_PAD;
  static constexpr int LDO = D + 4;
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(BMF * LDE * 4);
  static constexpr int K = DO + align128(BMF * LDE * 4);
  static constexpr int V = K + align128(BN * LDE * 4);
  static constexpr int S = V + align128(BN * LDE * 4);
  static constexpr int DP = S + align128(BMF * LDS * 4);
  static constexpr int DS = DP + align128(BMF * LDS * 4);
  static constexpr int DQ = DS + align128(BMF * LDP * 4);
  static constexpr int BYTES = DQ + align128(BMF * LDO * 4);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ corr,
                        float* __restrict__ dq, int H, int Tq, int Tk, int d,
                        int dv, int causal, float scale, float q_off,
                        float k_off) {
  using Sm = DqSmem<D>;
  constexpr int BN = Sm::BN, BMF = Sm::BMF, WR = Sm::WR, LPR = Sm::LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + Sm::Q);
  float* sDO = reinterpret_cast<float*>(smem + Sm::DO);
  float* sK = reinterpret_cast<float*>(smem + Sm::K);
  float* sV = reinterpret_cast<float*>(smem + Sm::V);
  float* sS = reinterpret_cast<float*>(smem + Sm::S);
  float* sDP = reinterpret_cast<float*>(smem + Sm::DP);
  float* sDS = reinterpret_cast<float*>(smem + Sm::DS);
  float* sDQ = reinterpret_cast<float*>(smem + Sm::DQ);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BMF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs_qk = (size_t)H * d, rs_v = (size_t)H * dv;
  const size_t q_row = (size_t)b * Tq * H + h;
  const size_t k_row = (size_t)b * Tk * H + h;

  load_rows<BMF, D, Sm::LDE>(sQ, q + q_row * d, q0, Tq, rs_qk, d);
  load_rows<BMF, D, Sm::LDE>(sDO, dout + q_row * dv, q0, Tq, rs_v, dv);
  for (int i = threadIdx.x; i < BMF * Sm::LDO; i += THREADS) sDQ[i] = 0.f;

  const int r = lane / LPR, part = lane % LPR;
  const int row = warp * WR + r;
  const int t = q0 + row;
  const float q_pos = q_off + (float)t;
  const float lse_r = t < Tq ? lse[(size_t)bh * Tq + t] : NEG_INF;
  const float corr_r = t < Tq ? corr[(size_t)bh * Tq + t] : 0.f;
  const bool live = lse_r > NEG_INF / 2;  // fully masked rows: zero grads
  const float* wQ = sQ + warp * WR * Sm::LDE;
  const float* wDO = sDO + warp * WR * Sm::LDE;
  float* wS = sS + warp * WR * Sm::LDS;
  float* wDP = sDP + warp * WR * Sm::LDS;
  float* wDS = sDS + warp * WR * Sm::LDP;
  float* wDQ = sDQ + warp * WR * Sm::LDO;

  int num_k = (Tk + BN - 1) / BN;
  if (causal) num_k = causal_num_k(q_off, k_off, q0, BN, num_k, BMF);
  __syncthreads();

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BN;
    load_rows<BN, D, Sm::LDE>(sK, k + k_row * d, k0, Tk, rs_qk, d);
    load_rows<BN, D, Sm::LDE>(sV, v + k_row * dv, k0, Tk, rs_v, dv);
    __syncthreads();

    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wS, wQ, sK);
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wDP, wDO, sV);
    __syncwarp();
    for (int c = part; c < BN; c += LPR) {
      const int kc = k0 + c;
      float p = 0.f;
      if (live && kc < Tk && !(causal && !(q_pos >= k_off + (float)kc)))
        p = expf(wS[r * Sm::LDS + c] * scale - lse_r);
      wDS[r * Sm::LDP + c] = p * (wDP[r * Sm::LDS + c] + corr_r) * scale;
    }
    __syncwarp();
    warp_mm_ab_acc<D, BN, Sm::LDP, Sm::LDE, Sm::LDO, WR>(wDQ, wDS, sK);
    __syncthreads();
  }
  store_rows<BMF, Sm::LDO>(dq + q_row * d, sDQ, q0, Tq, rs_qk, d, nullptr);
}

// ---- dq, bf16 / fp16: TMA + wgmma kernel -----------------------------------

template <int D>
struct DqSm90 {
  static constexpr int BN = D > 128 ? 32 : 64;  // k rows per streamed tile
  static constexpr int QT = BM * D * 2;         // bytes of the Q (or dO) tile
  static constexpr int KT = BN * D * 2;         // bytes of a K (or V) tile
  static constexpr int STAGES = 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + QT;
  static constexpr int RING = DO + QT;          // stage s: K at RING + 2 s KT,
                                                // V one KT further
  static constexpr int BAR = RING + STAGES * 2 * KT;  // q/do, then stages
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;  // + alignment
};

template <typename T, int D>
__global__ void __launch_bounds__(sm90::WG)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ corr, T* __restrict__ dq,
                      int H, int Tq, int Tk, int d, int causal, float scale,
                      float q_off, float k_off) {
  using namespace sm90;
  using L = DqSm90<D>;
  constexpr int BN = L::BN;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const uint32_t sQ = smem_u32(smem + L::Q), sDO = smem_u32(smem + L::DO);

  // heads on the fast grid axis, q tiles last to first on the slow one:
  // under causal masking the last q tiles see the most k tiles, so the
  // longest blocks start first and the tail is short
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this thread's q rows (r and r + 8 of its warp's 16) and k column pair
  const int r0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;

  // the rows' lse (in log2 units) and corr, read once; rows past Tq and
  // rows with no visible key are dead: their p, ds and dq are zero
  float q_pos[2], lse2[2], corr_r[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    const float l = t < Tq ? lse[(size_t)bh * Tq + t] : NEG_INF;
    q_pos[i] = q_off + (float)t;
    live[i] = l > NEG_INF / 2;
    lse2[i] = l * LOG2E;
    corr_r[i] = t < Tq ? corr[(size_t)bh * Tq + t] : 0.f;
  }

  int num_k = (Tk + BN - 1) / BN;
  if (causal) num_k = causal_num_k(q_off, k_off, q0, BN, num_k);

  if (tid == 0) {
    for (int i = 0; i < 1 + L::STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bar[0], 2 * L::QT);
    tma_tile<D, BM>(smem + L::Q, &map_q, &bar[0], h, q0, b);
    tma_tile<D, BM>(smem + L::DO, &map_do, &bar[0], h, q0, b);
    if (num_k > 0) {
      mbar_expect(&bar[1], 2 * L::KT);
      tma_tile<D, BN>(smem + L::RING, &map_k, &bar[1], h, 0, b);
      tma_tile<D, BN>(smem + L::RING + L::KT, &map_v, &bar[1], h, 0, b);
    }
  }

  float acc_dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt & 1, k0 = kt * BN;
    if (tid == 0 && kt + 1 < num_k) {
      // the other stage was released by the __syncthreads ending tile kt-1
      unsigned char* nxt = smem + L::RING + (s ^ 1) * 2 * L::KT;
      mbar_expect(&bar[1 + (s ^ 1)], 2 * L::KT);
      tma_tile<D, BN>(nxt, &map_k, &bar[1 + (s ^ 1)], h, k0 + BN, b);
      tma_tile<D, BN>(nxt + L::KT, &map_v, &bar[1 + (s ^ 1)], h, k0 + BN, b);
    }
    mbar_wait(&bar[1 + s], (kt >> 1) & 1);
    const uint32_t sK = smem_u32(smem + L::RING + s * 2 * L::KT);
    const uint32_t sV = sK + L::KT;

    // S = Q . K^T and dP = dO . V^T
    float acc_s[BN / 2], acc_dp[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(acc_s, desc_kmajor<D, BM>(sQ, kk),
                  desc_kmajor<D, BN>(sK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(acc_dp, desc_kmajor<D, BM>(sDO, kk),
                  desc_kmajor<D, BN>(sV, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_s);
    fence_regs(acc_dp);

    // p = exp(s * scale - lse), zero on dead rows, masked pairs and keys
    // past Tk (the TMA fills them with zeros, which would give s = 0);
    // ds = p * (dp + corr) * scale
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + 8 * j + c2 + (e & 1);
        float p = 0.f;
        if (live[i] && col < Tk &&
            !(causal && !(q_pos[i] >= k_off + (float)col)))
          p = exp2f(fmaf(acc_s[4 * j + e], scale_log2, -lse2[i]));
        acc_dp[4 * j + e] = p * (acc_dp[4 * j + e] + corr_r[i]) * scale;
      }

    // dQ += dS . K (ds cast to k's dtype, K read MN-major)
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) to_a_frag<T>(dsf[kk], acc_dp, kk);
    fence_regs(acc_dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<T, D, BN>(acc_dq, dsf[kk], sK, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dq);
    __syncthreads();  // every product has read stage s: it may be refilled
  }

  const size_t rs = (size_t)H * d;
  T* dqb = dq + ((size_t)b * Tq * H + h) * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j + c2 < d)  // d is even: a pair is wholly in or out
        *reinterpret_cast<uint32_t*>(dqb + (size_t)t * rs + 8 * j + c2) =
            pack2<T>(acc_dq[4 * j + 2 * i], acc_dq[4 * j + 2 * i + 1]);
  }
}

// ---- dk/dv, fp32: scalar kernel ------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int BMF = f32_bm(D);  // k rows of the block
  static constexpr int WR = BMF / WARPS;
  static constexpr int LPR = 32 / WR;
  static constexpr int BN = F32_BN;
  static constexpr int LDE = D + F32_PAD;
  static constexpr int LDS = BN + 4;
  static constexpr int LDP = BN + F32_PAD;
  static constexpr int LDO = D + 4;
  static constexpr int K = 0;
  static constexpr int V = K + align128(BMF * LDE * 4);
  static constexpr int Q = V + align128(BMF * LDE * 4);
  static constexpr int DO = Q + align128(BN * LDE * 4);
  static constexpr int LSE = DO + align128(BN * LDE * 4);
  static constexpr int CORR = LSE + align128(BN * 4);
  static constexpr int S = CORR + align128(BN * 4);
  static constexpr int DP = S + align128(BMF * LDS * 4);
  static constexpr int P = DP + align128(BMF * LDS * 4);
  static constexpr int DS = P + align128(BMF * LDP * 4);
  static constexpr int DK = DS + align128(BMF * LDP * 4);
  static constexpr int DV = DK + align128(BMF * LDO * 4);
  static constexpr int BYTES = DV + align128(BMF * LDO * 4);
};

// First q tile (of bn rows) whose last position reaches k row k0: the
// reference's causal start of the dk/dv loop at this kernel's tile size.
__device__ __forceinline__ int dkv_start(float q_off, float k_off, int k0,
                                         int bn, int num_q) {
  const float s0 = floorf((k_off + (float)k0 - q_off) / (float)bn);
  return (int)fminf(fmaxf(s0, 0.f), (float)num_q);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ corr,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Tq, int Tk, int d, int dvw, int causal,
                         float scale, float q_off, float k_off) {
  using Sm = DkvSmem<D>;
  constexpr int BN = Sm::BN, BMF = Sm::BMF, WR = Sm::WR, LPR = Sm::LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + Sm::K);
  float* sV = reinterpret_cast<float*>(smem + Sm::V);
  float* sQ = reinterpret_cast<float*>(smem + Sm::Q);
  float* sDO = reinterpret_cast<float*>(smem + Sm::DO);
  float* sLse = reinterpret_cast<float*>(smem + Sm::LSE);
  float* sCorr = reinterpret_cast<float*>(smem + Sm::CORR);
  float* sS = reinterpret_cast<float*>(smem + Sm::S);
  float* sDP = reinterpret_cast<float*>(smem + Sm::DP);
  float* sP = reinterpret_cast<float*>(smem + Sm::P);
  float* sDS = reinterpret_cast<float*>(smem + Sm::DS);
  float* sDK = reinterpret_cast<float*>(smem + Sm::DK);
  float* sDV = reinterpret_cast<float*>(smem + Sm::DV);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BMF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs_qk = (size_t)H * d, rs_v = (size_t)H * dvw;
  const size_t q_row = (size_t)b * Tq * H + h;
  const size_t k_row = (size_t)b * Tk * H + h;

  load_rows<BMF, D, Sm::LDE>(sK, k + k_row * d, k0, Tk, rs_qk, d);
  load_rows<BMF, D, Sm::LDE>(sV, v + k_row * dvw, k0, Tk, rs_v, dvw);
  for (int i = threadIdx.x; i < BMF * Sm::LDO; i += THREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  // Rows of this warp are k rows; the LPR lanes of a row split q columns.
  const int r = lane / LPR, part = lane % LPR;
  const float k_pos = k_off + (float)(k0 + warp * WR + r);
  const float* wK = sK + warp * WR * Sm::LDE;
  const float* wV = sV + warp * WR * Sm::LDE;
  float* wS = sS + warp * WR * Sm::LDS;
  float* wDP = sDP + warp * WR * Sm::LDS;
  float* wP = sP + warp * WR * Sm::LDP;
  float* wDS = sDS + warp * WR * Sm::LDP;
  float* wDK = sDK + warp * WR * Sm::LDO;
  float* wDV = sDV + warp * WR * Sm::LDO;

  const int num_q = (Tq + BN - 1) / BN;
  const int start = causal ? dkv_start(q_off, k_off, k0, BN, num_q) : 0;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* corr_bh = corr + (size_t)bh * Tq;

  for (int qt = start; qt < num_q; ++qt) {
    const int q0 = qt * BN;
    __syncthreads();  // previous tile's readers are done with sQ/sDO/sLse
    load_rows<BN, D, Sm::LDE>(sQ, q + q_row * d, q0, Tq, rs_qk, d);
    load_rows<BN, D, Sm::LDE>(sDO, dout + q_row * dvw, q0, Tq, rs_v, dvw);
    for (int i = threadIdx.x; i < BN; i += THREADS) {
      const bool in = q0 + i < Tq;
      sLse[i] = in ? lse_bh[q0 + i] : NEG_INF;  // rows past Tq are dead
      sCorr[i] = in ? corr_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are k, columns are q
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wS, wK, sQ);
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wDP, wV, sDO);
    __syncwarp();
    for (int c = part; c < BN; c += LPR) {
      const float lse_c = sLse[c];
      float p = 0.f;
      if (lse_c > NEG_INF / 2 &&
          !(causal && !(q_off + (float)(q0 + c) >= k_pos)))
        p = expf(wS[r * Sm::LDS + c] * scale - lse_c);
      wP[r * Sm::LDP + c] = p;
      wDS[r * Sm::LDP + c] = p * (wDP[r * Sm::LDS + c] + sCorr[c]) * scale;
    }
    __syncwarp();
    warp_mm_ab_acc<D, BN, Sm::LDP, Sm::LDE, Sm::LDO, WR>(wDV, wP, sDO);
    warp_mm_ab_acc<D, BN, Sm::LDP, Sm::LDE, Sm::LDO, WR>(wDK, wDS, sQ);
  }
  __syncthreads();
  store_rows<BMF, Sm::LDO>(dk + k_row * d, sDK, k0, Tk, rs_qk, d, nullptr);
  store_rows<BMF, Sm::LDO>(dv + k_row * dvw, sDV, k0, Tk, rs_v, dvw,
                           nullptr);
}

// ---- dk/dv, bf16 / fp16: TMA + wgmma kernel --------------------------------

template <int D>
struct DkvSm90 {
  // q rows per streamed tile: 32 from D=128 keeps dK and dV (2 x 64 fp32
  // at D = 128) and the two score tiles within one thread's registers
  static constexpr int BN = D >= 128 ? 32 : 64;
  // above D = 128 a block accumulates dV (z = 0) or dK (z = 1), not both
  static constexpr bool SPLIT = D > 128;
  static constexpr int KT = BM * D * 2;      // bytes of the K (or V) tile
  static constexpr int QT = BN * D * 2;      // bytes of a Q (or dO) tile
  static constexpr int STAGES = 2;
  static constexpr int K = 0;
  static constexpr int V = K + KT;
  static constexpr int RING = V + KT;        // stage s: Q at RING + 2 s QT,
                                             // dO one QT further
  static constexpr int ROWS = RING + STAGES * 2 * QT;  // lse, corr per stage
  static constexpr int BAR = ROWS + STAGES * 2 * BN * 4;  // kv, then stages
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;  // + alignment
};

// What a dk/dv block accumulates.
enum DkvRole { DKV_BOTH = 0, DKV_DV = 1, DKV_DK = 2 };

template <typename T, int D, int ROLE>
__device__ __forceinline__ void dkv_sm90_body(
    const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const float* __restrict__ lse, const float* __restrict__ corr,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk, int d,
    int dvw, int causal, float scale, float q_off, float k_off) {
  using namespace sm90;
  using L = DkvSm90<D>;
  constexpr int BN = L::BN;
  constexpr bool WANT_DK = ROLE != DKV_DV, WANT_DV = ROLE != DKV_DK;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* sRows = reinterpret_cast<float*>(smem + L::ROWS);  // [stage][2][BN]
  const uint32_t sK = smem_u32(smem + L::K), sV = smem_u32(smem + L::V);

  // heads on the fast grid axis, k tiles first to last on the slow one:
  // under causal masking the first k tiles see the most q tiles, so the
  // longest blocks start first and the tail is short
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this thread's k rows (r and r + 8 of its warp's 16) and q column pair
  const int r0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const float k_pos[2] = {k_off + (float)(k0 + r0),
                          k_off + (float)(k0 + r0 + 8)};

  const int num_q = (Tq + BN - 1) / BN;
  const int start = causal ? dkv_start(q_off, k_off, k0, BN, num_q) : 0;
  const int n = num_q - start;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* corr_bh = corr + (size_t)bh * Tq;

  // lse and corr of q tile qt into stage s, by the first BN threads; rows
  // past Tq are dead. (Plain loads: a TMA copy of a [B*H, Tq] fp32 row
  // needs 16-byte row strides, which a ragged Tq does not give.)
  auto load_rows_of = [&](int qt, int s) {
    if (tid < BN) {
      const int t = qt * BN + tid;
      float* dst = sRows + s * 2 * BN;
      dst[tid] = t < Tq ? lse_bh[t] : NEG_INF;
      dst[BN + tid] = t < Tq ? corr_bh[t] : 0.f;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + L::STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bar[0], 2 * L::KT);
    tma_tile<D, BM>(smem + L::K, map_k, &bar[0], h, k0, b);
    tma_tile<D, BM>(smem + L::V, map_v, &bar[0], h, k0, b);
    if (n > 0) {
      mbar_expect(&bar[1], 2 * L::QT);
      tma_tile<D, BN>(smem + L::RING, map_q, &bar[1], h, start * BN, b);
      tma_tile<D, BN>(smem + L::RING + L::QT, map_do, &bar[1], h,
                      start * BN, b);
    }
  }
  if (n > 0) load_rows_of(start, 0);
  __syncthreads();

  // a role's unused accumulator is never touched and compiles away
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  mbar_wait(&bar[0], 0);

  for (int it = 0; it < n; ++it) {
    const int s = it & 1, qt = start + it, q0 = qt * BN;
    if (it + 1 < n) {
      // the other stage was released by the __syncthreads ending tile it-1
      if (tid == 0) {
        unsigned char* nxt = smem + L::RING + (s ^ 1) * 2 * L::QT;
        mbar_expect(&bar[1 + (s ^ 1)], 2 * L::QT);
        tma_tile<D, BN>(nxt, map_q, &bar[1 + (s ^ 1)], h, (qt + 1) * BN, b);
        tma_tile<D, BN>(nxt + L::QT, map_do, &bar[1 + (s ^ 1)], h,
                        (qt + 1) * BN, b);
      }
      load_rows_of(qt + 1, s ^ 1);
    }
    mbar_wait(&bar[1 + s], (it >> 1) & 1);
    const uint32_t sQ = smem_u32(smem + L::RING + s * 2 * L::QT);
    const uint32_t sDO = sQ + L::QT;
    const float* sLse = sRows + s * 2 * BN;
    const float* sCorr = sLse + BN;

    // transposed scores S^T = K . Q^T and dP^T = V . dO^T (rows k, cols q)
    float acc_s[BN / 2], acc_dp[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(acc_s, desc_kmajor<D, BM>(sK, kk),
                  desc_kmajor<D, BN>(sQ, kk), kk > 0);
    if constexpr (WANT_DK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T>(acc_dp, desc_kmajor<D, BM>(sV, kk),
                    desc_kmajor<D, BN>(sDO, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_s);
    if constexpr (WANT_DK) fence_regs(acc_dp);

    // p = exp(s * scale - lse), zero on dead columns and masked pairs;
    // ds = p * (dp + corr) * scale
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + c2 + (e & 1);
        const float lse_c = sLse[c];
        float p = 0.f;
        if (lse_c > NEG_INF / 2 &&
            !(causal && !(q_off + (float)(q0 + c) >= k_pos[e >> 1])))
          p = exp2f(fmaf(acc_s[4 * j + e], scale_log2, -lse_c * LOG2E));
        if constexpr (WANT_DK)
          acc_dp[4 * j + e] = p * (acc_dp[4 * j + e] + sCorr[c]) * scale;
        acc_s[4 * j + e] = p;
      }

    // dV += P^T . dO (p cast to do's dtype), dK += dS^T . Q (ds cast to q's)
    uint32_t pf[BN / 16][4], dsf[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (WANT_DV) to_a_frag<T>(pf[kk], acc_s, kk);
      if constexpr (WANT_DK) to_a_frag<T>(dsf[kk], acc_dp, kk);
    }
    if constexpr (WANT_DV) fence_regs(acc_dv);
    if constexpr (WANT_DK) fence_regs(acc_dk);
    wgmma_fence();
    if constexpr (WANT_DV) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<T, D, BN>(acc_dv, pf[kk], sDO, kk);
    }
    if constexpr (WANT_DK) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<T, D, BN>(acc_dk, dsf[kk], sQ, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (WANT_DV) fence_regs(acc_dv);
    if constexpr (WANT_DK) fence_regs(acc_dk);
    __syncthreads();  // stage s is read; stage s^1's lse/corr are visible
  }

  const size_t dk_base = ((size_t)b * Tk * H + h) * d;
  const size_t dv_base = ((size_t)b * Tk * H + h) * dvw;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + r0 + 8 * i;
    if (t >= Tk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + c2;  // widths are even: pairs wholly in or out
      if constexpr (WANT_DK) {
        if (col < d)
          *reinterpret_cast<uint32_t*>(dk + dk_base + (size_t)t * H * d +
                                       col) =
              pack2<T>(acc_dk[4 * j + 2 * i], acc_dk[4 * j + 2 * i + 1]);
      }
      if constexpr (WANT_DV) {
        if (col < dvw)
          *reinterpret_cast<uint32_t*>(dv + dv_base + (size_t)t * H * dvw +
                                       col) =
              pack2<T>(acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(sm90::WG)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ corr, T* __restrict__ dk,
                       T* __restrict__ dv, int H, int Tq, int Tk, int d,
                       int dvw, int causal, float scale, float q_off,
                       float k_off) {
  if constexpr (DkvSm90<D>::SPLIT) {
    if (blockIdx.z == 0)
      dkv_sm90_body<T, D, DKV_DV>(&map_q, &map_k, &map_v, &map_do, lse, corr,
                                  dk, dv, H, Tq, Tk, d, dvw, causal, scale,
                                  q_off, k_off);
    else
      dkv_sm90_body<T, D, DKV_DK>(&map_q, &map_k, &map_v, &map_do, lse, corr,
                                  dk, dv, H, Tq, Tk, d, dvw, causal, scale,
                                  q_off, k_off);
  } else {
    dkv_sm90_body<T, D, DKV_BOTH>(&map_q, &map_k, &map_v, &map_do, lse, corr,
                                  dk, dv, H, Tq, Tk, d, dvw, causal, scale,
                                  q_off, k_off);
  }
}

// ---- wide: any d and dv, the outputs in WIDE_C-column chunks over z ------

// dq, fp32: the d 256 kernel's layout, each tile holding one chunk.
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ corr,
                             float* __restrict__ dq, int H, int Tq, int Tk,
                             int d, int dv, int causal, float scale,
                             float q_off, float k_off) {
  constexpr int C = WIDE_C;
  using Sm = DqSmem<C>;
  constexpr int BN = Sm::BN, BMF = Sm::BMF, WR = Sm::WR, LPR = Sm::LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + Sm::Q);
  float* sDO = reinterpret_cast<float*>(smem + Sm::DO);
  float* sK = reinterpret_cast<float*>(smem + Sm::K);
  float* sV = reinterpret_cast<float*>(smem + Sm::V);
  float* sS = reinterpret_cast<float*>(smem + Sm::S);
  float* sDP = reinterpret_cast<float*>(smem + Sm::DP);
  float* sDS = reinterpret_cast<float*>(smem + Sm::DS);
  float* sDQ = reinterpret_cast<float*>(smem + Sm::DQ);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BMF, c_o = blockIdx.z * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs_qk = (size_t)H * d, rs_v = (size_t)H * dv;
  const float* qb = q + ((size_t)b * Tq * H + h) * d;
  const float* dob = dout + ((size_t)b * Tq * H + h) * dv;
  const float* kb = k + ((size_t)b * Tk * H + h) * d;
  const float* vb = v + ((size_t)b * Tk * H + h) * dv;
  const int nd = wide_chunks(d), ndv = wide_chunks(dv);

  for (int i = threadIdx.x; i < BMF * Sm::LDO; i += THREADS) sDQ[i] = 0.f;
  const int r = lane / LPR, part = lane % LPR;
  const int row = warp * WR + r;
  const int t = q0 + row;
  const float q_pos = q_off + (float)t;
  const float lse_r = t < Tq ? lse[(size_t)bh * Tq + t] : NEG_INF;
  const float corr_r = t < Tq ? corr[(size_t)bh * Tq + t] : 0.f;
  const bool live = lse_r > NEG_INF / 2;
  const float* wQ = sQ + warp * WR * Sm::LDE;
  const float* wDO = sDO + warp * WR * Sm::LDE;
  float* wS = sS + warp * WR * Sm::LDS;
  float* wDP = sDP + warp * WR * Sm::LDS;
  float* wDS = sDS + warp * WR * Sm::LDP;
  float* wDQ = sDQ + warp * WR * Sm::LDO;

  int num_k = (Tk + BN - 1) / BN;
  if (causal) num_k = causal_num_k(q_off, k_off, q0, BN, num_k, BMF);

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BN;
    for (int c = 0; c < nd; ++c) {  // s = q . k^T over d
      __syncthreads();
      load_rows<BMF, C, Sm::LDE>(sQ, qb + c * C, q0, Tq, rs_qk, d - c * C);
      load_rows<BN, C, Sm::LDE>(sK, kb + c * C, k0, Tk, rs_qk, d - c * C);
      __syncthreads();
      if (c == 0)
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wS, wQ, sK);
      else
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR, true>(wS, wQ, sK);
    }
    for (int c = 0; c < ndv; ++c) {  // dp = do . v^T over dv
      __syncthreads();
      load_rows<BMF, C, Sm::LDE>(sDO, dob + c * C, q0, Tq, rs_v, dv - c * C);
      load_rows<BN, C, Sm::LDE>(sV, vb + c * C, k0, Tk, rs_v, dv - c * C);
      __syncthreads();
      if (c == 0)
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wDP, wDO, sV);
      else
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR, true>(wDP, wDO,
                                                                 sV);
    }
    __syncthreads();
    load_rows<BN, C, Sm::LDE>(sK, kb + c_o, k0, Tk, rs_qk, d - c_o);
    __syncthreads();
    for (int c = part; c < BN; c += LPR) {
      const int kc = k0 + c;
      float p = 0.f;
      if (live && kc < Tk && !(causal && !(q_pos >= k_off + (float)kc)))
        p = expf(wS[r * Sm::LDS + c] * scale - lse_r);
      wDS[r * Sm::LDP + c] = p * (wDP[r * Sm::LDS + c] + corr_r) * scale;
    }
    __syncwarp();
    warp_mm_ab_acc<C, BN, Sm::LDP, Sm::LDE, Sm::LDO, WR>(wDQ, wDS, sK);
  }
  __syncthreads();
  store_rows<BMF, Sm::LDO>(dq + ((size_t)b * Tq * H + h) * d + c_o, sDQ, q0,
                           Tq, rs_qk, min(C, d - c_o), nullptr);
}

// dk/dv, fp32: the d 256 kernel's layout, each tile holding one chunk and
// sDK the one accumulator (z < chunks of dv: dV's chunk z; else dK's).
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ corr,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int H, int Tq, int Tk, int d, int dvw,
                              int causal, float scale, float q_off,
                              float k_off) {
  constexpr int C = WIDE_C;
  using Sm = DkvSmem<C>;
  constexpr int BN = Sm::BN, BMF = Sm::BMF, WR = Sm::WR, LPR = Sm::LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + Sm::K);
  float* sV = reinterpret_cast<float*>(smem + Sm::V);
  float* sQ = reinterpret_cast<float*>(smem + Sm::Q);
  float* sDO = reinterpret_cast<float*>(smem + Sm::DO);
  float* sLse = reinterpret_cast<float*>(smem + Sm::LSE);
  float* sCorr = reinterpret_cast<float*>(smem + Sm::CORR);
  float* sS = reinterpret_cast<float*>(smem + Sm::S);
  float* sDP = reinterpret_cast<float*>(smem + Sm::DP);
  float* sP = reinterpret_cast<float*>(smem + Sm::P);
  float* sAcc = reinterpret_cast<float*>(smem + Sm::DK);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BMF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nd = wide_chunks(d), ndv = wide_chunks(dvw);
  const int z = blockIdx.z;
  const bool want_dk = z >= ndv;
  const int c_o = (want_dk ? z - ndv : z) * C;
  const size_t rs_qk = (size_t)H * d, rs_v = (size_t)H * dvw;
  const float* qb = q + ((size_t)b * Tq * H + h) * d;
  const float* dob = dout + ((size_t)b * Tq * H + h) * dvw;
  const float* kb = k + ((size_t)b * Tk * H + h) * d;
  const float* vb = v + ((size_t)b * Tk * H + h) * dvw;

  for (int i = threadIdx.x; i < BMF * Sm::LDO; i += THREADS) sAcc[i] = 0.f;
  const int r = lane / LPR, part = lane % LPR;
  const float k_pos = k_off + (float)(k0 + warp * WR + r);
  const float* wK = sK + warp * WR * Sm::LDE;
  const float* wV = sV + warp * WR * Sm::LDE;
  float* wS = sS + warp * WR * Sm::LDS;
  float* wDP = sDP + warp * WR * Sm::LDS;
  float* wP = sP + warp * WR * Sm::LDP;
  float* wAcc = sAcc + warp * WR * Sm::LDO;

  const int num_q = (Tq + BN - 1) / BN;
  const int start = causal ? dkv_start(q_off, k_off, k0, BN, num_q) : 0;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* corr_bh = corr + (size_t)bh * Tq;

  for (int qt = start; qt < num_q; ++qt) {
    const int q0 = qt * BN;
    __syncthreads();  // the last tile's readers are done with sLse/sCorr
    for (int i = threadIdx.x; i < BN; i += THREADS) {
      const bool in = q0 + i < Tq;
      sLse[i] = in ? lse_bh[q0 + i] : NEG_INF;
      sCorr[i] = in ? corr_bh[q0 + i] : 0.f;
    }
    for (int c = 0; c < nd; ++c) {  // s^T = k . q^T over d
      __syncthreads();
      load_rows<BMF, C, Sm::LDE>(sK, kb + c * C, k0, Tk, rs_qk, d - c * C);
      load_rows<BN, C, Sm::LDE>(sQ, qb + c * C, q0, Tq, rs_qk, d - c * C);
      __syncthreads();
      if (c == 0)
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wS, wK, sQ);
      else
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR, true>(wS, wK, sQ);
    }
    for (int c = 0; want_dk && c < ndv; ++c) {  // dp^T = v . do^T over dv
      __syncthreads();
      load_rows<BMF, C, Sm::LDE>(sV, vb + c * C, k0, Tk, rs_v, dvw - c * C);
      load_rows<BN, C, Sm::LDE>(sDO, dob + c * C, q0, Tq, rs_v,
                                dvw - c * C);
      __syncthreads();
      if (c == 0)
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR>(wDP, wV, sDO);
      else
        warp_mm_abT<BN, C, Sm::LDE, Sm::LDE, Sm::LDS, WR, true>(wDP, wV,
                                                                 sDO);
    }
    // the other side's chunk z: q's for dK, do's for dV
    float* sB = want_dk ? sQ : sDO;
    __syncthreads();
    if (want_dk)
      load_rows<BN, C, Sm::LDE>(sB, qb + c_o, q0, Tq, rs_qk, d - c_o);
    else
      load_rows<BN, C, Sm::LDE>(sB, dob + c_o, q0, Tq, rs_v, dvw - c_o);
    __syncthreads();
    for (int c = part; c < BN; c += LPR) {  // p for dV, ds for dK
      const float lse_c = sLse[c];
      float p = 0.f;
      if (lse_c > NEG_INF / 2 &&
          !(causal && !(q_off + (float)(q0 + c) >= k_pos)))
        p = expf(wS[r * Sm::LDS + c] * scale - lse_c);
      wP[r * Sm::LDP + c] =
          want_dk ? p * (wDP[r * Sm::LDS + c] + sCorr[c]) * scale : p;
    }
    __syncwarp();
    warp_mm_ab_acc<C, BN, Sm::LDP, Sm::LDE, Sm::LDO, WR>(wAcc, wP, sB);
  }
  __syncthreads();
  if (want_dk)
    store_rows<BMF, Sm::LDO>(dk + ((size_t)b * Tk * H + h) * d + c_o, sAcc,
                             k0, Tk, rs_qk, min(C, d - c_o), nullptr);
  else
    store_rows<BMF, Sm::LDO>(dv + ((size_t)b * Tk * H + h) * dvw + c_o, sAcc,
                             k0, Tk, rs_v, min(C, dvw - c_o), nullptr);
}

// dq, bf16 / fp16: per k tile, nd steps of (q, k) chunks into S, ndv of
// (do, v) chunks into dP, then one of k's chunk z into dQ
// (sm90::WideSm90's ring).
template <typename T>
__global__ void __launch_bounds__(sm90::WG)
    flash_bwd_dq_wide_sm90(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ corr,
                           T* __restrict__ dq, int H, int Tq, int Tk, int d,
                           int dv, int causal, float scale, float q_off,
                           float k_off) {
  using namespace sm90;
  using L = WideSm90;
  constexpr int BN = L::BN, C = L::C;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM, c_o = blockIdx.z * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;

  float q_pos[2], lse2[2], corr_r[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    const float l = t < Tq ? lse[(size_t)bh * Tq + t] : NEG_INF;
    q_pos[i] = q_off + (float)t;
    live[i] = l > NEG_INF / 2;
    lse2[i] = l * LOG2E;
    corr_r[i] = t < Tq ? corr[(size_t)bh * Tq + t] : 0.f;
  }

  int num_k = (Tk + BN - 1) / BN;
  if (causal) num_k = causal_num_k(q_off, k_off, q0, BN, num_k);
  const int nd = wide_chunks(d), ndv = wide_chunks(dv);
  const int spt = nd + ndv + 1, total = num_k * spt;
  auto load = [&](int it) {
    const int kt = it / spt, j = it - kt * spt;
    if (j < nd)  // S's chunk j
      wide_load(smem, bar, it, &map_q, q0, &map_k, kt * BN, j * C, h, b);
    else if (j < nd + ndv)  // dP's chunk j - nd
      wide_load(smem, bar, it, &map_do, q0, &map_v, kt * BN, (j - nd) * C,
                h, b);
    else  // dQ's: k's chunk z
      wide_load(smem, bar, it, nullptr, 0, &map_k, kt * BN, c_o, h, b);
  };

  if (tid == 0) {
    for (int i = 0; i < L::STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && total > 0) load(0);

  float acc_dq[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc_dq[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  int it = 0;
  auto next = [&]() {
    if (tid == 0 && it + 1 < total) load(it + 1);
    mbar_wait(&bar[it & 1], (it >> 1) & 1);
    return smem_u32(smem + (it & 1) * L::STAGE);
  };

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BN;
    float acc_s[BN / 2], acc_dp[BN / 2];
    for (int j = 0; j < nd; ++j, ++it) {  // S = Q . K^T over d
      wide_ss<T>(acc_s, next(), j == 0);
      __syncthreads();
    }
    for (int j = 0; j < ndv; ++j, ++it) {  // dP = dO . V^T over dv
      wide_ss<T>(acc_dp, next(), j == 0);
      __syncthreads();
    }

    // the narrow kernel's p and ds = p * (dp + corr) * scale
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + 8 * j + c2 + (e & 1);
        float p = 0.f;
        if (live[i] && col < Tk &&
            !(causal && !(q_pos[i] >= k_off + (float)col)))
          p = exp2f(fmaf(acc_s[4 * j + e], scale_log2, -lse2[i]));
        acc_dp[4 * j + e] = p * (acc_dp[4 * j + e] + corr_r[i]) * scale;
      }

    // dQ_z += dS . K_z (ds cast to k's dtype)
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) to_a_frag<T>(dsf[kk], acc_dp, kk);
    wide_rs<T>(acc_dq, dsf, next());
    __syncthreads();
    ++it;
  }

  const size_t rs = (size_t)H * d;
  T* dqb = dq + ((size_t)b * Tq * H + h) * d + c_o;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + r0 + 8 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      if (c_o + 8 * j + c2 < d)  // d is even: a pair is wholly in or out
        *reinterpret_cast<uint32_t*>(dqb + (size_t)t * rs + 8 * j + c2) =
            pack2<T>(acc_dq[4 * j + 2 * i], acc_dq[4 * j + 2 * i + 1]);
  }
}

// dk/dv, bf16 / fp16: per q tile, nd steps of (k, q) chunks into S^T, for
// dK also ndv of (v, do) chunks into dP^T, then one of do's chunk z (dV)
// or q's (dK) into the block's accumulator.
template <typename T>
__global__ void __launch_bounds__(sm90::WG)
    flash_bwd_dkv_wide_sm90(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ corr,
                            T* __restrict__ dk, T* __restrict__ dv, int H,
                            int Tq, int Tk, int d, int dvw, int causal,
                            float scale, float q_off, float k_off) {
  using namespace sm90;
  using L = WideSm90;
  constexpr int BN = L::BN, C = L::C;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* sRows = reinterpret_cast<float*>(smem + L::ROWS);  // lse, corr

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  const float k_pos[2] = {k_off + (float)(k0 + r0),
                          k_off + (float)(k0 + r0 + 8)};
  const int nd = wide_chunks(d), ndv = wide_chunks(dvw);
  const int z = blockIdx.z;
  const bool want_dk = z >= ndv;
  const int c_o = (want_dk ? z - ndv : z) * C;

  const int num_q = (Tq + BN - 1) / BN;
  const int start = causal ? dkv_start(q_off, k_off, k0, BN, num_q) : 0;
  const int spt = nd + (want_dk ? ndv : 0) + 1;
  const int total = (num_q - start) * spt;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* corr_bh = corr + (size_t)bh * Tq;
  auto load = [&](int it) {
    const int qt = start + it / spt, j = it % spt;
    if (j < nd)  // S^T's chunk j
      wide_load(smem, bar, it, &map_k, k0, &map_q, qt * BN, j * C, h, b);
    else if (j < spt - 1)  // dP^T's chunk j - nd
      wide_load(smem, bar, it, &map_v, k0, &map_do, qt * BN, (j - nd) * C,
                h, b);
    else  // the accumulator's: q's (dK) or do's (dV) chunk z
      wide_load(smem, bar, it, nullptr, 0, want_dk ? &map_q : &map_do,
                qt * BN, c_o, h, b);
  };

  if (tid == 0) {
    for (int i = 0; i < L::STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && total > 0) load(0);

  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  float acc_s[BN / 2], acc_dp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc_dp[i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  int it = 0;
  auto next = [&]() {
    if (tid == 0 && it + 1 < total) load(it + 1);
    mbar_wait(&bar[it & 1], (it >> 1) & 1);
    return smem_u32(smem + (it & 1) * L::STAGE);
  };

  for (int qt = start; qt < num_q; ++qt) {
    const int q0 = qt * BN;
    // this tile's lse and corr; the last tile's readers passed the
    // __syncthreads ending its last step, and the first step's below
    // publishes them
    if (tid < BN) {
      const int t = q0 + tid;
      sRows[tid] = t < Tq ? lse_bh[t] : NEG_INF;
      sRows[BN + tid] = t < Tq ? corr_bh[t] : 0.f;
    }
    for (int j = 0; j < nd; ++j, ++it) {  // S^T = K . Q^T over d
      wide_ss<T>(acc_s, next(), j == 0);
      __syncthreads();
    }
    for (int j = 0; want_dk && j < ndv; ++j, ++it) {  // dP^T = V . dO^T
      wide_ss<T>(acc_dp, next(), j == 0);
      __syncthreads();
    }

    // p for dV, ds = p * (dp + corr) * scale for dK, into acc_s
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + c2 + (e & 1);
        const float lse_c = sRows[c];
        float p = 0.f;
        if (lse_c > NEG_INF / 2 &&
            !(causal && !(q_off + (float)(q0 + c) >= k_pos[e >> 1])))
          p = exp2f(fmaf(acc_s[4 * j + e], scale_log2, -lse_c * LOG2E));
        if (want_dk) p = p * (acc_dp[4 * j + e] + sRows[BN + c]) * scale;
        acc_s[4 * j + e] = p;
      }
    uint32_t f[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) to_a_frag<T>(f[kk], acc_s, kk);
    wide_rs<T>(acc, f, next());
    __syncthreads();
    ++it;
  }

  T* out = want_dk ? dk : dv;
  const int w = want_dk ? d : dvw;
  const size_t base = ((size_t)b * Tk * H + h) * w + c_o;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + r0 + 8 * i;
    if (t >= Tk) continue;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      if (c_o + 8 * j + c2 < w)  // widths are even: pairs wholly in or out
        *reinterpret_cast<uint32_t*>(out + base + (size_t)t * H * w + 8 * j +
                                     c2) =
            pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <typename T>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* corr, void* dq, int B, int H, int Tq,
                           int Tk, int d, int dv, int causal, float scale,
                           float q_off, float k_off, cudaStream_t stream) {
  if (d < 1 || dv < 1) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    using Sm = DqSmem<WIDE_C>;
    cudaError_t err = prepare(flash_bwd_dq_wide_kernel, Sm::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tq + Sm::BMF - 1) / Sm::BMF, wide_chunks(d));
    flash_bwd_dq_wide_kernel<<<grid, THREADS, Sm::BYTES, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(corr),
        static_cast<float*>(dq), H, Tq, Tk, d, dv, causal, scale, q_off,
        k_off);
  } else {
    using L = sm90::WideSm90;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err = sm90::make_map<T>(&mq, q, B, Tq, H, d, L::C, BM);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mdo, dout, B, Tq, H, dv, L::C, BM);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mk, k, B, Tk, H, d, L::C, L::BN);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mv, v, B, Tk, H, dv, L::C, L::BN);
    if (err == cudaSuccess)
      err = prepare(flash_bwd_dq_wide_sm90<T>, L::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tq + BM - 1) / BM, wide_chunks(d));
    flash_bwd_dq_wide_sm90<T><<<grid, sm90::WG, L::BYTES, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse),
        static_cast<const float*>(corr), static_cast<T*>(dq), H, Tq, Tk, d,
        dv, causal, scale, q_off, k_off);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* corr, void* dk, void* dv, int B,
                            int H, int Tq, int Tk, int d, int dvw, int causal,
                            float scale, float q_off, float k_off,
                            cudaStream_t stream) {
  if (d < 1 || dvw < 1) return cudaErrorInvalidValue;
  const int nz = wide_chunks(dvw) + wide_chunks(d);
  if constexpr (std::is_same<T, float>::value) {
    using Sm = DkvSmem<WIDE_C>;
    cudaError_t err = prepare(flash_bwd_dkv_wide_kernel, Sm::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tk + Sm::BMF - 1) / Sm::BMF, nz);
    flash_bwd_dkv_wide_kernel<<<grid, THREADS, Sm::BYTES, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(corr),
        static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, d, dvw,
        causal, scale, q_off, k_off);
  } else {
    using L = sm90::WideSm90;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err = sm90::make_map<T>(&mq, q, B, Tq, H, d, L::C, L::BN);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mdo, dout, B, Tq, H, dvw, L::C, L::BN);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mk, k, B, Tk, H, d, L::C, BM);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mv, v, B, Tk, H, dvw, L::C, BM);
    if (err == cudaSuccess)
      err = prepare(flash_bwd_dkv_wide_sm90<T>, L::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tk + BM - 1) / BM, nz);
    flash_bwd_dkv_wide_sm90<T><<<grid, sm90::WG, L::BYTES, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse),
        static_cast<const float*>(corr), static_cast<T*>(dk),
        static_cast<T*>(dv), H, Tq, Tk, d, dvw, causal, scale, q_off, k_off);
  }
  return cudaGetLastError();
}

template <typename T>
int info_bwd_wide(int which, int* info) {
  if constexpr (std::is_same<T, float>::value) {
    if (which == 0)
      return kernel_info(flash_bwd_dq_wide_kernel, THREADS,
                         DqSmem<WIDE_C>::BYTES, info);
    return kernel_info(flash_bwd_dkv_wide_kernel, THREADS,
                       DkvSmem<WIDE_C>::BYTES, info);
  } else {
    if (which == 0)
      return kernel_info(flash_bwd_dq_wide_sm90<T>, sm90::WG,
                         sm90::WideSm90::BYTES, info);
    return kernel_info(flash_bwd_dkv_wide_sm90<T>, sm90::WG,
                       sm90::WideSm90::BYTES, info);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* corr,
                      void* dq, int B, int H, int Tq, int Tk, int d, int dv,
                      int causal, float scale, float q_off, float k_off,
                      cudaStream_t stream) {
  if (d < 1 || dv < 1 || d > D || dv > D) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    using Sm = DqSmem<D>;
    constexpr int bytes = Sm::BYTES;
    cudaError_t err = prepare(flash_bwd_dq_kernel<D>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tq + Sm::BMF - 1) / Sm::BMF);
    flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(corr),
        static_cast<float*>(dq), H, Tq, Tk, d, dv, causal, scale, q_off,
        k_off);
  } else {
    using L = DqSm90<D>;
    constexpr int bytes = L::BYTES;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err = sm90::make_map<T>(&mq, q, B, Tq, H, d, D, BM);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mdo, dout, B, Tq, H, dv, D, BM);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mk, k, B, Tk, H, d, D, L::BN);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mv, v, B, Tk, H, dv, D, L::BN);
    if (err == cudaSuccess) err = prepare(flash_bwd_dq_sm90<T, D>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tq + BM - 1) / BM);
    flash_bwd_dq_sm90<T, D><<<grid, sm90::WG, bytes, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse),
        static_cast<const float*>(corr), static_cast<T*>(dq), H, Tq, Tk, d,
        causal, scale, q_off, k_off);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* corr,
                       void* dk, void* dv, int B, int H, int Tq, int Tk,
                       int d, int dvw, int causal, float scale, float q_off,
                       float k_off, cudaStream_t stream) {
  if (d < 1 || dvw < 1 || d > D || dvw > D) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    using Sm = DkvSmem<D>;
    dim3 grid(B * H, (Tk + Sm::BMF - 1) / Sm::BMF);
    constexpr int bytes = Sm::BYTES;
    cudaError_t err = prepare(flash_bwd_dkv_kernel<D>, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(corr),
        static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, d, dvw,
        causal, scale, q_off, k_off);
  } else {
    using L = DkvSm90<D>;
    constexpr int bytes = L::BYTES;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err = sm90::make_map<T>(&mq, q, B, Tq, H, d, D, L::BN);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mdo, dout, B, Tq, H, dvw, D, L::BN);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mk, k, B, Tk, H, d, D, BM);
    if (err == cudaSuccess)
      err = sm90::make_map<T>(&mv, v, B, Tk, H, dvw, D, BM);
    if (err == cudaSuccess) err = prepare(flash_bwd_dkv_sm90<T, D>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tk + BM - 1) / BM, L::SPLIT ? 2 : 1);
    flash_bwd_dkv_sm90<T, D><<<grid, sm90::WG, bytes, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse),
        static_cast<const float*>(corr), static_cast<T*>(dk),
        static_cast<T*>(dv), H, Tq, Tk, d, dvw, causal, scale, q_off, k_off);
  }
  return cudaGetLastError();
}

template <typename T, int D>
int info_bwd(int which, int* info) {
  if constexpr (std::is_same<T, float>::value) {
    if (which == 0)
      return kernel_info(flash_bwd_dq_kernel<D>, THREADS, DqSmem<D>::BYTES,
                         info);
    return kernel_info(flash_bwd_dkv_kernel<D>, THREADS, DkvSmem<D>::BYTES,
                       info);
  } else {
    if (which == 0)
      return kernel_info(flash_bwd_dq_sm90<T, D>, sm90::WG,
                         DqSm90<D>::BYTES, info);
    return kernel_info(flash_bwd_dkv_sm90<T, D>, sm90::WG,
                       DkvSm90<D>::BYTES, info);
  }
}

}  // namespace hvdflash

// Registers, spill bytes, shared memory and blocks per SM of the dq
// (which = 0) or dk/dv (which = 1) kernel; see hvdflash::kernel_info.
extern "C" int hvd_flash_bwd_info(int which, int dtype, int head_dim,
                                  int* info) {
  using hvdflash::info_bwd;
  using hvdflash::info_bwd_wide;
  HVD_FLASH_DISPATCH(dtype, head_dim, info_bwd, which, info);
}

// head_dim: the instantiated width D, or HVD_FLASH_WIDE (any d and dv);
// d and dv: the widths of q/k/dq and of v/do, each at most D.
extern "C" int hvd_flash_bwd_dq(int dtype, int head_dim, int d, int dv,
                                const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* corr, void* dq, int B, int H,
                                int Tq, int Tk, int causal, float scale,
                                float q_off, float k_off, void* stream) {
  using hvdflash::launch_dq;
  using hvdflash::launch_dq_wide;
  HVD_FLASH_DISPATCH(dtype, head_dim, launch_dq, q, k, v, dout, lse, corr,
                     dq, B, H, Tq, Tk, d, dv, causal, scale, q_off, k_off,
                     static_cast<cudaStream_t>(stream));
}

// head_dim: the instantiated width D, or HVD_FLASH_WIDE (any d and dv);
// d and dv: the widths of q/k/dk and of v/do/dv, each at most D.
extern "C" int hvd_flash_bwd_dkv(int dtype, int head_dim, int d, int dv,
                                 const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* corr, void* dk, void* dvp,
                                 int B, int H, int Tq, int Tk, int causal,
                                 float scale, float q_off, float k_off,
                                 void* stream) {
  using hvdflash::launch_dkv;
  using hvdflash::launch_dkv_wide;
  HVD_FLASH_DISPATCH(dtype, head_dim, launch_dkv, q, k, v, dout, lse, corr,
                     dk, dvp, B, H, Tq, Tk, d, dv, causal, scale, q_off,
                     k_off, static_cast<cudaStream_t>(stream));
}
