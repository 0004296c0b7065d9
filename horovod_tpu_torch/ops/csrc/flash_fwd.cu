// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fwd_kernel`
// (horovod_tpu/ops/flash_attention.py:70-115, launched by `_flash_fwd` at
// :229). For one 64-row q tile it streams K/V tiles, keeps the online-softmax
// state (running max m, sum l, fp32 accumulator o) on chip, and writes o and
// the per-row log-sum-exp. The causal mask is in global positions
// q_off + i >= k_off + j with runtime fp32 offsets; k tiles entirely in the
// tile's future are never loaded.
//
// Rows with no visible key (a negative q_off) get what the reference gives
// them: lse = NEG_INF and o = the mean of v over the keys its tiling visits
// for the row's q block, ref_kv_end (flash_common.cuh) from block_q and
// block_k. Keys at or past that end weigh nothing (-inf, as keys past a
// ragged Tk); a q tile loops past its own causal tile count only when it
// holds such a row, so live rows and the main path do no extra work.
//
// What bounds it on an H100: at the GPT-2-small shape (B=8, T=1024, H=12,
// D=64, bf16, causal) the function needs ~12.9 GFLOP against ~51 MB of
// input and output, an intensity of ~255 FLOP/byte, just under the card's
// ~295 bf16 FLOP/byte ridge: memory first, tensor cores a close second.
//
// bf16 design (flash_fwd_sm90): one warpgroup per 64 q rows. Q arrives once
// by TMA; K/V tiles of 64 rows arrive by TMA into a two-stage ring guarded by
// mbarriers, tile k+1 loading while tile k computes. S = Q.K^T runs on wgmma
// (both operands from swizzled shared memory) into registers; the online
// softmax works on the accumulator fragment (quad shuffles for the row max,
// exp2 with the scale and log2(e) folded into one multiply), O is rescaled
// in registers, P is cast to bf16 in the accumulator layout and fed back as
// the register A operand of O += P.V (V read MN-major through the transpose
// bit). O is divided by l once, in the epilogue. Shared memory: 8 KB of Q and
// 2 x 16 KB of K/V at D=64, against 71.9 KB for the WMMA version it
// replaces; four blocks fit an SM, bound by 119 registers a thread.
//
// fp32 design (flash_fwd_kernel): scalar full-fp32 FMA (the reference's fp32
// tolerances rule out TF32), two lanes per row, tiles through shared memory.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace hvdflash {

// ---- fp32: scalar kernel ---------------------------------------------------

template <int D>
struct FwdSmem {
  using T = float;
  static constexpr int BN = F32_BN;
  static constexpr int LDE = D + F32_PAD;   // q/k/v tiles
  static constexpr int LDS = BN + 4;            // fp32 scores
  static constexpr int LDP = BN + F32_PAD;  // probabilities
  static constexpr int LDO = D + 4;             // fp32 accumulator
  static constexpr int ES = (int)sizeof(T);
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BM * LDE * ES);
  static constexpr int V = K + align128(BN * LDE * ES);
  static constexpr int S = V + align128(BN * LDE * ES);
  static constexpr int P = S + align128(BM * LDS * 4);
  static constexpr int O = P + align128(BM * LDP * ES);
  static constexpr int L = O + align128(BM * LDO * 4);
  static constexpr int BYTES = L + align128(BM * 4);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     int causal, float scale, float q_off, float k_off,
                     int block_q, int block_k) {
  using T = float;
  using Sm = FwdSmem<D>;
  constexpr int BN = Sm::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + Sm::Q);
  T* sK = reinterpret_cast<T*>(smem + Sm::K);
  T* sV = reinterpret_cast<T*>(smem + Sm::V);
  float* sS = reinterpret_cast<float*>(smem + Sm::S);
  T* sP = reinterpret_cast<T*>(smem + Sm::P);
  float* sO = reinterpret_cast<float*>(smem + Sm::O);
  float* sL = reinterpret_cast<float*>(smem + Sm::L);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * D;
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * Tk * H + h) * D;
  const T* vb = v + ((size_t)b * Tk * H + h) * D;

  load_rows<BM, D, Sm::LDE>(sQ, qb, q0, Tq, rs);
  for (int i = threadIdx.x; i < BM * Sm::LDO; i += THREADS) sO[i] = 0.f;

  // Two lanes per row: lane (r, half) owns columns half, half + 2, ...
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * WROWS + r;
  const float q_pos = q_off + (float)(q0 + row);
  const T* wQ = sQ + warp * WROWS * Sm::LDE;
  float* wS = sS + warp * WROWS * Sm::LDS;
  T* wP = sP + warp * WROWS * Sm::LDP;
  float* wO = sO + warp * WROWS * Sm::LDO;
  float m = NEG_INF, l = 0.f;

  int num_k = (Tk + BN - 1) / BN;
  int kv_end = Tk;
  if (causal) {
    num_k = fwd_num_k(q_off, k_off, q0, BN, Tq, Tk, block_q, block_k);
    kv_end = ref_kv_end(q_off, k_off, q0 + row, block_q, block_k, Tk);
  }
  __syncthreads();

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BN;
    load_rows<BN, D, Sm::LDE>(sK, kb, k0, Tk, rs);
    load_rows<BN, D, Sm::LDE>(sV, vb, k0, Tk, rs);
    __syncthreads();

    // s = (q . k^T) * scale, scale after the product as in the reference
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS>(wS, wQ, sK);
    __syncwarp();
    float mx = -INFINITY;
    for (int c = half; c < BN; c += 2) {
      const int kc = k0 + c;
      float s = wS[r * Sm::LDS + c] * scale;
      if (kc >= kv_end)
        s = -INFINITY;  // past the end of k or of the reference's tiles
      else if (causal && !(q_pos >= k_off + (float)kc))
        s = NEG_INF;    // masked as the reference masks
      wS[r * Sm::LDS + c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int c = half; c < BN; c += 2) {
      const float p = expf(wS[r * Sm::LDS + c] - m_new);
      sum += p;
      wP[r * Sm::LDP + c] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    for (int c = half; c < D; c += 2) wO[r * Sm::LDO + c] *= alpha;
    __syncwarp();
    warp_mm_ab_acc<D, BN, Sm::LDP, Sm::LDE, Sm::LDO>(wO, wP, sV);
    __syncthreads();  // sK/sV are overwritten by the next tile
  }

  if (half == 0) {
    sL[row] = l;
    if (q0 + row < Tq)
      lse[(size_t)bh * Tq + q0 + row] =
          l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : NEG_INF;
  }
  __syncthreads();
  store_rows<D, Sm::LDO>(o + ((size_t)b * Tq * H + h) * D, sO, q0, Tq, rs,
                           sL);
}

// ---- bf16: TMA + wgmma kernel ----------------------------------------------

template <int D>
struct FwdSm90 {
  static constexpr int BN = 64;              // k rows per streamed tile
  static constexpr int TILE = BM * D * 2;    // bytes of a 64-row tile
  static constexpr int STAGES = 2;
  static constexpr int Q = 0;
  static constexpr int KV = Q + TILE;        // stage s: K at KV + 2 s TILE,
                                             // V one TILE further
  static constexpr int BAR = KV + STAGES * 2 * TILE;  // q, then one per stage
  static constexpr int BYTES = BAR + 8 * (1 + STAGES) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(sm90::WG)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   bf16* __restrict__ o, float* __restrict__ lse, int H,
                   int Tq, int Tk, int causal, float scale, float q_off,
                   float k_off, int block_q, int block_k) {
  using namespace sm90;
  using L = FwdSm90<D>;
  constexpr int BN = L::BN;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const uint32_t sQ = smem_u32(smem + L::Q);

  // heads on the fast grid axis, q tiles last to first on the slow one:
  // the longest causal tiles start first and the tail is short
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this thread's rows (r and r + 8 of its warp's 16) and column pair
  const int r0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;

  int num_k = (Tk + BN - 1) / BN;
  float q_pos[2];
  int kv_end[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_pos[i] = q_off + (float)(q0 + r0 + 8 * i);
    kv_end[i] = causal ? ref_kv_end(q_off, k_off, q0 + r0 + 8 * i, block_q,
                                    block_k, Tk)
                       : Tk;
  }
  if (causal)
    num_k = fwd_num_k(q_off, k_off, q0, BN, Tq, Tk, block_q, block_k);

  if (tid == 0) {
    for (int i = 0; i < 1 + L::STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bar[0], L::TILE);
    tma_tile<D, BM>(smem + L::Q, &map_q, &bar[0], h, q0, b);
    if (num_k > 0) {
      mbar_expect(&bar[1], 2 * L::TILE);
      tma_tile<D, BN>(smem + L::KV, &map_k, &bar[1], h, 0, b);
      tma_tile<D, BN>(smem + L::KV + L::TILE, &map_v, &bar[1], h, 0, b);
    }
  }

  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * LOG2E;
  mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt & 1;
    if (tid == 0 && kt + 1 < num_k) {
      // the other stage was released by the __syncthreads ending tile kt-1
      unsigned char* nxt = smem + L::KV + (s ^ 1) * 2 * L::TILE;
      mbar_expect(&bar[1 + (s ^ 1)], 2 * L::TILE);
      tma_tile<D, BN>(nxt, &map_k, &bar[1 + (s ^ 1)], h, (kt + 1) * BN, b);
      tma_tile<D, BN>(nxt + L::TILE, &map_v, &bar[1 + (s ^ 1)], h,
                      (kt + 1) * BN, b);
    }
    mbar_wait(&bar[1 + s], (kt >> 1) & 1);
    const uint32_t sK = smem_u32(smem + L::KV + s * 2 * L::TILE);
    const uint32_t sV = sK + L::TILE;

    // S = Q . K^T
    float acc_s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(acc_s, desc_kmajor<D, BM>(sQ, kk), desc_kmajor<D, BN>(sK, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_s);

    // online softmax in log2 units: x = s * scale * log2(e)
    const int k0 = kt * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + 8 * j + c2 + (e & 1);
        float x = acc_s[4 * j + e] * scale_log2;
        if (col >= kv_end[i])
          x = -INFINITY;  // past the end of k or of the reference's tiles
        else if (causal && !(q_pos[i] >= k_off + (float)col))
          x = NEG_INF;    // masked as the reference masks
        acc_s[4 * j + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];  // per-thread partial sums, reduced in the epilogue
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(acc_s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p;  // the sum of p in fp32, before the bf16 cast
        acc_s[4 * j + e] = p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_o[4 * j + e] *= alpha[e >> 1];

    // O += P . V, p cast to v's dtype in registers
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) to_a_frag(pf[kk], acc_s, kk);
    fence_regs(acc_o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(acc_o, pf[kk], desc_mnmajor<D, BN>(sV, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_o);
    __syncthreads();  // every product has read stage s: it may be refilled
  }

  const size_t rs = (size_t)H * D;
  bf16* ob = o + ((size_t)b * Tq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = q0 + r0 + 8 * i;
    if (t >= Tq) continue;
    const float div = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)t * rs + 8 * j + c2) =
          pack_bf16(acc_o[4 * j + 2 * i] / div, acc_o[4 * j + 2 * i + 1] / div);
    if ((lane & 3) == 0) {
      // m is in log2 units; a row that saw only masked keys keeps NEG_INF
      const float ln2 = 0.6931471805599453f;
      lse[(size_t)bh * Tq + t] =
          (l[i] > 0.f && m[i] > NEG_INF / 2) ? m[i] * ln2 + logf(l[i])
                                              : NEG_INF;
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk, int causal,
                       float scale, float q_off, float k_off, int block_q,
                       int block_k, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    dim3 grid((Tq + BM - 1) / BM, B * H);
    constexpr int bytes = FwdSmem<D>::BYTES;
    cudaError_t err = prepare(flash_fwd_kernel<D>, bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), H, Tq, Tk, causal, scale, q_off, k_off,
        block_q, block_k);
  } else {
    constexpr int bytes = FwdSm90<D>::BYTES;
    CUtensorMap mq, mk, mv;
    cudaError_t err = sm90::make_map(&mq, q, B, Tq, H, D, BM);
    if (err == cudaSuccess)
      err = sm90::make_map(&mk, k, B, Tk, H, D, FwdSm90<D>::BN);
    if (err == cudaSuccess)
      err = sm90::make_map(&mv, v, B, Tk, H, D, FwdSm90<D>::BN);
    if (err == cudaSuccess) err = prepare(flash_fwd_sm90<D>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(B * H, (Tq + BM - 1) / BM);
    flash_fwd_sm90<D><<<grid, sm90::WG, bytes, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Tq,
        Tk, causal, scale, q_off, k_off, block_q, block_k);
  }
  return cudaGetLastError();
}

template <typename T, int D>
int info_fwd(int* info) {
  if constexpr (std::is_same<T, float>::value)
    return kernel_info(flash_fwd_kernel<D>, THREADS, FwdSmem<D>::BYTES, info);
  else
    return kernel_info(flash_fwd_sm90<D>, sm90::WG, FwdSm90<D>::BYTES, info);
}

}  // namespace hvdflash

// Registers, spill bytes, shared memory and blocks per SM of the forward
// kernel for (dtype, head_dim); see hvdflash::kernel_info.
extern "C" int hvd_flash_fwd_info(int dtype, int head_dim, int* info) {
  using hvdflash::info_fwd;
  HVD_FLASH_DISPATCH(dtype, head_dim, info_fwd, info);
}

// block_q/block_k: the reference's tiling, which decides o on rows with no
// visible key (0: no reference tiling, every key counts).
extern "C" int hvd_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Tq, int Tk, int causal,
                             float scale, float q_off, float k_off,
                             int block_q, int block_k, void* stream) {
  using hvdflash::launch_fwd;
  HVD_FLASH_DISPATCH(dtype, head_dim, launch_fwd, q, k, v, o, lse, B, H, Tq,
                     Tk, causal, scale, q_off, k_off, block_q, block_k,
                     static_cast<cudaStream_t>(stream));
}
