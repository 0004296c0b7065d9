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
// What bounds it on an H100: at the GPT-2-small shape (B=8, T=1024, H=12,
// D=64, bf16, causal) the function needs ~12.9 GFLOP against ~51 MB of
// input and output, an intensity of ~255 FLOP/byte, just under the card's
// ~295 bf16 FLOP/byte ridge: memory first, tensor cores a close second.
// Design: every input byte is read from device memory once per q tile
// (K/V tiles re-read by each of the T/64 q tiles come from L2), the score
// tile and the accumulator stay in shared memory, and the products run on
// the tensor cores (WMMA bf16, fp32 accumulate). This first version issues
// one tile load at a time with no copy/compute overlap; TMA + wgmma with a
// multi-stage ring is the next step (ROADMAP queue B).
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
struct FwdSmem {
  static constexpr int BN = Cfg<T>::BN;
  static constexpr int LDE = D + Cfg<T>::PAD;   // q/k/v tiles
  static constexpr int LDS = BN + 4;            // fp32 scores
  static constexpr int LDP = BN + Cfg<T>::PAD;  // probabilities in T
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     int causal, float scale, float q_off, float k_off) {
  using Sm = FwdSmem<T, D>;
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

  load_rows<T, BM, D, Sm::LDE>(sQ, qb, q0, Tq, rs);
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
  if (causal) num_k = causal_num_k(q_off, k_off, q0, BN, num_k);
  __syncthreads();

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BN;
    load_rows<T, BN, D, Sm::LDE>(sK, kb, k0, Tk, rs);
    load_rows<T, BN, D, Sm::LDE>(sV, vb, k0, Tk, rs);
    __syncthreads();

    // s = (q . k^T) * scale, scale after the product as in the reference
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS>(wS, wQ, sK);
    __syncwarp();
    float mx = -INFINITY;
    for (int c = half; c < BN; c += 2) {
      const int kc = k0 + c;
      float s = wS[r * Sm::LDS + c] * scale;
      if (kc >= Tk)
        s = -INFINITY;  // past the end of k: no weight at all
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
      wP[r * Sm::LDP + c] = from_f<T>(p);  // p cast to v's dtype for p . v
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
  store_rows<T, D, Sm::LDO>(o + ((size_t)b * Tq * H + h) * D, sO, q0, Tq, rs,
                           sL);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk, int causal,
                       float scale, float q_off, float k_off,
                       cudaStream_t stream) {
  constexpr int bytes = FwdSmem<T, D>::BYTES;
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tk, causal, scale, q_off, k_off);
  return cudaGetLastError();
}

}  // namespace hvdflash

extern "C" int hvd_flash_fwd(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, void* o, void* lse,
                             int B, int H, int Tq, int Tk, int causal,
                             float scale, float q_off, float k_off,
                             void* stream) {
  using hvdflash::launch_fwd;
  HVD_FLASH_DISPATCH(dtype, head_dim, launch_fwd, q, k, v, o, lse, B, H, Tq,
                     Tk, causal, scale, q_off, k_off,
                     static_cast<cudaStream_t>(stream));
}
