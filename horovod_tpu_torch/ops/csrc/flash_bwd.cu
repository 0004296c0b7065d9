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
// D=64, bf16, causal) dq needs ~19 GFLOP against ~64 MB, and dk/dv ~26
// GFLOP against ~76 MB, intensities of ~300 and ~340 FLOP/byte, right at or
// above the ~295 bf16 ridge: the tensor cores bound them, with memory close
// behind. Design: the block's own tile (q/do, or k/v) is loaded once and
// kept in shared memory, the other side is streamed through shared memory
// one BN-row tile at a time (never whole rows, which an SM cannot hold),
// products run on the tensor cores (WMMA bf16, fp32 accumulate) and the
// fp32 accumulators stay in shared memory. The causal tile skipping of the
// reference is kept in both kernels. Like the forward, this first version
// has no copy/compute overlap (TMA + wgmma later, ROADMAP queue B).
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
struct DqSmem {
  static constexpr int BN = Cfg<T>::BN;
  static constexpr int LDE = D + Cfg<T>::PAD;
  static constexpr int LDS = BN + 4;
  static constexpr int LDP = BN + Cfg<T>::PAD;
  static constexpr int LDO = D + 4;
  static constexpr int ES = (int)sizeof(T);
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(BM * LDE * ES);
  static constexpr int K = DO + align128(BM * LDE * ES);
  static constexpr int V = K + align128(BN * LDE * ES);
  static constexpr int S = V + align128(BN * LDE * ES);
  static constexpr int DP = S + align128(BM * LDS * 4);
  static constexpr int DS = DP + align128(BM * LDS * 4);
  static constexpr int DQ = DS + align128(BM * LDP * ES);
  static constexpr int BYTES = DQ + align128(BM * LDO * 4);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ corr, T* __restrict__ dq,
                        int H, int Tq, int Tk, int causal, float scale,
                        float q_off, float k_off) {
  using Sm = DqSmem<T, D>;
  constexpr int BN = Sm::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + Sm::Q);
  T* sDO = reinterpret_cast<T*>(smem + Sm::DO);
  T* sK = reinterpret_cast<T*>(smem + Sm::K);
  T* sV = reinterpret_cast<T*>(smem + Sm::V);
  float* sS = reinterpret_cast<float*>(smem + Sm::S);
  float* sDP = reinterpret_cast<float*>(smem + Sm::DP);
  T* sDS = reinterpret_cast<T*>(smem + Sm::DS);
  float* sDQ = reinterpret_cast<float*>(smem + Sm::DQ);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * D;
  const size_t q_base = ((size_t)b * Tq * H + h) * D;
  const size_t k_base = ((size_t)b * Tk * H + h) * D;

  load_rows<T, BM, D, Sm::LDE>(sQ, q + q_base, q0, Tq, rs);
  load_rows<T, BM, D, Sm::LDE>(sDO, dout + q_base, q0, Tq, rs);
  for (int i = threadIdx.x; i < BM * Sm::LDO; i += THREADS) sDQ[i] = 0.f;

  const int r = lane >> 1, half = lane & 1;
  const int row = warp * WROWS + r;
  const int t = q0 + row;
  const float q_pos = q_off + (float)t;
  const float lse_r = t < Tq ? lse[(size_t)bh * Tq + t] : NEG_INF;
  const float corr_r = t < Tq ? corr[(size_t)bh * Tq + t] : 0.f;
  const bool live = lse_r > NEG_INF / 2;  // fully masked rows: zero grads
  const T* wQ = sQ + warp * WROWS * Sm::LDE;
  const T* wDO = sDO + warp * WROWS * Sm::LDE;
  float* wS = sS + warp * WROWS * Sm::LDS;
  float* wDP = sDP + warp * WROWS * Sm::LDS;
  T* wDS = sDS + warp * WROWS * Sm::LDP;
  float* wDQ = sDQ + warp * WROWS * Sm::LDO;

  int num_k = (Tk + BN - 1) / BN;
  if (causal) num_k = causal_num_k(q_off, k_off, q0, BN, num_k);
  __syncthreads();

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BN;
    load_rows<T, BN, D, Sm::LDE>(sK, k + k_base, k0, Tk, rs);
    load_rows<T, BN, D, Sm::LDE>(sV, v + k_base, k0, Tk, rs);
    __syncthreads();

    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS>(wS, wQ, sK);
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS>(wDP, wDO, sV);
    __syncwarp();
    for (int c = half; c < BN; c += 2) {
      const int kc = k0 + c;
      float p = 0.f;
      if (live && kc < Tk && !(causal && !(q_pos >= k_off + (float)kc)))
        p = expf(wS[r * Sm::LDS + c] * scale - lse_r);
      const float ds = p * (wDP[r * Sm::LDS + c] + corr_r) * scale;
      wDS[r * Sm::LDP + c] = from_f<T>(ds);  // ds cast to k's dtype
    }
    __syncwarp();
    warp_mm_ab_acc<D, BN, Sm::LDP, Sm::LDE, Sm::LDO>(wDQ, wDS, sK);
    __syncthreads();
  }
  store_rows<T, D, Sm::LDO>(dq + q_base, sDQ, q0, Tq, rs, nullptr);
}

template <typename T, int D>
struct DkvSmem {
  static constexpr int BN = Cfg<T>::BN;
  static constexpr int LDE = D + Cfg<T>::PAD;
  static constexpr int LDS = BN + 4;
  static constexpr int LDP = BN + Cfg<T>::PAD;
  static constexpr int LDO = D + 4;
  static constexpr int ES = (int)sizeof(T);
  static constexpr int K = 0;
  static constexpr int V = K + align128(BM * LDE * ES);
  static constexpr int Q = V + align128(BM * LDE * ES);
  static constexpr int DO = Q + align128(BN * LDE * ES);
  static constexpr int LSE = DO + align128(BN * LDE * ES);
  static constexpr int CORR = LSE + align128(BN * 4);
  static constexpr int S = CORR + align128(BN * 4);
  static constexpr int DP = S + align128(BM * LDS * 4);
  static constexpr int P = DP + align128(BM * LDS * 4);
  static constexpr int DS = P + align128(BM * LDP * ES);
  static constexpr int DK = DS + align128(BM * LDP * ES);
  static constexpr int DV = DK + align128(BM * LDO * 4);
  static constexpr int BYTES = DV + align128(BM * LDO * 4);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ corr, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Tq, int Tk,
                         int causal, float scale, float q_off, float k_off) {
  using Sm = DkvSmem<T, D>;
  constexpr int BN = Sm::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + Sm::K);
  T* sV = reinterpret_cast<T*>(smem + Sm::V);
  T* sQ = reinterpret_cast<T*>(smem + Sm::Q);
  T* sDO = reinterpret_cast<T*>(smem + Sm::DO);
  float* sLse = reinterpret_cast<float*>(smem + Sm::LSE);
  float* sCorr = reinterpret_cast<float*>(smem + Sm::CORR);
  float* sS = reinterpret_cast<float*>(smem + Sm::S);
  float* sDP = reinterpret_cast<float*>(smem + Sm::DP);
  T* sP = reinterpret_cast<T*>(smem + Sm::P);
  T* sDS = reinterpret_cast<T*>(smem + Sm::DS);
  float* sDK = reinterpret_cast<float*>(smem + Sm::DK);
  float* sDV = reinterpret_cast<float*>(smem + Sm::DV);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * D;
  const size_t q_base = ((size_t)b * Tq * H + h) * D;
  const size_t k_base = ((size_t)b * Tk * H + h) * D;

  load_rows<T, BM, D, Sm::LDE>(sK, k + k_base, k0, Tk, rs);
  load_rows<T, BM, D, Sm::LDE>(sV, v + k_base, k0, Tk, rs);
  for (int i = threadIdx.x; i < BM * Sm::LDO; i += THREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }

  // Rows of this warp are k rows; the two lanes of a row split q columns.
  const int r = lane >> 1, half = lane & 1;
  const float k_pos = k_off + (float)(k0 + warp * WROWS + r);
  const T* wK = sK + warp * WROWS * Sm::LDE;
  const T* wV = sV + warp * WROWS * Sm::LDE;
  float* wS = sS + warp * WROWS * Sm::LDS;
  float* wDP = sDP + warp * WROWS * Sm::LDS;
  T* wP = sP + warp * WROWS * Sm::LDP;
  T* wDS = sDS + warp * WROWS * Sm::LDP;
  float* wDK = sDK + warp * WROWS * Sm::LDO;
  float* wDV = sDV + warp * WROWS * Sm::LDO;

  const int num_q = (Tq + BN - 1) / BN;
  int start = 0;
  if (causal) {
    // first q tile whose last position reaches this k tile's first one
    const float s0 = floorf((k_off + (float)k0 - q_off) / (float)BN);
    start = (int)fminf(fmaxf(s0, 0.f), (float)num_q);
  }
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* corr_bh = corr + (size_t)bh * Tq;

  for (int qt = start; qt < num_q; ++qt) {
    const int q0 = qt * BN;
    __syncthreads();  // previous tile's readers are done with sQ/sDO/sLse
    load_rows<T, BN, D, Sm::LDE>(sQ, q + q_base, q0, Tq, rs);
    load_rows<T, BN, D, Sm::LDE>(sDO, dout + q_base, q0, Tq, rs);
    for (int i = threadIdx.x; i < BN; i += THREADS) {
      const bool in = q0 + i < Tq;
      sLse[i] = in ? lse_bh[q0 + i] : NEG_INF;  // rows past Tq are dead
      sCorr[i] = in ? corr_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are k, columns are q
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS>(wS, wK, sQ);
    warp_mm_abT<BN, D, Sm::LDE, Sm::LDE, Sm::LDS>(wDP, wV, sDO);
    __syncwarp();
    for (int c = half; c < BN; c += 2) {
      const float lse_c = sLse[c];
      float p = 0.f;
      if (lse_c > NEG_INF / 2 &&
          !(causal && !(q_off + (float)(q0 + c) >= k_pos)))
        p = expf(wS[r * Sm::LDS + c] * scale - lse_c);
      wP[r * Sm::LDP + c] = from_f<T>(p);  // p cast to do's dtype
      wDS[r * Sm::LDP + c] =
          from_f<T>(p * (wDP[r * Sm::LDS + c] + sCorr[c]) * scale);
    }
    __syncwarp();
    warp_mm_ab_acc<D, BN, Sm::LDP, Sm::LDE, Sm::LDO>(wDV, wP, sDO);
    warp_mm_ab_acc<D, BN, Sm::LDP, Sm::LDE, Sm::LDO>(wDK, wDS, sQ);
  }
  __syncthreads();
  store_rows<T, D, Sm::LDO>(dk + k_base, sDK, k0, Tk, rs, nullptr);
  store_rows<T, D, Sm::LDO>(dv + k_base, sDV, k0, Tk, rs, nullptr);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* corr,
                      void* dq, int B, int H, int Tq, int Tk, int causal,
                      float scale, float q_off, float k_off,
                      cudaStream_t stream) {
  constexpr int bytes = DqSmem<T, D>::BYTES;
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(corr),
      static_cast<T*>(dq), H, Tq, Tk, causal, scale, q_off, k_off);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* corr,
                       void* dk, void* dv, int B, int H, int Tq, int Tk,
                       int causal, float scale, float q_off, float k_off,
                       cudaStream_t stream) {
  constexpr int bytes = DkvSmem<T, D>::BYTES;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + BM - 1) / BM, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(corr),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, causal, scale,
      q_off, k_off);
  return cudaGetLastError();
}

}  // namespace hvdflash

extern "C" int hvd_flash_bwd_dq(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* corr, void* dq, int B, int H,
                                int Tq, int Tk, int causal, float scale,
                                float q_off, float k_off, void* stream) {
  using hvdflash::launch_dq;
  HVD_FLASH_DISPATCH(dtype, head_dim, launch_dq, q, k, v, dout, lse, corr,
                     dq, B, H, Tq, Tk, causal, scale, q_off, k_off,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int hvd_flash_bwd_dkv(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* corr, void* dk, void* dv, int B,
                                 int H, int Tq, int Tk, int causal,
                                 float scale, float q_off, float k_off,
                                 void* stream) {
  using hvdflash::launch_dkv;
  HVD_FLASH_DISPATCH(dtype, head_dim, launch_dkv, q, k, v, dout, lse, corr,
                     dk, dv, B, H, Tq, Tk, causal, scale, q_off, k_off,
                     static_cast<cudaStream_t>(stream));
}
