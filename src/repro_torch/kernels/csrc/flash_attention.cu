// Flash (prefill) GQA attention for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see repro_torch/kernels/build.py).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_kernel (body
// _kernel) and computes its function: every query head n attends, with an
// online softmax in fp32, to kv head n // g; p is rounded to v's type
// before the PV product; NEG_INF is the finite -1e30; out = acc / max(l,
// 1e-30). One input more than the TPU kernel: q_offsets[b], the global
// position of row b's first query. With causal, query i of row b sees keys
// kpos <= q_offsets[b] + i (the TPU kernel is the case q_offsets == 0), so
// the dense prefill attends a chunk against its whole cache row in place.
// Key tiles wholly above a CTA's last query are skipped: exact, because key
// 0 is live for every causal row and so comes first.
//
// q, out: [B, Sq, Hq, D] and k, v: [B, Skv, Hkv, D] are read through
// strides (D contiguous), so neither the model's layout nor the cache is
// copied or transposed.
//
// What bounds it on the H100: operations for long sequences (4*Sq*Skv*D
// flops per head, halved by causality, against 2 bytes per K/V element read
// once per group); bytes for a short chunk against a long cache. Both
// instances run one CTA per (b * Hkv + h, tile of query positions), whose
// rows are the tile's positions x the group's g heads, so each K/V tile of
// 64 keys is staged in shared memory once and serves the whole group.
//
// - bf16: on the tensor cores (mma_attention_tile.cuh). 4 or 8 warps of 16
//   rows each (8 when there are CTAs enough to fill the card: twice the
//   rows per staged tile halves the L2 traffic of a long causal prefill).
//   K/V tiles come by cp.async into a two-stage ring, so the next tile
//   loads while the current one is folded; Q's fragments stay in registers
//   (D <= 128). Only the tiles that cross the diagonal or the end of the
//   keys are masked.
// - fp32: on the CUDA cores (attention_tile.cuh's fold_tile, lanes over
//   keys, 8 rows per warp), which hold the fp32 contract of 1e-4 that TF32
//   tensor cores cannot. Synchronous 16-byte loads, no double buffering.

#include "attention_tile.cuh"
#include "mma_attention_tile.cuh"

namespace {

using namespace attn;

constexpr int KPL = 2;          // keys per lane in a tile
constexpr int NK = 32 * KPL;    // keys per tile
constexpr int MAX_ROWS = 64;    // query rows per CTA (positions x group heads)

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

template <typename T, int EPL, bool LSE>
__global__ void __launch_bounds__(MAX_ROWS / ROWS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       const int* __restrict__ q_offsets, Strides qs, Strides ks,
                       Strides os, int Sq, int Skv, int Hkv, int g, int D, int bq,
                       int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = tile_stride<T>(D);
  const int nwarps = blockDim.x >> 5;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + NK * DP;
  float* q_all = reinterpret_cast<float*>(v_s + NK * DP);
  float* p_all = q_all + nwarps * ROWS * D;

  const int n = blockIdx.y;  // b * Hkv + h
  const int b = n / Hkv, h = n - b * Hkv;
  const int q0 = blockIdx.x * bq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(bq, Sq - q0) * g;  // live rows of this CTA
  const int off = q_offsets[b];
  float* q_s = q_all + warp * ROWS * D;
  float* p_s = p_all + warp * ROWS * NK;

  // this warp's rows: row r of the CTA is position q0 + r / g, head h*g + r % g
  int qpos[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    const bool live = r < rows;
    const int i = r / g, j = r - (r / g) * g;
    qpos[rr] = live ? off + q0 + i : -1;
    const T* src = q + b * qs.b + static_cast<long long>(q0 + i) * qs.s +
                   static_cast<long long>(h * g + j) * qs.h;
    for (int d = lane; d < D; d += 32) q_s[rr * D + d] = live ? to_f(src[d]) : 0.f;
  }
  __syncwarp();

  int ntiles = (Skv + NK - 1) / NK;
  if (causal) {
    const int last = off + min(q0 + bq, Sq) - 1;  // the CTA's last query
    ntiles = last < 0 ? 0 : min(ntiles, last / NK + 1);
  }

  RowState<ROWS, EPL> st;
  st.init();
  // k and v have equal strides (the wrapper checks), so one offset serves both
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * ks.b + h * ks.h;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * NK;
    __syncthreads();  // every warp is done with the previous tile
    load_kv_rows(k_s, v_s, kb, vb, NK, D, DP,
                 [&](int j) { return k0 + j < Skv ? (k0 + j) * ks.s : -1LL; },
                 threadIdx.x, blockDim.x);
    __syncthreads();
    if (warp * ROWS >= rows) continue;  // no live row in this warp
    fold_tile<T, ROWS, EPL, KPL>(st, q_s, k_s, v_s, p_s, D, DP, scale, [&](int r, int j) {
      const int kpos = k0 + j;
      if (kpos >= Skv) return -1;
      return (!causal || kpos <= qpos[r]) ? 1 : 0;
    });
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    if (r >= rows) break;
    const int i = r / g, j = r - (r / g) * g;
    T* dst = out + b * os.b + static_cast<long long>(q0 + i) * os.s +
             static_cast<long long>(h * g + j) * os.h;
    const float denom = fmaxf(st.l[rr], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) dst[d] = from_f<T>(st.acc[rr][e] / denom);
    }
    // the row's log-sum-exp of the scaled scores, [B, Hq, Sq], for the
    // backward (training only)
    if (LSE && lane == 0)
      lse[(static_cast<long long>(b) * Hkv * g + h * g + j) * Sq + q0 + i] =
          st.m[rr] + logf(denom);
  }
}

template <typename T, int EPL, bool LSE>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, float* lse, const int* q_offsets,
                   Strides qs, Strides ks, Strides os, int B, int Sq, int Skv,
                   int Hkv, int g, int D, int causal, float scale, cudaStream_t stream) {
  const int bq = max(1, min(MAX_ROWS / g, Sq));
  const int nwarps = (bq * g + ROWS - 1) / ROWS;
  const int DP = tile_stride<T>(D);
  const size_t smem = 2 * static_cast<size_t>(NK) * DP * sizeof(T) +
                      static_cast<size_t>(nwarps) * ROWS * (D + NK) * sizeof(float);
  auto kern = flash_attention_kernel<T, EPL, LSE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + bq - 1) / bq, B * Hkv);
  kern<<<grid, nwarps * 32, smem, stream>>>(q, k, v, out, lse, q_offsets, qs, ks, os, Sq, Skv,
                                            Hkv, g, D, bq, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
             const int* q_offsets,
             const long long* strides, int B, int Sq, int Skv, int Hq, int Hkv, int D,
             int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_ROWS ||
      D <= 0 || D % Vec<T>::N != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides os{strides[6], strides[7], strides[8]};
  const int g = Hq / Hkv;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define FA_LAUNCH(EPL)                                                                       \
  (lse ? launch<T, EPL, true>(qt, kt, vt, ot, lse, q_offsets, qs, ks, os, B, Sq, Skv, Hkv, g, \
                              D, causal, scale, stream)                                       \
       : launch<T, EPL, false>(qt, kt, vt, ot, lse, q_offsets, qs, ks, os, B, Sq, Skv, Hkv,   \
                               g, D, causal, scale, stream))
  cudaError_t e;
  if (D <= 32) e = FA_LAUNCH(1);
  else if (D <= 64) e = FA_LAUNCH(2);
  else if (D <= 128) e = FA_LAUNCH(4);
  else if (D <= 256) e = FA_LAUNCH(8);
  else e = cudaErrorInvalidValue;
#undef FA_LAUNCH
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_STAGES = 2;  // K/V tiles in flight

template <int DT, int NW, bool LSE>
__global__ void __launch_bounds__(NW * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, const int* __restrict__ q_offsets, Strides qs, Strides ks,
                           Strides os, int Sq, int Skv, int Hkv, int g, int D, int bq,
                           int causal, float scale) {
  using namespace mma;
  constexpr int ROWS_CTA = NW * WARP_ROWS;
  constexpr bool QREG = DT <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = mma::tile_stride(D);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kv_s = q_s + ROWS_CTA * SP;  // [stage][K, V][TILE_KEYS][SP]

  // heads on x, query tiles on y from the last: the tiles with the most
  // keys (causal) start first, so none of them is left for the tail
  const int n = blockIdx.x;  // b * Hkv + h
  const int b = n / Hkv, h = n - b * Hkv;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(bq, Sq - q0) * g;  // live rows of this CTA
  const int off = q_offsets[b];
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * ks.b + h * ks.h;  // k and v share strides

  // Q: row r of the CTA is position q0 + r / g, head h * g + r % g
  stage_rows(q_s, ROWS_CTA, D, SP, [&](int r) -> const __nv_bfloat16* {
    if (r >= rows) return nullptr;
    return q + b * qs.b + static_cast<long long>(q0 + r / g) * qs.s +
           static_cast<long long>(h * g + r % g) * qs.h;
  }, q, threadIdx.x, NW * 32);

  int ntiles = (Skv + TILE_KEYS - 1) / TILE_KEYS;
  if (causal) {
    const int last = off + min(q0 + bq, Sq) - 1;  // the CTA's last query
    ntiles = last < 0 ? 0 : min(ntiles, last / TILE_KEYS + 1);
  }
  auto stage = [&](int kt) {
    __nv_bfloat16* k_t = kv_s + (kt % MMA_STAGES) * 2 * TILE_KEYS * SP;
    const int k0 = kt * TILE_KEYS;
    stage_rows(k_t, TILE_KEYS, D, SP, [&](int j) -> const __nv_bfloat16* {
      return k0 + j < Skv ? kb + static_cast<long long>(k0 + j) * ks.s : nullptr;
    }, k, threadIdx.x, NW * 32);
    stage_rows(k_t + TILE_KEYS * SP, TILE_KEYS, D, SP, [&](int j) -> const __nv_bfloat16* {
      return k0 + j < Skv ? vb + static_cast<long long>(k0 + j) * ks.s : nullptr;
    }, v, threadIdx.x, NW * 32);
  };
  // group 0: Q and tile 0; then one group per tile
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }

  const int row0 = warp * WARP_ROWS;
  const bool live_warp = row0 < rows;
  const int first_q = off + q0;  // the CTA's first query position
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = off + q0 + (row0 + (lane >> 2) + 8 * r) / g;
  const uint32_t q_addr = q_lane_addr(smem_u32(q_s), row0, SP, lane);

  WarpState<DT> st;
  st.init();
  QFrags<DT, QREG> qf;
  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + MMA_STAGES - 1 < ntiles) stage(kt + MMA_STAGES - 1);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 1>();
    __syncthreads();
    if (kt == 0) qf.load(q_addr, D);
    if (live_warp) {
      const int k0 = kt * TILE_KEYS;
      const bool masked = k0 + TILE_KEYS > Skv || (causal && k0 + TILE_KEYS - 1 > first_q);
      const uint32_t k_t = smem_u32(kv_s + (kt % MMA_STAGES) * 2 * TILE_KEYS * SP);
      auto key_state = [&](int r, int j) {
        const int kpos = k0 + j;
        if (kpos >= Skv) return -1;
        return (!causal || kpos <= qpos[r]) ? 1 : 0;
      };
      const uint32_t v_t = k_t + TILE_KEYS * SP * 2;
      if (masked)
        fold<DT, TILE_KEYS, true>(st, qf, q_addr, k_t, v_t, SP, D, scale, 0.f, key_state);
      else
        fold<DT, TILE_KEYS, false>(st, qf, q_addr, k_t, v_t, SP, D, scale, 0.f, key_state);
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();
  if (!live_warp) return;
  st.reduce_l();
  store_rows(st, D, [&](int rr) -> __nv_bfloat16* {
    const int r = row0 + (lane >> 2) + 8 * rr;
    if (r >= rows) return nullptr;
    return out + b * os.b + static_cast<long long>(q0 + r / g) * os.s +
           static_cast<long long>(h * g + r % g) * os.h;
  });
  if (LSE && (lane & 3) == 0) {
    // the rows' log-sum-exp of the scaled scores, [B, Hq, Sq], for the
    // backward (training only)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = row0 + (lane >> 2) + 8 * rr;
      if (r < rows)
        lse[(static_cast<long long>(b) * Hkv * g + h * g + r % g) * Sq + q0 + r / g] =
            st.m[rr] + logf(fmaxf(st.l[rr], 1e-30f));
    }
  }
}

template <int DT, int NW, bool LSE>
cudaError_t launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                       const int* q_offsets,
                       Strides qs, Strides ks, Strides os, int B, int Sq, int Skv, int Hkv,
                       int g, int D, int causal, float scale, cudaStream_t stream) {
  constexpr int ROWS_CTA = NW * mma::WARP_ROWS;
  const int bq = max(1, min(ROWS_CTA / g, Sq));
  const int SP = mma::tile_stride(D);
  const size_t smem = static_cast<size_t>(ROWS_CTA + MMA_STAGES * 2 * mma::TILE_KEYS) * SP *
                      sizeof(__nv_bfloat16);
  auto kern = flash_attention_mma_kernel<DT, NW, LSE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(B * Hkv, (Sq + bq - 1) / bq);
  kern<<<grid, NW * 32, smem, stream>>>(q, k, v, out, lse, q_offsets, qs, ks, os, Sq, Skv,
                                        Hkv, g, D, bq, causal, scale);
  return cudaGetLastError();
}

template <int DT, bool LSE>
cudaError_t launch_mma_nw(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                          const int* q_offsets,
                          Strides qs, Strides ks, Strides os, int B, int Sq, int Skv,
                          int Hkv, int g, int D, int causal, float scale,
                          cudaStream_t stream) {
  // 8 warps (128 rows) when that still gives two CTAs per SM of the card
  // (132 SMs), else 4 (64 rows), so that short chunks spread wider
  const int bq8 = max(1, min(128 / g, Sq));
  const long long ctas8 = static_cast<long long>((Sq + bq8 - 1) / bq8) * B * Hkv;
  if (DT <= 128 && ctas8 >= 264)
    return launch_mma<DT, 8, LSE>(q, k, v, out, lse, q_offsets, qs, ks, os, B, Sq, Skv, Hkv,
                                  g, D, causal, scale, stream);
  return launch_mma<DT, 4, LSE>(q, k, v, out, lse, q_offsets, qs, ks, os, B, Sq, Skv, Hkv, g,
                                D, causal, scale, stream);
}

int dispatch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                 const int* q_offsets,
                 const long long* strides, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                 int causal, float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_ROWS ||
      D <= 0 || D % 16 != 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides os{strides[6], strides[7], strides[8]};
  const int g = Hq / Hkv;
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  auto* ot = static_cast<__nv_bfloat16*>(out);
#define FA_MMA(DT)                                                                          \
  (lse ? launch_mma_nw<DT, true>(qt, kt, vt, ot, lse, q_offsets, qs, ks, os, B, Sq, Skv, Hkv,  \
                                 g, D, causal, scale, stream)                                \
       : launch_mma_nw<DT, false>(qt, kt, vt, ot, lse, q_offsets, qs, ks, os, B, Sq, Skv, Hkv, \
                                  g, D, causal, scale, stream))
  cudaError_t e;
  if (D <= 32) e = FA_MMA(32);
  else if (D <= 64) e = FA_MMA(64);
  else if (D <= 128) e = FA_MMA(128);
  else e = FA_MMA(256);
#undef FA_MMA
  return static_cast<int>(e);
}

}  // namespace

// q, out: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D], each with element strides
// (batch, position, head) in `strides` (q, k and v alike, out: 9 values) and
// a contiguous head dim, 16-byte aligned; q_offsets: [B] int32. lse: null
// (serving), or an fp32 [B, Hq, Sq] output for each row's log-sum-exp of
// its scaled scores, which the backward (flash_attention_bwd.cu) reads; the
// instances without it are the serving path's, unchanged. All on the device
// of `stream`. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   float* lse, const int* q_offsets, const long long* strides,
                                   int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                                   float scale, void* stream) {
  return dispatch<float>(q, k, v, out, lse, q_offsets, strides, B, Sq, Skv, Hq, Hkv, D, causal,
                         scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    float* lse, const int* q_offsets, const long long* strides,
                                    int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                                    float scale, void* stream) {
  return dispatch_mma(q, k, v, out, lse, q_offsets, strides, B, Sq, Skv, Hq, Hkv, D, causal,
                      scale, static_cast<cudaStream_t>(stream));
}
