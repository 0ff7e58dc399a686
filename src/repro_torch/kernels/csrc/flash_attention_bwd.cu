// The backward of flash (prefill) GQA attention for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see repro_torch/kernels/build.py).
//
// Replaces no TPU kernel of its own: the reference trains through jnp
// attention (models/attention_math.py::attend) and JAX's autodiff, and the
// port trains through its flash kernel (flash_attention.cu, which replaces
// src/repro/kernels/flash_attention.py::flash_attention_kernel), so the
// flash kernel needs this gradient. It follows FlashAttention-2's scheme
// over the forward's saved fp32 log-sum-exp (lse, [B, Hq, Sq]), causal with
// q_offsets, GQA (query head n reads kv head n // g), in three launches:
//
//   1. delta[b, n, i] = sum_d dO[b, i, n, d] * O[b, i, n, d]   (fp32)
//   2. dK, dV: one CTA per (b * Hkv + h, tile of keys), looping over the
//      query tiles of all g heads of the group, so the group's sum stays in
//      the CTA's registers;
//   3. dQ: one CTA per (b * Hkv + h, tile of query positions), its rows the
//      positions x the group's heads as in the forward, looping over key
//      tiles.
//
// P is recomputed with the forward's convention: the score is scaled after
// the dot, p = exp(s * scale - lse), masked keys (kpos > q_offsets[b] + i)
// give 0. dS = P * (dP - delta), dQ = scale * dS K, dK = scale * dS^T Q,
// dV = P^T dO. No atomics: every output element is written by one thread,
// once, so two runs give bitwise equal gradients.
//
// q, dq, out, dout: [B, Sq, Hq, D]; k, v, dk, dv: [B, Skv, Hkv, D]; all
// contiguous (the wrapper makes them so).
//
// What bounds it on the H100: operations (five products of Sq x Skv x D per
// head, halved by causality, against the inputs read once per group). bf16
// runs on the tensor cores with mma.sync (mma_attention_tile.cuh's scores
// and accumulate: the dK/dV launch computes S^T = K Q^T with the warp's 16
// keys as rows, so P^T and dS^T are A operands as they stand, and Q and dO
// are staged as B tiles; dQ runs as the forward does with dO as a second A
// operand). P and dS are rounded to bf16 before their products, as the
// forward rounds P. fp32 runs on the CUDA cores (lanes over queries or keys
// for the dots, lanes over the head dim for the sums), holding the 1e-4
// contract that TF32 would not. Neither uses wgmma or TMA yet.

#include "attention_tile.cuh"
#include "mma_attention_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// launch 1: delta = rowsum(dO * O), one warp per (b, position, head) row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
             long long nrows, int Sq, int Hq, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;
  const T* o = out + row * D;
  const T* d = dout + row * D;
  float acc = 0.f;
  for (int e = lane; e < D; e += 32) acc += attn::to_f(o[e]) * attn::to_f(d[e]);
  acc = attn::warp_sum(acc);
  if (lane == 0) {
    // row = (b * Sq + i) * Hq + n  ->  delta[(b * Hq + n) * Sq + i]
    const long long bi = row / Hq;
    const int n = static_cast<int>(row - bi * Hq);
    const long long b = bi / Sq;
    const int i = static_cast<int>(bi - b * Sq);
    delta[(b * Hq + n) * Sq + i] = acc;
  }
}

struct Dims {
  int B, Sq, Skv, Hq, Hkv, g, D;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int F_KEYS = 32;      // keys per dK/dV CTA (8 warps x 4)
constexpr int F_KPW = 4;        // keys per warp
constexpr int F_QT = 32;        // queries per staged tile (lane = query)
constexpr int F_ROWS = 8;       // dQ rows per warp
constexpr int F_MAX_ROWS = 64;  // dQ rows per CTA (8 warps)
constexpr int F_KT = 32;        // keys per staged tile in dQ (lane = key)

// Row stride of an fp32 tile: D plus 4, so lanes reading rows at the same
// column spread over the banks.
__host__ __device__ __forceinline__ int f_stride(int D) { return D + 4; }

template <int EPL>
__global__ void __launch_bounds__(256)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_offsets, float* __restrict__ dk,
                float* __restrict__ dv, Dims dm, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = dm.D, DP = f_stride(D);
  float* k_s = reinterpret_cast<float*>(smem);      // [F_KEYS, DP]
  float* v_s = k_s + F_KEYS * DP;                   // [F_KEYS, DP]
  float* q_s = v_s + F_KEYS * DP;                   // [F_QT, DP]
  float* do_s = q_s + F_QT * DP;                    // [F_QT, DP]
  float* ld_s = do_s + F_QT * DP;                   // lse, delta [2, F_QT]
  float* pd_s = ld_s + 2 * F_QT;                    // per warp: p, ds [2, F_KPW, F_QT]

  const int n = blockIdx.x;  // b * Hkv + h
  const int b = n / dm.Hkv, h = n - b * dm.Hkv;
  const int k0 = blockIdx.y * F_KEYS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = q_offsets[b];
  float* p_w = pd_s + warp * 2 * F_KPW * F_QT;
  float* ds_w = p_w + F_KPW * F_QT;

  for (int e = threadIdx.x; e < F_KEYS * D; e += blockDim.x) {
    const int j = e / D, d = e - j * D;
    const bool ok = k0 + j < dm.Skv;
    const long long src = ((static_cast<long long>(b) * dm.Skv + k0 + j) * dm.Hkv + h) * D + d;
    k_s[j * DP + d] = ok ? k[src] : 0.f;
    v_s[j * DP + d] = ok ? v[src] : 0.f;
  }

  float adk[F_KPW][EPL], adv[F_KPW][EPL];
#pragma unroll
  for (int t = 0; t < F_KPW; ++t)
#pragma unroll
    for (int e = 0; e < EPL; ++e) adk[t][e] = adv[t][e] = 0.f;

  // the first query position that can see key k0 (causal)
  const int i_first = causal ? max(0, k0 - off) / F_QT * F_QT : 0;
  for (int j = 0; j < dm.g; ++j) {
    const int hq = h * dm.g + j;
    for (int i0 = i_first; i0 < dm.Sq; i0 += F_QT) {
      __syncthreads();  // the previous tile is done with
      for (int e = threadIdx.x; e < F_QT * D; e += blockDim.x) {
        const int i = e / D, d = e - i * D;
        const bool ok = i0 + i < dm.Sq;
        const long long src = ((static_cast<long long>(b) * dm.Sq + i0 + i) * dm.Hq + hq) * D + d;
        q_s[i * DP + d] = ok ? q[src] : 0.f;
        do_s[i * DP + d] = ok ? dout[src] : 0.f;
      }
      if (threadIdx.x < F_QT) {
        const int i = threadIdx.x;
        const bool ok = i0 + i < dm.Sq;
        const long long r = (static_cast<long long>(b) * dm.Hq + hq) * dm.Sq + i0 + i;
        ld_s[i] = ok ? lse[r] : 0.f;
        ld_s[F_QT + i] = ok ? delta[r] : 0.f;
      }
      __syncthreads();
      // dots with lane = query i: s = q_i . k_t, dp = do_i . v_t
      const int i = lane;
      const int qpos = off + i0 + i;
      const bool qlive = i0 + i < dm.Sq;
#pragma unroll
      for (int t = 0; t < F_KPW; ++t) {
        const int kk = warp * F_KPW + t;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + i * DP + d);
          const float4 ov = *reinterpret_cast<const float4*>(do_s + i * DP + d);
          const float4 kv = *reinterpret_cast<const float4*>(k_s + kk * DP + d);
          const float4 vv = *reinterpret_cast<const float4*>(v_s + kk * DP + d);
          s = fmaf(qv.x, kv.x, s); s = fmaf(qv.y, kv.y, s);
          s = fmaf(qv.z, kv.z, s); s = fmaf(qv.w, kv.w, s);
          dp = fmaf(ov.x, vv.x, dp); dp = fmaf(ov.y, vv.y, dp);
          dp = fmaf(ov.z, vv.z, dp); dp = fmaf(ov.w, vv.w, dp);
        }
        const int kpos = k0 + kk;
        const bool live = qlive && kpos < dm.Skv && (!causal || kpos <= qpos);
        const float p = live ? expf(s * scale - ld_s[i]) : 0.f;
        p_w[t * F_QT + i] = p;
        ds_w[t * F_QT + i] = p * (dp - ld_s[F_QT + i]);
      }
      __syncwarp();
      // sums with lanes over the head dim
      for (int ii = 0; ii < F_QT; ++ii) {
        float qd[EPL], od[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = e * 32 + lane;
          qd[e] = d < D ? q_s[ii * DP + d] : 0.f;
          od[e] = d < D ? do_s[ii * DP + d] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < F_KPW; ++t) {
          const float p = p_w[t * F_QT + ii], ds = ds_w[t * F_QT + ii];
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            adv[t][e] = fmaf(p, od[e], adv[t][e]);
            adk[t][e] = fmaf(ds, qd[e], adk[t][e]);
          }
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int t = 0; t < F_KPW; ++t) {
    const int kpos = k0 + warp * F_KPW + t;
    if (kpos >= dm.Skv) continue;
    const long long dst = ((static_cast<long long>(b) * dm.Skv + kpos) * dm.Hkv + h) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) {
        dk[dst + d] = adk[t][e] * scale;
        dv[dst + d] = adv[t][e];
      }
    }
  }
}

template <int EPL>
__global__ void __launch_bounds__(256)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ q_offsets, float* __restrict__ dq, Dims dm, int bq,
              int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = dm.D, DP = f_stride(D);
  float* k_s = reinterpret_cast<float*>(smem);   // [F_KT, DP]
  float* v_s = k_s + F_KT * DP;                  // [F_KT, DP]
  float* q_all = v_s + F_KT * DP;                // per warp [F_ROWS, D]
  const int nwarps = blockDim.x >> 5;
  float* do_all = q_all + nwarps * F_ROWS * D;   // per warp [F_ROWS, D]
  float* ds_all = do_all + nwarps * F_ROWS * D;  // per warp [F_ROWS, F_KT]

  const int n = blockIdx.y;  // b * Hkv + h
  const int b = n / dm.Hkv, h = n - b * dm.Hkv;
  const int g = dm.g;
  const int q0 = blockIdx.x * bq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(bq, dm.Sq - q0) * g;
  const int off = q_offsets[b];
  float* q_s = q_all + warp * F_ROWS * D;
  float* do_s = do_all + warp * F_ROWS * D;
  float* ds_s = ds_all + warp * F_ROWS * F_KT;

  // row r of the CTA: position q0 + r / g, head h * g + r % g
  int qpos[F_ROWS];
  float lse_r[F_ROWS], delta_r[F_ROWS];
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int r = warp * F_ROWS + rr;
    const bool live = r < rows;
    const int i = r / g, j = r - (r / g) * g;
    qpos[rr] = live ? off + q0 + i : -1;
    const long long src = ((static_cast<long long>(b) * dm.Sq + q0 + i) * dm.Hq + h * g + j) * D;
    for (int d = lane; d < D; d += 32) {
      q_s[rr * D + d] = live ? q[src + d] : 0.f;
      do_s[rr * D + d] = live ? dout[src + d] : 0.f;
    }
    const long long lr = (static_cast<long long>(b) * dm.Hq + h * g + j) * dm.Sq + q0 + i;
    lse_r[rr] = live ? lse[lr] : 0.f;
    delta_r[rr] = live ? delta[lr] : 0.f;
  }
  __syncwarp();

  int ntiles = (dm.Skv + F_KT - 1) / F_KT;
  if (causal) {
    const int last = off + min(q0 + bq, dm.Sq) - 1;
    ntiles = last < 0 ? 0 : min(ntiles, last / F_KT + 1);
  }
  float acc[F_ROWS][EPL];
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[rr][e] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * F_KT;
    __syncthreads();
    for (int e = threadIdx.x; e < F_KT * D; e += blockDim.x) {
      const int j = e / D, d = e - j * D;
      const bool ok = k0 + j < dm.Skv;
      const long long src = ((static_cast<long long>(b) * dm.Skv + k0 + j) * dm.Hkv + h) * D + d;
      k_s[j * DP + d] = ok ? k[src] : 0.f;
      v_s[j * DP + d] = ok ? v[src] : 0.f;
    }
    __syncthreads();
    if (warp * F_ROWS >= rows) continue;
    // dots with lane = key j
    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < F_ROWS; ++rr) {
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + lane * DP + d);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + lane * DP + d);
        const float4 qv = *reinterpret_cast<const float4*>(q_s + rr * D + d);
        const float4 ov = *reinterpret_cast<const float4*>(do_s + rr * D + d);
        s = fmaf(qv.x, kv.x, s); s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s); s = fmaf(qv.w, kv.w, s);
        dp = fmaf(ov.x, vv.x, dp); dp = fmaf(ov.y, vv.y, dp);
        dp = fmaf(ov.z, vv.z, dp); dp = fmaf(ov.w, vv.w, dp);
      }
      const bool live = qpos[rr] >= 0 && kpos < dm.Skv && (!causal || kpos <= qpos[rr]);
      const float p = live ? expf(s * scale - lse_r[rr]) : 0.f;
      ds_s[rr * F_KT + lane] = p * (dp - delta_r[rr]);
    }
    __syncwarp();
    for (int jj = 0; jj < F_KT; ++jj) {
      float kd[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = e * 32 + lane;
        kd[e] = d < D ? k_s[jj * DP + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < F_ROWS; ++rr) {
        const float ds = ds_s[rr * F_KT + jj];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[rr][e] = fmaf(ds, kd[e], acc[rr][e]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int r = warp * F_ROWS + rr;
    if (r >= rows) break;
    const int i = r / g, j = r - (r / g) * g;
    float* dst = dq + ((static_cast<long long>(b) * dm.Sq + q0 + i) * dm.Hq + h * g + j) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) dst[d] = acc[rr][e] * scale;
    }
  }
}

template <int EPL>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, const int* q_offsets, float* dq,
                       float* dk, float* dv, const Dims& dm, int causal, float scale,
                       cudaStream_t stream) {
  const int DP = f_stride(dm.D);
  {
    const size_t smem = (2 * static_cast<size_t>(F_KEYS) * DP + 2 * F_QT * DP + 2 * F_QT +
                         8 * 2 * F_KPW * F_QT) * sizeof(float);
    auto kern = dkdv_f32_kernel<EPL>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const dim3 grid(dm.B * dm.Hkv, (dm.Skv + F_KEYS - 1) / F_KEYS);
    kern<<<grid, 256, smem, stream>>>(q, k, v, dout, lse, delta, q_offsets, dk, dv, dm, causal,
                                      scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int bq = max(1, min(F_MAX_ROWS / dm.g, dm.Sq));
  const int nwarps = (bq * dm.g + F_ROWS - 1) / F_ROWS;
  const size_t smem = (2 * static_cast<size_t>(F_KT) * DP +
                       static_cast<size_t>(nwarps) * F_ROWS * (2 * dm.D + F_KT)) *
                      sizeof(float);
  auto kern = dq_f32_kernel<EPL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((dm.Sq + bq - 1) / bq, dm.B * dm.Hkv);
  kern<<<grid, nwarps * 32, smem, stream>>>(q, k, v, dout, lse, delta, q_offsets, dq, dm, bq,
                                            causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
constexpr int M_KW = 4;                      // warps of the dK/dV CTA
constexpr int M_KEYS = M_KW * mma::WARP_ROWS;  // keys per dK/dV CTA (64)
constexpr int M_QT = 32;                     // queries per staged tile
constexpr int M_QW = 4;                      // warps of the dQ CTA
constexpr int M_QROWS = M_QW * mma::WARP_ROWS;  // dQ rows per CTA (64)
constexpr int M_KT = 64;                     // keys per staged tile in dQ

// The warp's accumulator (16 rows x DT dims, the WarpState layout) scaled
// and written as bf16: row_ptr(r) gives the address of row lane/4 + 8r or
// nullptr.
template <int DT, typename RowPtr>
__device__ __forceinline__ void store_acc(const mma::WarpState<DT>& st, int D, float mul,
                                          RowPtr row_ptr) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* dst = row_ptr(r);
    if (dst == nullptr) continue;
#pragma unroll
    for (int t = 0; t < DT / 8; ++t) {
      const int d = t * 8 + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            mma::pack_bf16(st.o[t][2 * r] * mul, st.o[t][2 * r + 1] * mul);
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(M_KW * 32)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_offsets, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, Dims dm, int causal, float scale) {
  using namespace mma;
  constexpr int NT = M_QT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = dm.D, SP = tile_stride(D);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [M_KEYS, SP]
  __nv_bfloat16* v_s = k_s + M_KEYS * SP;                         // [M_KEYS, SP]
  __nv_bfloat16* q_s = v_s + M_KEYS * SP;                         // [M_QT, SP]
  __nv_bfloat16* do_s = q_s + M_QT * SP;                          // [M_QT, SP]
  float* ld_s = reinterpret_cast<float*>(do_s + M_QT * SP);       // lse, delta [2, M_QT]

  const int n = blockIdx.x;  // b * Hkv + h
  const int b = n / dm.Hkv, h = n - b * dm.Hkv;
  const int k0 = blockIdx.y * M_KEYS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = q_offsets[b];
  const int nthreads = M_KW * 32;

  stage_rows(k_s, M_KEYS, D, SP, [&](int j) -> const __nv_bfloat16* {
    return k0 + j < dm.Skv ? k + ((static_cast<long long>(b) * dm.Skv + k0 + j) * dm.Hkv + h) * D
                           : nullptr;
  }, k, threadIdx.x, nthreads);
  stage_rows(v_s, M_KEYS, D, SP, [&](int j) -> const __nv_bfloat16* {
    return k0 + j < dm.Skv ? v + ((static_cast<long long>(b) * dm.Skv + k0 + j) * dm.Hkv + h) * D
                           : nullptr;
  }, v, threadIdx.x, nthreads);
  cp_async_commit();

  // this lane's two keys (rows lane/4 and lane/4 + 8 of the warp's 16)
  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + warp * WARP_ROWS + (lane >> 2) + 8 * r;
  const uint32_t k_addr = q_lane_addr(smem_u32(k_s), warp * WARP_ROWS, SP, lane);
  const uint32_t v_addr = q_lane_addr(smem_u32(v_s), warp * WARP_ROWS, SP, lane);
  const uint32_t q_t = smem_u32(q_s), do_t = smem_u32(do_s);
  const QFrags<DT, false> kf{}, vf{};

  WarpState<DT> adk, adv;  // only o is used
  adk.init();
  adv.init();
  const int i_first = causal ? max(0, k0 - off) / M_QT * M_QT : 0;
  for (int j = 0; j < dm.g; ++j) {
    const int hq = h * dm.g + j;
    for (int i0 = i_first; i0 < dm.Sq; i0 += M_QT) {
      __syncthreads();  // every warp is done with the previous tile
      auto row_of = [&](const __nv_bfloat16* base) {
        return [&, base](int i) -> const __nv_bfloat16* {
          return i0 + i < dm.Sq
                     ? base + ((static_cast<long long>(b) * dm.Sq + i0 + i) * dm.Hq + hq) * D
                     : nullptr;
        };
      };
      stage_rows(q_s, M_QT, D, SP, row_of(q), q, threadIdx.x, nthreads);
      stage_rows(do_s, M_QT, D, SP, row_of(dout), dout, threadIdx.x, nthreads);
      cp_async_commit();
      if (threadIdx.x < M_QT) {
        const int i = threadIdx.x;
        const bool ok = i0 + i < dm.Sq;
        const long long r = (static_cast<long long>(b) * dm.Hq + hq) * dm.Sq + i0 + i;
        ld_s[i] = ok ? lse[r] : 0.f;
        ld_s[M_QT + i] = ok ? delta[r] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys, columns
      // the tile's queries 8t + 2(lane % 4) + {0, 1}
      float s[NT][4], dp[NT][4];
      scores<DT, NT>(s, kf, k_addr, q_t, SP, D);
      scores<DT, NT>(dp, vf, v_addr, do_t, SP, D);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = t * 8 + 2 * (lane & 3) + (e & 1);
          const int kp = kpos[e >> 1];
          const bool live = i0 + i < dm.Sq && kp < dm.Skv && (!causal || kp <= off + i0 + i);
          const float p = live ? exp_ftz(s[t][e] * scale - ld_s[i]) : 0.f;
          s[t][e] = p;
          dp[t][e] = p * (dp[t][e] - ld_s[M_QT + i]);
        }
      // dV += P^T dO, dK += dS^T Q (P and dS rounded to bf16 as A operands)
      accumulate<DT, NT>(adv, s, do_t, SP, D);
      accumulate<DT, NT>(adk, dp, q_t, SP, D);
    }
  }
  store_acc(adk, D, scale, [&](int r) -> __nv_bfloat16* {
    return kpos[r] < dm.Skv ? dk + ((static_cast<long long>(b) * dm.Skv + kpos[r]) * dm.Hkv + h) * D
                            : nullptr;
  });
  store_acc(adv, D, 1.f, [&](int r) -> __nv_bfloat16* {
    return kpos[r] < dm.Skv ? dv + ((static_cast<long long>(b) * dm.Skv + kpos[r]) * dm.Hkv + h) * D
                            : nullptr;
  });
}

template <int DT>
__global__ void __launch_bounds__(M_QW * 32)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ q_offsets, __nv_bfloat16* __restrict__ dq, Dims dm, int bq,
              int causal, float scale) {
  using namespace mma;
  constexpr int H = M_KT / 2, NT = H / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = dm.D, SP = tile_stride(D);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [M_QROWS, SP]
  __nv_bfloat16* do_s = q_s + M_QROWS * SP;                       // [M_QROWS, SP]
  __nv_bfloat16* k_s = do_s + M_QROWS * SP;                       // [M_KT, SP]
  __nv_bfloat16* v_s = k_s + M_KT * SP;                           // [M_KT, SP]
  const int nthreads = M_QW * 32;

  const int n = blockIdx.x;  // b * Hkv + h
  const int b = n / dm.Hkv, h = n - b * dm.Hkv;
  const int g = dm.g;
  const int q0 = blockIdx.y * bq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = min(bq, dm.Sq - q0) * g;
  const int off = q_offsets[b];

  auto row_of = [&](const __nv_bfloat16* base) {
    return [&, base](int r) -> const __nv_bfloat16* {
      if (r >= rows) return nullptr;
      return base + ((static_cast<long long>(b) * dm.Sq + q0 + r / g) * dm.Hq + h * g + r % g) * D;
    };
  };
  stage_rows(q_s, M_QROWS, D, SP, row_of(q), q, threadIdx.x, nthreads);
  stage_rows(do_s, M_QROWS, D, SP, row_of(dout), dout, threadIdx.x, nthreads);
  cp_async_commit();

  const int row0 = warp * WARP_ROWS;
  const bool live_warp = row0 < rows;
  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row0 + (lane >> 2) + 8 * r;
    const bool live = rr < rows;
    qpos[r] = live ? off + q0 + rr / g : -1;
    const long long lr = (static_cast<long long>(b) * dm.Hq + h * g + rr % g) * dm.Sq + q0 + rr / g;
    lse_r[r] = live ? lse[lr] : 0.f;
    delta_r[r] = live ? delta[lr] : 0.f;
  }
  const uint32_t q_addr = q_lane_addr(smem_u32(q_s), row0, SP, lane);
  const uint32_t do_addr = q_lane_addr(smem_u32(do_s), row0, SP, lane);
  const QFrags<DT, false> qf{}, df{};

  int ntiles = (dm.Skv + M_KT - 1) / M_KT;
  if (causal) {
    const int last = off + min(q0 + bq, dm.Sq) - 1;
    ntiles = last < 0 ? 0 : min(ntiles, last / M_KT + 1);
  }
  WarpState<DT> acc;  // only o is used
  acc.init();
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * M_KT;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows(k_s, M_KT, D, SP, [&](int j) -> const __nv_bfloat16* {
      return k0 + j < dm.Skv
                 ? k + ((static_cast<long long>(b) * dm.Skv + k0 + j) * dm.Hkv + h) * D
                 : nullptr;
    }, k, threadIdx.x, nthreads);
    stage_rows(v_s, M_KT, D, SP, [&](int j) -> const __nv_bfloat16* {
      return k0 + j < dm.Skv
                 ? v + ((static_cast<long long>(b) * dm.Skv + k0 + j) * dm.Hkv + h) * D
                 : nullptr;
    }, v, threadIdx.x, nthreads);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!live_warp) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t k_t = smem_u32(k_s + half * H * SP);
      const uint32_t v_t = smem_u32(v_s + half * H * SP);
      float s[NT][4], dp[NT][4];
      scores<DT, NT>(s, qf, q_addr, k_t, SP, D);
      scores<DT, NT>(dp, df, do_addr, v_t, SP, D);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + half * H + t * 8 + 2 * (lane & 3) + (e & 1);
          const int r = e >> 1;
          const bool live = qpos[r] >= 0 && kp < dm.Skv && (!causal || kp <= qpos[r]);
          const float p = live ? exp_ftz(s[t][e] * scale - lse_r[r]) : 0.f;
          dp[t][e] = p * (dp[t][e] - delta_r[r]);
        }
      // dQ += dS K (dS rounded to bf16 as the A operand; K as the B tile)
      accumulate<DT, NT>(acc, dp, k_t, SP, D);
    }
  }
  cp_async_wait<0>();
  if (!live_warp) return;
  store_acc(acc, D, scale, [&](int r) -> __nv_bfloat16* {
    const int rr = row0 + (lane >> 2) + 8 * r;
    if (rr >= rows) return nullptr;
    return dq + ((static_cast<long long>(b) * dm.Sq + q0 + rr / g) * dm.Hq + h * g + rr % g) * D;
  });
}

template <int DT>
cudaError_t launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const __nv_bfloat16* dout, const float* lse, const float* delta,
                       const int* q_offsets, __nv_bfloat16* dq, __nv_bfloat16* dk,
                       __nv_bfloat16* dv, const Dims& dm, int causal, float scale,
                       cudaStream_t stream) {
  const int SP = mma::tile_stride(dm.D);
  {
    const size_t smem = (2 * static_cast<size_t>(M_KEYS) + 2 * M_QT) * SP * 2 +
                        2 * M_QT * sizeof(float);
    auto kern = dkdv_mma_kernel<DT>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const dim3 grid(dm.B * dm.Hkv, (dm.Skv + M_KEYS - 1) / M_KEYS);
    kern<<<grid, M_KW * 32, smem, stream>>>(q, k, v, dout, lse, delta, q_offsets, dk, dv, dm,
                                            causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int bq = max(1, min(M_QROWS / dm.g, dm.Sq));
  const size_t smem = (2 * static_cast<size_t>(M_QROWS) + 2 * M_KT) * SP * 2;
  auto kern = dq_mma_kernel<DT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(dm.B * dm.Hkv, (dm.Sq + bq - 1) / bq);
  kern<<<grid, M_QW * 32, smem, stream>>>(q, k, v, dout, lse, delta, q_offsets, dq, dm, bq,
                                          causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const T* out, const T* dout, float* delta, const Dims& dm,
                         cudaStream_t stream) {
  const long long nrows = static_cast<long long>(dm.B) * dm.Sq * dm.Hq;
  const long long blocks = (nrows + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(out, dout, delta, nrows,
                                                                     dm.Sq, dm.Hq, dm.D);
  return cudaGetLastError();
}

bool valid(const Dims& dm, int step, int max_d) {
  return dm.B > 0 && dm.Sq > 0 && dm.Skv > 0 && dm.Hkv > 0 && dm.Hq % dm.Hkv == 0 &&
         dm.g <= 64 && dm.D > 0 && dm.D % step == 0 && dm.D <= max_d;
}

}  // namespace

// q, out, dout, dq: [B, Sq, Hq, D]; k, v, dk, dv: [B, Skv, Hkv, D]; lse and
// delta (scratch): [B, Hq, Sq] fp32; q_offsets: [B] int32. All contiguous,
// on the device of `stream`. Three launches (delta, dK/dV, dQ). Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       float* delta, const int* q_offsets, void* dq, void* dk,
                                       void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                       int causal, float scale, void* stream) {
  const Dims dm{B, Sq, Skv, Hq, Hkv, Hkv > 0 ? Hq / Hkv : 0, D};
  if (!valid(dm, 4, 256)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_delta(static_cast<const float*>(out), static_cast<const float*>(dout),
                               delta, dm, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* dot = static_cast<const float*>(dout);
  auto* dqt = static_cast<float*>(dq);
  auto* dkt = static_cast<float*>(dk);
  auto* dvt = static_cast<float*>(dv);
#define FB_F32(EPL) \
  launch_f32<EPL>(qt, kt, vt, dot, lse, delta, q_offsets, dqt, dkt, dvt, dm, causal, scale, st)
  if (D <= 32) e = FB_F32(1);
  else if (D <= 64) e = FB_F32(2);
  else if (D <= 128) e = FB_F32(4);
  else e = FB_F32(8);
#undef FB_F32
  return static_cast<int>(e);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const float* lse,
                                        float* delta, const int* q_offsets, void* dq, void* dk,
                                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                        int causal, float scale, void* stream) {
  const Dims dm{B, Sq, Skv, Hq, Hkv, Hkv > 0 ? Hq / Hkv : 0, D};
  if (!valid(dm, 16, 256)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e = launch_delta(static_cast<const bf*>(out), static_cast<const bf*>(dout), delta,
                               dm, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* qt = static_cast<const bf*>(q);
  const auto* kt = static_cast<const bf*>(k);
  const auto* vt = static_cast<const bf*>(v);
  const auto* dot = static_cast<const bf*>(dout);
  auto* dqt = static_cast<bf*>(dq);
  auto* dkt = static_cast<bf*>(dk);
  auto* dvt = static_cast<bf*>(dv);
#define FB_MMA(DT) \
  launch_mma<DT>(qt, kt, vt, dot, lse, delta, q_offsets, dqt, dkt, dvt, dm, causal, scale, st)
  if (D <= 32) e = FB_MMA(32);
  else if (D <= 64) e = FB_MMA(64);
  else if (D <= 128) e = FB_MMA(128);
  else e = FB_MMA(256);
#undef FB_MMA
  return static_cast<int>(e);
}
