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
// head, halved by causality, against the inputs read once per group; the
// kernels compute seven, since the dQ launch recomputes S and dP so that no
// launch needs atomics: a dQ summed across key tiles in a fixed order would
// move ~1 GB of fp32 partials at a training microbatch). Which kernels run
// is the wrapper's `design`, by type and shape alone:
//
// - bf16, D 64 and 128 (wgmma, the `wg` namespace): the tensor cores' full
//   rate is reached only through wgmma, fed from shared memory by TMA. The
//   dK/dV CTA holds 128 keys in two consumer warpgroups of 64; a producer
//   warp loads their K and V once and streams the Q and dO tiles (64 query
//   rows of one head) of every head of the group, with the rows' lse and
//   delta, through a ring of KV_ST stages on mbarriers. Each consumer
//   computes S^T = K Q^T and dP^T = V dO^T by wgmma (both operands K-major
//   in shared memory), P^T and dS^T in registers, and dV += P^T dO, dK +=
//   dS^T Q by wgmma with the bf16-rounded accumulators as A in registers
//   and the same Q and dO tiles read MN-major as B; dK and dV stay in
//   registers over the walk (setmaxnreg moves the producer's registers to
//   the consumers). Key tiles start in order of causal work, the heaviest
//   first. The dQ CTA loads its 64 rows (64 / g positions x the group's g
//   heads) of Q and dO once and streams K and V tiles of 64 keys through a
//   ring; S = Q K^T, dP = dO V^T, then dQ += dS K (K read MN-major), the
//   causal early exit past the last visible key tile, the heaviest tiles
//   first. hopper.cuh holds the descriptors, the wgmma, TMA and mbarrier
//   instructions and the tensor maps.
// - other bf16 D (a multiple of 16 up to 256): mma.sync m16n8k16 over
//   mma_attention_tile.cuh (scores and accumulate: the dK/dV launch computes
//   S^T = K Q^T with the warp's 16 keys as rows, so P^T and dS^T are A
//   operands as they stand; dQ runs as the forward does), cp.async staging.
// - fp32 on the CUDA cores (lanes over queries or keys for the dots, lanes
//   over the head dim for the sums), holding the 1e-4 contract that TF32
//   would not.
//
// P and dS are rounded to bf16 before their products, as the forward rounds
// P. The delta launch reads bf16 with 16-byte vectors.

#include "attention_tile.cuh"
#include "hopper.cuh"
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

// ---------------------------------------------------------------------------
// bf16, D 64 and 128: wgmma on tiles that TMA brings through an mbarrier ring
// ---------------------------------------------------------------------------
namespace wg {
using namespace hopper;

constexpr int KEYS = 128;           // keys per dK/dV CTA: two consumer warpgroups of 64
constexpr int QT = 64;              // query rows per streamed tile (dK/dV)
constexpr int KT = 64;              // keys per streamed tile (dQ)
constexpr int KV_ST = 3;            // ring stages of the dK/dV CTA (query tiles)
constexpr int Q_ST = 2;             // ring stages of the dQ CTA (key tiles)
constexpr int DKDV_THREADS = 384;   // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int DQ_THREADS = 160;     // consumer warpgroup 0; producer warp 4
constexpr float LOG2E = 1.4426950408889634f;
constexpr float DEAD_LSE = 1e30f;   // the log-sum-exp of a row that does not exist: p = 0

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// Shared memory of the dK/dV CTA, byte offsets: the K and V of its 128 keys
// (one 64-row tile per consumer warpgroup), a ring of query tiles of Q and
// dO with their rows' lse (times log2 e) and delta, the barriers.
template <int D>
struct DkdvSmem {
  static constexpr int TILE = (D / BOX) * BOX_BYTES;  // 64 rows x D
  static constexpr int K = 0;
  static constexpr int V = K + 2 * TILE;
  static constexpr int Q = V + 2 * TILE;
  static constexpr int DO = Q + KV_ST * TILE;
  static constexpr int LD = DO + KV_ST * TILE;         // [KV_ST][2 * QT] fp32
  static constexpr int BAR = LD + KV_ST * 2 * QT * 4;  // full[KV_ST], empty[KV_ST], kv
  static constexpr int BYTES = BAR + (2 * KV_ST + 1) * 8 + 1024;  // + alignment
};

// dK, dV for the 128 keys [k0, k0 + 128) of one (b, kv head h). The producer
// warp loads K and V once, then streams (Q, dO, lse, delta) tiles of 64
// query rows of every head of the group through the ring; each consumer
// warpgroup computes, for its 64 keys, S^T = K Q^T and dP^T = V dO^T
// (wgmma, both operands K-major in shared memory), P^T and dS^T in
// registers, then dV += P^T dO and dK += dS^T Q (wgmma, A the bf16-rounded
// P^T and dS^T in registers, B the same Q and dO tiles read MN-major). dK
// and dV stay in registers over the whole walk.
template <int D>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ q_offsets,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Dims dm,
                  int causal, float scale) {
  using L = DkdvSmem<D>;
  constexpr int NB = D / BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  float* ld = reinterpret_cast<float*>(smem + L::LD);

  // key tiles in order of causal work: every (b, h) of tile 0 first
  const int nbh = dm.B * dm.Hkv;
  const int kt = blockIdx.x / nbh, n = blockIdx.x - kt * nbh;
  const int b = n / dm.Hkv, h = n - b * dm.Hkv;
  const int k0 = kt * KEYS;
  const int off = q_offsets[b];
  // the first query tile that can see key k0 (causal), then every tile
  const int i_first = causal ? min(dm.Sq, max(0, k0 - off) / QT * QT) : 0;
  const int ntq = (dm.Sq - i_first + QT - 1) / QT;
  const int niters = dm.g * ntq;
  const uint32_t full = base + L::BAR, empty = full + KV_ST * 8, kv_bar = empty + KV_ST * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_ST; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes (lse, delta)
      mbar_init(empty + 8 * s, 8);  // the consumer warps
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: warp 8 loads, warps 9-11 only give registers up
    regs_dealloc<24>();
    const int lane = threadIdx.x & 31;
    if ((threadIdx.x >> 5) == 8 && niters > 0) {
      if (lane == 0) {
        mbar_arrive_tx(kv_bar, 4 * L::TILE);
        for (int w = 0; w < 2; ++w)
          for (int bb = 0; bb < NB; ++bb) {
            const uint32_t o = w * L::TILE + bb * BOX_BYTES;
            tma_load_4d(base + L::K + o, &tm_k, kv_bar, bb * BOX, h, k0 + 64 * w, b);
            tma_load_4d(base + L::V + o, &tm_v, kv_bar, bb * BOX, h, k0 + 64 * w, b);
          }
      }
      for (int it = 0; it < niters; ++it) {
        const int s = it % KV_ST;
        mbar_wait(empty + 8 * s, ((it / KV_ST) & 1) ^ 1);
        const int j = it / ntq, i0 = i_first + (it - j * ntq) * QT, hq = h * dm.g + j;
        const long long row0 = (static_cast<long long>(b) * dm.Hq + hq) * dm.Sq;
        for (int qq = lane; qq < QT; qq += 32) {
          const bool ok = i0 + qq < dm.Sq;
          ld[s * 2 * QT + qq] = ok ? lse[row0 + i0 + qq] * LOG2E : DEAD_LSE;
          ld[s * 2 * QT + QT + qq] = ok ? delta[row0 + i0 + qq] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_tx(full + 8 * s, 2 * L::TILE);
          for (int bb = 0; bb < NB; ++bb) {
            const uint32_t o = s * L::TILE + bb * BOX_BYTES;
            tma_load_4d(base + L::Q + o, &tm_q, full + 8 * s, bb * BOX, hq, i0, b);
            tma_load_4d(base + L::DO + o, &tm_do, full + 8 * s, bb * BOX, hq, i0, b);
          }
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: keys [k0 + 64 wg, k0 + 64 wg + 64)
    regs_alloc<240>();
    const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int kbase = k0 + 64 * wgi;
    const int kr = kbase + 16 * warp + (lane >> 2);  // this thread's keys: kr, kr + 8
    const uint32_t k_a = base + L::K + wgi * L::TILE, v_a = base + L::V + wgi * L::TILE;
    const float sl2 = scale * LOG2E;
    float adv[D / 2], adk[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) adv[e] = adk[e] = 0.f;
    if (niters > 0) mbar_wait(kv_bar, 0);
    for (int it = 0; it < niters; ++it) {
      const int s = it % KV_ST;
      mbar_wait(full + 8 * s, (it / KV_ST) & 1);
      const int j = it / ntq, i0 = i_first + (it - j * ntq) * QT;
      const uint32_t q_a = base + L::Q + s * L::TILE, do_a = base + L::DO + s * L::TILE;
      // S^T = K Q^T, dP^T = V dO^T: rows the warpgroup's keys, columns the tile's queries
      float sacc[32], dpacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sacc, desc_k(k_a, kk), desc_k(q_a, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpacc, desc_k(v_a, kk), desc_k(do_a, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sacc);
      const float* lse_s = ld + s * 2 * QT;
      const float* dl_s = lse_s + QT;
      // every key of the warpgroup sees every query of the tile: no mask
      const bool seen = !causal || kbase + 63 <= off + i0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = 8 * t + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(sacc[4 * t + e] * sl2 - ((e & 1) ? l2.y : l2.x));
          if (!seen && kr + 8 * (e >> 1) > off + i0 + c + (e & 1)) p = 0.f;
          sacc[4 * t + e] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpacc);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * t + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpacc[4 * t + e] = sacc[4 * t + e] * (dpacc[4 * t + e] - ((e & 1) ? d2.y : d2.x));
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        pack_a(sacc, kc, pa[kc]);
        pack_a(dpacc, kc, da[kc]);
      }
      // dV += P^T dO, dK += dS^T Q (P^T, dS^T rounded to bf16; dO and Q MN-major)
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs<D>(adv, pa[kc], desc_mn(do_a, kc), 1);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs<D>(adk, da[kc], desc_mn(q_a, kc), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = kr + 8 * r;
      if (kpos >= dm.Skv) continue;
      const long long dst = ((static_cast<long long>(b) * dm.Skv + kpos) * dm.Hkv + h) * D;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        const int d = 8 * t + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(dk + dst + d) =
            pack_bf16(adk[4 * t + 2 * r] * scale, adk[4 * t + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + dst + d) =
            pack_bf16(adv[4 * t + 2 * r], adv[4 * t + 2 * r + 1]);
      }
    }
  }
}

// Shared memory of the dQ CTA: its Q and dO rows (loaded once), a ring of
// key tiles of K and V, the barriers.
template <int D>
struct DqSmem {
  static constexpr int TILE = (D / BOX) * BOX_BYTES;  // 64 rows x D
  static constexpr int Q = 0;
  static constexpr int DO = TILE;
  static constexpr int K = 2 * TILE;
  static constexpr int V = K + Q_ST * TILE;
  static constexpr int BAR = V + Q_ST * TILE;  // full[Q_ST], empty[Q_ST], q
  static constexpr int BYTES = BAR + (2 * Q_ST + 1) * 8 + 1024;
};

// dQ for 64 rows of one (b, kv head h): P = 64 / g positions x the group's
// g heads (row r: position q0 + r / g, head h g + r % g, as the forward
// orders them; Q[b, i, h g : h g + g] is contiguous, so one TMA box per 64
// columns loads them). The producer warp streams K and V tiles of 64 keys
// through the ring; the consumer warpgroup computes S = Q K^T and dP = dO
// V^T (wgmma, K-major operands), dS in registers, then dQ += dS K (A the
// bf16-rounded dS in registers, B the K tile read MN-major).
template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 2)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_offsets, __nv_bfloat16* __restrict__ dq, Dims dm,
                int causal, float scale) {
  using L = DqSmem<D>;
  constexpr int NB = D / BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);

  const int g = dm.g, P = 64 / g, rows = P * g;
  // query tiles in order of causal work: every (b, h) of the last tile first
  const int nbh = dm.B * dm.Hkv, nqt = (dm.Sq + P - 1) / P;
  const int qi = blockIdx.x / nbh, n = blockIdx.x - qi * nbh;
  const int b = n / dm.Hkv, h = n - b * dm.Hkv;
  const int q0 = (nqt - 1 - qi) * P;
  const int off = q_offsets[b];
  int ntiles = (dm.Skv + KT - 1) / KT;
  if (causal) {
    const int last = off + min(q0 + P, dm.Sq) - 1;
    ntiles = last < 0 ? 0 : min(ntiles, last / KT + 1);
  }
  const uint32_t full = base + L::BAR, empty = full + Q_ST * 8, q_bar = empty + Q_ST * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the consumer warps
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  // rows [rows, 64) of the Q and dO tiles are never loaded (g does not
  // divide 64): zeros, so their scores are finite
  for (int e = threadIdx.x; e < (64 - rows) * 8 * NB; e += blockDim.x) {
    const int bb = e / ((64 - rows) * 8), rest = e - bb * (64 - rows) * 8;
    const int o = bb * BOX_BYTES + (rows + rest / 8) * 128 + (rest % 8) * 16;
    *reinterpret_cast<uint4*>(smem + L::Q + o) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(smem + L::DO + o) = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 issues every load
    if (threadIdx.x == 128 && ntiles > 0) {
      mbar_arrive_tx(q_bar, 2 * NB * rows * 128);
      for (int bb = 0; bb < NB; ++bb) {
        tma_load_4d(base + L::Q + bb * BOX_BYTES, &tm_q, q_bar, bb * BOX, h * g, q0, b);
        tma_load_4d(base + L::DO + bb * BOX_BYTES, &tm_do, q_bar, bb * BOX, h * g, q0, b);
      }
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % Q_ST;
        mbar_wait(empty + 8 * s, ((kt / Q_ST) & 1) ^ 1);
        mbar_arrive_tx(full + 8 * s, 2 * L::TILE);
        for (int bb = 0; bb < NB; ++bb) {
          const uint32_t o = s * L::TILE + bb * BOX_BYTES;
          tma_load_4d(base + L::K + o, &tm_k, full + 8 * s, bb * BOX, h, kt * KT, b);
          tma_load_4d(base + L::V + o, &tm_v, full + 8 * s, bb * BOX, h, kt * KT, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
    int qpos[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int p = row / g, j = row - p * g;
      const bool live = row < rows && q0 + p < dm.Sq;
      const long long idx = (static_cast<long long>(b) * dm.Hq + h * g + j) * dm.Sq + q0 + p;
      qpos[r] = off + q0 + p;
      lse2[r] = live ? lse[idx] * LOG2E : DEAD_LSE;
      dlt[r] = live ? delta[idx] : 0.f;
    }
    const float sl2 = scale * LOG2E;
    const uint32_t q_a = base + L::Q, do_a = base + L::DO;
    float adq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) adq[e] = 0.f;
    if (ntiles > 0) mbar_wait(q_bar, 0);
    for (int kt = 0; kt < ntiles; ++kt) {
      const int s = kt % Q_ST, k0 = kt * KT;
      mbar_wait(full + 8 * s, (kt / Q_ST) & 1);
      const uint32_t k_a = base + L::K + s * L::TILE, v_a = base + L::V + s * L::TILE;
      float sacc[32], dpacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sacc, desc_k(q_a, kk), desc_k(k_a, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpacc, desc_k(do_a, kk), desc_k(v_a, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sacc);
      // every key of the tile exists and every row sees it: no mask
      const bool seen = k0 + KT <= dm.Skv && (!causal || k0 + KT - 1 <= off + q0);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * t + 2 * (lane & 3) + (e & 1);
          float p = ex2(sacc[4 * t + e] * sl2 - lse2[e >> 1]);
          if (!seen && (kp >= dm.Skv || (causal && kp > qpos[e >> 1]))) p = 0.f;
          sacc[4 * t + e] = p;
        }
      wgmma_wait<0>();
      fence_regs(dpacc);
      uint32_t da[4][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpacc[4 * t + e] = sacc[4 * t + e] * (dpacc[4 * t + e] - dlt[e >> 1]);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) pack_a(dpacc, kc, da[kc]);
      // dQ += dS K (dS rounded to bf16; K MN-major)
      fence_regs(adq);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs<D>(adq, da[kc], desc_mn(k_a, kc), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adq);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int p = row / g, j = row - p * g;
      if (row >= rows || q0 + p >= dm.Sq) continue;
      __nv_bfloat16* dst = dq + ((static_cast<long long>(b) * dm.Sq + q0 + p) * dm.Hq + h * g + j) * D;
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
        *reinterpret_cast<uint32_t*>(dst + 8 * t + 2 * (lane & 3)) =
            pack_bf16(adq[4 * t + 2 * r] * scale, adq[4 * t + 2 * r + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* dout, const float* lse, const float* delta,
                   const int* q_offsets, __nv_bfloat16* dq, __nv_bfloat16* dk,
                   __nv_bfloat16* dv, const Dims& dm, int causal, float scale,
                   cudaStream_t stream) {
  const uint64_t row = static_cast<uint64_t>(D) * 2;  // bytes
  CUtensorMap tq, tdo, tk, tv, tqg, tdog;
  const int P = 64 / dm.g;
  cudaError_t e;
  const uint64_t qs1 = row, qs2 = row * dm.Hq, qs3 = row * dm.Hq * dm.Sq;
  const uint64_t ks1 = row, ks2 = row * dm.Hkv, ks3 = row * dm.Hkv * dm.Skv;
  if ((e = tensor_map_bf16(&tq, q, D, dm.Hq, dm.Sq, dm.B, qs1, qs2, qs3, 1, QT)) ||
      (e = tensor_map_bf16(&tdo, dout, D, dm.Hq, dm.Sq, dm.B, qs1, qs2, qs3, 1, QT)) ||
      (e = tensor_map_bf16(&tk, k, D, dm.Hkv, dm.Skv, dm.B, ks1, ks2, ks3, 1, 64)) ||
      (e = tensor_map_bf16(&tv, v, D, dm.Hkv, dm.Skv, dm.B, ks1, ks2, ks3, 1, 64)) ||
      (e = tensor_map_bf16(&tqg, q, D, dm.Hq, dm.Sq, dm.B, qs1, qs2, qs3, dm.g, P)) ||
      (e = tensor_map_bf16(&tdog, dout, D, dm.Hq, dm.Sq, dm.B, qs1, qs2, qs3, dm.g, P)))
    return e;
  const long long nbh = static_cast<long long>(dm.B) * dm.Hkv;
  {
    auto kern = dkdv_wgmma_kernel<D>;
    const int smem = DkdvSmem<D>::BYTES;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return e;
    const long long grid = nbh * ((dm.Skv + KEYS - 1) / KEYS);
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    kern<<<static_cast<unsigned>(grid), DKDV_THREADS, smem, stream>>>(
        tq, tdo, tk, tv, lse, delta, q_offsets, dk, dv, dm, causal, scale);
    if ((e = cudaGetLastError())) return e;
  }
  auto kern = dq_wgmma_kernel<D>;
  const int smem = DqSmem<D>::BYTES;
  if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return e;
  const long long grid = nbh * ((dm.Sq + P - 1) / P);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(grid), DQ_THREADS, smem, stream>>>(tqg, tdog, tk, tv, lse, delta,
                                                                 q_offsets, dq, dm, causal, scale);
  return cudaGetLastError();
}

}  // namespace wg

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

// delta in bf16 with 16-byte reads: LPR lanes per row (a power of two), 8
// values a lane per read, the lanes' sums reduced in one fixed order.
template <int LPR>
__global__ void __launch_bounds__(256)
delta_bf16_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ delta, long long nrows, int Sq, int Hq, int D) {
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const long long row =
      (static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5)) * (32 / LPR) + lane / LPR;
  float acc = 0.f;
  if (row < nrows) {
    const uint4* o = reinterpret_cast<const uint4*>(out + row * D);
    const uint4* d = reinterpret_cast<const uint4*>(dout + row * D);
    for (int c = sub; c < D / 8; c += LPR) {
      const uint4 a = __ldg(o + c), bv = __ldg(d + c);
      const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 x = __bfloat1622float2(ah[q]), y = __bfloat1622float2(bh[q]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (sub == 0 && row < nrows) {
    const long long bi = row / Hq;
    const int n = static_cast<int>(row - bi * Hq);
    const long long b = bi / Sq;
    const int i = static_cast<int>(bi - b * Sq);
    delta[(b * Hq + n) * Sq + i] = acc;
  }
}

cudaError_t launch_delta_bf16(const __nv_bfloat16* out, const __nv_bfloat16* dout, float* delta,
                              const Dims& dm, cudaStream_t stream) {
  const long long nrows = static_cast<long long>(dm.B) * dm.Sq * dm.Hq;
  int lpr = 2;
  while (lpr < 32 && lpr < dm.D / 8) lpr *= 2;
  const long long per_block = 8 * (32 / lpr);
  const long long blocks = (nrows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
#define DB(L) \
  delta_bf16_kernel<L><<<grid, 256, 0, stream>>>(out, dout, delta, nrows, dm.Sq, dm.Hq, dm.D)
  if (lpr == 2) DB(2);
  else if (lpr == 4) DB(4);
  else if (lpr == 8) DB(8);
  else if (lpr == 16) DB(16);
  else DB(32);
#undef DB
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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

// The same function for bf16 with any D the mma.sync kernels take (a
// multiple of 16 up to 256); q, k, v, out, dout 16-byte aligned.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const float* lse,
                                        float* delta, const int* q_offsets, void* dq, void* dk,
                                        void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                        int causal, float scale, void* stream) {
  const Dims dm{B, Sq, Skv, Hq, Hkv, Hkv > 0 ? Hq / Hkv : 0, D};
  if (!valid(dm, 16, 256)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (!aligned16(out) || !aligned16(dout)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t e = launch_delta_bf16(static_cast<const bf*>(out), static_cast<const bf*>(dout),
                                    delta, dm, st);
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

// The same function for bf16 with D 64 or 128 (any group size up to 64): the
// wgmma kernels. q, k, v, out, dout 16-byte aligned. Three launches (delta,
// dK/dV, dQ).
extern "C" int flash_attention_bwd_bf16_wgmma(const void* q, const void* k, const void* v,
                                              const void* out, const void* dout,
                                              const float* lse, float* delta,
                                              const int* q_offsets, void* dq, void* dk, void* dv,
                                              int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                              int causal, float scale, void* stream) {
  const Dims dm{B, Sq, Skv, Hq, Hkv, Hkv > 0 ? Hq / Hkv : 0, D};
  if (!valid(dm, 64, 128)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, out, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e = launch_delta_bf16(static_cast<const bf*>(out), static_cast<const bf*>(dout),
                                    delta, dm, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* qt = static_cast<const bf*>(q);
  const auto* kt = static_cast<const bf*>(k);
  const auto* vt = static_cast<const bf*>(v);
  const auto* dot = static_cast<const bf*>(dout);
  auto* dqt = static_cast<bf*>(dq);
  auto* dkt = static_cast<bf*>(dk);
  auto* dvt = static_cast<bf*>(dv);
  if (D == 64)
    e = wg::launch<64>(qt, kt, vt, dot, lse, delta, q_offsets, dqt, dkt, dvt, dm, causal, scale, st);
  else
    e = wg::launch<128>(qt, kt, vt, dot, lse, delta, q_offsets, dqt, dkt, dvt, dm, causal, scale,
                        st);
  return static_cast<int>(e);
}
