// The CUDA-core attention tile: the fp32 instances of flash_attention.cu
// and paged_ragged_attention.cu, and both instances of decode_attention.cu
// (dense and padded paged decode), fold keys with it. A warp carries the
// online-softmax state of up to ROWS query rows and folds one shared-memory
// tile of keys into it. (The bf16 flash and ragged instances use the
// tensor-core tile of mma_attention_tile.cuh instead.)
//
// Scores are computed with lanes over keys (lane j owns keys j, j+32, ...
// of the tile, a full dot product each, q broadcast from shared memory), so
// a row pays two warp reductions (max and sum) per tile, not one per key.
// The PV product runs with lanes over the head dim. Arithmetic is fp32
// FMAs, so fp32 inputs keep the 1e-4 contract that TF32 tensor cores could
// not; p is rounded to the value type before the PV product and the sum l
// takes the unrounded p, as the TPU kernels do. NEG_INF is their finite
// -1e30: masked keys seen before a row's first live key vanish through the
// correction factor. Keys past the end of the tensor do not exist at all
// (NO_KEY), so they never count, not even as masked keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr float NO_KEY = -3.0e38f;  // below NEG_INF: exp() of it is 0
constexpr int ROWS = 8;             // most query rows one warp carries

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of T as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Row stride of a key/value tile in shared memory, in elements: D plus 16
// bytes, so the 16-byte reads of 8 lanes on 8 consecutive rows hit 8
// distinct bank groups.
template <typename T>
__host__ __device__ __forceinline__ int tile_stride(int D) {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Copy `nrows` rows of D elements of K and of V into [nrows, DP] tiles, 16
// bytes per load. row(j) gives row j's offset from k and v, or -1 for a row
// that does not exist (zero-filled, so 0 * garbage never makes a NaN). Each
// thread issues the loads of LOADS vectors of K and V before it stores any,
// so that many round trips to device memory overlap instead of queueing.
template <typename T, typename Row>
__device__ __forceinline__ void load_kv_rows(T* k_dst, T* v_dst, const T* __restrict__ k,
                                             const T* __restrict__ v, int nrows, int D,
                                             int DP, Row row, int tid, int nthreads) {
  constexpr int V = Vec<T>::N;
  constexpr int LOADS = 4;
  const int vpr = D / V;
  const int total = nrows * vpr;
  for (int e0 = tid; e0 < total; e0 += LOADS * nthreads) {
    uint4 kb[LOADS], vb[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * nthreads;
      kb[u] = vb[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < total) {
        const int j = e / vpr, c = e - j * vpr;
        const long long off = row(j);
        if (off >= 0) {
          kb[u] = __ldg(reinterpret_cast<const uint4*>(k + off) + c);
          vb[u] = __ldg(reinterpret_cast<const uint4*>(v + off) + c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * nthreads;
      if (e < total) {
        const int j = e / vpr, c = e - j * vpr;
        *reinterpret_cast<uint4*>(k_dst + j * DP + c * V) = kb[u];
        *reinterpret_cast<uint4*>(v_dst + j * DP + c * V) = vb[u];
      }
    }
  }
}

// The online-softmax state of a warp's R rows; lane l holds the output
// elements d = i * 32 + l, i < EPL.
template <int R, int EPL>
struct RowState {
  float m[R], l[R], acc[R][EPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[r][i] = 0.f;
    }
  }
};

// Fold one tile of NK = 32 * KPL keys into the state. q_s: the warp's rows,
// fp32 [R, D]; k_s, v_s: [NK, DP] tiles; p_s: the warp's fp32 [R, NK]
// scratch. key_state(r, j) for key j < NK of the tile and row r returns 1
// (live), 0 (masked: NEG_INF) or -1 (absent: NO_KEY). soft_cap > 0 caps the
// scaled scores (soft_cap * tanh(s / soft_cap)). Every lane of the warp
// must call it.
template <typename T, int R, int EPL, int KPL, typename KeyState>
__device__ __forceinline__ void fold_tile(RowState<R, EPL>& st, const float* q_s, const T* k_s,
                                          const T* v_s, float* p_s, int D, int DP,
                                          float scale, KeyState key_state,
                                          float soft_cap = 0.f) {
  constexpr int V = Vec<T>::N;
  constexpr int NK = 32 * KPL;
  const int lane = threadIdx.x & 31;

  float s[R][KPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < KPL; ++t) s[r][t] = 0.f;

  for (int d = 0; d < D; d += V) {
    float kf[KPL][V];
#pragma unroll
    for (int t = 0; t < KPL; ++t) Vec<T>::load(k_s + (lane + 32 * t) * DP + d, kf[t]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float qf[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_s + r * D + d + e);
        qf[e] = q4.x; qf[e + 1] = q4.y; qf[e + 2] = q4.z; qf[e + 3] = q4.w;
      }
#pragma unroll
      for (int t = 0; t < KPL; ++t)
#pragma unroll
        for (int e = 0; e < V; ++e) s[r][t] = fmaf(qf[e], kf[t][e], s[r][t]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    float tmax = NO_KEY;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int ks = key_state(r, lane + 32 * t);
      float x = s[r][t] * scale;
      if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
      s[r][t] = ks > 0 ? x : (ks == 0 ? NEG_INF : NO_KEY);
      tmax = fmaxf(tmax, s[r][t]);
    }
    const float m_new = fmaxf(st.m[r], warp_max(tmax));
    const float corr = expf(st.m[r] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const float p = expf(s[r][t] - m_new);
      psum += p;
      // the PV product takes p in the value type, as the TPU kernels do
      p_s[r * NK + lane + 32 * t] = to_f(from_f<T>(p));
    }
    st.l[r] = st.l[r] * corr + warp_sum(psum);
    st.m[r] = m_new;
#pragma unroll
    for (int i = 0; i < EPL; ++i) st.acc[r][i] *= corr;
  }
  __syncwarp();

  for (int j = 0; j < NK; j += 4) {
    float vv[4][EPL];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = i * 32 + lane;
        vv[jj][i] = d < D ? to_f(v_s[(j + jj) * DP + d]) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * NK + j);
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float a = st.acc[r][i];
        a = fmaf(p4.x, vv[0][i], a);
        a = fmaf(p4.y, vv[1][i], a);
        a = fmaf(p4.z, vv[2][i], a);
        a = fmaf(p4.w, vv[3][i], a);
        st.acc[r][i] = a;
      }
    }
  }
  __syncwarp();
}

}  // namespace attn
