// GQA decode attention for Hopper (sm_90a), against a contiguous cache and
// through a block table, with a plain C interface loaded through ctypes
// (see repro_torch/kernels/build.py). One kernel, templated on how a key's
// address is found.
//
// Replaces two Pallas TPU kernels and computes their functions:
// - src/repro/kernels/decode_attention.py::decode_attention_kernel: the g
//   query heads of kv head h attend to k/v[b, :, h] masked by kpos <
//   lens[b] (lens counts the newly written token). The cache is read in the
//   model's [B, S, Hkv, D] layout, in place. Tiles past lens[b] are
//   skipped: exact for lens >= 1, the wrapper's contract (the TPU kernel
//   returns the mean of all values at lens == 0, which no caller passes).
// - src/repro/kernels/paged_decode_attention.py::paged_decode_attention_kernel:
//   the same through block_tables[b] into pools [num_blocks, bs, Hkv, D],
//   walking all nmax blocks, masked by lens, with no skip: the padded
//   baseline against which the ragged kernel's skip is measured.
// Both keep the TPU kernels' numerics: fp32 m/l/acc, the finite NEG_INF,
// p rounded to the value type before the PV product.
//
// What bounds it on the H100: bytes. Each live K/V element is read once per
// (sequence, kv head), ~2*g flops per element read, far below the ~295
// flop/byte ridge of bf16. The design: one CTA per (b * Hkv + h, group of
// up to 8 query heads; 4 when g <= 4) keeps the group's queries in shared
// memory, so KV is never expanded to Hq heads; its 8 warps (4 where shared
// memory is short) split the key range (warp w takes tiles w, w + nwarps,
// ...), each staging its own 32-key K and V tiles in shared memory with
// 16-byte loads, several in flight per lane, and the warps' partial softmax
// states merge at the end. No split across CTAs yet, so B * Hkv CTAs fill
// the card only at large batch.

#include "attention_tile.cuh"

namespace {

using namespace attn;

constexpr int KPL = 1;
constexpr int NK = 32 * KPL;  // keys per warp tile
constexpr int MAX_WARPS = 8;

// Keys of a contiguous cache [B, S, Hkv, D]: key p of (b, h).
template <typename T>
struct DenseKeys {
  const T* k;
  const T* v;
  int S;
  long long row;  // elements between positions: Hkv * D
  __device__ __forceinline__ int limit(int lens) const { return min(lens, S); }
  __device__ __forceinline__ long long offset(int b, int h, int Hkv, int D, int p) const {
    return (static_cast<long long>(b) * S + p) * row + static_cast<long long>(h) * D;
  }
};

// Keys through a block table into pools [num_blocks, bs, Hkv, D]: every
// position of every one of the nmax blocks is walked (the padded walk).
template <typename T>
struct PagedKeys {
  const T* k;
  const T* v;
  const int* tables;  // [B, nmax]
  int nmax, bs;
  __device__ __forceinline__ int limit(int) const { return nmax * bs; }
  __device__ __forceinline__ long long offset(int b, int h, int Hkv, int D, int p) const {
    const int blk = tables[static_cast<long long>(b) * nmax + p / bs];
    return ((static_cast<long long>(blk) * bs + p % bs) * Hkv + h) * D;
  }
};

template <typename T, int R, int EPL, typename Keys>
__global__ void __launch_bounds__(MAX_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, T* __restrict__ out, Keys keys,
                        const int* __restrict__ lens, int Hkv, int g, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = tile_stride<T>(D);
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = reinterpret_cast<float*>(smem);                      // [R, D]
  float* m_s = q_s + R * D;                                         // [nwarps, R]
  float* l_s = m_s + nwarps * R;                                    // [nwarps, R]
  float* a_s = l_s + nwarps * R;                                    // [nwarps, R, D]
  float* p_s = a_s + nwarps * R * D + warp * R * NK;                // [R, NK]
  T* k_s = reinterpret_cast<T*>(a_s + nwarps * R * (D + NK)) + warp * 2 * NK * DP;
  T* v_s = k_s + NK * DP;

  const int n = blockIdx.x;  // b * Hkv + h
  const int b = n / Hkv, h = n - b * Hkv;
  const int row0 = blockIdx.y * R;
  const int rows = min(R, g - row0);
  const int len = lens[b];

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    q_s[e] = r < rows ? to_f(q[(static_cast<long long>(n) * g + row0 + r) * D + d]) : 0.f;
  }
  __syncthreads();

  RowState<R, EPL> st;
  st.init();
  const int limit = keys.limit(len);
  const int ntiles = (limit + NK - 1) / NK;
  for (int kt = warp; kt < ntiles; kt += nwarps) {
    const int k0 = kt * NK;
    load_kv_rows(k_s, v_s, keys.k, keys.v, NK, D, DP, [&](int j) {
      return k0 + j < limit ? keys.offset(b, h, Hkv, D, k0 + j) : -1LL;
    }, lane, 32);
    __syncwarp();
    fold_tile<T, R, EPL, KPL>(st, q_s, k_s, v_s, p_s, D, DP, scale, [&](int, int j) {
      const int kpos = k0 + j;
      if (kpos >= limit) return -1;
      return kpos < len ? 1 : 0;
    });
  }

  // merge the warps' partial states
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      m_s[warp * R + r] = st.m[r];
      l_s[warp * R + r] = st.l[r];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = i * 32 + lane;
      if (d < D) a_s[(warp * R + r) * D + d] = st.acc[r][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    float mx = NEG_INF;
    for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, m_s[w * R + r]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float c = expf(m_s[w * R + r] - mx);
      l += l_s[w * R + r] * c;
      a += a_s[(w * R + r) * D + d] * c;
    }
    out[(static_cast<long long>(n) * g + row0 + r) * D + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
size_t smem_bytes(int R, int D, int nwarps) {
  return (static_cast<size_t>(R) * D + 2 * nwarps * R +
          static_cast<size_t>(nwarps) * R * (D + NK)) * sizeof(float) +
         static_cast<size_t>(nwarps) * 2 * NK * tile_stride<T>(D) * sizeof(T);
}

template <typename T, int R, int EPL, typename Keys>
cudaError_t launch(const T* q, T* out, Keys keys, const int* lens, int B, int Hkv, int g,
                   int D, float scale, cudaStream_t stream) {
  constexpr size_t SMEM_MAX = 227 * 1024;
  const int nwarps = smem_bytes<T>(R, D, MAX_WARPS) <= SMEM_MAX ? MAX_WARPS : MAX_WARPS / 2;
  const size_t smem = smem_bytes<T>(R, D, nwarps);
  auto kern = decode_attention_kernel<T, R, EPL, Keys>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(B * Hkv, (g + R - 1) / R);
  kern<<<grid, nwarps * 32, smem, stream>>>(q, out, keys, lens, Hkv, g, D, scale);
  return cudaGetLastError();
}

template <typename T, int R, typename Keys>
cudaError_t launch_d(const T* q, T* out, Keys keys, const int* lens, int B, int Hkv, int g,
                     int D, float scale, cudaStream_t stream) {
  if (D <= 32) return launch<T, R, 1>(q, out, keys, lens, B, Hkv, g, D, scale, stream);
  if (D <= 64) return launch<T, R, 2>(q, out, keys, lens, B, Hkv, g, D, scale, stream);
  if (D <= 128) return launch<T, R, 4>(q, out, keys, lens, B, Hkv, g, D, scale, stream);
  if (D <= 256) return launch<T, R, 8>(q, out, keys, lens, B, Hkv, g, D, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T, typename Keys>
int dispatch(const void* q, void* out, Keys keys, const int* lens, int B, int Hkv, int g,
             int D, float scale, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0 || D <= 0 || D % Vec<T>::N != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
  // a group of at most 4 heads takes the 4-row state: no FMA on empty rows
  const cudaError_t e =
      g <= 4 ? launch_d<T, 4>(qt, ot, keys, lens, B, Hkv, g, D, scale, stream)
             : launch_d<T, ROWS>(qt, ot, keys, lens, B, Hkv, g, D, scale, stream);
  return static_cast<int>(e);
}

template <typename T>
int dense(const void* q, const void* k, const void* v, void* out, const int* lens, int B,
          int S, int Hkv, int g, int D, float scale, void* stream) {
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DenseKeys<T> keys{static_cast<const T*>(k), static_cast<const T*>(v), S,
                          static_cast<long long>(Hkv) * D};
  return dispatch<T>(q, out, keys, lens, B, Hkv, g, D, scale,
                     static_cast<cudaStream_t>(stream));
}

template <typename T>
int paged(const void* q, const void* k_pool, const void* v_pool, void* out,
          const int* block_tables, const int* lens, int B, int Hkv, int g, int D, int bs,
          int nmax, float scale, void* stream) {
  if (bs <= 0 || nmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedKeys<T> keys{static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
                          block_tables, nmax, bs};
  return dispatch<T>(q, out, keys, lens, B, Hkv, g, D, scale,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, out: [B, Hkv, g, D]; k, v: [B, S, Hkv, D]; lens: [B] int32 >= 1. All
// contiguous, 16-byte aligned, on the device of `stream`. Returns a
// cudaError_t (0 = launched).
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v, void* out,
                                    const int* lens, int B, int S, int Hkv, int g, int D,
                                    float scale, void* stream) {
  return dense<float>(q, k, v, out, lens, B, S, Hkv, g, D, scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                     const int* lens, int B, int S, int Hkv, int g, int D,
                                     float scale, void* stream) {
  return dense<__nv_bfloat16>(q, k, v, out, lens, B, S, Hkv, g, D, scale, stream);
}

// q, out: [B, Hkv, g, D]; k_pool, v_pool: [num_blocks, bs, Hkv, D];
// block_tables: [B, nmax] int32 (0 = null block); lens: [B] int32 >= 1.
extern "C" int paged_decode_attention_f32(const void* q, const void* k_pool,
                                          const void* v_pool, void* out,
                                          const int* block_tables, const int* lens, int B,
                                          int Hkv, int g, int D, int bs, int nmax,
                                          float scale, void* stream) {
  return paged<float>(q, k_pool, v_pool, out, block_tables, lens, B, Hkv, g, D, bs, nmax,
                      scale, stream);
}

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool, void* out,
                                           const int* block_tables, const int* lens, int B,
                                           int Hkv, int g, int D, int bs, int nmax,
                                           float scale, void* stream) {
  return paged<__nv_bfloat16>(q, k_pool, v_pool, out, block_tables, lens, B, Hkv, g, D, bs,
                              nmax, scale, stream);
}
