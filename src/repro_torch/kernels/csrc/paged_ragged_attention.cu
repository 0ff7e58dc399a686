// Ragged paged GQA attention for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see repro_torch/kernels/build.py).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_ragged_attention.py::paged_ragged_attention_kernel
// (body _kernel) and computes the same function: for every sequence b and
// kv head h, the g*C query rows of the head's group attend, with an online
// softmax in fp32, to the keys of the blocks listed in block_tables[b].
// Column c of row b sits at global position ctx - q_len + c and sees keys
// kpos <= that position, kpos < ctx, and (window > 0) kpos > pos - window.
// Blocks past ceil(ctx / bs) (clamped to [1, nmax]) or wholly below the
// window of the earliest real column are skipped; rows with ctx == 0 give
// zeros. NEG_INF is the finite -1e30 of the TPU kernel, so masked keys seen
// before a row's first live key vanish through the correction factor.
//
// What bounds it on the H100: bytes. Each live K/V block is read once per
// (sequence, kv head) and the work per byte is ~2*g*C flops, far below the
// ~295 flop/byte ridge of bf16. The design: one CTA per (b*Hkv, group of
// rows) stages each live [bs, D] K and V tile in shared memory once (16-byte
// vector loads when aligned) and every warp of the CTA reuses it for its own
// query row, so the group is broadcast and KV is never expanded to Hq heads.
// Lanes split D; scores are warp reductions. Skipped blocks are never read.
// No tensor cores, no TMA and no double buffering yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
// below NEG_INF: a lane past the sub-tile never wins the block max
constexpr float NO_KEY = -3.0e38f;
constexpr int MAX_WARPS = 8;

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

// Copy `rows` rows of D elements, row stride `stride` (elements), into a
// dense [rows, D] tile in shared memory.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows, int D,
                                          size_t stride, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = D / V;
    for (int e = threadIdx.x; e < rows * vpr; e += blockDim.x) {
      const int r = e / vpr, cv = e % vpr;
      reinterpret_cast<uint4*>(dst + r * D)[cv] =
          reinterpret_cast<const uint4*>(src + r * stride)[cv];
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
      const int r = e / D, d = e % D;
      dst[e] = src[r * stride + d];
    }
  }
}

// EPL: elements of the head dim each lane holds (D <= 32 * EPL).
template <typename T, int EPL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool, T* __restrict__ out,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ q_lens,
                              const int* __restrict__ ctx_lens, int Hkv, int g, int C,
                              int D, int bs, int nmax, int window, float soft_cap,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_tile = reinterpret_cast<T*>(smem);
  T* v_tile = k_tile + bs * D;

  const int n = blockIdx.x;  // b * Hkv + h
  const int b = n / Hkv, h = n % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = g * C;
  const int r = blockIdx.y * (blockDim.x >> 5) + warp;  // row of the [g*C] axis
  const bool active = r < rows;                         // uniform per warp

  const int ctx = ctx_lens[b], q_len = q_lens[b];
  const int qpos = ctx - q_len + (active ? r % C : 0);
  int nblk = 0, lo = 0;
  if (ctx > 0) {
    nblk = min(max((ctx + bs - 1) / bs, 1), nmax);
    if (window > 0) lo = max(ctx - q_len - window + 1, 0) / bs;
  }

  const size_t row_off = (static_cast<size_t>(n) * rows + (active ? r : 0)) * D;
  float qv[EPL], acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int d = i * 32 + lane;
    qv[i] = (active && d < D) ? to_f(q[row_off + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const size_t stride = static_cast<size_t>(Hkv) * D;  // between block rows
  const bool vec = (D * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k_pool) |
                     reinterpret_cast<uintptr_t>(v_pool)) % 16) == 0;
  const int* bt = block_tables + static_cast<size_t>(b) * nmax;

  for (int ib = lo; ib < nblk; ++ib) {
    const size_t base = (static_cast<size_t>(bt[ib]) * bs * Hkv + h) * D;
    __syncthreads();  // every warp is done with the previous tile
    load_tile(k_tile, k_pool + base, bs, D, stride, vec);
    load_tile(v_tile, v_pool + base, bs, D, stride, vec);
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < bs; j0 += 32) {  // sub-tiles of at most 32 keys
      const int nj = min(32, bs - j0);
      float s_mine = NO_KEY;  // lane j keeps the score of key j0 + j
      for (int j = 0; j < nj; ++j) {
        const T* kr = k_tile + (j0 + j) * D;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          const int d = i * 32 + lane;
          if (d < D) part = fmaf(qv[i], to_f(kr[d]), part);
        }
        float s = warp_sum(part) * scale;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
        const int kpos = ib * bs + j0 + j;
        bool ok = kpos <= qpos && kpos < ctx;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (lane == j) s_mine = ok ? s : NEG_INF;
      }
      const float m_new = fmaxf(m, warp_max(s_mine));
      const float p = lane < nj ? expf(s_mine - m_new) : 0.f;
      const float corr = expf(m - m_new);
      l = l * corr + warp_sum(p);
      // the PV product takes p in the value type, as the TPU kernel does
      const float pv = to_f(from_f<T>(p));
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] *= corr;
      for (int j = 0; j < nj; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
        const T* vr = v_tile + (j0 + j) * D;
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          const int d = i * 32 + lane;
          if (d < D) acc[i] = fmaf(pj, to_f(vr[d]), acc[i]);
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int d = i * 32 + lane;
    if (d < D) out[row_off + d] = from_f<T>(acc[i] / denom);
  }
}

template <typename T, int EPL>
cudaError_t launch(const T* q, const T* k_pool, const T* v_pool, T* out,
                   const int* block_tables, const int* q_lens, const int* ctx_lens,
                   int B, int Hkv, int g, int C, int D, int bs, int nmax, int window,
                   float soft_cap, float scale, cudaStream_t stream) {
  const int rows = g * C;
  const int warps = rows < MAX_WARPS ? rows : MAX_WARPS;
  const dim3 grid(B * Hkv, (rows + warps - 1) / warps);
  const size_t smem = 2 * static_cast<size_t>(bs) * D * sizeof(T);
  auto kern = paged_ragged_attention_kernel<T, EPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, warps * 32, smem, stream>>>(q, k_pool, v_pool, out, block_tables, q_lens,
                                           ctx_lens, Hkv, g, C, D, bs, nmax, window,
                                           soft_cap, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool, void* out,
             const int* block_tables, const int* q_lens, const int* ctx_lens, int B,
             int Hkv, int g, int C, int D, int bs, int nmax, int window, float soft_cap,
             float scale, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0 || C <= 0 || D <= 0 || bs <= 0 || nmax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
#define PRA_LAUNCH(EPL)                                                                 \
  launch<T, EPL>(qt, kt, vt, ot, block_tables, q_lens, ctx_lens, B, Hkv, g, C, D, bs, \
                 nmax, window, soft_cap, scale, stream)
  cudaError_t e;
  if (D <= 32) e = PRA_LAUNCH(1);
  else if (D <= 64) e = PRA_LAUNCH(2);
  else if (D <= 128) e = PRA_LAUNCH(4);
  else if (D <= 256) e = PRA_LAUNCH(8);
  else e = cudaErrorInvalidValue;
#undef PRA_LAUNCH
  return static_cast<int>(e);
}

}  // namespace

// q, out: [B, Hkv, g, C, D]; k_pool, v_pool: [num_blocks, bs, Hkv, D];
// block_tables: [B, nmax] int32; q_lens, ctx_lens: [B] int32. All contiguous
// on the device of `stream`. Returns a cudaError_t (0 = launched).
extern "C" int paged_ragged_attention_f32(const void* q, const void* k_pool,
                                          const void* v_pool, void* out,
                                          const int* block_tables, const int* q_lens,
                                          const int* ctx_lens, int B, int Hkv, int g,
                                          int C, int D, int bs, int nmax, int window,
                                          float soft_cap, float scale, void* stream) {
  return dispatch<float>(q, k_pool, v_pool, out, block_tables, q_lens, ctx_lens, B, Hkv,
                         g, C, D, bs, nmax, window, soft_cap, scale,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int paged_ragged_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool, void* out,
                                           const int* block_tables, const int* q_lens,
                                           const int* ctx_lens, int B, int Hkv, int g,
                                           int C, int D, int bs, int nmax, int window,
                                           float soft_cap, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pool, v_pool, out, block_tables, q_lens, ctx_lens,
                                 B, Hkv, g, C, D, bs, nmax, window, soft_cap, scale,
                                 static_cast<cudaStream_t>(stream));
}
