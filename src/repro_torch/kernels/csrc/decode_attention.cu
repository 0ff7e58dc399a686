// GQA decode attention for Hopper (sm_90a), against a contiguous cache and
// through a block table, with a plain C interface loaded through ctypes
// (see repro_torch/kernels/build.py).
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
//   over the table's nmax blocks masked by lens: the padded baseline against
//   which the ragged kernel is held. In bf16, tiles past lens[b] are skipped
//   as in the dense decode (exact for lens >= 1: a wholly masked tile adds
//   exp(NEG_INF - m) = 0 and leaves m unchanged); the fp32 instance walks
//   every block.
// All keep the TPU kernels' numerics: fp32 m/l/acc, the finite NEG_INF,
// p rounded to the value type before the PV product.
//
// What bounds it on the H100: bytes. Each live K/V element is read once per
// (sequence, kv head), ~2*g flops per element read, far below the ~295
// flop/byte ridge of bf16. A decode batch has few (sequence, kv head)
// pairs (64 at B 8 for qwen3-8b) and rows of very different lengths, so
// the time is set by how fast one pair's keys stream into the SMs that
// walk them.
//
// - bf16, either cache: on the tensor cores (mma_attention_tile.cuh). A CTA
//   of 4 warps takes the g <= 16 query rows of one (b, h) pair (one m16
//   tile; g > 16 takes more CTAs along y) and stages 64-key K/V tiles by
//   cp.async into a two-stage ring (the next tile loads while one is
//   folded; three or four stages measured no faster at B 8, as fewer CTAs
//   then fit on an SM); the 4 warps split each tile (16 keys each). The
//   pair's key walk is also split across a thread-block cluster of
//   NSPLIT CTAs (chosen from the grid: see launch_mma), CTA c taking tiles
//   c, c + NSPLIT, ...; the warps' and CTAs' (m, l, acc) merge exactly
//   through distributed shared memory (merge_partials). What still sets
//   the time is the longest pair's walk: its NSPLIT CTAs each stream a
//   tile at a time while most other SMs have finished. The kernel is
//   templated on how a key is addressed (DenseKeys, PagedKeys): the paged
//   walk gathers each tile's K/V rows through the block table row by row.
// - fp32, either cache: on the CUDA cores (attention_tile.cuh's fold_tile,
//   lanes over keys). One CTA per (b * Hkv + h, group of up to 8 query
//   heads; 4 when g <= 4) keeps the group's queries in shared memory; its 8
//   warps (4 where shared memory is short) split the key range (warp w
//   takes tiles w, w + nwarps, ...), each staging its own 32-key K and V
//   tiles in shared memory with 16-byte loads, several in flight per lane,
//   and the warps' partial softmax states merge at the end. fp32 keeps the
//   1e-4 contract that TF32 tensor cores could not.

#include "attention_tile.cuh"
#include "mma_attention_tile.cuh"

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
  __device__ __forceinline__ void prefetch(int, int, int, int) const {}
};

// Keys through a block table into pools [num_blocks, bs, Hkv, D]: the
// CUDA-core walk takes every position of every one of the nmax blocks (the
// padded walk); the tensor-core walk stops at lens.
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
  // Bring the table entries of keys [0, limit) into L1, one 128-byte line
  // per thread, so that no tile's lookups wait on device memory.
  __device__ __forceinline__ void prefetch(int b, int limit, int tid, int nthreads) const {
    const int* row = tables + static_cast<long long>(b) * nmax;
    const int n = (limit + bs - 1) / bs;
    for (int e = tid * 32; e < n; e += nthreads * 32)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(row + e));
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

// ---------------------------------------------------------------------------
// bf16, either cache: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;
constexpr int MMA_STAGES = 2;
constexpr int NKW = mma::TILE_KEYS / MMA_WARPS;  // keys per warp per tile: 16

template <int DT, typename Keys>
__global__ void __launch_bounds__(MMA_WARPS * 32)
decode_attention_mma_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                            Keys keys, const int* __restrict__ lens, int Hkv, int g, int D,
                            float scale) {
  using namespace mma;
  constexpr bool QREG = DT <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = mma::tile_stride(D);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [16][SP]
  __nv_bfloat16* kv_s = q_s + WARP_ROWS * SP;  // [stage][K, V][TILE_KEYS][SP]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, nthreads = MMA_WARPS * 32;
  const int nsplit = gridDim.z, rank = blockIdx.z;  // the cluster spans z

  const int n = blockIdx.x;  // b * Hkv + h
  const int b = n / Hkv, h = n - b * Hkv;
  const int row0 = blockIdx.y * WARP_ROWS, rows = min(WARP_ROWS, g - row0);
  const __nv_bfloat16* q_rows = q + (static_cast<long long>(n) * g + row0) * D;
  stage_rows(q_s, WARP_ROWS, D, SP, [&](int r) -> const __nv_bfloat16* {
    return r < rows ? q_rows + static_cast<long long>(r) * D : nullptr;
  }, q, tid, nthreads);

  // keys past lens are skipped, in the padded walk's table too: a tile
  // that lies wholly past lens would add exp(NEG_INF - m) = 0 for lens >= 1
  const int len = lens[b];
  const int limit = min(len, keys.limit(len));
  const int ntiles_all = (limit + TILE_KEYS - 1) / TILE_KEYS;
  const int ntiles = ntiles_all > rank ? (ntiles_all - rank + nsplit - 1) / nsplit : 0;
  keys.prefetch(b, limit, tid, nthreads);
  auto k0_of = [&](int i) { return (rank + i * nsplit) * TILE_KEYS; };
  // K and V rows of tile i, each row's address from `keys`: through the
  // block table for the padded walk, one lookup per key shared by its K and
  // V rows, so any block size works. (Looking up all of a thread's keys
  // before its first copy, as paged_ragged_attention.cu does, measured
  // slower here once the table row is prefetched.)
  auto stage = [&](int i) {
    __nv_bfloat16* k_t = kv_s + (i % MMA_STAGES) * 2 * TILE_KEYS * SP;
    const int k0 = k0_of(i);
    const int cpr = D >> 3;
    const uint32_t kd = smem_u32(k_t), vd = kd + TILE_KEYS * SP * 2;
    auto copy = [&](int j, int c) {
      const bool live = k0 + j < limit;
      const long long o = live ? keys.offset(b, h, Hkv, D, k0 + j) + c * 8 : 0;
      cp_async16(kd + (j * SP + c * 8) * 2, keys.k + o, live);
      cp_async16(vd + (j * SP + c * 8) * 2, keys.v + o, live);
    };
    if (nthreads % cpr == 0) {
      const int c = tid % cpr, step = nthreads / cpr;
      for (int j = tid / cpr; j < TILE_KEYS; j += step) copy(j, c);
    } else {
      for (int e = tid; e < TILE_KEYS * cpr; e += nthreads) copy(e / cpr, e % cpr);
    }
  };
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();  // with q in the first group
  }

  const uint32_t q_addr = q_lane_addr(smem_u32(q_s), 0, SP, lane);
  WarpState<DT> st;
  st.init();
  QFrags<DT, QREG> qf;
  for (int i = 0; i < ntiles; ++i) {
    if (i + MMA_STAGES - 1 < ntiles) stage(i + MMA_STAGES - 1);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 1>();
    __syncthreads();
    if (i == 0) qf.load(q_addr, D);
    const int k0 = k0_of(i) + warp * NKW;  // this warp's first key
    if (k0 < limit) {
      const uint32_t k_t =
          smem_u32(kv_s + (i % MMA_STAGES) * 2 * TILE_KEYS * SP) + warp * NKW * SP * 2;
      const uint32_t v_t = k_t + TILE_KEYS * SP * 2;
      auto key_state = [&](int, int j) { return k0 + j < limit ? 1 : -1; };
      if (k0 + NKW > limit)
        fold<DT, NKW, true>(st, qf, q_addr, k_t, v_t, SP, D, scale, 0.f, key_state);
      else
        fold<DT, NKW, false>(st, qf, q_addr, k_t, v_t, SP, D, scale, 0.f, key_state);
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();
  st.reduce_l();

  // the K/V ring is free now: the merge's buffers
  float* ml_s = reinterpret_cast<float*>(kv_s);     // [warp][16][2]
  float* acc_s = ml_s + MMA_WARPS * WARP_ROWS * 2;  // [warp][16][D]
  float* cta_ml = acc_s + MMA_WARPS * WARP_ROWS * D;  // [16][2]
  put_partial(st, ml_s, acc_s, warp, D);
  __nv_bfloat16* out_rows = out + (static_cast<long long>(n) * g + row0) * D;
  merge_partials<MMA_WARPS>(ml_s, acc_s, cta_ml, rows, D, rank, nsplit, [&](int r) {
    return out_rows + static_cast<long long>(r) * D;
  });
}

template <int DT, typename Keys>
cudaError_t launch_mma(const __nv_bfloat16* q, __nv_bfloat16* out, Keys keys, const int* lens,
                       int B, int Hkv, int g, int D, float scale, cudaStream_t stream) {
  const int SP = mma::tile_stride(D);
  const size_t ring = static_cast<size_t>(MMA_STAGES) * 2 * mma::TILE_KEYS * SP * 2;
  const size_t merge =
      (static_cast<size_t>(MMA_WARPS) * mma::WARP_ROWS * (2 + D) + 2 * mma::WARP_ROWS) * 4;
  const size_t smem = static_cast<size_t>(mma::WARP_ROWS) * SP * 2 + (ring > merge ? ring : merge);
  auto kern = decode_attention_mma_kernel<DT, Keys>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // Split each (b, h) pair's key walk over a cluster of CTAs while the
  // grid leaves SMs idle: the portable maximum of 8 while pairs fill fewer
  // than a quarter of the card's 132 SMs (B 1), 4 below half of them (B 8
  // of qwen3-8b: 64 pairs, 256 CTAs), 2 below all of them.
  const int ty = (g + mma::WARP_ROWS - 1) / mma::WARP_ROWS, tiles = B * Hkv * ty;
  const int nsplit = tiles < 33 ? 8 : tiles < 66 ? 4 : tiles < 132 ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv, ty, nsplit);
  cfg.blockDim = dim3(MMA_WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = nsplit;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, q, out, keys, lens, Hkv, g, D, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// bf16 on the tensor cores, for either cache: D a multiple of 16, <= 256.
template <typename Keys>
int run_mma(const void* q, void* out, Keys keys, const int* lens, int B, int Hkv, int g, int D,
            float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0 || D <= 0 || D % 16 != 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 32) e = launch_mma<32>(qt, ot, keys, lens, B, Hkv, g, D, scale, s);
  else if (D <= 64) e = launch_mma<64>(qt, ot, keys, lens, B, Hkv, g, D, scale, s);
  else if (D <= 128) e = launch_mma<128>(qt, ot, keys, lens, B, Hkv, g, D, scale, s);
  else e = launch_mma<256>(qt, ot, keys, lens, B, Hkv, g, D, scale, s);
  return static_cast<int>(e);
}

int dense_bf16(const void* q, const void* k, const void* v, void* out, const int* lens, int B,
               int S, int Hkv, int g, int D, float scale, void* stream) {
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DenseKeys<__nv_bfloat16> keys{static_cast<const __nv_bfloat16*>(k),
                                      static_cast<const __nv_bfloat16*>(v), S,
                                      static_cast<long long>(Hkv) * D};
  return run_mma(q, out, keys, lens, B, Hkv, g, D, scale, stream);
}

int paged_bf16(const void* q, const void* k_pool, const void* v_pool, void* out,
               const int* block_tables, const int* lens, int B, int Hkv, int g, int D, int bs,
               int nmax, float scale, void* stream) {
  if (bs <= 0 || nmax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedKeys<__nv_bfloat16> keys{static_cast<const __nv_bfloat16*>(k_pool),
                                      static_cast<const __nv_bfloat16*>(v_pool), block_tables,
                                      nmax, bs};
  return run_mma(q, out, keys, lens, B, Hkv, g, D, scale, stream);
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

// bf16 on the tensor cores: D a multiple of 16.
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                     const int* lens, int B, int S, int Hkv, int g, int D,
                                     float scale, void* stream) {
  return dense_bf16(q, k, v, out, lens, B, S, Hkv, g, D, scale, stream);
}

// q, out: [B, Hkv, g, D]; k_pool, v_pool: [num_blocks, bs, Hkv, D];
// block_tables: [B, nmax] int32 (0 = null block); lens: [B] int32 >= 1.
// bf16 runs on the tensor cores (D a multiple of 16), fp32 on the CUDA cores.
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
  return paged_bf16(q, k_pool, v_pool, out, block_tables, lens, B, Hkv, g, D, bs, nmax, scale,
                    stream);
}
