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
// Padding columns (c >= q_len) are written as zeros, unless pad_cols is set:
// then they are computed as the reference's CPU path computes them. Their
// position ctx - q_len + c is at least ctx, so the mask gives each of them
// all of its row's ctx keys (a MoE layer routes every column of the step,
// so their values reach the router and take expert capacity).
//
// What bounds it on the H100: bytes. Each live K/V block is read once per
// (sequence, kv head) and the work per byte is ~2*g*q_len flops, below the
// ~295 flop/byte ridge of bf16 until q_len is in the hundreds. The design,
// shared by both instances: one CTA per (b * Hkv + h, tile of up to 64
// query rows). A tile's rows are ordered position-major (column c, then
// head j of the group), so a tile covers whole positions and its last
// query bounds the keys it walks: key tiles past the tile's last query are
// skipped, tiles past g * q_len exit at once, and the work is proportional
// to q_len as well as to ctx. A key tile is 64 keys gathered through
// block_tables[b] from 64 / bs pool blocks (any bs), each key a [D] row at
// stride Hkv * D, staged in shared memory once for all the CTA's rows, so
// the query group is broadcast and KV is never expanded to Hq heads.
//
// - bf16: on the tensor cores (mma_attention_tile.cuh), 4 warps of 16
//   rows; K/V tiles come by cp.async into a two-stage ring (the next tile
//   loads while the current one is folded), each thread looking up all its
//   keys' blocks before it issues a copy. A tile with at most 16 live rows
//   (decode rows: g rows per sequence and kv head) would leave three warps
//   idle, so its warps split each key tile instead (16 keys each; 32 each
//   at most 32 rows). An SM keeps about one tile of copies in flight, so a
//   small grid (a decode batch: B * Hkv CTAs for 132 SMs) or a serving
//   chunk is also split across a cluster of 2 or 4 CTAs, each walking
//   every 2nd or 4th key tile. The warps' and CTAs' (m, l, acc) merge
//   exactly at the end, through distributed shared memory
//   (mma_attention_tile.cuh's merge_partials, shared with the dense decode;
//   full tiles merge their register fragments here).
// - fp32: on the CUDA cores (attention_tile.cuh's fold_tile: lanes over
//   keys, 8 rows per warp, 8 warps), which holds the fp32 contract of 1e-4
//   that TF32 tensor cores cannot. Synchronous 16-byte loads.

#include <cooperative_groups.h>

#include "attention_tile.cuh"
#include "mma_attention_tile.cuh"

namespace {

constexpr int TILE_ROWS = 64;               // query rows per CTA
constexpr int TILE_KEYS = mma::TILE_KEYS;  // keys per staged tile, both instances

struct Args {
  const int* block_tables;  // [B, nmax]
  const int* q_lens;
  const int* ctx_lens;
  int Hkv, g, C, D, bs, nmax, window;
  int pad_cols;  // 1: padding columns are computed, 0: written as zeros
  float soft_cap, scale;
};

// What one CTA does: its rows, and the keys they need.
struct Tile {
  int n, b, h;       // n = b * Hkv + h
  int r0, rows;      // first row of the [g*C] axis (position-major), rows in the tile
  int live;          // rows in [0, live) are computed; the rest are zeroed
  int ctx, base;     // base = ctx - q_len: the position of column 0
  int kbeg, kend;    // keys [kbeg, kend) are walked; kend is past the tile's last query
  int bs_log;        // log2(bs) when bs is a power of two, else -1
  const int* bt;

  __device__ __forceinline__ Tile(const Args& a) {
    n = blockIdx.x;
    b = n / a.Hkv;
    h = n - b * a.Hkv;
    // row tiles from the last: later positions walk more keys, so they
    // start first and none of them is left for the tail
    r0 = (gridDim.y - 1 - blockIdx.y) * TILE_ROWS;
    rows = min(TILE_ROWS, a.g * a.C - r0);
    ctx = a.ctx_lens[b];
    const int q_len = a.q_lens[b];
    base = ctx - q_len;
    live = ctx > 0 ? max(0, min(rows, a.g * (a.pad_cols ? a.C : q_len) - r0)) : 0;
    bt = a.block_tables + static_cast<long long>(b) * a.nmax;
    bs_log = (a.bs & (a.bs - 1)) == 0 ? __ffs(a.bs) - 1 : -1;
    kbeg = kend = 0;
    if (live > 0) {
      const int nblk = min(max((ctx + a.bs - 1) / a.bs, 1), a.nmax);
      const int lo = a.window > 0 ? max(base - a.window + 1, 0) / a.bs : 0;
      const int last_q = base + (r0 + live - 1) / a.g;  // the tile's last query
      kbeg = lo * a.bs;
      // a padding column's query lies at or past ctx: its keys end at ctx
      kend = min(min(nblk * a.bs, last_q + 1), ctx);
    }
  }
  // Column of row r of the tile.
  __device__ __forceinline__ int col(int r, int g) const { return (r0 + r) / g; }
  // Offset of row r in q and out ([B, Hkv, g, C, D], contiguous).
  __device__ __forceinline__ long long row_off(int r, const Args& a) const {
    const int R = r0 + r, c = R / a.g, j = R - c * a.g;
    return ((static_cast<long long>(n) * a.g + j) * a.C + c) * a.D;
  }
  // Offset of key kpos (in [kbeg, kend)) in the pools [nb, bs, Hkv, D].
  __device__ __forceinline__ long long key_off(int kpos, const Args& a) const {
    const int ib = bs_log >= 0 ? kpos >> bs_log : kpos / a.bs;
    const long long blk = bt[ib];
    return ((blk * a.bs + (kpos - ib * a.bs)) * a.Hkv + h) * a.D;
  }
  // 1 live, 0 masked, for a key in [kbeg, kend) and a row at position qpos.
  __device__ __forceinline__ int state(int kpos, int qpos, int window) const {
    return kpos <= qpos && (window <= 0 || kpos > qpos - window) ? 1 : 0;
  }
};

// Zero the padding rows [t.live, t.rows) of the tile (16-byte stores).
template <typename T>
__device__ __forceinline__ void zero_padding(const Tile& t, T* out, const Args& a) {
  const int vpr = a.D * static_cast<int>(sizeof(T)) / 16;
  const int n = (t.rows - t.live) * vpr;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = t.live + e / vpr, c = e - (e / vpr) * vpr;
    reinterpret_cast<uint4*>(out + t.row_off(r, a))[c] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = TILE_ROWS / mma::WARP_ROWS;  // 4
constexpr int MMA_STAGES = 2;

// The walk of one CTA of the cluster with KS warps on each group of 16
// rows: warp w takes rows 16 * (w / KS) and keys [(w % KS) * 64 / KS, +64 /
// KS) of every key tile whose index is the CTA's rank modulo the cluster
// size. The partial states of all warps of all CTAs then merge exactly.
template <int DT, int KS>
__device__ __forceinline__ void ragged_mma(const Tile& t, const __nv_bfloat16* q,
                                           const __nv_bfloat16* k_pool,
                                           const __nv_bfloat16* v_pool, __nv_bfloat16* out,
                                           const Args& a, unsigned char* smem) {
  using namespace mma;
  namespace cg = cooperative_groups;
  constexpr int NKW = TILE_KEYS / KS;                    // keys per warp per tile
  constexpr int ROWS_USED = WARP_ROWS * MMA_WARPS / KS;  // rows staged
  constexpr bool QREG = DT <= 128;
  const int D = a.D, SP = mma::tile_stride(D);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kv_s = q_s + TILE_ROWS * SP;  // [stage][K, V][TILE_KEYS][SP]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, nthreads = MMA_WARPS * 32;
  const int nsplit = gridDim.z, rank = blockIdx.z;  // the cluster spans z, 1 to 4

  stage_rows(q_s, ROWS_USED, D, SP, [&](int r) -> const __nv_bfloat16* {
    return r < t.live ? q + t.row_off(r, a) : nullptr;
  }, q, tid, nthreads);
  const int ntiles_all = t.kend > t.kbeg ? (t.kend - t.kbeg + TILE_KEYS - 1) / TILE_KEYS : 0;
  const int ntiles = ntiles_all > rank ? (ntiles_all - rank + nsplit - 1) / nsplit : 0;
  // the CTA's i-th tile starts at key k0(i)
  auto k0_of = [&](int i) { return t.kbeg + (rank + i * nsplit) * TILE_KEYS; };
  auto stage = [&](int i) {
    __nv_bfloat16* k_t = kv_s + (i % MMA_STAGES) * 2 * TILE_KEYS * SP;
    const int k0 = k0_of(i);
    // one table lookup per key, shared by its K and V rows. A thread keeps
    // one 16-byte column (D a power of two) and looks up all its keys'
    // blocks before it issues any copy, so the lookups overlap.
    const int cpr = D >> 3;
    const uint32_t kd = smem_u32(k_t), vd = kd + TILE_KEYS * SP * 2;
    auto copy = [&](int j, int c, long long o) {
      cp_async16(kd + (j * SP + c * 8) * 2, k_pool + (o < 0 ? 0 : o + c * 8), o >= 0);
      cp_async16(vd + (j * SP + c * 8) * 2, v_pool + (o < 0 ? 0 : o + c * 8), o >= 0);
    };
    auto key = [&](int j) { return k0 + j < t.kend ? t.key_off(k0 + j, a) : -1LL; };
    if (nthreads % cpr == 0) {
      constexpr int KPT = DT / 16;  // keys per thread: 64 / (128 / (D / 8)) <= DT / 16
      const int c = tid % cpr, step = nthreads / cpr, j0 = tid / cpr;
      long long off[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) off[i] = j0 + i * step < TILE_KEYS ? key(j0 + i * step) : -1;
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        if (j0 + i * step < TILE_KEYS) copy(j0 + i * step, c, off[i]);
    } else {
      for (int e = tid; e < TILE_KEYS * cpr; e += nthreads) copy(e / cpr, e % cpr, key(e / cpr));
    }
  };
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }

  const int row0 = (warp / KS) * WARP_ROWS, kslice = (warp % KS) * NKW;
  const bool live_warp = row0 < t.live;
  const int first_q = t.base + t.col(0, a.g), last_q = t.base + t.col(t.live - 1, a.g);
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = t.base + t.col(row0 + (lane >> 2) + 8 * r, a.g);
  const uint32_t q_addr = q_lane_addr(smem_u32(q_s), row0, SP, lane);

  WarpState<DT> st;
  st.init();
  QFrags<DT, QREG> qf;
  for (int i = 0; i < ntiles; ++i) {
    if (i + MMA_STAGES - 1 < ntiles) stage(i + MMA_STAGES - 1);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 1>();
    __syncthreads();
    if (i == 0) qf.load(q_addr, D);
    if (live_warp) {
      const int k0 = k0_of(i) + kslice;  // this warp's first key
      // every key of the slice live for every row of the tile?
      const bool masked = k0 + NKW > t.kend || k0 + NKW - 1 > first_q ||
                          (a.window > 0 && k0 <= last_q - a.window);
      const uint32_t k_t =
          smem_u32(kv_s + (i % MMA_STAGES) * 2 * TILE_KEYS * SP) + kslice * SP * 2;
      auto key_state = [&](int r, int j) {
        const int kpos = k0 + j;
        if (kpos >= t.kend) return -1;
        return t.state(kpos, qpos[r], a.window);
      };
      const uint32_t v_t = k_t + TILE_KEYS * SP * 2;
      if (masked)
        fold<DT, NKW, true>(st, qf, q_addr, k_t, v_t, SP, D, a.scale, a.soft_cap, key_state);
      else
        fold<DT, NKW, false>(st, qf, q_addr, k_t, v_t, SP, D, a.scale, a.soft_cap, key_state);
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();
  st.reduce_l();

  if (KS == 1 && nsplit == 1) {  // each row's state is whole in one warp
    if (live_warp)
      store_rows(st, D, [&](int rr) -> __nv_bfloat16* {
        const int r = row0 + (lane >> 2) + 8 * rr;
        return r < t.live ? out + t.row_off(r, a) : nullptr;
      });
    return;
  }
  // merge the partial states exactly, through (distributed) shared memory
  // (the K/V ring is free now): with M the largest m, out = sum(acc_w *
  // e^(m_w - M)) / max(sum(l_w * e^(m_w - M)), 1e-30)
  cg::cluster_group cluster = cg::this_cluster();
  if (KS == 1) {
    // a full tile split across CTAs: every warp leaves its fragments; warp
    // w of the first CTA reads warp w's of the others at its own lane's
    // place and folds them into its registers
    constexpr int F = DT / 8 + 1;  // float4 per lane: acc, then (m0, m1, l0, l1)
    float4* frag = reinterpret_cast<float4*>(kv_s);  // [warp][lane][F]
    float4* mine = frag + (warp * 32 + lane) * F;
#pragma unroll
    for (int tt = 0; tt < DT / 8; ++tt)
      mine[tt] = make_float4(st.o[tt][0], st.o[tt][1], st.o[tt][2], st.o[tt][3]);
    mine[DT / 8] = make_float4(st.m[0], st.m[1], st.l[0], st.l[1]);
    cluster.sync();  // every CTA's fragments are written
    if (rank == 0 && live_warp) {
      for (int c = 1; c < nsplit; ++c) {
        const float4* p = cluster.map_shared_rank(frag, c) + (warp * 32 + lane) * F;
        const float4 ml = p[DT / 8];
        const float mw[2] = {ml.x, ml.y}, lw[2] = {ml.z, ml.w};
        float fs[2], fw[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(st.m[r], mw[r]);
          fs[r] = exp_ftz(st.m[r] - mn);
          fw[r] = exp_ftz(mw[r] - mn);
          st.l[r] = st.l[r] * fs[r] + lw[r] * fw[r];
          st.m[r] = mn;
        }
#pragma unroll
        for (int tt = 0; tt < DT / 8; ++tt) {
          const float4 o = p[tt];
          st.o[tt][0] = st.o[tt][0] * fs[0] + o.x * fw[0];
          st.o[tt][1] = st.o[tt][1] * fs[0] + o.y * fw[0];
          st.o[tt][2] = st.o[tt][2] * fs[1] + o.z * fw[1];
          st.o[tt][3] = st.o[tt][3] * fs[1] + o.w * fw[1];
        }
      }
      store_rows(st, D, [&](int rr) -> __nv_bfloat16* {
        const int r = row0 + (lane >> 2) + 8 * rr;
        return r < t.live ? out + t.row_off(r, a) : nullptr;
      });
    }
    cluster.sync();  // the fragments are read before any CTA exits
    return;
  }
  // at most 32 live rows, their keys split across KS warps (and maybe
  // CTAs): (m, l) and acc by row, merged by mma_attention_tile.cuh
  float* ml_s = reinterpret_cast<float*>(kv_s);     // [warp][16][2]
  float* acc_s = ml_s + MMA_WARPS * WARP_ROWS * 2;  // [warp][16][D]
  float* cta_ml = acc_s + MMA_WARPS * WARP_ROWS * D;  // [2 * 16][2]
  put_partial(st, ml_s, acc_s, warp, D);
  merge_partials<KS>(ml_s, acc_s, cta_ml, t.live, D, rank, nsplit,
                     [&](int r) { return out + t.row_off(r, a); });
}

template <int DT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
paged_ragged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k_pool,
                                  const __nv_bfloat16* __restrict__ v_pool,
                                  __nv_bfloat16* __restrict__ out, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t(a);
  if (blockIdx.z == 0) zero_padding(t, out, a);
  if (t.live == 0) return;  // every CTA of the cluster: same tile
  if (t.live <= mma::WARP_ROWS) ragged_mma<DT, 4>(t, q, k_pool, v_pool, out, a, smem);
  else if (t.live <= 2 * mma::WARP_ROWS) ragged_mma<DT, 2>(t, q, k_pool, v_pool, out, a, smem);
  else ragged_mma<DT, 1>(t, q, k_pool, v_pool, out, a, smem);
}

template <int DT>
cudaError_t launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k_pool,
                       const __nv_bfloat16* v_pool, __nv_bfloat16* out, const Args& a, int B,
                       cudaStream_t stream) {
  const int SP = mma::tile_stride(a.D);
  const size_t kv = static_cast<size_t>(MMA_STAGES) * 2 * TILE_KEYS * SP * 2;
  // the merge's buffers: fragments of full tiles, or rows of split-warp tiles
  const size_t frag = static_cast<size_t>(MMA_WARPS) * 32 * (DT / 8 + 1) * 16;
  const size_t rows =
      (static_cast<size_t>(MMA_WARPS) * mma::WARP_ROWS * (2 + a.D) + 4 * mma::WARP_ROWS) * 4;
  const size_t merge = frag > rows ? frag : rows;
  const size_t smem = static_cast<size_t>(TILE_ROWS) * SP * 2 + (kv > merge ? kv : merge);
  auto kern = paged_ragged_attention_mma_kernel<DT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // Split each tile's keys over a cluster of CTAs where a tile's walk would
  // otherwise set the time: 4 while the grid fills fewer than one CTA per
  // SM of the card (132 SMs; a decode batch of B * Hkv tiles of g rows then
  // uses every SM, not B * Hkv of them), 2 while it fills fewer than two or
  // a sequence has at most 4 row tiles (a serving chunk: its rows with the
  // longest context walk the most keys, and little else runs beside them).
  const int ty = (a.g * a.C + TILE_ROWS - 1) / TILE_ROWS, tiles = B * a.Hkv * ty;
  const int nsplit = tiles < 66 ? 4 : (tiles < 132 || ty <= 4) ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.Hkv, ty, nsplit);
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
  e = cudaLaunchKernelEx(&cfg, kern, q, k_pool, v_pool, out, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int F32_WARPS = TILE_ROWS / attn::ROWS;  // 8
constexpr int KPL = TILE_KEYS / 32;                // keys per lane in a tile

template <int EPL>
__global__ void __launch_bounds__(F32_WARPS * 32)
paged_ragged_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                                  const float* __restrict__ v_pool, float* __restrict__ out,
                                  Args a) {
  using namespace attn;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, DP = attn::tile_stride<float>(D);
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + TILE_KEYS * DP;
  float* q_all = v_s + TILE_KEYS * DP;
  float* p_all = q_all + TILE_ROWS * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = q_all + warp * ROWS * D;
  float* p_s = p_all + warp * ROWS * TILE_KEYS;

  const Tile t(a);
  zero_padding(t, out, a);
  if (t.live == 0) return;

  int qpos[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    const bool live = r < t.live;
    qpos[rr] = t.base + t.col(r, a.g);
    const float* src = q + (live ? t.row_off(r, a) : 0);
    for (int d = lane; d < D; d += 32) q_s[rr * D + d] = live ? src[d] : 0.f;
  }
  __syncwarp();

  RowState<ROWS, EPL> st;
  st.init();
  const bool live_warp = warp * ROWS < t.live;
  for (int k0 = t.kbeg; k0 < t.kend; k0 += TILE_KEYS) {
    __syncthreads();  // every warp is done with the previous tile
    load_kv_rows(k_s, v_s, k_pool, v_pool, TILE_KEYS, D, DP, [&](int j) {
      return k0 + j < t.kend ? t.key_off(k0 + j, a) : -1LL;
    }, threadIdx.x, blockDim.x);
    __syncthreads();
    if (!live_warp) continue;
    fold_tile<float, ROWS, EPL, KPL>(st, q_s, k_s, v_s, p_s, D, DP, a.scale,
                                     [&](int r, int j) {
                                       const int kpos = k0 + j;
                                       if (kpos >= t.kend) return -1;
                                       return t.state(kpos, qpos[r], a.window);
                                     }, a.soft_cap);
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    if (r >= t.live) break;
    float* dst = out + t.row_off(r, a);
    const float denom = fmaxf(st.l[rr], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = e * 32 + lane;
      if (d < D) dst[d] = st.acc[rr][e] / denom;
    }
  }
}

template <int EPL>
cudaError_t launch_f32(const float* q, const float* k_pool, const float* v_pool, float* out,
                       const Args& a, int B, cudaStream_t stream) {
  const int DP = attn::tile_stride<float>(a.D);
  const size_t smem = (2 * static_cast<size_t>(TILE_KEYS) * DP +
                       static_cast<size_t>(TILE_ROWS) * (a.D + TILE_KEYS)) * sizeof(float);
  auto kern = paged_ragged_attention_f32_kernel<EPL>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.Hkv, (a.g * a.C + TILE_ROWS - 1) / TILE_ROWS);
  kern<<<grid, F32_WARPS * 32, smem, stream>>>(q, k_pool, v_pool, out, a);
  return cudaGetLastError();
}

bool valid(int B, const Args& a) {
  return B > 0 && a.Hkv > 0 && a.g > 0 && a.C > 0 && a.D > 0 && a.D <= 256 && a.bs > 0 &&
         a.nmax > 0;
}

}  // namespace

// q, out: [B, Hkv, g, C, D]; k_pool, v_pool: [num_blocks, bs, Hkv, D];
// block_tables: [B, nmax] int32; q_lens, ctx_lens: [B] int32. All contiguous
// and 16-byte aligned on the device of `stream`; D <= 256, a multiple of 4
// (fp32) or of 16 (bf16). pad_cols != 0 computes the padding columns.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_ragged_attention_f32(const void* q, const void* k_pool,
                                          const void* v_pool, void* out,
                                          const int* block_tables, const int* q_lens,
                                          const int* ctx_lens, int B, int Hkv, int g,
                                          int C, int D, int bs, int nmax, int window,
                                          int pad_cols, float soft_cap, float scale,
                                          void* stream) {
  const Args a{block_tables, q_lens, ctx_lens, Hkv, g, C, D, bs, nmax, window, pad_cols != 0,
               soft_cap, scale};
  if (!valid(B, a) || D % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k_pool);
  const auto* vt = static_cast<const float*>(v_pool);
  auto* ot = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 32) e = launch_f32<1>(qt, kt, vt, ot, a, B, s);
  else if (D <= 64) e = launch_f32<2>(qt, kt, vt, ot, a, B, s);
  else if (D <= 128) e = launch_f32<4>(qt, kt, vt, ot, a, B, s);
  else e = launch_f32<8>(qt, kt, vt, ot, a, B, s);
  return static_cast<int>(e);
}

extern "C" int paged_ragged_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool, void* out,
                                           const int* block_tables, const int* q_lens,
                                           const int* ctx_lens, int B, int Hkv, int g,
                                           int C, int D, int bs, int nmax, int window,
                                           int pad_cols, float soft_cap, float scale,
                                           void* stream) {
  const Args a{block_tables, q_lens, ctx_lens, Hkv, g, C, D, bs, nmax, window, pad_cols != 0,
               soft_cap, scale};
  if (!valid(B, a) || D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vt = static_cast<const __nv_bfloat16*>(v_pool);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 32) e = launch_mma<32>(qt, kt, vt, ot, a, B, s);
  else if (D <= 64) e = launch_mma<64>(qt, kt, vt, ot, a, B, s);
  else if (D <= 128) e = launch_mma<128>(qt, kt, vt, ot, a, B, s);
  else e = launch_mma<256>(qt, kt, vt, ot, a, B, s);
  return static_cast<int>(e);
}
