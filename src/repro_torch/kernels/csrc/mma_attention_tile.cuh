// The tensor-core attention tile shared by the bf16 instances of
// flash_attention.cu, paged_ragged_attention.cu and decode_attention.cu
// (dense cache): one warp carries the online-softmax state of 16 query rows
// and folds into it a slice of a shared-memory tile of keys, with
// mma.sync.m16n8k16 (bf16 in, fp32 out). The exact merge of states whose
// key walk was split across warps and the CTAs of a cluster is here too
// (put_partial, merge_partials).
//
// - S = Q·Kᵀ: Q's fragments come by ldmatrix (kept in registers for the
//   whole key loop when D <= 128, reloaded from shared memory per tile for
//   D 256, where registers are short); K's by ldmatrix, rows = keys.
// - The online softmax runs on the accumulator fragments in registers.
//   A thread holds rows lane/4 and lane/4 + 8 of the warp's 16; the row max
//   is reduced across the quad (the 4 lanes of a row) by __shfl_xor_sync.
//   The row sum l stays a per-thread partial (every lane of a quad shares
//   the row's max, so the partials can be summed once at the end).
// - P is rounded to bf16 in registers and is the A operand of P·V as it
//   stands: the m16n8 accumulator layout of two key tiles of 8 is the A
//   layout of one k16 chunk. V comes by ldmatrix.trans.
// - A warp's 64 keys are folded as two halves of 32, ordered so that one
//   half's softmax sits beside the other half's products (see fold).
//
// Numerics are those of the TPU kernels and of attention_tile.cuh: scores
// in fp32, scaled after the dot (then soft-capped where asked); NEG_INF
// (-1e30) for masked keys, NO_KEY for keys that do not exist; p rounded to
// bf16 before the PV product while l sums the unrounded fp32 p; the caller
// writes out = acc / max(l, 1e-30). exp is ex2.approx.ftz of x·log2(e):
// within a few ulp of expf, far inside the bf16 tolerance; results below
// 2^-126 flush to 0, which no sum in fp32 or p in bf16 would keep anyway.
//
// Tiles in shared memory are [rows, SP] bf16 with SP = D + 8: a row is
// 16 bytes longer than its data, so the 8 row addresses of one 8x8
// ldmatrix fall on 8 distinct 16-byte bank groups (conflict-free). They
// are filled by cp.async.cg 16-byte copies, zero-filled where a row does
// not exist, so 0 * garbage never makes a NaN.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

constexpr float NEG_INF = -1e30f;
constexpr float NO_KEY = -3.0e38f;  // below NEG_INF: exp() of it is 0
constexpr int TILE_KEYS = 64;       // keys staged per tile
constexpr int WARP_ROWS = 16;       // query rows per warp (one m16 tile)
constexpr int MAX_CLUSTER = 8;      // CTAs a key walk is split over, at most (portable)

// Row stride of a bf16 tile in shared memory, in elements.
__host__ __device__ __forceinline__ int tile_stride(int D) { return D + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !valid (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a · b for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp(x) as 2^(x·log2 e), flushing denormal results to 0.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Two floats as bf16x2, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Copy `nrows` rows of D bf16 (D % 8 == 0) into a [nrows, SP] tile with
// cp.async; src(j) gives row j's address, or nullptr for a row that does
// not exist (zero-filled). Every thread of the CTA calls it; the caller
// commits the group. A thread keeps one 16-byte column of the rows where
// the thread count allows (D a power of two), so the loop divides once.
template <typename Src>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int nrows, int D, int SP,
                                           Src src, const void* any, int tid,
                                           int nthreads) {
  const int cpr = D >> 3;  // 16-byte chunks per row
  const uint32_t base = smem_u32(dst);
  auto copy = [&](int j, int c) {
    const __nv_bfloat16* s = src(j);
    cp_async16(base + (j * SP + c * 8) * 2, s ? s + c * 8 : any, s != nullptr);
  };
  if (nthreads % cpr == 0) {
    const int c = tid % cpr, step = nthreads / cpr;
    for (int j = tid / cpr; j < nrows; j += step) copy(j, c);
  } else {
    for (int e = tid; e < nrows * cpr; e += nthreads) copy(e / cpr, e % cpr);
  }
}

// The online-softmax state of one warp's 16 rows against a head dim of at
// most DT (a multiple of 16). Thread (lane) holds o[t][0..1] for row lane/4
// and o[t][2..3] for row lane/4 + 8, dims 8t + 2(lane%4) + {0, 1}.
template <int DT>
struct WarpState {
  float o[DT / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < DT / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // The rows' sums over the quad; call once, after the last fold.
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

// Q's A fragments for the warp's 16 rows: in registers (QREG) or reread
// from the shared-memory tile at every fold.
template <int DT, bool QREG>
struct QFrags;

template <int DT>
struct QFrags<DT, true> {
  uint32_t f[DT / 16][4];
  // q_addr: this lane's ldmatrix address of chunk 0 (see q_lane_addr)
  __device__ __forceinline__ void load(uint32_t q_addr, int D) {
#pragma unroll
    for (int kc = 0; kc < DT / 16; ++kc)
      if (kc * 16 < D) ldsm_x4(q_addr + kc * 32, f[kc]);
  }
  __device__ __forceinline__ void get(int kc, uint32_t, uint32_t (&a)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = f[kc][e];
  }
};

template <int DT>
struct QFrags<DT, false> {
  __device__ __forceinline__ void load(uint32_t, int) {}
  __device__ __forceinline__ void get(int kc, uint32_t q_addr, uint32_t (&a)[4]) const {
    ldsm_x4(q_addr + kc * 32, a);
  }
};

// This lane's ldmatrix address for the A fragments of rows [row0, row0 +
// 16) of a [rows, SP] tile at `tile` (shared address), dims 0..15.
__device__ __forceinline__ uint32_t q_lane_addr(uint32_t tile, int row0, int SP, int lane) {
  return tile + ((row0 + (lane & 15)) * SP + (lane >> 4) * 8) * 2;
}

// S = Q·Kᵀ for NT n-tiles of 8 keys, rows [0, 8 NT) of the K tile at
// k_tile (shared address). ldmatrix x4 over 16 keys x 16 dims: matrices
// (keys 0-7, dims 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) = b0, b1 of
// two n-tiles. The fragments of chunk kc + 1 are loaded before the
// products of chunk kc, so the ldmatrix latency hides behind the mma.
template <int DT, int NT, bool QREG>
__device__ __forceinline__ void scores(float (&s)[NT][4], const QFrags<DT, QREG>& qf,
                                       uint32_t q_addr, uint32_t k_tile, int SP, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  const uint32_t k_lane =
      k_tile + (((lane & 7) + ((lane >> 4) << 3)) * SP + ((lane >> 3) & 1) * 8) * 2;
  uint32_t kf[2][NT / 2][4], qa[2][4];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) ldsm_x4(k_lane + np * 16 * SP * 2, kf[0][np]);
  qf.get(0, q_addr, qa[0]);
#pragma unroll
  for (int kc = 0; kc < DT / 16; ++kc) {
    if (kc * 16 >= D) break;
    if (kc + 1 < DT / 16 && (kc + 1) * 16 < D) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4(k_lane + (np * 16 * SP + (kc + 1) * 16) * 2, kf[(kc + 1) & 1][np]);
      qf.get(kc + 1, q_addr, qa[(kc + 1) & 1]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      mma16816(s[2 * np], qa[kc & 1], kf[kc & 1][np][0], kf[kc & 1][np][1]);
      mma16816(s[2 * np + 1], qa[kc & 1], kf[kc & 1][np][2], kf[kc & 1][np][3]);
    }
  }
}

// The online softmax of NT n-tiles of scores into the state: scale, cap,
// mask (MASKED: key_state(r, j0 + j) as in fold), the rows' max over the
// quad, the correction of l and acc; s becomes the unrounded p.
template <int DT, int NT, bool MASKED, typename KeyState>
__device__ __forceinline__ void softmax(WarpState<DT>& st, float (&s)[NT][4], float scale,
                                        float soft_cap, int j0, KeyState key_state) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] *= scale;
  if (soft_cap > 0.f) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = soft_cap * tanhf(s[t][e] / soft_cap);
  }
  float mx[2] = {NO_KEY, NO_KEY};
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        const int ks = key_state(e >> 1, j0 + t * 8 + 2 * (lane & 3) + (e & 1));
        s[t][e] = ks > 0 ? s[t][e] : (ks == 0 ? NEG_INF : NO_KEY);
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r]);
    corr[r] = exp_ftz(st.m[r] - m_new);
    st.m[r] = m_new;
    st.l[r] *= corr[r];
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = exp_ftz(s[t][e] - st.m[e >> 1]);
      st.l[e >> 1] += s[t][e];  // the unrounded p
    }
#pragma unroll
  for (int t = 0; t < DT / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[t][e] *= corr[e >> 1];
}

// O += P·V for NT n-tiles of p (rows [0, 8 NT) of the V tile at v_tile), P
// rounded to bf16 in registers: the m16n8 accumulator layout of two key
// tiles of 8 is the A layout of one k16 chunk. ldmatrix x4.trans over 16
// keys x 16 dims: (keys 0-7, dims 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
// 8-15) = b0, b1 of two dim tiles. Step i = (key chunk, dim pair) loads the
// fragments of step i + 1 before its own products.
template <int DT, int NT>
__device__ __forceinline__ void accumulate(WarpState<DT>& st, const float (&p)[NT][4],
                                           uint32_t v_tile, int SP, int D) {
  constexpr int NDP = DT / 16;
  const int lane = threadIdx.x & 31;
  const uint32_t v_lane =
      v_tile + (((lane & 7) + ((lane >> 3) & 1) * 8) * SP + (lane >> 4) * 8) * 2;
  uint32_t vf[2][4];
  ldsm_x4_trans(v_lane, vf[0]);
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NDP; ++dp) {
      const int i = kc * NDP + dp;
      const int nk = dp + 1 < NDP ? kc : kc + 1, nd = dp + 1 < NDP ? dp + 1 : 0;
      if (nk < NT / 2 && nd * 16 < D)
        ldsm_x4_trans(v_lane + (nk * 16 * SP + nd * 16) * 2, vf[(i + 1) & 1]);
      if (dp * 16 < D) {
        mma16816(st.o[2 * dp], a, vf[i & 1][0], vf[i & 1][1]);
        mma16816(st.o[2 * dp + 1], a, vf[i & 1][2], vf[i & 1][3]);
      }
    }
  }
}

// Fold NK keys (rows [0, NK) of the K and V tiles at k_tile, v_tile, shared
// addresses) into the warp's state. With MASKED, key_state(r, j) for r in
// {0, 1} (row lane/4 + 8r) and key j < NK returns 1 (live), 0 (masked:
// NEG_INF) or -1 (absent: NO_KEY); without, every key is live. soft_cap > 0
// caps the scaled scores. Every lane of the warp must call it.
//
// 64 keys go as two halves in the order S_a, S_b, softmax_a, P_a·V,
// softmax_b, P_b·V: each half's softmax (ALU and exp) has the other half's
// products beside it, so the tensor cores do not wait for the softmax. The
// result is that of one online softmax over the two halves in turn.
template <int DT, int NK, bool MASKED, bool QREG, typename KeyState>
__device__ __forceinline__ void fold(WarpState<DT>& st, const QFrags<DT, QREG>& qf,
                                     uint32_t q_addr, uint32_t k_tile, uint32_t v_tile,
                                     int SP, int D, float scale, float soft_cap,
                                     KeyState key_state) {
  if constexpr (NK == 64) {
    constexpr int H = 32, NT = H / 8;
    float sa[NT][4], sb[NT][4];
    scores<DT, NT>(sa, qf, q_addr, k_tile, SP, D);
    scores<DT, NT>(sb, qf, q_addr, k_tile + H * SP * 2, SP, D);
    softmax<DT, NT, MASKED>(st, sa, scale, soft_cap, 0, key_state);
    accumulate<DT, NT>(st, sa, v_tile, SP, D);
    softmax<DT, NT, MASKED>(st, sb, scale, soft_cap, H, key_state);
    accumulate<DT, NT>(st, sb, v_tile + H * SP * 2, SP, D);
  } else {
    constexpr int NT = NK / 8;
    float s[NT][4];
    scores<DT, NT>(s, qf, q_addr, k_tile, SP, D);
    softmax<DT, NT, MASKED>(st, s, scale, soft_cap, 0, key_state);
    accumulate<DT, NT>(st, s, v_tile, SP, D);
  }
}

// Write the warp's finished rows: out_row(r) gives the global address of
// row lane/4 + 8r, or nullptr for a row that is not written. Call after
// reduce_l().
template <int DT, typename OutRow>
__device__ __forceinline__ void store_rows(const WarpState<DT>& st, int D, OutRow out_row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* dst = out_row(r);
    if (dst == nullptr) continue;
    const float denom = fmaxf(st.l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < DT / 8; ++t) {
      const int d = t * 8 + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(st.o[t][2 * r] / denom, st.o[t][2 * r + 1] / denom);
    }
  }
}

// Leave the warp's 16 rows of partial state (after reduce_l) in slot
// `slot` of the merge buffers: (m, l) at ml_s[(slot * 16 + r) * 2] and acc
// at acc_s[(slot * 16 + r) * D].
template <int DT>
__device__ __forceinline__ void put_partial(const WarpState<DT>& st, float* ml_s, float* acc_s,
                                            int slot, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = slot * WARP_ROWS + (lane >> 2) + 8 * rr;
    if ((lane & 3) == 0) {
      ml_s[i * 2] = st.m[rr];
      ml_s[i * 2 + 1] = st.l[rr];
    }
#pragma unroll
    for (int t = 0; t < DT / 8; ++t) {
      const int d = t * 8 + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<float2*>(acc_s + i * D + d) =
            make_float2(st.o[t][2 * rr], st.o[t][2 * rr + 1]);
    }
  }
}

// The exact merge of split key walks, called by every thread of every CTA
// of the cluster after each warp's put_partial: row r (< rows) has KS
// partial states, in slots (r / 16) * KS + w (w < KS) of each of the nsplit
// (<= MAX_CLUSTER) CTAs (rank `rank`). With M the largest m, out = sum(acc_i e^(m_i - M)) /
// max(sum(l_i e^(m_i - M)), 1e-30), in two levels: each CTA merges its own
// KS slots (acc in place, into the group's first slot; (m, l) into
// cta_ml[r * 2]), then, after a cluster barrier, CTA c merges the nsplit
// CTAs' states of its own 1/nsplit of the (row, two dims) items, reading
// the others' shared memory, and writes them to out_row(r) + d. Ends with a
// cluster barrier, so no CTA exits while its partials are read.
template <int KS, typename OutRow>
__device__ __forceinline__ void merge_partials(float* ml_s, float* acc_s, float* cta_ml,
                                               int rows, int D, int rank, int nsplit,
                                               OutRow out_row) {
  namespace cg = cooperative_groups;
  const int tid = threadIdx.x, nthreads = blockDim.x, half = D >> 1;
  const int items = rows * half;
  __syncthreads();  // every warp's partials are written
  for (int e = tid; e < items; e += nthreads) {
    const int r = e / half, d = 2 * (e - r * half);
    const int i0 = (r / WARP_ROWS) * KS * WARP_ROWS + r % WARP_ROWS;
    float mv[KS], lv[KS];
    float2 av[KS];
#pragma unroll
    for (int w = 0; w < KS; ++w) {
      const int i = i0 + w * WARP_ROWS;
      mv[w] = ml_s[i * 2];
      lv[w] = ml_s[i * 2 + 1];
      av[w] = *reinterpret_cast<const float2*>(acc_s + i * D + d);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < KS; ++w) mx = fmaxf(mx, mv[w]);
    float l = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < KS; ++w) {
      const float f = exp_ftz(mv[w] - mx);
      l += lv[w] * f;
      a0 += av[w].x * f;
      a1 += av[w].y * f;
    }
    *reinterpret_cast<float2*>(acc_s + i0 * D + d) = make_float2(a0, a1);
    if (d == 0) {
      cta_ml[r * 2] = mx;
      cta_ml[r * 2 + 1] = l;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (nsplit > 1) cluster.sync();  // every CTA's merged partials are written
  else __syncthreads();
  const int lo = static_cast<int>(static_cast<long long>(items) * rank / nsplit);
  const int hi = static_cast<int>(static_cast<long long>(items) * (rank + 1) / nsplit);
  for (int e = lo + tid; e < hi; e += nthreads) {
    const int r = e / half, d = 2 * (e - r * half);
    const int i0 = (r / WARP_ROWS) * KS * WARP_ROWS + r % WARP_ROWS;
    // every CTA's partial loaded before any is used: one round trip
    float mv[MAX_CLUSTER], lv[MAX_CLUSTER];
    float2 av[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c >= nsplit) break;
      const float* ml = nsplit > 1 ? cluster.map_shared_rank(cta_ml, c) : cta_ml;
      const float* acc = nsplit > 1 ? cluster.map_shared_rank(acc_s, c) : acc_s;
      mv[c] = ml[r * 2];
      lv[c] = ml[r * 2 + 1];
      av[c] = *reinterpret_cast<const float2*>(acc + i0 * D + d);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < nsplit) mx = fmaxf(mx, mv[c]);
    float l = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < nsplit) {
        const float f = exp_ftz(mv[c] - mx);
        l += lv[c] * f;
        a0 += av[c].x * f;
        a1 += av[c].y * f;
      }
    const float denom = fmaxf(l, 1e-30f);
    *reinterpret_cast<uint32_t*>(out_row(r) + d) = pack_bf16(a0 / denom, a1 / denom);
  }
  if (nsplit > 1) cluster.sync();  // the partials are read before any CTA exits
}

}  // namespace mma
