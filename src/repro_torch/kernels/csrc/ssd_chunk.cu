// Mamba-2 SSD intra-chunk step for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see repro_torch/kernels/build.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_kernel (body _kernel) and computes its function, in fp32, for
// each (batch row, chunk of L positions, head):
//   y_intra[t]  = sum_{s <= t} (c_t . b_s) exp(cum_t - cum_s) dt_s x_s
//   S_c[p][n]   = sum_t x_t[p] exp(cum_{L-1} - cum_t) dt_t b_t[n]
//   decay_in[t] = exp(cum_t)
// The upper triangle (s > t) is exactly 0, as the TPU kernel's
// exp(where(tri, dec, -1e30)) makes it; for s <= t, cum_t - cum_s <= 0 (the
// log decay -dt*A is never positive), so no exponent overflows.
//
// Layouts, read through strides so that the model's tensors are not copied:
// x [B, S, H, hd] and b, c [B, S, H, ds] with element strides (batch,
// position, head) and a contiguous last dim; the head stride of b and c is 0
// when one group's projections serve every head (mamba2). dt and cum are
// contiguous fp32 [B, S, H]. Outputs are contiguous fp32: y [B, S, H, hd],
// S_c [B, S/L, H, hd, ds], decay_in [B, S, H]. The TPU kernel's contract,
// x [N, L, hd] per (head, chunk), is the case B = N, S = L, H = 1.
//
// What bounds it on the H100: bytes. At the serving step (B 8, L 64, H 64,
// hd 64, ds 128) it reads 4.2 MB of x (bf16) and writes 8.4 MB of y and
// 16.8 MB of S_c (fp32): ~30 MB, 9 us at 3.35 TB/s, against ~0.3 GFMA of
// products. Both instances take one CTA per (row, chunk, group of hpc
// heads); c.b^T does not depend on the head when b and c are shared, so a
// CTA forms it once for its group, and hpc is the largest that still gives
// every SM a CTA.
//
// - bf16 inputs: on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
//   accumulate). b and c of the chunk and each head's x are staged in
//   shared memory by cp.async, x in a two-stage ring (the next head's x
//   loads while this head computes). c.b^T: products of bf16 values are
//   exact in fp32; warp w keeps rows [16w, 16w + 16) of it (the lower
//   triangle) in its accumulator registers across the CTA's heads. y: the
//   scores sc = cb * exp(cum_t - cum_s) * dt_s are built in those registers
//   and are the A operand of sc.x as they stand (as flash's P is), x coming
//   by ldmatrix.trans. S_c: (x*w)^T comes from x by ldmatrix.trans and is
//   scaled per position in registers; b by ldmatrix.trans. sc and x*w are
//   fp32, so each is split into three bf16 parts (hi = bf16(a), mid =
//   bf16(a - hi), lo = bf16(a - hi - mid)) and multiplied by three MMAs:
//   the residual is at most 2^-27 of a, so the sums keep the 1e-4 contract
//   (two parts leave up to 2^-18, which inputs of 8x their scale take past
//   1e-4: tests/test_torch_ssd.py emulates both). L is padded to a multiple
//   of 16 with zeros (dt 0). y and S_c go out through a staging buffer per
//   warp, as 16-byte stores that write whole 256-byte row segments. What
//   holds it back on the card is latency, not bytes: at over 200 registers
//   a thread an SM holds two CTAs of 4 warps, too few to hide the chain of
//   shared-memory loads, splits and MMAs of each head; the stores overlap
//   the products almost wholly (PERF.md).
// - fp32 inputs: on the CUDA cores, which keep 1e-4 where TF32 would not:
//   b and c staged in fp32, c.b^T formed once in shared memory, then per
//   head the masked, decayed score tile (transposed, so four query rows
//   load as one float4) and both products from shared memory with register
//   tiles (4 x 4 outputs a thread for y, 4 x 8 for S_c).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_attention_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_L = 128;   // positions in a chunk
constexpr int MAX_HD = 128;  // head dim
constexpr int MAX_DS = 256;  // state dim

struct Strides {
  long long b, s, h;  // elements; the last dim is contiguous
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Shared memory, in floats, rows padded by 4 (16 bytes) so that float4 rows
// stay aligned and neighbouring rows start on other banks:
//   b_s   [Lp][ds + 4]
//   c_s   [Lp][ds + 4], reused per head as x_s [Lp][hd + 4] + scT_s [Lp][Lp + 4]
//   cb_s  [Lp][Lp + 4]
//   cum_s, dt_s, w_s [Lp]
__host__ __device__ __forceinline__ size_t smem_floats(int Lp, int hd, int ds) {
  const size_t bc = static_cast<size_t>(Lp) * (ds + 4);
  const size_t xs = static_cast<size_t>(Lp) * (hd + 4) + static_cast<size_t>(Lp) * (Lp + 4);
  return bc + (bc > xs ? bc : xs) + static_cast<size_t>(Lp) * (Lp + 4) + 3 * Lp;
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_f32_kernel(const float* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ c,
                 const float* __restrict__ dt, const float* __restrict__ cum,
                 float* __restrict__ y, float* __restrict__ st, float* __restrict__ dec,
                 Strides xs, Strides bs, Strides cs, int S, int H, int hd, int ds, int L,
                 int hpc) {
  extern __shared__ __align__(16) float smem[];
  const int Lp = round4(L);
  const int BS = ds + 4, XS = hd + 4, TS = Lp + 4;
  float* b_s = smem;
  float* c_s = b_s + Lp * BS;
  float* x_s = c_s;  // after c.b^T is formed
  float* scT_s = x_s + Lp * XS;
  const size_t region = static_cast<size_t>(Lp) * BS > static_cast<size_t>(Lp) * (XS + TS)
                            ? static_cast<size_t>(Lp) * BS
                            : static_cast<size_t>(Lp) * (XS + TS);
  float* cb_s = c_s + region;
  float* cum_s = cb_s + Lp * TS;
  float* dt_s = cum_s + Lp;
  float* w_s = dt_s + Lp;

  const int h0 = blockIdx.x * hpc;
  const int ci = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = ci * L;
  const int tid = threadIdx.x;

  // b and c of this chunk (of head h0: equal for the group when shared)
  {
    const float* bp = b + bi * bs.b + static_cast<long long>(t0) * bs.s + h0 * bs.h;
    const float* cp = c + bi * cs.b + static_cast<long long>(t0) * cs.s + h0 * cs.h;
    for (int i = tid; i < Lp * ds; i += THREADS) {
      const int t = i / ds, n = i - t * ds;
      const bool live = t < L;
      b_s[t * BS + n] = live ? bp[t * bs.s + n] : 0.f;
      c_s[t * BS + n] = live ? cp[t * cs.s + n] : 0.f;
    }
  }
  __syncthreads();

  // cb[t][s] = c_t . b_s over all Lp x Lp pairs; a thread owns rows
  // {tg + i*Q} x {sg + j*Q} (Q = Lp/4), so the 32 lanes of a warp read rows
  // that start on different banks
  {
    const int Q = Lp / 4;
    for (int k = tid; k < Q * Q; k += THREADS) {
      const int tg = k / Q, sg = k - tg * Q;
      float acc[4][4] = {};
      for (int n = 0; n < ds; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = *reinterpret_cast<const float4*>(c_s + (tg + i * Q) * BS + n);
          bv[i] = *reinterpret_cast<const float4*>(b_s + (sg + i * Q) * BS + n);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += cv[i].x * bv[j].x + cv[i].y * bv[j].y + cv[i].z * bv[j].z +
                         cv[i].w * bv[j].w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb_s[(tg + i * Q) * TS + sg + j * Q] = acc[i][j];
    }
  }
  __syncthreads();

  const int nh = min(hpc, H - h0);
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    // x, dt and cum of this head; rows past L are zero (dt 0 removes them
    // from every sum) and their cum repeats the last row's
    const float* xp = x + bi * xs.b + static_cast<long long>(t0) * xs.s + h * xs.h;
    for (int i = tid; i < Lp * hd; i += THREADS) {
      const int t = i / hd, p = i - t * hd;
      x_s[t * XS + p] = t < L ? xp[t * xs.s + p] : 0.f;
    }
    if (tid < Lp) {
      const long long row = (static_cast<long long>(bi) * S + t0 + min(tid, L - 1)) * H + h;
      const float cm = cum[row];
      cum_s[tid] = cm;
      dt_s[tid] = tid < L ? dt[row] : 0.f;
      if (tid < L) dec[row] = expf(cm);
    }
    __syncthreads();

    // the masked, decayed scores, transposed: scT[s][t]; and the state
    // weights w_t = exp(cum_{L-1} - cum_t) dt_t
    const float cum_last = cum_s[L - 1];
    for (int i = tid; i < Lp * Lp; i += THREADS) {
      const int s = i / Lp, t = i - s * Lp;
      scT_s[s * TS + t] =
          s <= t ? cb_s[t * TS + s] * expf(cum_s[t] - cum_s[s]) * dt_s[s] : 0.f;
    }
    if (tid < Lp) w_s[tid] = expf(cum_last - cum_s[tid]) * dt_s[tid];
    __syncthreads();

    // y_intra: rows 4tg..4tg+3, head-dim columns 4pq..4pq+3; keys past the
    // tile's last row have zero scores and are skipped
    {
      const int P4 = hd / 4;
      float* yb = y + ((static_cast<long long>(bi) * S + t0) * H + h) * hd;
      for (int k = tid; k < (Lp / 4) * P4; k += THREADS) {
        const int tg = k / P4, pq = k - tg * P4;
        float4 acc[4] = {};
        const int s_end = min(Lp, 4 * tg + 4);
        for (int s = 0; s < s_end; ++s) {
          const float4 sv = *reinterpret_cast<const float4*>(scT_s + s * TS + 4 * tg);
          const float4 xv = *reinterpret_cast<const float4*>(x_s + s * XS + 4 * pq);
          const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i].x += sa[i] * xv.x;
            acc[i].y += sa[i] * xv.y;
            acc[i].z += sa[i] * xv.z;
            acc[i].w += sa[i] * xv.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * tg + i;
          if (t < L)
            *reinterpret_cast<float4*>(yb + static_cast<long long>(t) * H * hd + 4 * pq) = acc[i];
        }
      }
    }

    // S_c: head-dim rows 4pg..4pg+3, state columns 4nq..4nq+3 and
    // ds/2 + 4nq..+3 (neighbouring lanes read neighbouring 16 bytes)
    {
      const int N8 = ds / 8;
      float* sb = st + ((static_cast<long long>(bi) * nc + ci) * H + h) * hd * ds;
      for (int k = tid; k < (hd / 4) * N8; k += THREADS) {
        const int pg = k / N8, nq = k - pg * N8;
        float acc[4][8] = {};
        for (int t = 0; t < L; ++t) {
          const float wt = w_s[t];
          const float4 xv = *reinterpret_cast<const float4*>(x_s + t * XS + 4 * pg);
          const float4 b0 = *reinterpret_cast<const float4*>(b_s + t * BS + 4 * nq);
          const float4 b1 = *reinterpret_cast<const float4*>(b_s + t * BS + ds / 2 + 4 * nq);
          const float xa[4] = {xv.x * wt, xv.y * wt, xv.z * wt, xv.w * wt};
          const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += xa[i] * ba[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = sb + static_cast<long long>(4 * pg + i) * ds;
          *reinterpret_cast<float4*>(row + 4 * nq) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(row + ds / 2 + 4 * nq) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
    }
    __syncthreads();  // x_s and scT_s are rewritten by the next head
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Heads per CTA: c.b^T is shared by a group only when b and c are; the
// largest group (at most 8) that still gives every SM a CTA. (Two CTAs per
// SM, half the group, measured slower for the bf16 instance: the CTA's
// prefetch of the next head's x, and c.b^T once per group, gain more.)
int heads_per_cta(const Strides& bs, const Strides& cs, int B, int nc, int H) {
  if (bs.h != 0 || cs.h != 0) return 1;
  for (int cand = 8; cand > 1; cand /= 2)
    if (static_cast<long long>(B) * nc * ((H + cand - 1) / cand) >= num_sms()) return cand;
  return 1;
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

constexpr int STAGE_COLS = 64;                // columns a warp stages at a time
constexpr int STAGE_STRIDE = STAGE_COLS + 8;  // conflict-free float2 writes

// Shared memory, in bytes: b_s [Lp][ds + 8] bf16; c_s [Lp][ds + 8] bf16,
// whose room the warps' output staging buffers [NW][16][STAGE_STRIDE] fp32
// take once c.b^T is formed; the x ring [2][Lp][hd + 8] bf16; cum, dt, w
// [hpc][Lp] fp32.
__host__ __device__ __forceinline__ size_t mma_region_bytes(int L, int ds) {
  const size_t c = static_cast<size_t>(round16(L)) * (ds + 8) * 2;
  const size_t stage = static_cast<size_t>(round16(L) > 64 ? 8 : 4) * 16 * STAGE_STRIDE * 4;
  return c > stage ? c : stage;
}
__host__ __device__ __forceinline__ size_t mma_smem_bytes(int L, int hd, int ds, int hpc) {
  const size_t Lp = round16(L);
  return Lp * (ds + 8) * 2 + mma_region_bytes(L, ds) + 2 * Lp * (hd + 8) * 2 +
         3 * static_cast<size_t>(hpc) * Lp * 4;
}

// fp32 a (two values) as three bf16x2 parts whose sum is a within 2^-27 of a.
__device__ __forceinline__ void split3(float a0, float a1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const float2 h = __bfloat1622float2(__floats2bfloat162_rn(a0, a1));
  const float r0 = a0 - h.x, r1 = a1 - h.y;  // exact
  const float2 m = __bfloat1622float2(__floats2bfloat162_rn(r0, r1));
  hi = mma::pack_bf16(a0, a1);
  mid = mma::pack_bf16(r0, r1);
  lo = mma::pack_bf16(r0 - m.x, r1 - m.y);
}

// Write a warp's STAGE_COLS / 8 accumulator tiles acc[t] (columns 8t ..
// 8t + 7 of 16 rows) to columns [0, ncols) of rows dst(r), r < 16 (nullptr:
// row not written), through the warp's staging buffer buf [16][STAGE_STRIDE]
// floats: each 16-byte store then writes four consecutive floats of a
// row, sixteen lanes a whole 256-byte row.
template <typename RowPtr>
__device__ __forceinline__ void store_staged(const float (*acc)[4], float* buf, int ncols,
                                             RowPtr dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  __syncwarp();  // the buffer's last rows are read
#pragma unroll
  for (int t = 0; t < STAGE_COLS / 8; ++t)
    if (t * 8 < ncols) {
      *reinterpret_cast<float2*>(buf + g * STAGE_STRIDE + t * 8 + 2 * q) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(buf + (g + 8) * STAGE_STRIDE + t * 8 + 2 * q) =
          make_float2(acc[t][2], acc[t][3]);
    }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * STAGE_COLS / 4 / 32; ++i) {
    const int e = i * 32 + lane, r = e / (STAGE_COLS / 4), c = (e % (STAGE_COLS / 4)) * 4;
    float* d = dst(r);
    if (c < ncols && d != nullptr)
      *reinterpret_cast<float4*>(d + c) =
          *reinterpret_cast<const float4*>(buf + r * STAGE_STRIDE + c);
  }
}

// NW warps (4 for L <= 64, 8 for L <= 128): warp w owns rows [16w, 16w +
// 16) of c.b^T and y. HDT: the largest head dim of the instance (64 or
// 128), which sizes y's accumulators.
template <int NW, int HDT>
__global__ void __launch_bounds__(NW * 32)
ssd_chunk_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ b,
                     const bf16* __restrict__ c, const float* __restrict__ dt,
                     const float* __restrict__ cum, float* __restrict__ y,
                     float* __restrict__ st, float* __restrict__ dec, Strides xs, Strides bs,
                     Strides cs, int S, int H, int hd, int ds, int L, int hpc) {
  using namespace mma;
  constexpr int CBT = 2 * NW;  // n-tiles of c.b^T a warp may hold
  constexpr int SCT = STAGE_COLS / 8;  // n-tiles of S_c per work item (64 columns)
  extern __shared__ __align__(16) float smem[];  // the fp32 instance's name and type
  const int Lp = round16(L), DSP = ds + 8, XP = hd + 8;
  bf16* b_s = reinterpret_cast<bf16*>(smem);
  bf16* c_s = b_s + Lp * DSP;
  bf16* x_s = c_s + mma_region_bytes(L, ds) / 2;  // [2][Lp][XP]
  float* cum_s = reinterpret_cast<float*>(x_s + 2 * Lp * XP);  // [hpc][Lp]
  float* dt_s = cum_s + hpc * Lp;
  float* w_s = dt_s + hpc * Lp;

  const int h0 = blockIdx.x * hpc;
  const int ci = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = ci * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, nthreads = NW * 32;
  const int nh = min(hpc, H - h0);
  const int g = lane >> 2, q = lane & 3;
  // this warp's output staging buffer, in c_s's room once c.b^T is formed
  float* stage_buf = reinterpret_cast<float*>(c_s) + warp * 16 * STAGE_STRIDE;

  // b and c of this chunk (of head h0: equal for the group when shared),
  // and x of the first two heads; rows past L are zero
  {
    const bf16* bp = b + bi * bs.b + static_cast<long long>(t0) * bs.s + h0 * bs.h;
    const bf16* cp = c + bi * cs.b + static_cast<long long>(t0) * cs.s + h0 * cs.h;
    stage_rows(b_s, Lp, ds, DSP, [&](int t) -> const bf16* {
      return t < L ? bp + t * bs.s : nullptr;
    }, b, tid, nthreads);
    stage_rows(c_s, Lp, ds, DSP, [&](int t) -> const bf16* {
      return t < L ? cp + t * cs.s : nullptr;
    }, c, tid, nthreads);
  }
  auto stage_x = [&](int hh) {
    const bf16* xp = x + bi * xs.b + static_cast<long long>(t0) * xs.s + (h0 + hh) * xs.h;
    stage_rows(x_s + (hh & 1) * Lp * XP, Lp, hd, XP, [&](int t) -> const bf16* {
      return t < L ? xp + t * xs.s : nullptr;
    }, x, tid, nthreads);
  };
  stage_x(0);
  cp_async_commit();
  if (nh > 1) stage_x(1);
  cp_async_commit();

  // cum, dt (0 past L, where cum repeats the last row's) and decay_in of
  // the group's heads, then the state weights w_t = exp(cum_{L-1} - cum_t) dt_t
  for (int i = tid; i < nh * Lp; i += nthreads) {
    const int t = i / nh, hh = i - t * nh;
    const long long row = (static_cast<long long>(bi) * S + t0 + min(t, L - 1)) * H + h0 + hh;
    const float cm = cum[row];
    cum_s[hh * Lp + t] = cm;
    dt_s[hh * Lp + t] = t < L ? dt[row] : 0.f;
    if (t < L) dec[row] = expf(cm);
  }
  __syncthreads();
  for (int i = tid; i < nh * Lp; i += nthreads) {
    const int hh = i / Lp;
    w_s[i] = expf(cum_s[hh * Lp + L - 1] - cum_s[i]) * dt_s[i];
  }
  cp_async_wait<1>();  // b, c and the first x
  __syncthreads();

  // c.b^T, rows [16w, 16w + 16), the n-tiles of columns s <= 16w + 15
  const bool cb_warp = warp * WARP_ROWS < Lp;
  float cb[CBT][4];
#pragma unroll
  for (int t = 0; t < CBT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[t][e] = 0.f;
  if (cb_warp) {
    const uint32_t a_lane = q_lane_addr(smem_u32(c_s), warp * WARP_ROWS, DSP, lane);
    const uint32_t b_lane =
        smem_u32(b_s) + (((lane & 7) + ((lane >> 4) << 3)) * DSP + ((lane >> 3) & 1) * 8) * 2;
    for (int kc = 0; kc < ds / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4(a_lane + kc * 32, a);
#pragma unroll
      for (int np = 0; np < CBT / 2; ++np) {
        if (np > warp) break;
        uint32_t bf[4];
        ldsm_x4(b_lane + (np * 16 * DSP + kc * 16) * 2, bf);
        mma16816(cb[2 * np], a, bf[0], bf[1]);
        mma16816(cb[2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }

  // ldmatrix lanes: x as the B operand of sc.x (rows s = k, columns p = n,
  // transposed), x as the A operand (x*w)^T of S_c (rows t = k, columns p =
  // m, transposed), b as the B operand of S_c (rows t = k, columns n)
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;
  const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8, a_col = ((lane >> 3) & 1) * 8;
  const int nchk = (ds + SCT * 8 - 1) / (SCT * 8);
  const int items = (hd / 16) * nchk;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    cp_async_wait<1>();  // x of head hh
    __syncthreads();
    const bf16* xh = x_s + (hh & 1) * Lp * XP;
    const uint32_t x_base = smem_u32(xh);
    const float* cumh = cum_s + hh * Lp;
    const float* dth = dt_s + hh * Lp;
    const float* wh = w_s + hh * Lp;

    // y_intra = sc . x for the warp's rows
    if (cb_warp) {
      const int tr0 = warp * WARP_ROWS + g, tr1 = tr0 + 8;
      const float ct[2] = {cumh[tr0], cumh[tr1]};
      float acc[HDT / 8][4];
#pragma unroll
      for (int t = 0; t < HDT / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NW; ++kc) {
        if (kc > warp) break;
        float sv[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = (2 * kc + j) * 8 + 2 * q + (e & 1);
            const int t = e < 2 ? tr0 : tr1;
            sv[j][e] = s <= t ? cb[2 * kc + j][e] * expf(ct[e >> 1] - cumh[s]) * dth[s] : 0.f;
          }
        uint32_t a[3][4];
        split3(sv[0][0], sv[0][1], a[0][0], a[1][0], a[2][0]);
        split3(sv[0][2], sv[0][3], a[0][1], a[1][1], a[2][1]);
        split3(sv[1][0], sv[1][1], a[0][2], a[1][2], a[2][2]);
        split3(sv[1][2], sv[1][3], a[0][3], a[1][3], a[2][3]);
        // x's fragments of the chunk first, then the products part by part,
        // so that no MMA waits for the one before it
        uint32_t xf[HDT / 16][4];
#pragma unroll
        for (int dp = 0; dp < HDT / 16; ++dp)
          if (dp * 16 < hd)
            ldsm_x4_trans(x_base + ((kc * 16 + v_row) * XP + dp * 16 + v_col) * 2, xf[dp]);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int dp = 0; dp < HDT / 16; ++dp)
            if (dp * 16 < hd) {
              mma16816(acc[2 * dp], a[part], xf[dp][0], xf[dp][1]);
              mma16816(acc[2 * dp + 1], a[part], xf[dp][2], xf[dp][3]);
            }
      }
#pragma unroll
      for (int ch = 0; ch < HDT / STAGE_COLS; ++ch) {
        if (ch * STAGE_COLS >= hd) break;
        store_staged(acc + ch * STAGE_COLS / 8, stage_buf,
                     min(STAGE_COLS, hd - ch * STAGE_COLS), [&](int r) {
          const int t = warp * WARP_ROWS + r;
          return t < L ? y + ((static_cast<long long>(bi) * S + t0 + t) * H + h) * hd +
                             ch * STAGE_COLS
                       : nullptr;
        });
      }
    }

    // S_c = (x*w)^T . b: items of 16 rows p x 64 columns n, over the warps
    float* sb = st + ((static_cast<long long>(bi) * nc + ci) * H + h) * hd * ds;
    for (int it = warp; it < items; it += NW) {
      const int mt = it / nchk, n0 = (it - mt * nchk) * SCT * 8;
      float acc[SCT][4];
#pragma unroll
      for (int t = 0; t < SCT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      for (int kc = 0; kc < Lp / 16; ++kc) {
        uint32_t xr[4];
        ldsm_x4_trans(x_base + ((kc * 16 + a_row) * XP + mt * 16 + a_col) * 2, xr);
        const int tk = kc * 16 + 2 * q;
        const float w0 = wh[tk], w1 = wh[tk + 1], w2 = wh[tk + 8], w3 = wh[tk + 9];
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float lo = __uint_as_float(xr[i] << 16) * (i < 2 ? w0 : w2);
          const float hi = __uint_as_float(xr[i] & 0xffff0000u) * (i < 2 ? w1 : w3);
          split3(lo, hi, a[0][i], a[1][i], a[2][i]);
        }
        uint32_t bf[SCT / 2][4];
#pragma unroll
        for (int np = 0; np < SCT / 2; ++np)
          if (n0 + np * 16 < ds)
            ldsm_x4_trans(smem_u32(b_s) + ((kc * 16 + v_row) * DSP + n0 + np * 16 + v_col) * 2,
                          bf[np]);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int np = 0; np < SCT / 2; ++np)
            if (n0 + np * 16 < ds) {
              mma16816(acc[2 * np], a[part], bf[np][0], bf[np][1]);
              mma16816(acc[2 * np + 1], a[part], bf[np][2], bf[np][3]);
            }
      }
      store_staged(acc, stage_buf, min(SCT * 8, ds - n0), [&](int r) {
        return sb + static_cast<long long>(mt * 16 + r) * ds + n0;
      });
    }
    __syncthreads();  // every warp is done with this head's x
    if (hh + 2 < nh) stage_x(hh + 2);
    cp_async_commit();
  }
}

template <int NW, int HDT>
cudaError_t launch_mma_t(const bf16* x, const bf16* b, const bf16* c, const float* dt,
                         const float* cum, float* y, float* st, float* dec, const Strides& xs,
                         const Strides& bs, const Strides& cs, int B, int S, int H, int hd,
                         int ds, int L, int hpc, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(L, hd, ds, hpc);
  auto kern = ssd_chunk_mma_kernel<NW, HDT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((H + hpc - 1) / hpc, S / L, B);
  kern<<<grid, NW * 32, smem, stream>>>(x, b, c, dt, cum, y, st, dec, xs, bs, cs, S, H, hd, ds,
                                        L, hpc);
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int hd, int ds, int L) {
  return B > 0 && B <= 65535 && H > 0 && L > 0 && L <= MAX_L && S % L == 0 &&
         S / L <= 65535 && hd > 0 && hd <= MAX_HD && ds > 0 && ds <= MAX_DS;
}

int launch_f32(const float* x, const float* b, const float* c, const float* dt,
               const float* cum, float* y, float* st, float* dec, const long long* strides,
               int B, int S, int H, int hd, int ds, int L, cudaStream_t stream) {
  if (!valid(B, S, H, hd, ds, L) || hd % 4 != 0 || ds % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides bs{strides[3], strides[4], strides[5]};
  const Strides cs{strides[6], strides[7], strides[8]};
  const int hpc = heads_per_cta(bs, cs, B, S / L, H);
  const size_t smem = smem_floats(round4(L), hd, ds) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_chunk_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((H + hpc - 1) / hpc, S / L, B);
  ssd_chunk_f32_kernel<<<grid, THREADS, smem, stream>>>(x, b, c, dt, cum, y, st, dec, xs, bs,
                                                        cs, S, H, hd, ds, L, hpc);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const bf16* x, const bf16* b, const bf16* c, const float* dt, const float* cum,
                float* y, float* st, float* dec, const long long* strides, int B, int S, int H,
                int hd, int ds, int L, cudaStream_t stream) {
  if (!valid(B, S, H, hd, ds, L) || hd % 16 != 0 || ds % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides bs{strides[3], strides[4], strides[5]};
  const Strides cs{strides[6], strides[7], strides[8]};
  const int hpc = heads_per_cta(bs, cs, B, S / L, H);
  cudaError_t e;
  if (round16(L) <= 64)
    e = hd <= 64 ? launch_mma_t<4, 64>(x, b, c, dt, cum, y, st, dec, xs, bs, cs, B, S, H, hd,
                                       ds, L, hpc, stream)
                 : launch_mma_t<4, 128>(x, b, c, dt, cum, y, st, dec, xs, bs, cs, B, S, H, hd,
                                        ds, L, hpc, stream);
  else
    e = hd <= 64 ? launch_mma_t<8, 64>(x, b, c, dt, cum, y, st, dec, xs, bs, cs, B, S, H, hd,
                                       ds, L, hpc, stream)
                 : launch_mma_t<8, 128>(x, b, c, dt, cum, y, st, dec, xs, bs, cs, B, S, H, hd,
                                        ds, L, hpc, stream);
  return static_cast<int>(e);
}

}  // namespace

// Bytes of dynamic shared memory a launch at these sizes asks for: the
// fp32 instance's (is_bf16 == 0) or, at its largest group of heads, the bf16
// instance's.
extern "C" long long ssd_chunk_smem_bytes(int L, int hd, int ds, int is_bf16) {
  return is_bf16 ? static_cast<long long>(mma_smem_bytes(L, hd, ds, 8))
              : static_cast<long long>(smem_floats(round4(L), hd, ds) * sizeof(float));
}

// x [B, S, H, hd], b and c [B, S, H, ds] of one type (fp32 or bf16), with
// element strides (batch, position, head) in `strides` (x, b, c: 9 values)
// and a contiguous last dim; dt, cum [B, S, H] fp32 contiguous; outputs y
// [B, S, H, hd], st [B, S/L, H, hd, ds], dec [B, S, H] fp32 contiguous. All
// on the device of `stream`, rows 16-byte aligned. fp32: hd % 4 == 0, ds %
// 8 == 0; bf16: hd and ds multiples of 16. Returns a cudaError_t (0 =
// launched).
extern "C" int ssd_chunk_f32(const void* x, const void* b, const void* c, const float* dt,
                             const float* cum, float* y, float* st, float* dec,
                             const long long* strides, int B, int S, int H, int hd, int ds,
                             int L, void* stream) {
  return launch_f32(static_cast<const float*>(x), static_cast<const float*>(b),
                    static_cast<const float*>(c), dt, cum, y, st, dec, strides, B, S, H, hd, ds,
                    L, static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_chunk_bf16(const void* x, const void* b, const void* c, const float* dt,
                              const float* cum, float* y, float* st, float* dec,
                              const long long* strides, int B, int S, int H, int hd, int ds,
                              int L, void* stream) {
  return launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                     static_cast<const bf16*>(c), dt, cum, y, st, dec, strides, B, S, H, hd, ds,
                     L, static_cast<cudaStream_t>(stream));
}
