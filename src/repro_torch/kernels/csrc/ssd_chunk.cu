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
// What bounds it on the H100: operations. Per (row, chunk, head) it does
// L*L*ds FMAs for c.b^T, L*L*hd/2 for y and L*hd*ds for S_c, against
// 2-byte reads of x, b, c (bf16) and 4-byte writes; at the serving step (B 8,
// L 64, H 64, hd 64, ds 128) that is ~0.6 GFMA over ~30 MB. The design: one
// CTA per (row, chunk, group of HPC heads) stages b and c of its chunk in
// shared memory in fp32 and forms c.b^T once for the group (it does not
// depend on the head when b and c are shared), then per head builds the
// masked, decayed score tile (transposed, so four query rows load as one
// float4) and runs both products from shared memory with register tiles
// (4 x 4 outputs a thread for y, 4 x 8 for S_c). HPC is chosen so that the
// grid covers the card's SMs at least once. CUDA cores only: no tensor
// cores, no TMA, no double buffering yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_L = 128;   // positions in a chunk
constexpr int MAX_HD = 128;  // head dim
constexpr int MAX_DS = 256;  // state dim

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
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
    const T* bp = b + bi * bs.b + static_cast<long long>(t0) * bs.s + h0 * bs.h;
    const T* cp = c + bi * cs.b + static_cast<long long>(t0) * cs.s + h0 * cs.h;
    for (int i = tid; i < Lp * ds; i += THREADS) {
      const int t = i / ds, n = i - t * ds;
      const bool live = t < L;
      b_s[t * BS + n] = live ? to_f(bp[t * bs.s + n]) : 0.f;
      c_s[t * BS + n] = live ? to_f(cp[t * cs.s + n]) : 0.f;
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
    const T* xp = x + bi * xs.b + static_cast<long long>(t0) * xs.s + h * xs.h;
    for (int i = tid; i < Lp * hd; i += THREADS) {
      const int t = i / hd, p = i - t * hd;
      x_s[t * XS + p] = t < L ? to_f(xp[t * xs.s + p]) : 0.f;
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

template <typename T>
int launch(const void* x, const void* b, const void* c, const float* dt, const float* cum,
           float* y, float* st, float* dec, const long long* strides, int B, int S, int H,
           int hd, int ds, int L, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0 || L > MAX_L || S % L != 0 || S / L > 65535 || B > 65535 ||
      hd <= 0 || hd % 4 != 0 || hd > MAX_HD || ds <= 0 || ds % 8 != 0 || ds > MAX_DS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{strides[0], strides[1], strides[2]};
  const Strides bs{strides[3], strides[4], strides[5]};
  const Strides cs{strides[6], strides[7], strides[8]};
  const int nc = S / L;
  // heads per CTA: c.b^T is shared by a group only when b and c are; take
  // the largest group that still gives every SM a CTA
  int hpc = 1;
  if (bs.h == 0 && cs.h == 0) {
    for (int cand = 8; cand > 1; cand /= 2) {
      if (static_cast<long long>(B) * nc * ((H + cand - 1) / cand) >= num_sms()) {
        hpc = cand;
        break;
      }
    }
  }
  const size_t smem = smem_floats(round4(L), hd, ds) * sizeof(float);
  auto kern = ssd_chunk_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((H + hpc - 1) / hpc, nc, B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(b),
                                        static_cast<const T*>(c), dt, cum, y, st, dec, xs, bs,
                                        cs, S, H, hd, ds, L, hpc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory a launch at these sizes asks for.
extern "C" long long ssd_chunk_smem_bytes(int L, int hd, int ds) {
  return static_cast<long long>(smem_floats(round4(L), hd, ds) * sizeof(float));
}

// x [B, S, H, hd], b and c [B, S, H, ds] of one type (fp32 or bf16), with
// element strides (batch, position, head) in `strides` (x, b, c: 9 values)
// and a contiguous last dim; dt, cum [B, S, H] fp32 contiguous; outputs y
// [B, S, H, hd], st [B, S/L, H, hd, ds], dec [B, S, H] fp32 contiguous. All
// on the device of `stream`. Returns a cudaError_t (0 = launched).
extern "C" int ssd_chunk_f32(const void* x, const void* b, const void* c, const float* dt,
                             const float* cum, float* y, float* st, float* dec,
                             const long long* strides, int B, int S, int H, int hd, int ds,
                             int L, void* stream) {
  return launch<float>(x, b, c, dt, cum, y, st, dec, strides, B, S, H, hd, ds, L,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_chunk_bf16(const void* x, const void* b, const void* c, const float* dt,
                              const float* cum, float* y, float* st, float* dec,
                              const long long* strides, int B, int S, int H, int hd, int ds,
                              int L, void* stream) {
  return launch<__nv_bfloat16>(x, b, c, dt, cum, y, st, dec, strides, B, S, H, hd, ds, L,
                               static_cast<cudaStream_t>(stream));
}
