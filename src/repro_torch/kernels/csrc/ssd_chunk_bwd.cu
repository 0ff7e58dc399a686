// The backward of the Mamba-2 SSD intra-chunk step for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see repro_torch/kernels/build.py).
//
// The forward (csrc/ssd_chunk.cu) replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan.py::ssd_chunk_kernel; training needs its
// gradient, which the reference takes with jax.grad of its jnp scan. Per
// (batch row, chunk of L positions, head), with t, s < L, E_ts = exp(cum_t -
// cum_s) for s <= t (0 above), K = c.b^T, M = K * E * dt_s and w_s =
// exp(cum_{L-1} - cum_s) dt_s, the forward gave y = M.x, S_c = (x*w)^T.b and
// dec = exp(cum). Given dy, dS_c and ddec this computes, in fp32:
//   dM   = dy.x^T on the lower triangle
//   dx   = M^T.dy + w * (b.dS_c^T)
//   G    = dM * E * dt_s;  dc = G.b;  db = G^T.c + (x*w).dS_c
//   ddt  = colsum(dM * K * E) + u * exp(cum_{L-1} - cum),  u = rowsum(x * (b.dS_c^T))
//   dcum = rowsum(Q) - colsum(Q) - u * w + ddec * dec (+ sum(u * w) at L-1),
//          Q = dM * M
// db and dc are summed over the heads, which share one group of b and c.
//
// Layouts: x [B, S, H, hd] and b, c [B, S, ds] (one type, fp32 or bf16) with
// element strides and a contiguous last dim; dt, cum, dy, dS_c [B, S/L, H,
// hd, ds], ddec fp32 contiguous. Outputs fp32 contiguous: dx [B, S, H, hd],
// db, dc [B, S, ds], ddt, dcum [B, S, H].
//
// Design: one CTA of 256 threads per (row, chunk, group of hpc heads). It
// stages b and c of the chunk and forms K once for the group; per head it
// stages x, dy and dS_c, forms M, G and R = dM * K * E on the lower triangle
// and b.dS_c^T, then writes dx, ddt and dcum and adds the head's db and dc
// into registers, in head order. At the end each CTA writes its group's db
// and dc as one partial; a second launch sums the partials over the groups
// in group order. No atomics, so two runs are bitwise equal. Every product
// runs on the CUDA cores in fp32, for bf16 inputs too (they are widened as
// they are staged): the operands dy and dS_c are fp32, and the tensor cores
// would need each split into three bf16 parts, as the forward splits its
// fp32 operands. The products read their operands from shared memory, so a
// thread takes a register tile of each (rows rb + 16i, i < 4, of the 16
// row groups; columns lane + 16j of dM and b.dS_c^T, the float4 columns
// 4 lane + 64j of db and dc): a float4 of an operand row then serves four
// (or eight) FMAs. Hence L <= 64, hd <= 64 and ds <= 128.
//
// What bounds it on the H100: at mamba2-1.3b's training microbatch (B 2, S
// 2048, H 64, hd 64, ds 128, L 64) it must move ~0.31 GB, dominated by dS_c
// (134 MB fp32), dy and dx; ~0.09 ms at 3.35 TB/s. Its ~15 GFLOP on the CUDA
// cores' 67 TFLOP/s take ~0.23 ms at best; shared memory sets the pace
// (PERF.md has the measured time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_L = 64;   // positions in a chunk: 16 lanes x 4 tile rows
constexpr int MAX_HD = 64;  // head dim: 16 lanes x 4 tile columns
constexpr int MAX_DS = 128; // state dim: 16 lanes x 2 float4 columns

struct Strides {
  long long xb, xs, xh, bb, bs, cb, cs;  // elements; the last dims are contiguous
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float a, float4 v) {
  acc.x += a * v.x;
  acc.y += a * v.y;
  acc.z += a * v.z;
  acc.w += a * v.w;
}

// Shared memory, in floats; the float4-read arrays first, rows padded by 4
// (16 bytes) so that neighbouring rows start on other banks:
//   b_s, c_s [L][ds + 4]; x_s, dy_s, bd_s [L][hd + 4]; ds_s [hd][ds + 4];
//   k_s, m_s, g_s, r_s [L][L + 4]; cum, dt, w, ddec, colR, rowQ, u [L] (+1 spare)
__host__ __device__ __forceinline__ size_t smem_floats(int L, int hd, int ds) {
  return static_cast<size_t>(L) * (2 * (ds + 4) + 4 * (L + 4) + 3 * (hd + 4)) +
         static_cast<size_t>(hd) * (ds + 4) + 8 * static_cast<size_t>(L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_bwd_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
                     const float* __restrict__ dt, const float* __restrict__ cum,
                     const float* __restrict__ dy, const float* __restrict__ dst,
                     const float* __restrict__ ddec, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dcum,
                     float* __restrict__ part, Strides st, int B, int S, int H, int hd, int ds,
                     int L, int hpc) {
  extern __shared__ __align__(16) float smem[];
  const int BS = ds + 4, XS = hd + 4, TS = L + 4;
  float* b_s = smem;
  float* c_s = b_s + L * BS;
  float* x_s = c_s + L * BS;
  float* dy_s = x_s + L * XS;
  float* bd_s = dy_s + L * XS;
  float* ds_s = bd_s + L * XS;
  float* k_s = ds_s + hd * BS;
  float* m_s = k_s + L * TS;
  float* g_s = m_s + L * TS;
  float* r_s = g_s + L * TS;
  float* cum_s = r_s + L * TS;
  float* dt_s = cum_s + L;
  float* w_s = dt_s + L;
  float* dd_s = w_s + L;
  float* colr_s = dd_s + L;
  float* rowq_s = colr_s + L;
  float* u_s = rowq_s + L;

  const int grp = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int groups = gridDim.x, nc = gridDim.y;
  const int h0 = grp * hpc, nh = min(hpc, H - h0);
  const int t0 = ci * L, tid = threadIdx.x;

  // b and c of the chunk, widened to fp32
  for (int i = tid; i < L * ds; i += THREADS) {
    const int t = i / ds, n = i - t * ds;
    b_s[t * BS + n] = to_f(b[bi * st.bb + static_cast<long long>(t0 + t) * st.bs + n]);
    c_s[t * BS + n] = to_f(c[bi * st.cb + static_cast<long long>(t0 + t) * st.cs + n]);
  }
  __syncthreads();
  // K[t][s] = c_t . b_s on the lower triangle (the rest is never read)
  for (int i = tid; i < L * L; i += THREADS) {
    const int t = i / L, s = i - t * L;
    float acc = 0.f;
    if (s <= t)
      for (int n = 0; n < ds; n += 4) acc += dot4(ld4(c_s + t * BS + n), ld4(b_s + s * BS + n));
    k_s[t * TS + s] = acc;
  }

  // a thread's tiles: rows rb + 16i (i < 4) and, of the [L, L] and [L, hd]
  // products, columns lane + 16j; of db and dc, the float4 columns
  // 4 lane + 64j (j < 2), accumulated over the group's heads in registers
  const int rb = tid >> 4, lane = tid & 15;
  int rr[4], cn[2];
  bool row_ok[4], col_ok[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = min(rb + 16 * i, L - 1);
    row_ok[i] = rb + 16 * i < L;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    cn[j] = min(4 * lane + 64 * j, ds - 4);
    col_ok[j] = 4 * lane + 64 * j < ds;
  }
  float4 adb[4][2], adc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      adb[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      adc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    // x, dy and dS_c of this head, and its per-position vectors
    for (int i = tid; i < L * hd; i += THREADS) {
      const int t = i / hd, p = i - t * hd;
      x_s[t * XS + p] = to_f(x[bi * st.xb + static_cast<long long>(t0 + t) * st.xs +
                               h * st.xh + p]);
      dy_s[t * XS + p] = dy[((static_cast<long long>(bi) * S + t0 + t) * H + h) * hd + p];
    }
    const float* dsp = dst + ((static_cast<long long>(bi) * nc + ci) * H + h) * hd * ds;
    for (int i = tid; i < hd * ds; i += THREADS) {
      const int p = i / ds, n = i - p * ds;
      ds_s[p * BS + n] = dsp[i];
    }
    if (tid < L) {
      const long long row = (static_cast<long long>(bi) * S + t0 + tid) * H + h;
      cum_s[tid] = cum[row];
      dt_s[tid] = dt[row];
      dd_s[tid] = ddec[row];
    }
    __syncthreads();
    if (tid < L) w_s[tid] = expf(cum_s[L - 1] - cum_s[tid]) * dt_s[tid];

    // M, G and R on the lower triangle, exactly 0 above it, and bd[s][p] =
    // b_s . dS_c[p]: each thread a 4 x 4 tile of rows rb + 16i and columns
    // lane + 16j, so that a float4 of each operand row serves four dots
    {
      float acc[4][4];
      int ca[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ca[i] = min(lane + 16 * i, L - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int p = 0; p < hd; p += 4) {
        float4 dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = ld4(dy_s + rr[i] * XS + p);
          xv[i] = ld4(x_s + ca[i] * XS + p);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += dot4(dv[i], xv[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = rb + 16 * i, s = lane + 16 * j;
          if (t >= L || s >= L) continue;
          float m = 0.f, g = 0.f, r = 0.f;
          if (s <= t) {
            const float e = expf(cum_s[t] - cum_s[s]);
            const float kv = k_s[t * TS + s];
            m = kv * e * dt_s[s];
            g = acc[i][j] * e * dt_s[s];
            r = acc[i][j] * kv * e;
          }
          m_s[t * TS + s] = m;
          g_s[t * TS + s] = g;
          r_s[t * TS + s] = r;
        }
    }
    {
      float acc[4][4];
      int pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = min(lane + 16 * i, hd - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int n = 0; n < ds; n += 4) {
        float4 bv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bv[i] = ld4(b_s + rr[i] * BS + n);
          dv[i] = ld4(ds_s + pa[i] * BS + n);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += dot4(bv[i], dv[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = rb + 16 * i, p = lane + 16 * j;
          if (s < L && p < hd) bd_s[s * XS + p] = acc[i][j];
        }
    }
    __syncthreads();

    // rowsum of Q = R * dt_s, colsum of R, and u
    if (tid < L) {
      const int t = tid;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += r_s[t * TS + s] * dt_s[s];
      rowq_s[t] = acc;
    } else if (tid < 2 * L) {
      const int s = tid - L;
      float acc = 0.f;
      for (int t = s; t < L; ++t) acc += r_s[t * TS + s];
      colr_s[s] = acc;
    } else if (tid < 3 * L) {
      const int s = tid - 2 * L;
      float acc = 0.f;
      for (int p = 0; p < hd; ++p) acc += x_s[s * XS + p] * bd_s[s * XS + p];
      u_s[s] = acc;
    }
    __syncthreads();

    // ddt and dcum; the state's terms collect at L-1
    if (tid < L) {
      const int s = tid;
      const long long row = (static_cast<long long>(bi) * S + t0 + s) * H + h;
      ddt[row] = colr_s[s] + u_s[s] * expf(cum_s[L - 1] - cum_s[s]);
      float dc = rowq_s[s] - dt_s[s] * colr_s[s] - u_s[s] * w_s[s] + dd_s[s] * expf(cum_s[s]);
      if (s == L - 1)
        for (int j = 0; j < L; ++j) dc += u_s[j] * w_s[j];
      dcum[row] = dc;
    }
    // dx[s] = sum_{t >= s} M[t][s] dy[t] + w_s bd[s]
    {
      const int h4 = hd / 4;
      for (int i = tid; i < L * h4; i += THREADS) {
        const int s = i / h4, p = (i - s * h4) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t = s; t < L; ++t) fma4(acc, m_s[t * TS + s], ld4(dy_s + t * XS + p));
        fma4(acc, w_s[s], ld4(bd_s + s * XS + p));
        *reinterpret_cast<float4*>(dx + ((static_cast<long long>(bi) * S + t0 + s) * H + h) * hd +
                                   p) = acc;
      }
    }
    // this head's dc[t] = sum_s G[t][s] b_s and db[t] = sum_t' G[t'][t] c_t'
    // + sum_p x[t][p] w_t dS_c[p] (G is 0 above the diagonal), added in
    // head order
    for (int s2 = 0; s2 < L; ++s2) {
      float g[4];
      float4 bv[2], cv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = g_s[rr[i] * TS + s2];
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[j] = ld4(b_s + s2 * BS + cn[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) fma4(adc[i][j], g[i], bv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = g_s[s2 * TS + rr[i]];
#pragma unroll
      for (int j = 0; j < 2; ++j) cv[j] = ld4(c_s + s2 * BS + cn[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) fma4(adb[i][j], g[i], cv[j]);
    }
    {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = w_s[rr[i]];
      for (int p = 0; p < hd; ++p) {
        float xw[4];
        float4 dv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) xw[i] = x_s[rr[i] * XS + p] * w[i];
#pragma unroll
        for (int j = 0; j < 2; ++j) dv[j] = ld4(ds_s + p * BS + cn[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) fma4(adb[i][j], xw[i], dv[j]);
      }
    }
    __syncthreads();  // the head's staging is rewritten by the next head
  }

  // the group's partial db and dc: part [2][groups][B][S][ds]
  const long long plane = static_cast<long long>(B) * S * ds;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!row_ok[i] || !col_ok[j]) continue;
      const long long off = (static_cast<long long>(bi) * S + t0 + rr[i]) * ds + cn[j];
      *reinterpret_cast<float4*>(part + static_cast<long long>(grp) * plane + off) = adb[i][j];
      *reinterpret_cast<float4*>(part + (static_cast<long long>(groups) + grp) * plane + off) =
          adc[i][j];
    }
}

// db and dc: the groups' partials summed in group order.
__global__ void __launch_bounds__(THREADS)
sum_groups_kernel(const float* __restrict__ part, float* __restrict__ db, float* __restrict__ dc,
                  int groups, long long plane4) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < 2 * plane4;
       i += stride) {
    const int which = i >= plane4;
    const long long j = i - which * plane4;
    const float* src = part + (static_cast<long long>(which) * groups * plane4 + j) * 4;
    float4 acc = ld4(src);
    for (int g = 1; g < groups; ++g) {
      const float4 v = ld4(src + static_cast<long long>(g) * plane4 * 4);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>((which ? dc : db) + j * 4) = acc;
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
int launch(const T* x, const T* b, const T* c, const float* dt, const float* cum,
           const float* dy, const float* dst, const float* ddec, float* dx, float* db, float* dc,
           float* ddt, float* dcum, float* part, const long long* strides, int B, int S, int H,
           int hd, int ds, int L, int hpc, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || H <= 0 || L <= 0 || L > MAX_L || S % L != 0 || S / L > 65535 ||
      hd <= 0 || hd > MAX_HD || hd % 4 != 0 || ds <= 0 || ds > MAX_DS || ds % 4 != 0 ||
      hpc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6]};
  const size_t smem = smem_floats(L, hd, ds) * sizeof(float);
  auto kern = ssd_chunk_bwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (H + hpc - 1) / hpc;
  kern<<<dim3(groups, S / L, B), THREADS, smem, stream>>>(x, b, c, dt, cum, dy, dst, ddec, dx,
                                                          ddt, dcum, part, st, B, S, H, hd, ds,
                                                          L, hpc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long plane4 = static_cast<long long>(B) * S * ds / 4;
  long long blocks = (2 * plane4 + THREADS - 1) / THREADS;
  const long long cap = 8LL * num_sms();
  sum_groups_kernel<<<static_cast<int>(blocks < cap ? blocks : cap), THREADS, 0, stream>>>(
      part, db, dc, groups, plane4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, b, c: fp32 or bf16 per the entry's name, strides (x: batch, position,
// head; b, c: batch, position) in `strides` (7 values); dt, cum, dy, dst,
// ddec fp32 contiguous; outputs dx, db, dc, ddt, dcum fp32 contiguous; part
// fp32 [2][ceil(H / hpc)][B][S][ds] scratch. All on the device of `stream`.
// Returns a cudaError_t (0 = both kernels launched).
extern "C" int ssd_chunk_bwd_f32(const void* x, const void* b, const void* c, const float* dt,
                                 const float* cum, const float* dy, const float* dst,
                                 const float* ddec, float* dx, float* db, float* dc, float* ddt,
                                 float* dcum, float* part, const long long* strides, int B,
                                 int S, int H, int hd, int ds, int L, int hpc, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(b),
                static_cast<const float*>(c), dt, cum, dy, dst, ddec, dx, db, dc, ddt, dcum, part,
                strides, B, S, H, hd, ds, L, hpc, static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_chunk_bwd_bf16(const void* x, const void* b, const void* c, const float* dt,
                                  const float* cum, const float* dy, const float* dst,
                                  const float* ddec, float* dx, float* db, float* dc, float* ddt,
                                  float* dcum, float* part, const long long* strides, int B,
                                  int S, int H, int hd, int ds, int L, int hpc, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch(static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                static_cast<const bf16*>(c), dt, cum, dy, dst, ddec, dx, db, dc, ddt, dcum, part,
                strides, B, S, H, hd, ds, L, hpc, static_cast<cudaStream_t>(stream));
}
