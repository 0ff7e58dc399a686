// The backward of RMSNorm for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see repro_torch/kernels/build.py).
//
// Replaces no TPU kernel of its own: the reference trains through jnp
// (models/layers.py::rmsnorm) and JAX's autodiff, and the port trains
// through its RMSNorm kernel (rmsnorm.cu, which replaces
// src/repro/kernels/rmsnorm.py::rmsnorm_kernel), so that kernel needs this
// gradient. For y = T(x * r) * s with r = rsqrt(mean(x^2) + eps), per row,
// in fp32 with xh = x * r:
//
//   dx     = r * (s * dy - xh * mean(xh * s * dy))
//   dscale = sum over rows of dy * xh   (rows of one head for a grouped
//                                        scale [H, D]: row i takes row i % H)
//
// The cast before the product is taken as the identity, as autodiff of the
// reference takes it in fp32. One launch covers two segments of rows with
// their own tensors and scales, as the forward does: a plain norm passes an
// empty second segment, a layer's q_norm and k_norm pass q's rows and k's.
//
// What bounds it on the H100: bytes (x and dy read once, dx written once, a
// few flops per element). So every row is read once, in one pass:
//
// Launch 1 (rows). A record is one row of a plain norm, or one position's
// H rows of a grouped norm ([H, D], contiguous), W = H * D values. A team
// of lanes (a power of two: part of a warp for narrow records such as the
// 128-wide q/k heads, whole warps for d_model rows) holds a record in
// registers, read once with streaming 16-byte vectors (scalars when D is
// not a multiple of 16 bytes), each lane the chunks t, t + team, ... of
// it, while the team's next record is already being read. Each
// row's two sums (x^2 and x * s * dy) are reduced by xor shuffles over the
// row's lanes where a row is a power of two of at most 32 chunks, else over
// the team (warp shuffles, then the warps' sums in shared memory in a fixed
// order), else (a grouped row of another width) through shared memory, one
// lane summing each row's chunks in order. Then dx is written with 16-byte
// stores. A lane's chunks are the same columns of the [H, D] scale in every
// record, so it sums dy * xh for them in registers over the records its
// team takes; at the end the CTA's teams (two of 256 lanes for d_model
// rows, up to 16 of narrow rows) are summed in shared memory in team order
// into one fp32 partial row [W] per CTA.
//
// Launch 2 (dscale): CTAs over 32-column chunks of both segments' partials;
// each column's partial rows are summed by 8 lanes over strided rows, then
// the 8 sums in order, and cast to the scale's type.
//
// No atomics: every sum has one fixed order, so two runs give bitwise equal
// gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC values of T as raw bits: one 16-byte vector, or one scalar.
template <typename T, int VEC>
struct Raw {
  static constexpr int WORDS = VEC * sizeof(T) >= 4 ? VEC * sizeof(T) / 4 : 1;
  uint32_t w[WORDS];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_raw(const T* p, Raw<T, VEC>& r) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));  // read once: streaming
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (sizeof(T) == 4) {
    r.w[0] = __float_as_uint(*reinterpret_cast<const float*>(p));
  } else {
    r.w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ float get(const Raw<T, VEC>& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[e]);
  } else {
    const uint32_t w = r.w[e >> 1];
    return __uint_as_float((e & 1 ? w & 0xffff0000u : w << 16));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vals(T* p, const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = __float_as_uint(f[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    __stcs(reinterpret_cast<uint4*>(p), v);
  } else {
    p[0] = from_f<T>(f[0]);
  }
}

// One segment: x, dy, dx [n, D] contiguous (n rows), scale [h, D]; `rows`
// rows per CTA (a multiple of h) over `blocks` CTAs; partial [blocks, h * D]
// fp32; dscale [h, D].
template <typename T>
struct Seg {
  const T* x;
  const T* dy;
  const T* scale;
  T* dx;
  float* partial;
  T* dscale;
  long long n;
  int h, rows, blocks;
};

// How a record is spread over the lanes (the same for both segments).
struct Plan {
  int vec;      // values per chunk: 16 bytes, or 1 (D not a multiple of 16 bytes)
  int cpl;      // chunks per lane (a power of two, at most MAX_CPL)
  int team;     // lanes per record (a power of two, at most MAX_TEAM)
  int threads;  // per CTA
  int mode;     // how a row's sums are reduced (below)
};
constexpr int MAX_TEAM = 512, MAX_CPL = 16;  // records up to 8192 chunks
constexpr int SHFL = 0;  // a row is a power of two of at most 32 chunks: xor shuffles
constexpr int WIDE = 1;  // a plain row over the whole team
constexpr int SEGS = 2;  // grouped rows of another width: through shared memory

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

inline bool make_plan(int D, int h, int elt, Plan& p) {
  const int v16 = 16 / elt;
  p.vec = D % v16 == 0 ? v16 : 1;
  const long long W = static_cast<long long>(h) * D;
  const long long nch = W / p.vec;
  const int L = D / p.vec;
  const bool shfl = L <= 32 && (L & (L - 1)) == 0;
  if (nch > MAX_TEAM * MAX_CPL) return false;
  const int cpl = nch <= 32 ? 1 : nch <= MAX_TEAM * 2 ? 2 : nch <= MAX_TEAM * 4 ? 4
                : nch <= MAX_TEAM * 8 ? 8 : 16;
  int team = pow2_at_least(static_cast<int>((nch + cpl - 1) / cpl));
  if (shfl && team < L) team = L;
  p.team = team;
  p.cpl = pow2_at_least(static_cast<int>((nch + team - 1) / team));
  // at least 256 threads; two teams where a team is 256 (d_model rows),
  // which keeps twice the records' reads in flight on an SM
  p.threads = std::max(256, std::min(2 * p.team, MAX_TEAM));
  p.mode = shfl ? SHFL : h == 1 ? WIDE : SEGS;
  return true;
}

// Floats of one buffer of a team's row-reduction scratch: the warps' two
// sums (WIDE over several warps), or every chunk's two sums and every
// row's r and mean term (SEGS).
__host__ __device__ inline int red_floats(int mode, int team, int nch, int h) {
  return mode == WIDE ? (team > 32 ? 2 * (team / 32) : 0)
                      : mode == SEGS ? 2 * nch + 2 * h : 0;
}

// Floats of shared memory a CTA of the rows launch uses: per team two
// buffers of its scratch, then (several teams) the teams' dscale sums.
inline long long smem_floats(const Plan& p, int D, int h) {
  const int nt = p.threads / p.team;
  const int W = h * D, nch = W / p.vec;
  return static_cast<long long>(nt) * 2 * red_floats(p.mode, p.team, nch, h) +
         (nt > 1 ? static_cast<long long>(nt) * W : 0);
}

__device__ __forceinline__ void team_sync(int team, int team_id, unsigned mask) {
  if (team <= 32)
    __syncwarp(mask);
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team_id), "r"(team) : "memory");
}

template <typename T, int VEC, int CPL>
__device__ void rows_part(const Seg<T>& s, int blk, int D, const Plan& pl, float eps,
                          float* sm) {
  const int h = s.h, W = h * D, nch = W / VEC, L = D / VEC;
  const int tw = pl.team, nt = blockDim.x / tw;
  const int team = threadIdx.x / tw, t = threadIdx.x - team * tw, lane = threadIdx.x & 31;
  const unsigned mask =
      tw >= 32 ? 0xffffffffu : (((1u << tw) - 1u) << (lane & ~(tw - 1)));
  const long long per = s.rows / h;  // records per CTA
  const long long rec0 = static_cast<long long>(blk) * per;
  const int nr = static_cast<int>(min(per, s.n / h - rec0));
  const int red_n = red_floats(pl.mode, tw, nch, h);
  float* red = sm + team * 2 * red_n;  // two buffers, by record parity
  const float inv_d = 1.f / static_cast<float>(D);

  float sc[CPL][VEC], acc[CPL][VEC];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = t + k * tw;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sc[k][e] = c < nch ? to_f(s.scale[c * VEC + e]) : 0.f;
      acc[k][e] = 0.f;
    }
  }

  // the team's record i in registers (zeros past the record or the CTA's rows)
  auto fetch = [&](int i, Raw<T, VEC>(&xr)[CPL], Raw<T, VEC>(&dr)[CPL]) {
    const T* x = s.x + (rec0 + i) * W;
    const T* dy = s.dy + (rec0 + i) * W;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = t + k * tw;
      if (i < nr && c < nch) {
        load_raw<T, VEC>(x + c * VEC, xr[k]);
        load_raw<T, VEC>(dy + c * VEC, dr[k]);
      } else {
#pragma unroll
        for (int q = 0; q < Raw<T, VEC>::WORDS; ++q) xr[k].w[q] = dr[k].w[q] = 0u;
      }
    }
  };
  Raw<T, VEC> xn[CPL], dn[CPL];
  fetch(team, xn, dn);
  for (int i = team; i < nr; i += nt) {
    const long long rec = rec0 + i;
    // this record's values, and the next record's reads in flight meanwhile
    Raw<T, VEC> xr[CPL], dr[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      xr[k] = xn[k];
      dr[k] = dn[k];
    }
    fetch(i + nt, xn, dn);
    float ss[CPL], xs[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      ss[k] = xs[k] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xv = get(xr[k], e);
        ss[k] = fmaf(xv, xv, ss[k]);
        xs[k] = fmaf(xv * sc[k][e], get(dr[k], e), xs[k]);
      }
    }
    float r[CPL], m[CPL];
    float* buf = red + ((i / nt) & 1) * red_n;
    if (pl.mode == SHFL) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        for (int o = L / 2; o > 0; o >>= 1) {
          ss[k] += __shfl_xor_sync(mask, ss[k], o);
          xs[k] += __shfl_xor_sync(mask, xs[k], o);
        }
        r[k] = rsqrtf(ss[k] * inv_d + eps);
        m[k] = r[k] * xs[k] * inv_d;
      }
    } else if (pl.mode == WIDE) {
      float a = 0.f, bsum = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        a += ss[k];
        bsum += xs[k];
      }
      for (int o = (tw < 32 ? tw : 32) / 2; o > 0; o >>= 1) {
        a += __shfl_xor_sync(mask, a, o);
        bsum += __shfl_xor_sync(mask, bsum, o);
      }
      if (tw > 32) {
        const int w = t >> 5;
        if (lane == 0) {
          buf[2 * w] = a;
          buf[2 * w + 1] = bsum;
        }
        team_sync(tw, team, mask);
        a = bsum = 0.f;
        for (int q = 0; q < tw / 32; ++q) {
          a += buf[2 * q];
          bsum += buf[2 * q + 1];
        }
      }
      const float rr = rsqrtf(a * inv_d + eps), mm = rr * bsum * inv_d;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        r[k] = rr;
        m[k] = mm;
      }
    } else {
      float* rm = buf + 2 * nch;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = t + k * tw;
        if (c < nch) {
          buf[2 * c] = ss[k];
          buf[2 * c + 1] = xs[k];
        }
      }
      team_sync(tw, team, mask);
      for (int hh = t; hh < h; hh += tw) {
        float a = 0.f, bsum = 0.f;
        for (int q = hh * L; q < hh * L + L; ++q) {
          a += buf[2 * q];
          bsum += buf[2 * q + 1];
        }
        const float rr = rsqrtf(a * inv_d + eps);
        rm[2 * hh] = rr;
        rm[2 * hh + 1] = rr * bsum * inv_d;
      }
      team_sync(tw, team, mask);
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = t + k * tw;
        const int hh = c < nch ? c / L : 0;
        r[k] = rm[2 * hh];
        m[k] = rm[2 * hh + 1];
      }
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = t + k * tw;
      if (c >= nch) continue;
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float dyv = get(dr[k], e), xh = get(xr[k], e) * r[k];
        o[e] = r[k] * (sc[k][e] * dyv - xh * m[k]);
        acc[k][e] = fmaf(dyv, xh, acc[k][e]);
      }
      store_vals<T, VEC>(s.dx + rec * W + c * VEC, o);
    }
  }

  // the CTA's teams summed in team order: one partial row
  float* part = s.partial + static_cast<long long>(blk) * W;
  if (nt == 1) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = t + k * tw;
      if (c < nch)
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[c * VEC + e] = acc[k][e];
    }
    return;
  }
  float* tr = sm + nt * 2 * red_n;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = t + k * tw;
    if (c < nch)
#pragma unroll
      for (int e = 0; e < VEC; ++e) tr[team * W + c * VEC + e] = acc[k][e];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    float a = 0.f;
    for (int q = 0; q < nt; ++q) a += tr[q * W + j];
    part[j] = a;
  }
}

template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(MAX_TEAM)
rmsnorm_bwd_rows(Seg<T> a, Seg<T> b, int D, Plan pl, float eps) {
  extern __shared__ float sm[];
  // the first a.blocks CTAs take segment a, the rest segment b
  if (blockIdx.x < a.blocks)
    rows_part<T, VEC, CPL>(a, blockIdx.x, D, pl, eps, sm);
  else
    rows_part<T, VEC, CPL>(b, blockIdx.x - a.blocks, D, pl, eps, sm);
}

// dscale of both segments: a CTA per 32 columns; 8 lanes per column sum its
// partial rows k, k + 8, ... in order, then the 8 sums are added in order
constexpr int SUM_COLS = 32, SUM_GROUPS = 8;

template <typename T>
__global__ void __launch_bounds__(SUM_COLS * SUM_GROUPS)
rmsnorm_bwd_scale(Seg<T> a, Seg<T> b, int D) {
  __shared__ float red[SUM_GROUPS][SUM_COLS + 1];
  const int ca = (a.h * D + SUM_COLS - 1) / SUM_COLS;
  const bool in_a = static_cast<int>(blockIdx.x) < ca;
  const Seg<T>& s = in_a ? a : b;
  const int chunk = in_a ? blockIdx.x : blockIdx.x - ca;
  const int W = s.h * D;
  const int cl = threadIdx.x % SUM_COLS, grp = threadIdx.x / SUM_COLS;
  const int col = chunk * SUM_COLS + cl;
  float acc = 0.f;
  if (col < W)
    for (int k = grp; k < s.blocks; k += SUM_GROUPS)
      acc += s.partial[static_cast<long long>(k) * W + col];
  red[grp][cl] = acc;
  __syncthreads();
  if (grp == 0 && col < W) {
    float v = red[0][cl];
    for (int q = 1; q < SUM_GROUPS; ++q) v += red[q][cl];
    s.dscale[col] = from_f<T>(v);
  }
}

template <typename T>
bool ok(const Seg<T>& s) {
  if (s.n == 0) return s.blocks == 0;
  return s.n > 0 && s.h >= 1 && s.n % s.h == 0 && s.rows >= s.h && s.rows % s.h == 0 &&
         s.blocks >= 1 && static_cast<long long>(s.blocks) * s.rows >= s.n;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int VEC>
cudaError_t launch_rows(const Seg<T>& a, const Seg<T>& b, int D, const Plan& pl, float eps,
                        size_t smem, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(a.blocks + b.blocks);
#define RB(C)                                                                             \
  do {                                                                                    \
    auto kern = rmsnorm_bwd_rows<T, VEC, C>;                                              \
    if (smem > 48 * 1024) {                                                               \
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           static_cast<int>(smem));                      \
      if (e != cudaSuccess) return e;                                                     \
    }                                                                                     \
    kern<<<grid, pl.threads, smem, st>>>(a, b, D, pl, eps);                               \
  } while (0)
  if (pl.cpl == 1) RB(1);
  else if (pl.cpl == 2) RB(2);
  else if (pl.cpl == 4) RB(4);
  else if (pl.cpl == 8) RB(8);
  else RB(16);
#undef RB
  return cudaGetLastError();
}

template <typename T>
int run(const void* x0, const void* dy0, const void* s0, void* dx0, float* p0, void* ds0,
        long long n0, int h0, int rows0, int blocks0, const void* x1, const void* dy1,
        const void* s1, void* dx1, float* p1, void* ds1, long long n1, int rows1, int blocks1,
        int D, float eps, void* stream) {
  const Seg<T> a{static_cast<const T*>(x0), static_cast<const T*>(dy0),
                 static_cast<const T*>(s0), static_cast<T*>(dx0), p0, static_cast<T*>(ds0),
                 n0, h0, rows0, blocks0};
  const Seg<T> b{static_cast<const T*>(x1), static_cast<const T*>(dy1),
                 static_cast<const T*>(s1), static_cast<T*>(dx1), p1, static_cast<T*>(ds1),
                 n1, 1, rows1, n1 > 0 ? blocks1 : 0};
  Plan pl;
  if (D <= 0 || !ok(a) || !ok(b) || a.blocks + b.blocks < 1 || (b.n > 0 && a.h != 1) ||
      static_cast<long long>(a.h) * D > 0x7fffffffLL ||
      !make_plan(D, a.h, static_cast<int>(sizeof(T)), pl))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pl.vec > 1 && !(aligned16(a.x) && aligned16(a.dy) && aligned16(a.dx) &&
                      (b.n == 0 || (aligned16(b.x) && aligned16(b.dy) && aligned16(b.dx)))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = static_cast<size_t>(smem_floats(pl, D, a.h)) * sizeof(float);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = pl.vec > 1 ? launch_rows<T, 16 / sizeof(T)>(a, b, D, pl, eps, smem, st)
                             : launch_rows<T, 1>(a, b, D, pl, eps, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = (a.h * D + SUM_COLS - 1) / SUM_COLS + (n1 > 0 ? (D + SUM_COLS - 1) / SUM_COLS : 0);
  rmsnorm_bwd_scale<T><<<chunks, SUM_COLS * SUM_GROUPS, 0, st>>>(a, b, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Segment a: x0, dy0, dx0 [n0, D] contiguous, scale s0 [h0, D], rows0 rows
// per CTA (a multiple of h0) over blocks0 CTAs, partial p0 [blocks0, h0 *
// D] fp32 (scratch), dscale ds0 [h0, D]. Segment b likewise with a [D]
// scale; n1 = 0 leaves it empty (a grouped segment a needs it empty). All
// on the device of `stream`; x, dy and dx 16-byte aligned where D is a
// multiple of 16 bytes. Two launches. Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_bwd_f32(const void* x0, const void* dy0, const void* s0, void* dx0,
                               float* p0, void* ds0, long long n0, int h0, int rows0,
                               int blocks0, const void* x1, const void* dy1, const void* s1,
                               void* dx1, float* p1, void* ds1, long long n1, int rows1,
                               int blocks1, int D, float eps, void* stream) {
  return run<float>(x0, dy0, s0, dx0, p0, ds0, n0, h0, rows0, blocks0, x1, dy1, s1, dx1, p1,
                    ds1, n1, rows1, blocks1, D, eps, stream);
}

extern "C" int rmsnorm_bwd_bf16(const void* x0, const void* dy0, const void* s0, void* dx0,
                                float* p0, void* ds0, long long n0, int h0, int rows0,
                                int blocks0, const void* x1, const void* dy1, const void* s1,
                                void* dx1, float* p1, void* ds1, long long n1, int rows1,
                                int blocks1, int D, float eps, void* stream) {
  return run<__nv_bfloat16>(x0, dy0, s0, dx0, p0, ds0, n0, h0, rows0, blocks0, x1, dy1, s1, dx1,
                            p1, ds1, n1, rows1, blocks1, D, eps, stream);
}
