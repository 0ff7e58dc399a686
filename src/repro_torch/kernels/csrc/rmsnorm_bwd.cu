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
// Launch 1 (rows): a CTA takes `rows` consecutive rows of its segment.
// Each warp reduces its rows' sum of squares and sum of x * s * dy (lanes
// over the row), keeps r and the mean term in shared memory, then every
// thread of the CTA takes columns of the H x D scale (column c, head
// c / D), walks the CTA's rows of that head in order, writes dx and sums
// dy * xh into an fp32 partial [CTA, H * D]. Launch 2 sums each segment's
// partials over its CTAs in CTA order and casts them to the scale's type.
// No atomics: every sum has one fixed order, so two runs give bitwise equal
// gradients.
//
// What bounds it on the H100: bytes. x and dy are read twice (once for the
// row sums, once for dx, mostly from L2 at the CTA's few rows), dx written
// once, plus the partials; a few flops per element. Reads are scalar and
// made faster later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 1024;  // rows per CTA, at most (r and the mean term in shared memory)

// One segment: x, dy, dx [n, D] contiguous, scale [h, D]; `rows` rows per
// CTA over `blocks` CTAs; partial [blocks, h * D] fp32; dscale [h, D].
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

template <typename T>
__device__ void rows_part(const Seg<T>& s, int blk, int D, float eps, float* r_s, float* c_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blk) * s.rows;
  const int nr = static_cast<int>(min(static_cast<long long>(s.rows), s.n - r0));
  for (int i = warp; i < nr; i += THREADS / 32) {
    const long long row = r0 + i;
    const T* x = s.x + row * D;
    const T* dy = s.dy + row * D;
    const T* sc = s.scale + (s.h > 1 ? (row % s.h) * D : 0);
    float ss = 0.f, xsd = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xv = to_f(x[c]);
      ss += xv * xv;
      xsd += xv * to_f(sc[c]) * to_f(dy[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      xsd += __shfl_xor_sync(0xffffffffu, xsd, o);
    }
    if (lane == 0) {
      const float r = rsqrtf(ss / static_cast<float>(D) + eps);
      r_s[i] = r;
      c_s[i] = r * xsd / static_cast<float>(D);  // mean(xh * s * dy)
    }
  }
  __syncthreads();
  // columns of the [h, D] scale: head c / D, dim c % D
  const int cols = s.h * D;
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    const int hh = c / D, d = c - hh * D;
    const float sv = to_f(s.scale[c]);
    // the CTA's first row of head hh
    const int first = s.h > 1 ? static_cast<int>(((hh - r0 % s.h) % s.h + s.h) % s.h) : 0;
    float acc = 0.f;
    for (int i = first; i < nr; i += s.h) {
      const long long row = r0 + i;
      const float xv = to_f(s.x[row * D + d]);
      const float dyv = to_f(s.dy[row * D + d]);
      const float r = r_s[i];
      const float xh = xv * r;
      s.dx[row * D + d] = from_f<T>(r * (sv * dyv - xh * c_s[i]));
      acc += dyv * xh;
    }
    s.partial[static_cast<long long>(blk) * cols + c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_rows(Seg<T> a, Seg<T> b, int D, float eps) {
  __shared__ float r_s[MAX_ROWS], c_s[MAX_ROWS];
  // the first a.blocks CTAs take segment a, the rest segment b
  if (blockIdx.x < a.blocks)
    rows_part(a, blockIdx.x, D, eps, r_s, c_s);
  else
    rows_part(b, blockIdx.x - a.blocks, D, eps, r_s, c_s);
}

// dscale of both segments: thread per column, partials summed in CTA order
template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_scale(Seg<T> a, Seg<T> b, int D) {
  const int ca = a.h * D, cb = b.n > 0 ? b.h * D : 0;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= ca + cb) return;
  const Seg<T>& s = c < ca ? a : b;
  const int col = c < ca ? c : c - ca;
  const int cols = s.h * D;
  float acc = 0.f;
  for (int k = 0; k < s.blocks; ++k) acc += s.partial[static_cast<long long>(k) * cols + col];
  s.dscale[col] = from_f<T>(acc);
}

template <typename T>
bool ok(const Seg<T>& s) {
  if (s.n == 0) return s.blocks == 0;
  return s.n > 0 && s.h >= 1 && s.rows >= 1 && s.rows <= MAX_ROWS && s.blocks >= 1 &&
         static_cast<long long>(s.blocks) * s.rows >= s.n;
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
  if (D <= 0 || !ok(a) || !ok(b) || a.blocks + b.blocks < 1 ||
      static_cast<long long>(a.h) * D > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  rmsnorm_bwd_rows<T><<<a.blocks + b.blocks, THREADS, 0, st>>>(a, b, D, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cols = a.h * D + (n1 > 0 ? D : 0);
  rmsnorm_bwd_scale<T><<<(cols + THREADS - 1) / THREADS, THREADS, 0, st>>>(a, b, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Segment a: x0, dy0, dx0 [n0, D] contiguous, scale s0 [h0, D], rows0 rows
// per CTA over blocks0 CTAs, partial p0 [blocks0, h0 * D] fp32 (scratch),
// dscale ds0 [h0, D]. Segment b likewise with a [D] scale; n1 = 0 leaves it
// empty. All on the device of `stream`. Two launches. Returns a cudaError_t
// (0 = launched).
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
