// RMSNorm for Hopper (sm_90a), with a plain C interface loaded through
// ctypes (see repro_torch/kernels/build.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_kernel
// and computes the reference's layers.rmsnorm: per row of D, the sum of
// squares in fp32, y = T(x * rsqrt(sum / D + eps)), then out = T(float(y) *
// float(scale)). The cast comes before the product, as in the reference;
// bf16 parity depends on that order. The scale is [D], or [H, D] for the SSD
// mixer's grouped norm, where row r takes scale row r mod H. One launch
// covers two segments of rows, each with its own tensors and scale and its
// own run of CTAs: a single norm passes an empty second segment, a layer's
// q_norm and k_norm pass q's rows and k's. Lanes per row and chunks per lane
// never depend on the row count, so a row's result does not depend on the
// batch, and the pair computes both norms bitwise as two single launches
// would.
//
// What bounds it on the H100: bytes, about 2 * N * D elements (x in, out
// out) plus the scale, a few flops per element and no tensor cores. At the
// decode step's shapes (a few KB) launch and memory latency set the time.
//
// Design: a row belongs to a group of `lanes` threads (a power of two that
// the wrapper's launch plan picks from D and the element size: 8 or 16
// lanes at D 64 or 128 in bf16, so a warp takes 4 or 2 rows; 4 warps at D
// 4096). Lane l of the group takes the row's 16-byte chunks l, l + lanes,
// ... (at most CPL of them), so neighbouring lanes read neighbouring
// bytes. Every lane issues all its loads of x and of the scale row before
// it reduces, the reduction runs over the group's lanes only (shuffles;
// across warps through shared memory when a row spans several), and each
// chunk is written once. The scale is read through the read-only path:
// every row of a CTA takes the same [D] row (or one of H rows), which stays
// in L1. Where D * size is not a multiple of 16 bytes or a pointer is not
// 16-byte aligned, a chunk is one element (the scalar instance). CTAs have
// 256 threads, fewer when the rows would leave SMs idle. At the decode
// step's sizes the time is the launch and one memory round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// V elements of T, loaded and stored as one access (16 bytes, or one
// element in the scalar instance).
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

// One segment of rows: x [n, D] with rows `stride` elements apart, out
// [n, D] contiguous, scale [h, D], over `blocks` CTAs.
template <typename T>
struct Seg {
  const T* x;
  T* out;
  const T* scale;
  long long n, stride;
  int h, blocks;
};

// Threads per CTA, at most, so at most 255 registers a thread: a row of up
// to 8192 bf16 or 4096 fp32 elements (4 16-byte chunks a lane), or 4096
// single elements (16 a lane).
constexpr int MAX_THREADS = 256;

// A chunk through the read-only data path.
template <typename C>
__device__ __forceinline__ C load_ro(const C* p) {
  C c;
  if constexpr (sizeof(C) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&c, &u, 16);
  } else if constexpr (sizeof(C) == 4) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    memcpy(&c, &u, 4);
  } else {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&c, &u, 2);
  }
  return c;
}

// A CTA's rows of one segment (blk: the CTA's index within it). LANES
// threads per row and CPL chunks per lane are compile-time: the lane and row
// arithmetic become shifts and masks, the shuffles unroll, and a row within
// a warp needs no shared memory.
template <typename T, int V, int LANES, int CPL>
__device__ __forceinline__ void norm_rows(const Seg<T>& s, int blk, int D, float eps) {
  using C = Chunk<T, V>;
  const int tid = threadIdx.x;
  const int lane = tid & (LANES - 1);
  const long long r = static_cast<long long>(blk) * (blockDim.x / LANES) + tid / LANES;
  const bool live = r < s.n;
  const int nchunks = D / V;
  const C* x = reinterpret_cast<const C*>(s.x + r * s.stride);
  const C* sc = reinterpret_cast<const C*>(
      s.scale + (s.h > 1 ? static_cast<long long>(static_cast<unsigned>(r) % s.h) * D : 0));

  C xv[CPL], sv[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + k * LANES;
    if (live && c < nchunks) {
      xv[k] = x[c];
      sv[k] = load_ro(sc + c);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (live && lane + k * LANES < nchunks) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f(xv[k].v[e]);
        ss += f * f;
      }
    }
  }
  // the row's lanes: a power of two, aligned within the warp, or whole warps
#pragma unroll
  for (int o = (LANES < 32 ? LANES : 32) >> 1; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (LANES > 32) {
    __shared__ float part[MAX_THREADS / 32];  // warps' partial sums
    constexpr int WARPS = LANES / 32;
    const int w0 = (tid >> 5) & ~(WARPS - 1);
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ss += part[w0 + w];
  }
  if (!live) return;
  const float rs = rsqrtf(ss / static_cast<float>(D) + eps);
  C* out = reinterpret_cast<C*>(s.out + r * D);
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + k * LANES;
    if (c < nchunks) {
      C o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const T y = from_f<T>(to_f(xv[k].v[e]) * rs);
        o.v[e] = from_f<T>(to_f(y) * to_f(sv[k].v[e]));
      }
      out[c] = o;
    }
  }
}

template <typename T, int V, int LANES, int CPL>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(Seg<T> a, Seg<T> b, int D, float eps) {
  // the first a.blocks CTAs take segment a, the rest segment b: a branch
  // that is uniform over the CTA, so each side reads its segment's
  // parameters directly
  if (blockIdx.x < a.blocks)
    norm_rows<T, V, LANES, CPL>(a, blockIdx.x, D, eps);
  else
    norm_rows<T, V, LANES, CPL>(b, blockIdx.x - a.blocks, D, eps);
}

template <typename T, int V, int LANES, int CPL>
cudaError_t launch_k(const Seg<T>& a, const Seg<T>& b, int D, int threads, float eps,
                     cudaStream_t stream) {
  rmsnorm_kernel<T, V, LANES, CPL><<<a.blocks + b.blocks, threads, 0, stream>>>(a, b, D, eps);
  return cudaGetLastError();
}

// The (lanes, chunks per lane) pairs the launch plan makes: one chunk a
// lane on fewer than 32 lanes; 1, 2 or 4 chunks of 16 bytes (up to 16
// single elements) on 32 lanes; the most chunks on more lanes. More than 4
// chunks of 16 bytes would spill at 16 bytes of x and of the scale each.
template <typename T, int V, int LANES>
cudaError_t launch_l(const Seg<T>& a, const Seg<T>& b, int D, int cpl, int threads, float eps,
                     cudaStream_t stream) {
  constexpr int MAX_CPL = V == 1 ? 16 : 4;
  if constexpr (LANES != 32) {
    constexpr int CPL = LANES < 32 ? 1 : MAX_CPL;
    if (cpl != CPL) return cudaErrorInvalidValue;
    return launch_k<T, V, LANES, CPL>(a, b, D, threads, eps, stream);
  } else {
    switch (cpl) {
      case 1: return launch_k<T, V, 32, 1>(a, b, D, threads, eps, stream);
      case 2: return launch_k<T, V, 32, 2>(a, b, D, threads, eps, stream);
      case 4: return launch_k<T, V, 32, 4>(a, b, D, threads, eps, stream);
    }
    if constexpr (V == 1) {
      if (cpl == 8) return launch_k<T, 1, 32, 8>(a, b, D, threads, eps, stream);
      if (cpl == 16) return launch_k<T, 1, 32, 16>(a, b, D, threads, eps, stream);
    }
    return cudaErrorInvalidValue;
  }
}

template <typename T, int V>
cudaError_t launch_v(const Seg<T>& a, const Seg<T>& b, int D, int lanes, int cpl, int threads,
                     float eps, cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch_l<T, V, 1>(a, b, D, cpl, threads, eps, stream);
    case 2: return launch_l<T, V, 2>(a, b, D, cpl, threads, eps, stream);
    case 4: return launch_l<T, V, 4>(a, b, D, cpl, threads, eps, stream);
    case 8: return launch_l<T, V, 8>(a, b, D, cpl, threads, eps, stream);
    case 16: return launch_l<T, V, 16>(a, b, D, cpl, threads, eps, stream);
    case 32: return launch_l<T, V, 32>(a, b, D, cpl, threads, eps, stream);
    case 64: return launch_l<T, V, 64>(a, b, D, cpl, threads, eps, stream);
    case 128: return launch_l<T, V, 128>(a, b, D, cpl, threads, eps, stream);
    case 256: return launch_l<T, V, 256>(a, b, D, cpl, threads, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A segment's part of the plan covers every row and chunk (an empty
// segment has no CTA).
template <typename T>
bool covers(const Seg<T>& s, int lanes, int threads) {
  if (s.n == 0) return s.blocks == 0;
  // a grouped segment takes row r's scale row as a 32-bit r % h
  return s.n > 0 && s.h >= 1 && (s.h == 1 || s.n <= 0xffffffffLL) && s.blocks >= 0 &&
         static_cast<long long>(s.blocks) * (threads / lanes) >= s.n;
}

template <typename T>
bool aligned(const Seg<T>& s, int V) {
  return s.n == 0 || (aligned16(s.x) && aligned16(s.out) && aligned16(s.scale) &&
                      s.stride % V == 0);
}

template <typename T>
int run(const void* x0, void* out0, const void* s0, long long n0, long long stride0, int h0,
        int blocks0, const void* x1, void* out1, const void* s1, long long n1, long long stride1,
        int blocks1, int D, float eps, int vec, int lanes, int cpl, int threads, void* stream) {
  const Seg<T> a{static_cast<const T*>(x0), static_cast<T*>(out0), static_cast<const T*>(s0),
                 n0, stride0, h0, blocks0};
  const Seg<T> b{static_cast<const T*>(x1), static_cast<T*>(out1), static_cast<const T*>(s1),
                 n1, stride1, 1, n1 > 0 ? blocks1 : 0};
  constexpr int V16 = 16 / sizeof(T);
  const int V = vec ? V16 : 1;
  // the launch plan must cover every row and chunk: refuse one that does not
  if (D <= 0 || D % V != 0 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      lanes < 1 || (lanes & (lanes - 1)) != 0 || threads % lanes != 0 ||
      static_cast<long long>(cpl) * lanes < D / V || a.blocks + b.blocks < 1 ||
      !covers(a, lanes, threads) || !covers(b, lanes, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(aligned(a, V16) && aligned(b, V16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec ? launch_v<T, V16>(a, b, D, lanes, cpl, threads, eps, st)
                            : launch_v<T, 1>(a, b, D, lanes, cpl, threads, eps, st);
  return static_cast<int>(e);
}

}  // namespace

// Segment a: x0 [n0, D] (rows stride0 elements apart), out0 [n0, D]
// contiguous, scale s0 [h0, D] (row r takes scale row r % h0), over blocks0
// CTAs. Segment b likewise with a [D] scale, on the blocks1 CTAs after them;
// n1 = 0 leaves it empty. The launch plan (vec: 16-byte chunks or single
// elements; lanes per row; chunks per lane cpl, 1, 2 or 4, or also 8 or 16
// single elements; threads per CTA) comes from the wrapper
// (repro_torch/kernels/rmsnorm.py) and holds for both segments. All on the
// device of `stream`. Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_f32(const void* x0, void* out0, const void* s0, long long n0,
                           long long stride0, int h0, int blocks0, const void* x1, void* out1,
                           const void* s1, long long n1, long long stride1, int blocks1, int D,
                           float eps, int vec, int lanes, int cpl, int threads, void* stream) {
  return run<float>(x0, out0, s0, n0, stride0, h0, blocks0, x1, out1, s1, n1, stride1, blocks1,
                    D, eps, vec, lanes, cpl, threads, stream);
}

extern "C" int rmsnorm_bf16(const void* x0, void* out0, const void* s0, long long n0,
                            long long stride0, int h0, int blocks0, const void* x1, void* out1,
                            const void* s1, long long n1, long long stride1, int blocks1, int D,
                            float eps, int vec, int lanes, int cpl, int threads, void* stream) {
  return run<__nv_bfloat16>(x0, out0, s0, n0, stride0, h0, blocks0, x1, out1, s1, n1, stride1,
                            blocks1, D, eps, vec, lanes, cpl, threads, stream);
}
