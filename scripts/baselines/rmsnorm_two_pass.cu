// Fused RMSNorm for Hopper (sm_90a): rmsnorm.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm_kernel.py :: rmsnorm
// (pallas_call at :37, body _rmsnorm_kernel at :21).  Same function: for
// each row of x (rows, d), y = (x * rsqrt(mean(x^2) + eps)) * (1 + w) in
// fp32, stored in x's dtype; w (d,) is fp32 or bf16 (the models'
// zero-centred gains).  The plain twin is models/layers.py::rmsnorm; the
// sum of squares is taken in another order than its torch.mean, so the two
// agree to fp32 rounding (then, for bf16, to the rounding of the output).
//
// What bounds it on an H100: bytes.  It reads x once and writes y once
// (w is d values, read from cache by every row) and does ~4 operations per
// element.  The least time is 2 * rows * d * sizeof(T) over HBM bandwidth
// (3.35 TB/s on the SXM part): 0.015 ms at (4096, 3072) bf16.
//
// Design.  The Pallas kernel normalizes a block of rows per grid step in
// VMEM.  Here one CTA of 128 threads owns one row: each thread sums the
// squares of its 16-byte vectors (8 bf16 or 4 fp32; scalars when d is not
// a multiple), a warp-shuffle and shared-memory reduction gives the row's
// sum, and a second pass over the row (now in L1/L2) scales and stores.
// Not done yet (later work): keeping the row in registers between the two
// passes, several rows per CTA for short rows, and fusing the norm into
// the matrix product that follows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// Sum over the block (any order: the reference's mean promises none).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) s += part[i];
  return s;
}

// V elements of T, loaded and stored as one 16-byte vector when V > 1.
template <typename T, int V>
struct alignas(V > 1 ? 16 : sizeof(T)) Pack {
  T v[V];
};

template <typename TX, typename TW, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int d, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const TX* row = x + base;
  TX* orow = out + base;
  const Pack<TX, V>* xin = reinterpret_cast<const Pack<TX, V>*>(row);
  Pack<TX, V>* xout = reinterpret_cast<Pack<TX, V>*>(orow);
  const int nvec = d / V;

  float ss = 0.f;
  for (int c = threadIdx.x; c < nvec; c += kThreads) {
    const Pack<TX, V> e = xin[c];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float f = to_f(e.v[u]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int c = threadIdx.x; c < nvec; c += kThreads) {
    const Pack<TX, V> e = xin[c];
    Pack<TX, V> o;
#pragma unroll
    for (int u = 0; u < V; ++u)
      store_f((to_f(e.v[u]) * r) * (1.f + to_f(w[c * V + u])), &o.v[u]);
    xout[c] = o;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  if (d % V == 0)
    rmsnorm_kernel<TX, TW, V><<<rows, kThreads, 0, stream>>>(xp, wp, op, d, eps);
  else
    rmsnorm_kernel<TX, TW, 1><<<rows, kThreads, 0, stream>>>(xp, wp, op, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// x_bf16 / w_bf16: x (and out) / w are bf16 (else fp32).  x and out are
// contiguous (rows, d) and 16-byte aligned, w is (d,).
int rmsnorm(const void* x, const void* w, void* out, int rows, int d,
            float eps, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return 0;
  if (x_bf16)
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s)
                  : launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  return w_bf16 ? launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, s)
                : launch<float, float>(x, w, out, rows, d, eps, s);
}

}  // extern "C"
