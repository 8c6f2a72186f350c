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
// VMEM.  Here a group of WPR warps owns one row and a CTA holds several
// groups (rows_per_cta; the wrapper's rmsnorm_plan picks both from the
// shapes).  Each lane loads its share of the row as 16-byte vectors (8
// bf16 or 4 fp32; scalars when d is not a multiple) into registers, at
// most kMaxVecs of them, so the row is read from HBM once: the sum of
// squares (warp shuffles, then shared memory across the group's warps)
// and the scaling both read the registers.  The CTA first stages 1 + w
// in shared memory as fp32, read from w in 16-byte vectors once per CTA.
// Few rows get more warps per row, so that short inputs still spread over
// the SMs.  Rows wider than 32 WPR kMaxVecs vectors take a two-pass
// kernel: one CTA per row, the second pass re-reading the row (from L2).
// Not done (later work): fusing the norm into the matrix product that
// follows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // the two-pass kernel
constexpr int kMaxVecs = 12;    // vectors of a row one lane holds
constexpr int kMaxWarps = 8;    // warps of a CTA of the register kernel

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

// Rows of up to 32 WPR kMaxVecs vectors, held in registers.
template <typename TX, typename TW, int V, int WPR>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_rows_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ out, int rows, int d, float eps) {
  extern __shared__ float4 smem4[];
  float* wf = reinterpret_cast<float*>(smem4);  // [d]  1 + w
  __shared__ float part[kMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / WPR, li = (warp % WPR) * 32 + lane;
  const int row = blockIdx.x * (blockDim.x / (32 * WPR)) + grp;
  const int nvec = d / V;
  const bool live = row < rows;

  Pack<TX, V> v[kMaxVecs];
  const Pack<TX, V>* xin =
      reinterpret_cast<const Pack<TX, V>*>(x + static_cast<size_t>(row) * d);
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int c = li + k * 32 * WPR;
    if (live && c < nvec) v[k] = xin[c];
  }

  // 1 + w in fp32, w read in 16-byte vectors where its width allows.
  constexpr int VW = 16 / sizeof(TW);
  if (d % VW == 0) {
    const Pack<TW, VW>* win = reinterpret_cast<const Pack<TW, VW>*>(w);
    for (int c = threadIdx.x; c < d / VW; c += blockDim.x) {
      const Pack<TW, VW> e = win[c];
#pragma unroll
      for (int u = 0; u < VW; ++u) wf[c * VW + u] = 1.f + to_f(e.v[u]);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += blockDim.x) wf[c] = 1.f + to_f(w[c]);
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int c = li + k * 32 * WPR;
    if (live && c < nvec)
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float f = to_f(v[k].v[u]);
        ss += f * f;
      }
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) part[warp] = ss;
  __syncthreads();              // part and wf are written
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < WPR; ++i) ss += part[grp * WPR + i];
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  Pack<TX, V>* xout =
      reinterpret_cast<Pack<TX, V>*>(out + static_cast<size_t>(row) * d);
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int c = li + k * 32 * WPR;
    if (c < nvec) {
      float g[V];
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int u = 0; u < V; u += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(wf + c * V + u);
          g[u] = g4.x;
          g[u + 1] = g4.y;
          g[u + 2] = g4.z;
          g[u + 3] = g4.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) g[u] = wf[c * V + u];
      }
      Pack<TX, V> o;
#pragma unroll
      for (int u = 0; u < V; ++u)
        store_f((to_f(v[k].v[u]) * r) * g[u], &o.v[u]);
      xout[c] = o;
    }
  }
}

// Wider rows: one CTA per row, two passes over it.
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

template <typename TX, typename TW, int V, int WPR>
int launch_rows(const TX* x, const TW* w, TX* out, int rows, int d,
                float eps, int rpc, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(d) * sizeof(float);
  auto kernel = rmsnorm_rows_kernel<TX, TW, V, WPR>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(rows + rpc - 1) / rpc, 32 * WPR * rpc, bytes, stream>>>(
      x, w, out, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, int V>
int launch_v(const void* x, const void* w, void* out, int rows, int d,
             float eps, int wpr, int rpc, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  switch (wpr) {
    case 0:
      rmsnorm_kernel<TX, TW, V><<<rows, kThreads, 0, stream>>>(xp, wp, op, d,
                                                               eps);
      return static_cast<int>(cudaGetLastError());
    case 1: return launch_rows<TX, TW, V, 1>(xp, wp, op, rows, d, eps, rpc, stream);
    case 2: return launch_rows<TX, TW, V, 2>(xp, wp, op, rows, d, eps, rpc, stream);
    case 4: return launch_rows<TX, TW, V, 4>(xp, wp, op, rows, d, eps, rpc, stream);
    default: return launch_rows<TX, TW, V, 8>(xp, wp, op, rows, d, eps, rpc, stream);
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d,
           float eps, int wpr, int rpc, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int nvec = d % V == 0 ? d / V : d;
  if (wpr != 0 && nvec > 32 * wpr * kMaxVecs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d % V == 0)
    return launch_v<TX, TW, V>(x, w, out, rows, d, eps, wpr, rpc, stream);
  return launch_v<TX, TW, 1>(x, w, out, rows, d, eps, wpr, rpc, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a plan the kernels do not take).  x_bf16 /
// w_bf16: x (and out) / w are bf16 (else fp32).  x and out are contiguous
// (rows, d) and 16-byte aligned, w is (d,) and 16-byte aligned.
// warps_per_row 1, 2, 4 or 8 with warps_per_row * rows_per_cta <= 8 holds
// rows in registers; 0 takes the two-pass kernel (rows_per_cta 1).
int rmsnorm(const void* x, const void* w, void* out, int rows, int d,
            float eps, int x_bf16, int w_bf16, int warps_per_row,
            int rows_per_cta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return 0;
  const int wpr = warps_per_row, rpc = rows_per_cta;
  if ((wpr != 0 && wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) ||
      rpc < 1 || (wpr == 0 && rpc != 1) || wpr * rpc > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    return w_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, wpr, rpc, s)
        : launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, wpr, rpc, s);
  return w_bf16 ? launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, wpr, rpc, s)
                : launch<float, float>(x, w, out, rows, d, eps, wpr, rpc, s);
}

}  // extern "C"
