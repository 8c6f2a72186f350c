// One Jacobi sweep of the 4-point stencil for Hopper (sm_90a): stencil2d.
//
// Replaces the TPU kernel src/repro/kernels/stencil.py :: stencil2d
// (pallas_call at :68, body _stencil_kernel at :28).  Same function:
// out[i][j] = 0.25 * (x[i-1][j] + x[i+1][j] + x[i][j-1] + x[i][j+1]) over
// an (H, W) grid with a zero boundary, computed in fp32 and stored in x's
// dtype.  The four taps are summed north, south, west, east and the sum is
// then scaled, the order of the reference and of the plain twin
// (kernels/stencil.py::stencil2d_plain), so the three agree bit for bit;
// a boundary tap adds +0.0 as the zero padding does.
//
// What bounds it on an H100: bytes.  A sweep reads the grid once and
// writes it once (8 bytes per fp32 element) and does 4 operations per
// element, far below the card's operations-per-byte balance.  The least
// time is 2 * H * W * sizeof(T) over HBM bandwidth (3.35 TB/s on the SXM
// part): 0.64 ms for a 16384 x 16384 fp32 grid.
//
// Design.  The Pallas kernel passes the input three times (row blocks
// i-1, i, i+1) to give each block its north and south halo rows, because a
// BlockSpec cannot overlap blocks.  On the GPU every thread reads its
// neighbours directly: one thread computes V consecutive outputs of a row
// (V = 16 bytes / sizeof(T) when W % V == 0, else 1) from three 16-byte
// loads (its row, the row above, the row below) and two scalar loads for
// the west and east neighbours of the vector's ends.  Rows above and
// below are read again by the blocks of the neighbouring rows; with the
// rows swept in order they come from L2, so HBM sees each byte about
// once.  Not done yet (later work): staging a tile with its halo in
// shared memory, and fusing several sweeps into one launch (temporal
// blocking), which cuts the HBM traffic of the iterated stencil.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// x, out: (H, W) row-major.  Thread (blockIdx.x, threadIdx.x) of grid row
// blockIdx.y handles columns [V*c, V*c + V) of rows blockIdx.y,
// blockIdx.y + gridDim.y, ...
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int j0 = c * V;
  if (j0 >= W) return;
  for (int i = blockIdx.y; i < H; i += gridDim.y) {
    const T* row = x + static_cast<size_t>(i) * W;
    float cur[V], north[V], south[V];
    if constexpr (V > 1) {
      const uint4 vc = *reinterpret_cast<const uint4*>(row + j0);
      const uint4 vn = i > 0 ? *reinterpret_cast<const uint4*>(row - W + j0)
                             : make_uint4(0, 0, 0, 0);
      const uint4 vs = i + 1 < H
                           ? *reinterpret_cast<const uint4*>(row + W + j0)
                           : make_uint4(0, 0, 0, 0);
      const T* ec = reinterpret_cast<const T*>(&vc);
      const T* en = reinterpret_cast<const T*>(&vn);
      const T* es = reinterpret_cast<const T*>(&vs);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        cur[u] = to_f(ec[u]);
        north[u] = to_f(en[u]);   // all-zero bits: +0.0 outside the grid
        south[u] = to_f(es[u]);
      }
    } else {
      cur[0] = to_f(row[j0]);
      north[0] = i > 0 ? to_f(row[j0 - W]) : 0.f;
      south[0] = i + 1 < H ? to_f(row[j0 + W]) : 0.f;
    }
    const float west0 = j0 > 0 ? to_f(row[j0 - 1]) : 0.f;
    const float eastV = j0 + V < W ? to_f(row[j0 + V]) : 0.f;
    T* orow = out + static_cast<size_t>(i) * W + j0;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float west = u > 0 ? cur[u - 1] : west0;
      const float east = u + 1 < V ? cur[u + 1] : eastV;
      const float s = ((north[u] + south[u]) + west) + east;
      store_f(s * 0.25f, orow + u);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int H, int W, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = W % V == 0;
  const int per_thread = vec ? V : 1;
  const int cols = (W + per_thread - 1) / per_thread;
  dim3 grid((cols + kThreads - 1) / kThreads, H < kMaxGridY ? H : kMaxGridY);
  if (vec)
    stencil2d_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), H, W);
  else
    stencil2d_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// bf16: x and out are bf16 (else fp32); both contiguous (H, W), 16-byte
// aligned, and out does not alias x.
int stencil2d(const void* x, void* out, int H, int W, int bf16,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return 0;
  if (bf16) return launch<__nv_bfloat16>(x, out, H, W, s);
  return launch<float>(x, out, H, W, s);
}

}  // extern "C"
