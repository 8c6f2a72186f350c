// int8 KV quantize / dequantize for Hopper (sm_90a): kv_quantize, kv_dequantize.
//
// Replaces the TPU kernels src/repro/kernels/kv_quant.py :: kv_quantize
// (pallas_call at :55, body _quant_kernel) and kv_dequantize (pallas_call
// at :76, body _dequant_kernel), which are the kernel form of
// src/repro/models/layers.py :: _kv_quantize / _kv_dequantize.  Same
// functions, bit for bit:
//
//   quantize:   x (rows, d) f32 or bf16 -> q int8 (rows, d), s bf16 (rows, 1)
//               amax  = max |x| over the row, in fp32 (exact in any order)
//               scale = max(amax, 1e-6) / 127            (IEEE division)
//               q     = clamp(rint(x / scale), -127, 127) (IEEE division,
//                       round half to even, as jnp.round)
//               s     = bf16(scale), round to nearest even
//   dequantize: out = (dtype)(float(q) * float(s))       (one fp32 product)
//
// The divisions are __fdiv_rn and the rounding is rintf, never roundf
// (half away from zero) and never a multiply by a reciprocal; build.py's
// flags carry no --use_fast_math, which would relax both.
//
// What bounds them on an H100: bytes.  Each does O(1) operations per
// element, far below the ~295 flop/byte at which compute would bound, so
// the least time is the bytes read and written once over HBM bandwidth
// (3.35 TB/s on the SXM part).
//
// Design.  The Pallas kernels take (256, d) row blocks in VMEM.  Here
// quantize gives one warp to one row: each lane loads 4 contiguous
// elements per 128-element stretch (one 16- or 8-byte vector), keeps them
// in registers, the warp reduces the row max with shuffles, and each lane
// stores its 4 int8 values as one 32-bit word.  Dequantize is a flat
// elementwise pass: each thread turns 8 int8 values (one 8-byte load) and
// their row's scale into 8 outputs (16- or 32-byte stores).  Not done
// yet (later work): fusing quantize into the cache write and dequantize
// into the decode attention read, so the bf16 copy of the cache is never
// written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 4;  // 4-element vectors per lane: rows up to d = 512
constexpr int kDequantVec = 8;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(e[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                   __nv_bfloat16* __restrict__ s, int rows, int d) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + static_cast<size_t>(row) * d;
  float v[kMaxVec][4];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int e = (i * 32 + lane) * 4;
    if (e < d) {
      load4(xr + e, v[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  amax = warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  int8_t* qr = q + static_cast<size_t>(row) * d;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int e = (i * 32 + lane) * 4;
    if (e < d) {
      char4 c;
      int8_t* ce = reinterpret_cast<int8_t*>(&c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i][j], scale)), -127.f), 127.f);
        ce[j] = static_cast<int8_t>(static_cast<int>(r));
      }
      *reinterpret_cast<char4*>(qr + e) = c;
    }
  }
  if (lane == 0) s[row] = __float2bfloat16_rn(scale);
}

__device__ __forceinline__ void store8(const float* v, float* o) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(const float* v, __nv_bfloat16* o) {
  uint4 r;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(o) = r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_dequantize_kernel(const int8_t* __restrict__ q,
                     const __nv_bfloat16* __restrict__ s, T* __restrict__ out,
                     long long n_vec, int d) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long e0 = i * kDequantVec;
    const float sc = __bfloat162float(s[e0 / d]);  // d % 8 == 0: one row
    const uint2 r = *reinterpret_cast<const uint2*>(q + e0);
    const int8_t* qe = reinterpret_cast<const int8_t*>(&r);
    float v[kDequantVec];
#pragma unroll
    for (int j = 0; j < kDequantVec; ++j)
      v[j] = __fmul_rn(static_cast<float>(qe[j]), sc);
    store8(v, out + e0);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch.
// x_bf16: x is bf16 (else fp32).  Needs d % 4 == 0, d <= 512, 16-byte
// aligned rows of x.
int kv_quantize(const void* x, void* q, void* s, int rows, int d, int x_bf16,
                void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = kThreads / 32;
  const int grid = (rows + rows_per_block - 1) / rows_per_block;
  if (x_bf16)
    kv_quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<__nv_bfloat16*>(s), rows, d);
  else
    kv_quantize_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<__nv_bfloat16*>(s), rows, d);
  return static_cast<int>(cudaGetLastError());
}

// out_bf16: out is bf16 (else fp32).  Needs d % 8 == 0 and aligned rows.
int kv_dequantize(const void* q, const void* s, void* out, long long rows,
                  int d, int out_bf16, void* stream) {
  const long long n_vec = rows * d / kDequantVec;
  if (n_vec == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  if (out_bf16)
    kv_dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
        static_cast<__nv_bfloat16*>(out), n_vec, d);
  else
    kv_dequantize_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
        static_cast<float*>(out), n_vec, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
