// int8 KV quantize / dequantize for Hopper (sm_90a): kv_quantize,
// kv_quantize_store, kv_dequantize.
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
// The divisions are __fdiv_rn, never a multiply by a reciprocal, and the
// rounding is __float2int_rn (to nearest, half to even, as rintf), never
// roundf (half away from zero); build.py's flags carry no
// --use_fast_math, which would relax both.
//
// kv_quantize_store is the same quantize fused with the cache write of
// the reference's int8 decode and paged append (dynamic_update_slice at
// src/repro/models/layers.py:458-463, .at[wp, :, wo].set(mode="drop") at
// :599-604): one launch quantizes a layer's K rows and V rows and writes
// row i's int8 values and scale straight to flat row dst_row[i] of the
// cache leaves (viewed as (-1, d)); a row whose dst_row lies outside
// [0, n_dst) is dropped.  kv_quantize runs the same body with the
// identity destination.
//
// What bounds them on an H100: bytes, and at decode sizes the launch.
// Each does O(1) operations per element, far below the ~295 flop/byte at
// which compute would bound, so the least time is the bytes read and
// written once over HBM bandwidth (3.35 TB/s on the SXM part).  A decode
// step stores 2 x 64 rows per layer, far less than one launch costs, so
// there the gain is the launch count: one launch per layer where the
// separate quantize calls and indexed cache writes took six or more.
//
// Design.  The Pallas kernels take (256, d) row blocks in VMEM.  Here a
// group of G lanes (a power of two, G <= 32) takes a row of 16-byte
// vectors, NV per lane, so that a warp holds 32 / G rows and every lane
// has all its loads in flight (streaming loads: each is read once), with
// the row's destination, before the first reduction.  The group reduces
// the row's max with __shfl_xor_sync on its own lane mask, every lane
// divides and stores its int8 values (8 or 4 bytes a vector), and the
// group's first lane stores the scale.  The wrapper's plan
// (kv_quant_plan) picks G, NV and the CTA size from the shapes: for many
// rows, two vectors a lane (8 lanes per bf16 row of 128, 16 per fp32 row
// of 128) in CTAs of 4 warps; for few rows (a decode step), one vector a
// lane in CTAs of 2 warps, spread over the SMs.  More rows per lane
// group, and a grid-stride loop that loads a warp's next rows while it
// quantizes these, were tried on the card and were no faster at these
// shapes: they cost registers, and so resident warps.  Dequantize is a flat elementwise pass: each
// thread turns 8 int8 values (one 8-byte load) and their row's scale into
// 8 outputs (16- or 32-byte stores).  Not done (later work): dequantize
// fused into the decode attention read, so the bf16 copy of the cache is
// never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // at most, for quantize; always, for dequantize
constexpr int kDequantVec = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// int8 values of one 16-byte input vector: 8 (bf16 in) or 4 (fp32 in).
template <int N> struct Packed;
template <> struct Packed<4> { using T = uint32_t; };
template <> struct Packed<8> { using T = uint2; };

struct QuantArgs {
  const void* x0;             // K rows (or the only input)
  const void* x1;             // V rows, or null
  int8_t* q0;
  int8_t* q1;
  __nv_bfloat16* s0;
  __nv_bfloat16* s1;
  const long long* dst_row;   // (n,) destination rows, or null: identity
  long long n;                // rows per input
  long long total;            // n times the number of inputs
  long long n_dst;            // rows of each destination leaf
  int d;
};

// G lanes per row, NV 16-byte vectors per lane: lane group g of a warp
// takes row warp * 32 / G + g (rows of x0, then of x1).
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads)
kv_quantize_store_kernel(const QuantArgs a) {
  constexpr int N = 16 / sizeof(T);      // elements per vector
  using Q = typename Packed<N>::T;
  const int lane = threadIdx.x & 31;
  const int g = lane / G, l = lane % G;
  const long long row =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
       (threadIdx.x >> 5)) * (32 / G) + g;
  if (row >= a.total) return;            // whole groups leave together
  const bool second = row >= a.n;
  const long long i = second ? row - a.n : row;
  const int nvec = a.d / N;

  // every load of the row (and its destination) before the reduction
  const long long dst = a.dst_row ? a.dst_row[i] : i;
  const uint4* x = reinterpret_cast<const uint4*>(
      static_cast<const T*>(second ? a.x1 : a.x0) + i * a.d);
  uint4 raw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = j * G + l;
    // streaming loads: each vector is read once
    raw[j] = c < nvec ? __ldcs(x + c) : make_uint4(0, 0, 0, 0);
  }

  float v[NV][N];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const T* e = reinterpret_cast<const T*>(&raw[j]);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[j][k] = to_f32(e[k]);
      amax = fmaxf(amax, fabsf(v[j][k]));
    }
  }
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (g * G);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(mask, amax, off));
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  if (dst < 0 || dst >= a.n_dst) return;  // dropped: the whole group

  Q* q = reinterpret_cast<Q*>((second ? a.q1 : a.q0) + dst * a.d);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = j * G + l;
    if (c < nvec) {
      Q out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int k = 0; k < N; ++k)
        // __float2int_rn rounds half to even, as rintf does; the clamp
        // follows in integers (NaN and inf land on -127 / 127 as through
        // fmaxf / fminf).
        o[k] = static_cast<int8_t>(min(max(
            __float2int_rn(__fdiv_rn(v[j][k], scale)), -127), 127));
      q[c] = out;
    }
  }
  if (l == 0) (second ? a.s1 : a.s0)[dst] = __float2bfloat16_rn(scale);
}

template <typename T, int G, int NV>
void launch_quant(const QuantArgs& a, int threads, cudaStream_t st) {
  const long long rows_per_block = threads / 32 * (32 / G);
  const long long grid = (a.total + rows_per_block - 1) / rows_per_block;
  kv_quantize_store_kernel<T, G, NV>
      <<<static_cast<int>(grid), threads, 0, st>>>(a);
}

// The plan (kernels/kv_quant.py :: kv_quant_plan): G lanes per row, NV
// vectors per lane, threads per CTA; these are the (G, NV) it picks.
template <typename T>
int dispatch_quant(const QuantArgs& a, int lanes, int nv, int threads,
                   cudaStream_t st) {
  if (threads < 32 || threads > kThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes * 8 + nv) {
#define KVQ_CASE(G, NV) \
    case G * 8 + NV: launch_quant<T, G, NV>(a, threads, st); break;
    KVQ_CASE(1, 1) KVQ_CASE(2, 1) KVQ_CASE(4, 1) KVQ_CASE(8, 1)
    KVQ_CASE(16, 1) KVQ_CASE(32, 1)
    KVQ_CASE(1, 2) KVQ_CASE(2, 2) KVQ_CASE(4, 2) KVQ_CASE(8, 2)
    KVQ_CASE(16, 2) KVQ_CASE(32, 2) KVQ_CASE(32, 4)
#undef KVQ_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int run_quant(const QuantArgs& a, int x_bf16, const int* plan, void* stream) {
  if (a.total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch_quant<__nv_bfloat16>(a, plan[0], plan[1], plan[2],
                                                st)
                : dispatch_quant<float>(a, plan[0], plan[1], plan[2], st);
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
// x_bf16: the inputs are bf16 (else fp32).  Rows are whole 16-byte
// vectors: d a multiple of 8 (bf16) or 4 (fp32), d <= 512; inputs 16-byte
// aligned, int8 outputs aligned to 8 bytes.

// plan: {lanes per row, vectors per lane, threads per CTA}.

// x (rows, d) -> q (rows, d), s (rows, 1).
int kv_quantize(const void* x, void* q, void* s, int rows, int d, int x_bf16,
                const int* plan, void* stream) {
  const QuantArgs a{x, nullptr, static_cast<int8_t*>(q), nullptr,
                    static_cast<__nv_bfloat16*>(s), nullptr, nullptr,
                    rows, rows, rows, d};
  return run_quant(a, x_bf16, plan, stream);
}

// k, v (n, d) -> rows dst_row[i] of kq, vq (n_dst, d) and ks, vs (n_dst,
// 1); dst_row int64, rows outside [0, n_dst) dropped.
int kv_quantize_store(const void* k, const void* v, void* kq, void* vq,
                      void* ks, void* vs, const void* dst_row, long long n,
                      long long n_dst, int d, int x_bf16, const int* plan,
                      void* stream) {
  const QuantArgs a{k, v, static_cast<int8_t*>(kq), static_cast<int8_t*>(vq),
                    static_cast<__nv_bfloat16*>(ks),
                    static_cast<__nv_bfloat16*>(vs),
                    static_cast<const long long*>(dst_row), n, 2 * n, n_dst,
                    d};
  return run_quant(a, x_bf16, plan, stream);
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
