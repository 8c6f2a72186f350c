// Row-wise balanced tree reduction for Hopper (sm_90a): tree_row_reduce.
//
// Replaces the TPU kernel src/repro/kernels/treereduce_kernel.py ::
// tree_row_reduce (pallas_call at :57, body _tree_kernel at :25).  Same
// function: add or max over the last axis of x (rows, N), N padded to the
// next power of two P2 with the identity (0 for add, -inf for max), in
// fp32, by balanced halving: at every level element i combines with
// element i + half.  That pairing fixes every rounding, so the result is
// bit-reproducible; the plain twin (kernels/treereduce_kernel.py ::
// tree_row_reduce_plain) halves the same way and agrees bit for bit.
//
// What bounds it on an H100: bytes.  Each element is read once and
// combined once; the least time is rows * N * sizeof(T) over HBM bandwidth
// (3.35 TB/s on the SXM part).
//
// Design: one CTA per row, P threads (P = min(P2, 256 or 1024)).  Element
// i = t + j * P of the padded row belongs to thread t, at its index j in
// [0, K), K = P2 / P.  The halving's top levels (half >= P) pair i with
// i + half, i.e. j with j + half / P in the same thread: they are a
// halving over the thread's own index j.  Rows up to P2 = 16 * P are held
// in registers and halved there.  Longer rows (262 144 lanes, 1 MiB per
// row in fp32, far more than registers or shared memory hold) are
// streamed: the tree over j splits first (at its root) by j's lowest bit,
// so its subtrees of R = 16 leaves are the sets j = lo + (K / R) * h, h in
// [0, R), for fixed lo, each itself a halving over h.  A thread loads one
// such subtree at a time (R coalesced loads in flight, one per h), halves
// it in registers, and feeds the subtrees to a binary-counter stack in
// bit-reversed order of lo: chunk c (lo = bitreverse(c)) merges with the
// stack entries of its trailing one bits, which are exactly its left
// siblings in the tree.  So every combine is one the halving makes, with
// the same operands.  Then the P per-thread values are halved in shared
// memory (half >= 32) and by __shfl_down_sync(v, half) inside the last
// warp: lane i takes lane i + half, the same pairing again (no xor
// butterfly, no atomics).  Not done yet (later work): splitting a long row
// over several CTAs (16 rows of 262 144 lanes keep only 16 SMs busy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kChunk = 16;      // register-held subtree (R) for long rows
constexpr int kMaxDepth = 13;   // stack levels 0..m, m <= log2(2^24 / 256 / kChunk)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (MAX) {
    // NaN-propagating maximum, as torch.maximum and jnp.maximum.
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
  } else {
    return a + b;
  }
}

// Loads the R leaves j = lo + stride * h (h < R) of thread t's subtree,
// identity past the row's end, and halves them (h with h + R/2 first).
template <typename T, bool MAX, int R>
__device__ __forceinline__ float subtree(const T* __restrict__ row, int n,
                                         int t, int P, int lo, int stride) {
  const float ident = MAX ? -INFINITY : 0.f;
  float v[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int i = t + (lo + stride * h) * P;
    v[h] = i < n ? to_f(row[i]) : ident;
  }
#pragma unroll
  for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
    for (int h = 0; h < half; ++h) v[h] = combine<MAX>(v[h], v[h + half]);
  }
  return v[0];
}

// x: (rows, n) row-major; out: (rows,).  blockDim.x = max(P, 32); K = P2 / P
// = R * nchunks with nchunks = 2^m.
template <typename T, bool MAX, int R>
__global__ void __launch_bounds__(kMaxThreads)
tree_row_reduce_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                       int P, int m) {
  __shared__ float red[kMaxThreads];
  const int t = threadIdx.x;
  const T* row = x + static_cast<size_t>(blockIdx.x) * n;
  const int nchunks = 1 << m;
  float val = MAX ? -INFINITY : 0.f;
  if (t < P) {
    float stack[kMaxDepth];
    for (int c = 0; c < nchunks; ++c) {
      const int lo = m ? static_cast<int>(__brev(static_cast<unsigned>(c)) >>
                                          (32 - m))
                       : 0;
      val = subtree<T, MAX, R>(row, n, t, P, lo, nchunks);
      // merge with the left siblings (one per trailing one bit of c), then
      // wait on the stack; after the last chunk val is the thread's total.
      int cc = c;
#pragma unroll
      for (int l = 0; l < kMaxDepth; ++l) {
        if (cc & 1) {
          val = combine<MAX>(stack[l], val);
          cc >>= 1;
        } else {
          stack[l] = val;
          break;
        }
      }
    }
    red[t] = val;
  }
  __syncthreads();
  for (int half = P / 2; half >= 32; half >>= 1) {
    if (t < half) red[t] = combine<MAX>(red[t], red[t + half]);
    __syncthreads();
  }
  if (t < 32) {
    float v = t < P ? red[t] : val;
    for (int half = (P < 32 ? P : 32) / 2; half >= 1; half >>= 1)
      v = combine<MAX>(v, __shfl_down_sync(0xffffffffu, v, half));
    if (t == 0) store_f(v, out + blockIdx.x);
  }
}

template <typename T, bool MAX>
int launch(const void* x, void* out, int rows, int n, cudaStream_t stream) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  const int cap = rows >= 1024 ? 256 : kMaxThreads;
  const int P = p2 < cap ? p2 : cap;
  const int K = p2 / P;
  const int R = K < kChunk ? K : kChunk;
  int m = 0;
  while ((R << m) < K) ++m;
  const int threads = P < 32 ? 32 : P;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  switch (R) {
    case 1: tree_row_reduce_kernel<T, MAX, 1><<<rows, threads, 0, stream>>>(xp, op, n, P, m); break;
    case 2: tree_row_reduce_kernel<T, MAX, 2><<<rows, threads, 0, stream>>>(xp, op, n, P, m); break;
    case 4: tree_row_reduce_kernel<T, MAX, 4><<<rows, threads, 0, stream>>>(xp, op, n, P, m); break;
    case 8: tree_row_reduce_kernel<T, MAX, 8><<<rows, threads, 0, stream>>>(xp, op, n, P, m); break;
    default: tree_row_reduce_kernel<T, MAX, kChunk><<<rows, threads, 0, stream>>>(xp, op, n, P, m); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// is_max: max (else add); bf16: x and out are bf16 (else fp32).  x is a
// contiguous (rows, n) array with 0 < n <= 2^24; out holds rows values.
int tree_row_reduce(const void* x, void* out, int rows, int n, int is_max,
                    int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (bf16)
    return is_max ? launch<__nv_bfloat16, true>(x, out, rows, n, s)
                  : launch<__nv_bfloat16, false>(x, out, rows, n, s);
  return is_max ? launch<float, true>(x, out, rows, n, s)
                : launch<float, false>(x, out, rows, n, s);
}

}  // extern "C"
