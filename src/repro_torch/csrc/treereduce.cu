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
// The identity every stage rests on: for Q a power of two no larger than
// P2, after the first log2(P2 / Q) halving levels element t (t < Q) holds
// the halving tree over {x[t + Q * j]}, j in [0, P2 / Q), and the levels
// left are the halving tree over those Q values.  So the reduction may be
// cut into stages at any power-of-two boundary without changing a single
// rounding.
//
// Design, many rows (the main shape, 32768 x 4096): one warp per row,
// eight rows per CTA, no block barrier.  Lane l loads W adjacent elements
// with one 16-byte streaming load (W = 4 fp32 or 8 bf16): element i = W *
// l + c + 32 W * j.  Stage 1 (Q = 32 W) halves over j inside the lane, one
// tree per component c; stage 2 halves over lanes with __shfl_down_sync
// (lane l takes lane l + half, the same c); stage 3 halves over the W
// components of lane 0.  Where a row's start is not 16-byte aligned (N *
// sizeof(T) % 16 != 0, or x itself unaligned) the kernel takes W = 1,
// scalar loads, and the same three stages.
//
// Few long rows (16 x 256 000): each row is split over C CTAs by residue
// class, Q = 512 * C.  CTA c owns the residues [512 c, 512 (c + 1)), W of
// them per thread, so every warp load is contiguous; each thread halves
// over j its residues' trees and writes them to an fp32 scratch (rows, Q)
// that the wrapper allocates (a bf16 input's partials are never rounded
// to bf16).  A second kernel, launched by the same C call, halves each
// row's Q values (one CTA per row, stage 1 in registers, then shared
// memory and the last warp, as the first design did) and stores once in
// x's dtype.  The wrapper chooses C from the shapes and the SM count only
// (kernels/treereduce_kernel.py :: tree_splits).
//
// Halving over j (a lane's J = P2 / Q leaves, J = R * 2^m, R <= 8) is
// streamed: the tree over j splits first by j's lowest bits, so its
// subtrees of R leaves are the sets j = lo + 2^m * h, h in [0, R), each
// itself a halving over h.  A thread loads one subtree at a time (R
// unconditional loads: past the row's end they read its start and are
// discarded), halves it in registers, and feeds the subtrees to a
// binary-counter stack (one entry per component) in bit-reversed order
// of lo: chunk k (lo = bitreverse(k)) merges with the stack entries of
// its trailing one bits, which are exactly its left siblings.  So every
// combine is one the halving makes, with the same operands.  The loop
// over chunks is unrolled by two, so that one chunk's loads are issued
// while the previous one is combined.
//
// Not done yet (later work): at the main shape the kernel still reads
// device memory somewhat more slowly than torch.sum does (PERF.md);
// neither staging whole rows in shared memory with cp.async nor more
// leaves in flight closed that gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpRowsPerCta = 8;    // one warp per row
constexpr int kSplitResidues = 512;   // residues per split CTA (Q = 512 C)
constexpr int kMaxLeaves = 8;         // R: leaves of a register subtree
constexpr int kBlockThreads = 1024;   // second pass: one CTA per row

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
    // NaN-propagating maximum, as torch.maximum computes it on the card
    // (fmaxf takes +0.0 over -0.0).
    return a != a ? a : (b != b ? b : fmaxf(a, b));
  } else {
    return a + b;
  }
}

// R leaves of chunk k of a register subtree (j = lo + 2^m h, h < R, lo =
// bitreverse(k)) as fp32, the identity past the row's end.  A leaf is W
// elements: W > 1 is one 16-byte streaming load (evict first: each
// element is read once; n % W == 0 and the row is aligned, so a vector
// lies wholly inside or wholly past the row).  Loads past the end read
// the row's start and are discarded, so the R loads are straight-line
// code.
template <typename T, bool MAX, int W, int R>
__device__ __forceinline__ void load_leaves(const T* __restrict__ row, int n,
                                            int base, int stride, int m,
                                            int k, float (&v)[R][W]) {
  using Raw = typename std::conditional<W == 1, T, uint4>::type;
  const float ident = MAX ? -INFINITY : 0.f;
  const int lo =
      m ? static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - m)) : 0;
  Raw raw[R];
  bool in[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int i = base + (lo + (1 << m) * h) * stride;
    in[h] = i < n;
    if constexpr (W == 1) {
      raw[h] = row[in[h] ? i : 0];
    } else {
      raw[h] = __ldcs(reinterpret_cast<const uint4*>(row + (in[h] ? i : 0)));
    }
  }
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const T* e = reinterpret_cast<const T*>(&raw[h]);
#pragma unroll
    for (int c = 0; c < W; ++c) v[h][c] = in[h] ? to_f(e[c]) : ident;
  }
}

// Stage 1: the halving tree over j of J = R * 2^m leaves per component,
// streamed as described above; leaves(k, v) fills chunk k's R leaves.
template <bool MAX, int W, int R, int MAXD, typename Leaves>
__device__ __forceinline__ void jtree(int m, float (&acc)[W],
                                      const Leaves& leaves) {
  const int nchunks = 1 << m;
  float stack[MAXD][W];
#pragma unroll 2
  for (int k = 0; k < nchunks; ++k) {
    float v[R][W];
    leaves(k, v);
#pragma unroll
    for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
      for (int h = 0; h < half; ++h) {
#pragma unroll
        for (int c = 0; c < W; ++c) v[h][c] = combine<MAX>(v[h][c], v[h + half][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = v[0][c];
    // merge with the left siblings (one per trailing one bit of k), then
    // wait on the stack; after the last chunk acc is the total.
    int kk = k;
#pragma unroll
    for (int l = 0; l < MAXD; ++l) {
      if (kk & 1) {
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] = combine<MAX>(stack[l][c], acc[c]);
        kk >>= 1;
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) stack[l][c] = acc[c];
        break;
      }
    }
  }
}

// Stages 2 and 3 of a warp's row, and lane 0's store: halving over lanes
// (lanes past P2 / W hold only the identity and are never taken), then
// over the components, from min(W, P2) / 2 down.
template <typename T, bool MAX, int W>
__device__ __forceinline__ void finish_row(float (&acc)[W], int lane, int p2,
                                           T* out) {
  int lanes = p2 / W;
  lanes = lanes < 1 ? 1 : (lanes > 32 ? 32 : lanes);
  for (int half = lanes / 2; half >= 1; half >>= 1) {
#pragma unroll
    for (int c = 0; c < W; ++c)
      acc[c] = combine<MAX>(acc[c], __shfl_down_sync(0xffffffffu, acc[c], half));
  }
  if (lane == 0) {
#pragma unroll
    for (int half = W / 2; half >= 1; half >>= 1) {
      if (2 * half <= p2) {
#pragma unroll
        for (int c = 0; c < half; ++c) acc[c] = combine<MAX>(acc[c], acc[c + half]);
      }
    }
    store_f(acc[0], out);
  }
}

// One warp per row, loads straight into registers.
template <typename T, bool MAX, int W, int R, int MAXD>
__global__ void __launch_bounds__(32 * kWarpRowsPerCta)
tree_warp_rows(const T* __restrict__ x, T* __restrict__ out, int rows, int n,
               int p2, int m) {
  const int r = blockIdx.x * kWarpRowsPerCta + (threadIdx.x >> 5);
  if (r >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const T* row = x + static_cast<size_t>(r) * n;
  float acc[W];
  jtree<MAX, W, R, MAXD>(m, acc, [&](int k, float (&v)[R][W]) {
    load_leaves<T, MAX, W, R>(row, n, W * lane, 32 * W, m, k, v);
  });
  finish_row<T, MAX, W>(acc, lane, p2, out + r);
}

// Split pass: grid (C, rows), 512 / W threads.  Thread t of CTA c owns
// residues q0 .. q0 + W - 1, q0 = 512 c + W t, and writes their trees over
// j (J = P2 / Q leaves, J = R * 2^m) to part (rows, Q).
template <typename T, bool MAX, int W, int R, int MAXD>
__global__ void __launch_bounds__(kSplitResidues)
tree_split_rows(const T* __restrict__ x, float* __restrict__ part, int n,
                int Q, int m) {
  const int r = blockIdx.y;
  const int q0 = blockIdx.x * kSplitResidues + W * threadIdx.x;
  const T* row = x + static_cast<size_t>(r) * n;
  float acc[W];
  jtree<MAX, W, R, MAXD>(m, acc, [&](int k, float (&v)[R][W]) {
    load_leaves<T, MAX, W, R>(row, n, q0, Q, m, k, v);
  });
  float* dst = part + static_cast<size_t>(r) * Q + q0;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 4)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) dst[c] = acc[c];
  }
}

// Second pass: one CTA per row of part (rows, Q) fp32, Q a power of two.
// P threads (P = min(Q, 1024)); thread t halves over j its values t + P j
// (K = Q / P of them, streamed in subtrees of R, stack depth m), then the
// P per-thread values are halved in shared memory (half >= 32) and by
// __shfl_down_sync in the last warp.
template <typename TO, bool MAX, int R>
__global__ void __launch_bounds__(kBlockThreads)
tree_block_rows(const float* __restrict__ part, TO* __restrict__ out, int Q,
                int P, int m) {
  __shared__ float red[kBlockThreads];
  const int t = threadIdx.x;
  const float* row = part + static_cast<size_t>(blockIdx.x) * Q;
  float val[1] = {MAX ? -INFINITY : 0.f};
  if (t < P) {
    jtree<MAX, 1, R, 12>(m, val, [&](int k, float (&v)[R][1]) {
      load_leaves<float, MAX, 1, R>(row, Q, t, P, m, k, v);
    });
    red[t] = val[0];
  }
  __syncthreads();
  for (int half = P / 2; half >= 32; half >>= 1) {
    if (t < half) red[t] = combine<MAX>(red[t], red[t + half]);
    __syncthreads();
  }
  if (t < 32) {
    float v = t < P ? red[t] : val[0];
    for (int half = (P < 32 ? P : 32) / 2; half >= 1; half >>= 1)
      v = combine<MAX>(v, __shfl_down_sync(0xffffffffu, v, half));
    if (t == 0) store_f(v, out + blockIdx.x);
  }
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// J leaves -> R = min(J, kMaxLeaves) and m = log2(J / R).
void leaves(int J, int* R, int* m) {
  *R = J < kMaxLeaves ? J : kMaxLeaves;
  *m = log2i(J / *R);
}

// go(std::integral_constant<int, r>) for r, a power of two <= RMAX.
template <int RMAX, typename Go>
void with_leaves(int r, const Go& go) {
  if constexpr (RMAX > 1) {
    if (r < RMAX) {
      with_leaves<RMAX / 2>(r, go);
      return;
    }
  }
  go(std::integral_constant<int, RMAX>{});
}

template <typename T, bool MAX, int W>
void launch_rows(const T* x, T* out, int rows, int n, int p2, cudaStream_t s) {
  int J = p2 / (32 * W);
  if (J < 1) J = 1;
  int R, m;
  leaves(J, &R, &m);
  with_leaves<kMaxLeaves>(R, [&](auto r) {
    constexpr int RR = decltype(r)::value;
    auto kern = m <= 4 ? tree_warp_rows<T, MAX, W, RR, 4>
                       : tree_warp_rows<T, MAX, W, RR, 16>;
    const int grid = (rows + kWarpRowsPerCta - 1) / kWarpRowsPerCta;
    kern<<<grid, 32 * kWarpRowsPerCta, 0, s>>>(x, out, rows, n, p2, m);
  });
}

template <typename T, bool MAX, int W>
int launch_split(const T* x, T* out, float* part, int rows, int n, int p2,
                 int n_split, cudaStream_t s) {
  const int Q = kSplitResidues * n_split;
  int R, m;
  leaves(p2 / Q, &R, &m);
  with_leaves<kMaxLeaves>(R, [&](auto r) {
    constexpr int RR = decltype(r)::value;
    tree_split_rows<T, MAX, W, RR, 12>
        <<<dim3(n_split, rows), kSplitResidues / W, 0, s>>>(x, part, n, Q, m);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = Q < kBlockThreads ? Q : kBlockThreads;
  leaves(Q / P, &R, &m);
  with_leaves<kMaxLeaves>(R, [&](auto r) {
    constexpr int RR = decltype(r)::value;
    tree_block_rows<T, MAX, RR><<<rows, P, 0, s>>>(part, out, Q, P, m);
  });
  return 0;
}

template <typename T, bool MAX>
int launch(const void* xv, void* outv, float* part, int rows, int n,
           int n_split, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const int p2 = 1 << log2i(n);
  constexpr int V = 16 / sizeof(T);
  const bool vec = (static_cast<size_t>(n) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (n_split > 1) {
    // Q must be a power of two no larger than P2, with the scratch given.
    if ((n_split & (n_split - 1)) || kSplitResidues * n_split > p2 ||
        part == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const int e =
        vec ? launch_split<T, MAX, V>(x, out, part, rows, n, p2, n_split, s)
            : launch_split<T, MAX, 1>(x, out, part, rows, n, p2, n_split, s);
    if (e) return e;
  } else if (vec) {
    launch_rows<T, MAX, V>(x, out, rows, n, p2, s);
  } else {
    launch_rows<T, MAX, 1>(x, out, rows, n, p2, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launches.
// is_max: max (else add); bf16: x and out are bf16 (else fp32).  x is a
// contiguous (rows, n) array with 0 < n <= 2^24; out holds rows values.
// n_split == 1: one warp per row.  n_split > 1 (a power of two, with
// 512 * n_split <= the padded row length): the split pass into part, an
// fp32 (rows, 512 * n_split) scratch, then the second pass into out.
int tree_row_reduce(const void* x, void* out, void* part, int rows, int n,
                    int n_split, int is_max, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (n <= 0 || n > (1 << 24) || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  if (bf16)
    return is_max ? launch<__nv_bfloat16, true>(x, out, p, rows, n, n_split, s)
                  : launch<__nv_bfloat16, false>(x, out, p, rows, n, n_split, s);
  return is_max ? launch<float, true>(x, out, p, rows, n, n_split, s)
                : launch<float, false>(x, out, p, rows, n, n_split, s);
}

}  // extern "C"
