// Mamba2 SSD chunked scan for Hopper (sm_90a): ssd_scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py :: ssd_scan
// (pallas_call at :88, body _ssd_kernel at :29-65).  Same function, per
// (batch, head), over the chunks of Q = `chunk` positions, with the state
// S (ds x dh, fp32) carried from one chunk to the next:
//
//   cum_i = sum_{k<=i} dt_k A                       (within the chunk)
//   y_i   = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
//           + exp(cum_i) (C_i . S_in)
//   S_out = exp(cum_last) S_in + sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
//
// x, y (b, s, h, dh), dt (b, s, h), A (h,), B, C (b, s, ds) [ngroups = 1],
// all fp32.  The plain twin is kernels/ref.py::ssd_chunked_batch; the two
// sum in other orders, so they agree to fp32 rounding, not bit for bit.
//
// What bounds it on an H100: operations.  Per (b, chunk) C.B^T takes
// Q^2 ds flops over the causal triangle, and per (b, h, chunk) the
// weighted sum of x Q^2 dh and the two state products 4 Q ds dh, against
// ~0.3 MB of x, y, B, C and dt per (b, h, chunk).
//
// Design: the chunk-parallel decomposition, four kernels from one C call,
// all on the caller's stream, with fp32 scratch the wrapper allocates:
//
//   1. ssd_cb_kernel, grid (triangle tiles, chunk, b): G = C . B^T once per
//      (b, chunk), 64 x 64 tiles on and below the diagonal, into G
//      (b, nc, Qp, Qp) (Qp = Q rounded up to 64; padded rows are zeros).
//      The heads share B and C, so no head recomputes it.
//   2. ssd_state_kernel, grid (chunk x dh slab, h, b): the chunk's own
//      state B^T diag(exp(cum_last - cum) dt) x into S (b, h, nc, ds, dh),
//      and cum_last into L (b, h, nc).
//   3. ssd_pass_kernel, grid (ds dh / 1024, h, b): the short serial pass
//      over chunks, S_in[c] = exp(cum_last[c-1]) S_in[c-1] + S_loc[c-1],
//      in place (slot c of S then holds the state chunk c finds).
//   4. ssd_out_kernel, grid (chunk x row tile x dh slab, h, b): y of one
//      64-row tile, exp(cum_i) (C_i . S_in) plus (G o L o dt_j) . x over
//      the tiles J <= I, written once.
//
// Every product is a warp's mma.sync m16n8k8 on fp32 tiles in shared
// memory, loaded with 16-byte cp.async and double-buffered in the loops
// over j tiles.  One TF32 product keeps ~3 decimal digits, past the 2e-4
// rule, so each operand is split hi + lo (hi its top 10 mantissa bits by
// a mask, lo the rest) and a product is hi.hi + hi.lo + lo.hi (3xTF32;
// lo.lo, ~2^-20 of it, is dropped).  Per-position factors (the decays,
// dt) are folded into the operands as they are loaded into registers.
// SSD_PRODUCT selects another form for scripts/kernel_variants.py: 1 split
// bf16 (the same three products, bf16 halves), 2 fp32 on the CUDA cores
// (same tiles), 3 one TF32 product (diagnostic).  Above the diagonal
// cum_i - cum_j > 0 can overflow exp to inf, and inf * 0 is NaN: that exp
// is never taken (the weight is selected 0 first), and the m16n8 tiles
// and k steps wholly above the diagonal of a diagonal tile are skipped.
// Not done yet (later work): wgmma with TMA tiles, and several heads of
// one (b, chunk) per CTA sharing the G and C tiles in shared memory
// (every head's CTA reads them from L2 here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#ifndef SSD_PRODUCT
#define SSD_PRODUCT 0
#endif

namespace {

constexpr int kThreads = 256;   // 8 warps in every kernel
constexpr int kT = 64;          // rows of an i or j tile of G and y
constexpr int kTS = 32;         // rows of a j tile of the chunk's state
constexpr int kMaxDs = 128;
constexpr int kMaxChunk = 1024;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* G;   // (b, nc, Qp, Qp)  C . B^T, tiles on and below the diagonal
  float* S;   // (b, h, nc, ds, dh)  chunk states, then incoming states
  float* L;   // (b, h, nc)  cum_last of each chunk
  int s, h, dh, ds, Q, nc, nqt;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros if !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x cols floats (cols % 4 == 0), row r from src + r * stride, into
// dst[r * ld]; rows at or past `valid` are zeros.
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, size_t stride,
                                          int rows, int cols, int valid) {
  const int per = cols / 4, dr = kThreads / per, dc = kThreads % per;
  int r = threadIdx.x / per, c = threadIdx.x % per;
  for (; r < rows; r += dr, c += dc) {   // (r, c) walk without a division
    if (c >= per) {
      c -= per;
      ++r;
      if (r >= rows) break;
    }
    const bool ok = r < valid;
    cp_async16(dst + r * ld + 4 * c, ok ? src + r * stride + 4 * c : src,
               ok);
  }
}

// --- one warp's 16 x 8 x 8 product in the form SSD_PRODUCT selects -------
// A(r, k) = pa[r * rs + k * ks] (16 x 8), B(k, n) = pb[k * ks + n * ns]
// sc[k] (8 x 8; sc, a scale per k, may be null).  Accumulator c: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// with g = lane / 4, t = lane % 4, in every form.

#if SSD_PRODUCT == 2
struct FragA { float v[2][8]; };
struct FragB { float v[2][8]; };
#else
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };
#endif

#if SSD_PRODUCT == 1
// x = hi + lo, both bf16, packed in pairs (x0 in the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
#elif SSD_PRODUCT != 2
// x = hi + lo: hi keeps the top 10 mantissa bits (a TF32 value), lo the
// rest, exactly; the tensor core reads lo's top bits.  A mask and a
// subtraction, where cvt.rna.tf32 would be a slow conversion.
__device__ __forceinline__ void split1(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
#endif

__device__ __forceinline__ void load_a(FragA& f, const float* p, int rs,
                                       int ks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#if SSD_PRODUCT == 2
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) f.v[r][k] = p[(g + 8 * r) * rs + k * ks];
#else
  const float v0 = p[g * rs + t * ks], v1 = p[(g + 8) * rs + t * ks];
  const float v2 = p[g * rs + (t + 4) * ks];
  const float v3 = p[(g + 8) * rs + (t + 4) * ks];
#if SSD_PRODUCT == 1
  // k of m16n8k8.bf16 (2t, 2t + 1) stands for this form's (t, t + 4).
  split2(v0, v2, f.hi[0], f.lo[0]);
  split2(v1, v3, f.hi[1], f.lo[1]);
#else
  split1(v0, f.hi[0], f.lo[0]);
  split1(v1, f.hi[1], f.lo[1]);
  split1(v2, f.hi[2], f.lo[2]);
  split1(v3, f.hi[3], f.lo[3]);
#endif
#endif
}

__device__ __forceinline__ void load_b(FragB& f, const float* p, int ks,
                                       int ns, const float* sc = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#if SSD_PRODUCT == 2
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      f.v[n][k] = p[k * ks + (2 * t + n) * ns] * (sc ? sc[k] : 1.f);
#else
  float v0 = p[t * ks + g * ns], v1 = p[(t + 4) * ks + g * ns];
  if (sc) {
    v0 *= sc[t];
    v1 *= sc[t + 4];
  }
#if SSD_PRODUCT == 1
  split2(v0, v1, f.hi[0], f.lo[0]);
#else
  split1(v0, f.hi[0], f.lo[0]);
  split1(v1, f.hi[1], f.lo[1]);
#endif
#endif
}

#if SSD_PRODUCT == 1
__device__ __forceinline__ void mma_k8(float* c, uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
#elif SSD_PRODUCT != 2
__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

// c += A . B, the small terms first.
__device__ __forceinline__ void mma(float* c, const FragA& a,
                                    const FragB& b) {
#if SSD_PRODUCT == 2
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int k = 0; k < 8; ++k) c[2 * r + n] += a.v[r][k] * b.v[n][k];
#elif SSD_PRODUCT == 1
  mma_k8(c, a.lo[0], a.lo[1], b.hi[0]);
  mma_k8(c, a.hi[0], a.hi[1], b.lo[0]);
  mma_k8(c, a.hi[0], a.hi[1], b.hi[0]);
#elif SSD_PRODUCT == 3
  mma_k8(c, a.hi, b.hi[0], b.hi[1]);
#else
  mma_k8(c, a.lo, b.hi[0], b.hi[1]);
  mma_k8(c, a.hi, b.lo[0], b.lo[1]);
  mma_k8(c, a.hi, b.hi[0], b.hi[1]);
#endif
}

// dt of the chunk whose first (b, t) row is row0 (zeros past Q), and cum,
// the prefix sum of dt A (cum_last past Q), into shared memory.  One warp
// scans: serial runs per lane, then a shuffle scan of the lane totals.
__device__ void chunk_cum(const Args& a, size_t row0, int hi, float* dts,
                          float* cum) {
  const int Q = a.Q, Qp = a.nqt * kT, t = threadIdx.x;
  const float Av = a.A[hi];
  for (int e = t; e < Qp; e += kThreads)
    dts[e] = e < Q ? a.dt[(row0 + e) * a.h + hi] : 0.f;
  __syncthreads();
  if (t < 32) {
    const int per = (Q + 31) / 32;
    const int e0 = min(t * per, Q), e1 = min(e0 + per, Q);
    float run = 0.f;
    for (int e = e0; e < e1; ++e) {
      run += dts[e] * Av;
      cum[e] = run;
    }
    float inc = run;
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, inc, o);
      if (t >= o) inc += v;
    }
    const float off = inc - run;
    for (int e = e0; e < e1; ++e) cum[e] += off;
  }
  __syncthreads();
  const float cl = cum[Q - 1];
  for (int e = Q + t; e < Qp; e += kThreads) cum[e] = cl;
  __syncthreads();
}

// 1. G = C . B^T for one 64 x 64 tile (I, J <= I) of one (b, chunk).
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int ds = a.ds, ld = ds + 4, Qp = a.nqt * kT;
  float* CS = reinterpret_cast<float*>(smem4);  // [kT][ld] C rows of tile I
  float* BS = CS + kT * ld;                     // [kT][ld] B rows of tile J
  int I = 0, J = blockIdx.x;                    // the triangle, row by row
  while (J > I) J -= ++I;
  const int c = blockIdx.y, bi = blockIdx.z;
  const size_t row0 = static_cast<size_t>(bi) * a.s +
                      static_cast<size_t>(c) * a.Q;
  load_tile(CS, ld, a.C + (row0 + I * kT) * ds, ds, kT, ds, a.Q - I * kT);
  load_tile(BS, ld, a.B + (row0 + J * kT) * ds, ds, kT, ds, a.Q - J * kT);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // warp w: rows 16 (w % 4), columns 8 (w / 4 + 2 u), u < 4.
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mt = w & 3;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < ds; k0 += 8) {
    FragA fa;
    load_a(fa, CS + mt * 16 * ld + k0, ld, 1);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int nt = (w >> 2) + 2 * u;
      if (I == J && nt * 8 > mt * 16 + 15) continue;  // above the diagonal
      FragB fb;
      load_b(fb, BS + nt * 8 * ld + k0, 1, ld);
      mma(acc[u], fa, fb);
    }
  }
  float* out = a.G + ((static_cast<size_t>(bi) * a.nc + c) * Qp + I * kT) *
                         Qp + J * kT;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int col = ((w >> 2) + 2 * u) * 8 + 2 * t, r = mt * 16 + g;
    *reinterpret_cast<float2*>(out + r * Qp + col) =
        make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(out + (r + 8) * Qp + col) =
        make_float2(acc[u][2], acc[u][3]);
  }
}

// 2. The chunk's own state for one (b, h, chunk, dh slab):
//    S_loc = sum_j B_j^T exp(cum_last - cum_j) dt_j x_j, over 32-row j
//    tiles, double-buffered; cum_last into L.
template <int DHS>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(Args a) {
  constexpr int NT = DHS / 8;   // 8-column tiles of the slab
  extern __shared__ float4 smem4[];
  const int ds = a.ds, ldb = ds + 8, ldx = DHS + 8, Q = a.Q;
  const int Qp = a.nqt * kT, slabs = a.dh / DHS;
  float* BS = reinterpret_cast<float*>(smem4);  // [2][kTS][ldb]
  float* XS = BS + 2 * kTS * ldb;               // [2][kTS][ldx]
  float* dts = XS + 2 * kTS * ldx;              // [Qp]
  float* cum = dts + Qp;                        // [Qp]
  float* wj = cum + Qp;                         // [Qp]
  const int c = blockIdx.x / slabs, d0 = (blockIdx.x % slabs) * DHS;
  const int hi = blockIdx.y, bi = blockIdx.z, h = a.h, dh = a.dh;
  const size_t row0 = static_cast<size_t>(bi) * a.s +
                      static_cast<size_t>(c) * Q;
  const int ntj = (Q + kTS - 1) / kTS;
  auto load = [&](int J, int buf) {
    const size_t r = row0 + J * kTS;
    load_tile(BS + buf * kTS * ldb, ldb, a.B + r * ds, ds, kTS, ds,
              Q - J * kTS);
    load_tile(XS + buf * kTS * ldx, ldx, a.x + (r * h + hi) * dh + d0,
              static_cast<size_t>(h) * dh, kTS, DHS, Q - J * kTS);
    cp_async_commit();
  };
  load(0, 0);
  chunk_cum(a, row0, hi, dts, cum);
  const float cl = cum[Q - 1];
  for (int e = threadIdx.x; e < Qp; e += kThreads)
    wj[e] = expf(cl - cum[e]) * dts[e];   // 0 past Q (dt 0 there)
  const size_t bh = static_cast<size_t>(bi) * h + hi;
  if (d0 == 0 && threadIdx.x == 0) a.L[bh * a.nc + c] = cl;

  // warp w: 8-column tile w % NT, 16-row tiles w / NT + (8 / NT) u.
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, nt = w % NT;
  float acc[NT][4] = {};
  for (int J = 0; J < ntj; ++J) {
    const int buf = J & 1;
    if (J + 1 < ntj) {
      load(J + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bs = BS + buf * kTS * ldb;
    const float* xs = XS + buf * kTS * ldx;
#pragma unroll
    for (int k0 = 0; k0 < kTS; k0 += 8) {
      FragB fb;                 // wj_j x_j
      load_b(fb, xs + k0 * ldx + nt * 8, ldx, 1, wj + J * kTS + k0);
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int mt = w / NT + (8 / NT) * u;
        if (mt * 16 >= ds) break;
        FragA fa;               // A(s, j) = B_j[s]
        load_a(fa, bs + k0 * ldb + mt * 16, 1, ldb);
        mma(acc[u], fa, fb);
      }
    }
    __syncthreads();            // this buffer is reloaded next iteration
  }
  float* out = a.S + (bh * a.nc + c) * ds * dh + d0 + nt * 8 + 2 * t;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int r = (w / NT + (8 / NT) * u) * 16 + g;
    if (r >= ds) break;
    *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * dh) =
        make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8) * dh) =
        make_float2(acc[u][2], acc[u][3]);
  }
}

// 3. The serial pass over chunks for one (b, h) and 4 state entries per
//    thread: slot c of S becomes the state chunk c finds.
__global__ void __launch_bounds__(kThreads) ssd_pass_kernel(Args a) {
  const int n4 = a.ds * a.dh / 4;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n4) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * a.h + blockIdx.y;
  float4* st = reinterpret_cast<float4*>(a.S + bh * a.nc * a.ds * a.dh) + e;
  const float* L = a.L + bh * a.nc;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  // 8 chunks' loads issued before their stores (a store may alias a later
  // load for all the compiler knows, which would serialize the loop).
  for (int c0 = 0; c0 < a.nc; c0 += 8) {
    float4 loc[8];
    float el[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < a.nc) {
        loc[k] = st[static_cast<size_t>(c0 + k) * n4];
        el[k] = expf(L[c0 + k]);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < a.nc) {
        st[static_cast<size_t>(c0 + k) * n4] = run;
        run = make_float4(run.x * el[k] + loc[k].x, run.y * el[k] + loc[k].y,
                          run.z * el[k] + loc[k].z, run.w * el[k] + loc[k].w);
      }
  }
}

// 4. y of one 64-row tile I of one (b, h, chunk, dh slab):
//    exp(cum_i) (C_i . S_in) + sum_{J <= I} W_IJ . x_J with
//    W_ij = G_ij exp(cum_i - cum_j) dt_j for j <= i, else 0.
//    Below the diagonal tile the decay factors through the tile's first
//    row i0: exp(cum_i - cum_j) = a_i b_j, a_i = exp(cum_i - cum_i0) and
//    b_j = exp(cum_i0 - cum_j), both <= 1 (cum falls along the chunk), so
//    neither overflows, and one that underflows leaves a product below
//    it.  So the tiles J < I take G as it is, with b_j dt_j folded into
//    the x fragments and a_i into the accumulator once, as exp(cum_i) =
//    a_i exp(cum_i0) is for the state term.  Only the diagonal tile forms
//    W element by element, its upper half selected 0 before any exp.
template <int DHS>
__global__ void __launch_bounds__(kThreads) ssd_out_kernel(Args a) {
  constexpr int U = DHS / 16;   // 8-column tiles per warp
  extern __shared__ float4 smem4[];
  const int ds = a.ds, ldc = ds + 4, lds = DHS + 8, ldw = kT + 4;
  const int ldx = DHS + 8, Q = a.Q, Qp = a.nqt * kT, slabs = a.dh / DHS;
  const int h = a.h, dh = a.dh;
  float* tiles = reinterpret_cast<float*>(smem4);
  // phase 1: CS [kT][ldc], SS [ds][lds]; phase 2: WS [2][kT][ldw],
  // XS [2][kT][ldx], in the same space.
  const int tile_floats = max(kT * ldc + ds * lds, 2 * kT * (ldw + ldx));
  float* dts = tiles + tile_floats;             // [Qp]
  float* cum = dts + Qp;                        // [Qp]
  float* bj = cum + Qp;                         // [Qp] b_j dt_j, j < i0
  const int d0 = (blockIdx.x % slabs) * DHS;
  const int I = (blockIdx.x / slabs) % a.nqt;
  const int c = blockIdx.x / (slabs * a.nqt);
  const int hi = blockIdx.y, bi = blockIdx.z, i0 = I * kT;
  const size_t row0 = static_cast<size_t>(bi) * a.s +
                      static_cast<size_t>(c) * Q;
  const size_t bh = static_cast<size_t>(bi) * h + hi;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mt = w & 3;

  float* CS = tiles;
  float* SS = tiles + kT * ldc;
  if (c > 0) {
    load_tile(CS, ldc, a.C + (row0 + i0) * ds, ds, kT, ds, Q - i0);
    load_tile(SS, lds, a.S + (bh * a.nc + c) * ds * dh + d0, dh, ds, DHS,
              ds);
    cp_async_commit();
  }
  chunk_cum(a, row0, hi, dts, cum);
  const float ci0 = cum[i0];
  for (int e = threadIdx.x; e < i0; e += kThreads)
    bj[e] = expf(ci0 - cum[e]) * dts[e];

  // warp w: rows 16 (w % 4), columns 8 (w / 4 + 2 u), u < U.
  float acc[U][4] = {};
  if (c > 0) {                  // the first chunk finds no state
    cp_async_wait<0>();
    __syncthreads();
    for (int k0 = 0; k0 < ds; k0 += 8) {
      FragA fa;
      load_a(fa, CS + mt * 16 * ldc + k0, ldc, 1);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        FragB fb;
        load_b(fb, SS + k0 * lds + ((w >> 2) + 2 * u) * 8, lds, 1);
        mma(acc[u], fa, fb);
      }
    }
    const float e = expf(ci0);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][q] *= e;
  }
  __syncthreads();              // CS, SS read and bj written: phase 2

  float* WS = tiles;
  float* XS = tiles + 2 * kT * ldw;
  const float* Gt = a.G + ((static_cast<size_t>(bi) * a.nc + c) * Qp +
                           i0) * Qp;
  auto load = [&](int J, int buf) {
    load_tile(WS + buf * kT * ldw, ldw, Gt + J * kT, Qp, kT, kT, kT);
    load_tile(XS + buf * kT * ldx, ldx,
              a.x + ((row0 + J * kT) * h + hi) * dh + d0,
              static_cast<size_t>(h) * dh, kT, DHS, Q - J * kT);
    cp_async_commit();
  };
  load(0, 0);
  for (int J = 0; J <= I; ++J) {
    const int buf = J & 1;
    if (J < I) {
      load(J + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* ws = WS + buf * kT * ldw;
    const float* xs = XS + buf * kT * ldx;
    const float* sc = bj + J * kT;
    int kmax = kT;
    if (J == I) {               // the diagonal tile
      for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
        const int r = e / kT, cc = e % kT;
        float* p = ws + r * ldw + cc;
        // j > i: selected 0 before any exp (it may be inf there).
        *p = cc <= r ? *p * expf(cum[i0 + r] - cum[i0 + cc]) *
                           dts[i0 + cc]
                     : 0.f;
      }
      const float a0 = expf(cum[i0 + mt * 16 + g] - ci0);
      const float a1 = expf(cum[i0 + mt * 16 + g + 8] - ci0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[u][0] *= a0;
        acc[u][1] *= a0;
        acc[u][2] *= a1;
        acc[u][3] *= a1;
      }
      sc = nullptr;
      kmax = mt * 16 + 16;      // W is 0 past column 16 mt + 15
      __syncthreads();
    }
    for (int k0 = 0; k0 < kmax; k0 += 8) {
      FragA fa;
      load_a(fa, ws + mt * 16 * ldw + k0, ldw, 1);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        FragB fb;
        load_b(fb, xs + k0 * ldx + ((w >> 2) + 2 * u) * 8, ldx, 1,
               sc ? sc + k0 : nullptr);
        mma(acc[u], fa, fb);
      }
    }
    __syncthreads();            // this buffer is reloaded next iteration
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + mt * 16 + g + 8 * half;
    if (i >= Q) continue;
    float* yo = a.y + ((row0 + i) * h + hi) * dh + d0 + 2 * t;
#pragma unroll
    for (int u = 0; u < U; ++u)
      *reinterpret_cast<float2*>(yo + ((w >> 2) + 2 * u) * 8) =
          make_float2(acc[u][2 * half], acc[u][2 * half + 1]);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int DHS>
int launch(const Args& a, int b, cudaStream_t st) {
  const int Qp = a.nqt * kT, slabs = a.dh / DHS, ds = a.ds;
  const size_t f = sizeof(float);
  const size_t cb = 2 * kT * (ds + 4) * f;
  const size_t state =
      (2 * kTS * (ds + 8) + 2 * kTS * (DHS + 8) + 3 * Qp) * f;
  const int tile_floats = std::max(kT * (ds + 4) + ds * (DHS + 8),
                                   2 * kT * (kT + 4 + DHS + 8));
  const size_t out = (tile_floats + 3 * Qp) * f;
  int err = set_smem(ssd_cb_kernel, cb);
  if (!err) err = set_smem(ssd_state_kernel<DHS>, state);
  if (!err) err = set_smem(ssd_out_kernel<DHS>, out);
  if (err) return err;
  ssd_cb_kernel<<<dim3(a.nqt * (a.nqt + 1) / 2, a.nc, b), kThreads, cb,
                  st>>>(a);
  ssd_state_kernel<DHS><<<dim3(a.nc * slabs, a.h, b), kThreads, state,
                          st>>>(a);
  const int n4 = ds * a.dh / 4;
  ssd_pass_kernel<<<dim3((n4 + kThreads - 1) / kThreads, a.h, b), kThreads,
                    0, st>>>(a);
  ssd_out_kernel<DHS><<<dim3(a.nc * a.nqt * slabs, a.h, b), kThreads, out,
                        st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the four kernels on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes the kernels do not take: the wrapper
// checks them first).  x, y: (b, s, h, dh); dt: (b, s, h); A: (h,);
// B, C: (b, s, ds); all fp32, contiguous.  s % chunk == 0, chunk <= 1024,
// ds % 16 == 0 and ds <= 128, dh % dhs == 0 with dhs (the dh slab of a
// CTA) 16, 32 or 64.  Scratch, fp32: G (b, nc, Qp, Qp), S (b, h, nc, ds,
// dh), L (b, h, nc), with nc = s / chunk and Qp = chunk rounded up to 64.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* y, void* G, void* S, void* L, int b,
             int s, int h, int dh, int ds, int chunk, int dhs,
             void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || s % chunk || ds <= 0 ||
      ds % 16 || ds > kMaxDs || dh <= 0 || h > 65535 || b > 65535 ||
      s / chunk > 65535 || (dhs != 16 && dhs != 32 && dhs != 64) ||
      dh % dhs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = s / chunk, nqt = (chunk + kT - 1) / kT;
  Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A),  static_cast<const float*>(B),
         static_cast<const float*>(C),  static_cast<float*>(y),
         static_cast<float*>(G),        static_cast<float*>(S),
         static_cast<float*>(L),        s, h, dh, ds, chunk, nc, nqt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dhs) {
    case 64: return launch<64>(a, b, st);
    case 32: return launch<32>(a, b, st);
    default: return launch<16>(a, b, st);
  }
}

}  // extern "C"
