// Forward tiled online-softmax attention for Hopper (sm_90a):
// flash_attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (pallas_call at :153, body _flash_kernel at :49).  Same
// function: q (b, hq, sq, d) attends k, v (b, hkv, sk, d), all fp32 or all
// bf16, with query head h reading kv head h / (hq / hkv) (GQA); queries
// align to the end of the keys (row i sits at position i + sk - sq); key j
// is valid for row i iff j < sk, and (causal) j <= position, and (window >
// 0) j > position - window.  q is scaled in fp32 before the dot, scores
// and the running max, sum and accumulator are fp32, masked scores are
// NEG_INF = -1e30 and their probabilities exactly 0, a row with no valid
// key writes 0 (the l == 0 guard), and the output is in q's dtype.
//
// What bounds it on an H100: at the shapes of a prefill, operations.
// 4 * d flops per (query, live key) pair on the tensor cores (989 TFLOP/s
// in bf16) against q, k, v read once and out written once (3.35 TB/s): a
// 512-token causal prefill of minitron-4b's heads is near the balance
// (0.013 ms of operations, 0.020 ms of bytes), 8192 tokens are far above
// it (0.417 ms of operations).
//
// Design.  The Pallas grid (b * hq, q blocks, kv blocks) runs its kv
// dimension in order and carries (m, l, acc) in VMEM across it; CUDA
// blocks run in no order, so one CTA owns one (batch, q head, q tile) and
// loops over key tiles itself, skipping tiles wholly in the future
// (causal) or wholly before the window.
//
// bf16 (flash_fwd_tc_kernel): the products run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  A q tile of 128 rows (8
// warps; 64 rows and 4 warps at d > 128) is copied once, unscaled, in
// bf16; each warp owns 16 query rows.  K and V tiles (64 keys; 32 at d >
// 128) ride a two-stage ring in shared memory filled by cp.async 16-byte
// copies: after the one barrier a tile, the next tile's copy is issued and
// stays in flight while the current one is computed.  Rows are padded by
// 16 bytes, so the ldmatrix operand loads (V through ldmatrix.trans) are
// free of bank conflicts.  A warp scores a tile in steps of 64 keys (32
// at d >= 128, which keeps the d = 128 kernel within 128 registers, two
// CTAs per SM, with no spills).  S = Q.K^T comes out in fp32 fragments;
// `scale` multiplies the fp32 scores (never q in bf16).  The online
// softmax runs on those fragments in registers: a row's max and sum over
// its quad by shuffles, expf without fast-math, the mask only on steps
// that straddle the causal diagonal, the window's edge or the end of the
// keys (a warp skips steps wholly masked for its rows), and O rescaled
// only when a row's max moved.  P.V keeps P to fp32 accuracy: P = p_hi +
// p_lo, both bf16, and the kernel accumulates p_hi.V + p_lo.V in fp32
// with P taken straight from the score fragments (the C -> A fragment
// reuse of mma.sync), so P is kept to about 2^-16 relative, as the
// reference's fp32 P (a single bf16 P misses the 2-ulp rule by ~100x).
// Shared memory is 104 KB per CTA at d = 128 (two CTAs per SM) and 99 KB
// at d = 256.  The CTAs are numbered so that the q tile varies slowest
// and its index is reversed: the heaviest (last) q tiles of a causal mask
// launch first and do not straggle.
//
// fp32 (flash_fwd_kernel): the CUDA-core kernel of the first port, kept
// as it was, with no TF32.  The 256 threads form a 16 x 16 grid: thread
// (ty, tx) owns query rows ty + 16 i (i < 4), score columns tx + 16 j (j
// < 4) and output columns tx + 16 c (c < d / 16); q is staged scaled in
// fp32, K padded, P through shared memory once per tile.  210 KB of
// shared memory at d = 256.
//
// Not done yet (later work): wgmma and TMA (a warpgroup-wide product with
// operands read by descriptor, tiles copied by the TMA unit on an
// mbarrier), warp-specialised producer/consumer warps, one CTA for the
// `group` q heads of a kv head, and splitting long key ranges across
// CTAs when b * hq * q-tiles is below the SM count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;   // 16 x 16
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kPST = kBK + 1;   // P row stride (floats)
constexpr size_t kMaxSmem = 232448;  // what one CTA may use on an H100

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }

// four consecutive elements from shared memory (16-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// max / sum over the 16 lanes of a half-warp (one query row)
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
struct Smem {
  static constexpr int QST = D + 4;   // fp32 q row stride (16-byte rows)
  static constexpr int KST = D + 4;   // K row stride, in T
  static constexpr size_t q_bytes = sizeof(float) * kBQ * QST;
  static constexpr size_t k_bytes = sizeof(T) * kBK * KST;
  static constexpr size_t v_bytes = sizeof(T) * kBK * D;
  static constexpr size_t p_bytes = sizeof(float) * kBQ * kPST;
  static constexpr size_t total = q_bytes + k_bytes + v_bytes + p_bytes;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int hq,
                 int hkv, int sq, int sk, int causal, int window,
                 float scale) {
  using S = Smem<T, D>;
  constexpr int NC = D / 16;          // output columns per thread
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  T* k_s = reinterpret_cast<T*>(reinterpret_cast<char*>(q_s) + S::q_bytes);
  T* v_s = reinterpret_cast<T*>(reinterpret_cast<char*>(k_s) + S::k_bytes);
  float* p_s = reinterpret_cast<float*>(reinterpret_cast<char*>(v_s) + S::v_bytes);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q_first = q0 + (sk - sq);          // absolute position of row 0
  const int q_last = q_first + min(kBQ, sq - q0) - 1;

  const T* qb = q + (static_cast<size_t>(bi) * hq + h) * sq * D;
  const T* kb = k + (static_cast<size_t>(bi) * hkv + kh) * sk * D;
  const T* vb = v + (static_cast<size_t>(bi) * hkv + kh) * sk * D;
  T* ob = out + (static_cast<size_t>(bi) * hq + h) * sq * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, e = i % D;
    q_s[r * S::QST + e] =
        q0 + r < sq ? to_f(qb[static_cast<size_t>(q0 + r) * D + e]) * scale
                    : 0.f;
  }

  float m_r[4], l_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that can hold a valid key for some row of this q tile
  const int n_tiles = (sk + kBK - 1) / kBK;
  int kt_end = n_tiles;
  if (causal) kt_end = q_last < 0 ? 0 : min(n_tiles, q_last / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;       // the window's first key
    if (lo > 0) kt_begin = lo / kBK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    const int n = min(kBK, sk - k0);
    __syncthreads();  // the previous tile's P.V is done with k_s, v_s, p_s

    // stage K and V (rows past the end are zero), 16-byte loads.
    for (int w = tid; w < kBK * D / VE; w += kThreads) {
      const int key = w / (D / VE), col = (w % (D / VE)) * VE;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (key < n) {
        const size_t off = static_cast<size_t>(k0 + key) * D + col;
        kr = *reinterpret_cast<const uint4*>(kb + off);
        vr = *reinterpret_cast<const uint4*>(vb + off);
      }
      uint2* kd = reinterpret_cast<uint2*>(k_s + key * S::KST + col);
      kd[0] = make_uint2(kr.x, kr.y);
      kd[1] = make_uint2(kr.z, kr.w);
      *reinterpret_cast<uint4*>(v_s + key * D + col) = vr;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = load4(q_s + (ty + 16 * i) * S::QST + e);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = load4(k_s + (tx + 16 * j) * S::KST + e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

    // mask, online softmax per row, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + ty + 16 * i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        valid[j] = ok;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_r[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPST + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + row_sum(sum);
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P.V
    for (int kk = 0; kk < n; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPST + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = to_f(v_s[kk * D + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float l = l_r[i] == 0.f ? 1.f : l_r[i];  // a row with no valid key -> 0
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_f(acc[i][c] / l, ob + static_cast<size_t>(row) * D + tx + 16 * c);
  }
}

// --- bf16 on the tensor cores ------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct Tc {
  static constexpr int kWarps = D <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;          // query rows per CTA
  static constexpr int BK = D <= 128 ? 64 : 32;   // keys per copied tile
  static constexpr int BC = D <= 64 ? 64 : 32;    // keys per score step
  static constexpr int ST = D + 8;                // padded row stride (bf16)
  static constexpr int NS = BC / 8;   // 16 x 8 score fragments per warp
  static constexpr int NO = D / 8;    // 16 x 8 output fragments per warp
  static constexpr size_t q_bytes = sizeof(bf16) * BQ * ST;
  static constexpr size_t tile_bytes = sizeof(bf16) * BK * ST;
  static constexpr size_t total = q_bytes + 4 * tile_bytes;  // 2 stages of K, V
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

// four 8 x 8 bf16 matrices from shared memory, one row address per lane.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) = hi + lo with hi, lo bf16 pairs: lo holds what hi rounded off.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One warp's 16 query rows (q_w) against BC keys (ks, vs) starting at key
// k0: scores, online softmax and O += P.V.  Thread (g, t4) of the warp
// holds rows g (r = 0) and g + 8 (r = 1) of each 16 x 8 fragment.  FULL:
// no key of the step is masked for any row of the warp.
template <int D, bool FULL>
__device__ __forceinline__ void tile_step(
    const bf16* q_w, const bf16* ks, const bf16* vs, int lane, int k0,
    int sk, int w_first, int causal, int window, float scale,
    float (&o)[Tc<D>::NO][4], float (&m_r)[2], float (&l_r)[2]) {
  constexpr int ST = Tc<D>::ST, BC = Tc<D>::BC;
  constexpr int NS = Tc<D>::NS, NO = Tc<D>::NO;
  const int g = lane >> 2, t4 = lane & 3;

  // the mask (only where a step straddles an edge: the causal diagonal,
  // the window's start or the end of the keys), before S is live.
  uint32_t valid = 0xffffffffu;   // bit 4 j + e
  if (!FULL) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qpos = w_first + g + 8 * (e >> 1);
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) valid &= ~(1u << (4 * j + e));
      }
  }

  // S = Q.K^T in fp32
  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, q_w + (lane & 15) * ST + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t bb[4];
      ldsm_x4(bb, ks + (16 * j + ((lane >> 4) << 3) + (lane & 7)) * ST +
                      16 * kk + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * j], a, bb[0], bb[1]);
      mma_bf16(s[2 * j + 1], a, bb[2], bb[3]);
    }
  }

  // scale the fp32 scores; masked ones are NEG_INF.
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = FULL || ((valid >> (4 * j + e)) & 1u) ? s[j][e] * scale
                                                       : kNegInf;

  // online softmax on the fragments: a row lives in one quad.
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r]);
    alpha[r] = expf(m_r[r] - m_new);
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(s[j][e] - m_r[e >> 1]);
      const float p = FULL || ((valid >> (4 * j + e)) & 1u) ? x : 0.f;
      s[j][e] = p;
      l_r[e >> 1] += p;
    }
  // once the row maxima settle, alpha is 1 and O needs no rescale.
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
  }

  // O += (p_hi + p_lo).V, the score fragments reused as A operands.
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      uint32_t bb[4];
      ldsm_x4_t(bb, vs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * ST +
                        16 * jj + (lane >> 4) * 8);
      mma_bf16(o[2 * jj], hi, bb[0], bb[1]);
      mma_bf16(o[2 * jj + 1], hi, bb[2], bb[3]);
      mma_bf16(o[2 * jj], lo, bb[0], bb[1]);
      mma_bf16(o[2 * jj + 1], lo, bb[2], bb[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::kThreads, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int b,
                    int hq, int hkv, int sq, int sk, int causal, int window,
                    float scale) {
  using C = Tc<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::ST, NT = C::kThreads;
  constexpr int NO = C::NO, BC = C::BC;
  constexpr int CH = D / 8;    // 16-byte chunks per row
  extern __shared__ uint4 smem_tc[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* kv_s = q_s + BQ * ST;  // stage st: K tile 2 st, V tile 2 st + 1

  // the q tile varies slowest, heaviest (last) first.
  const int n_qt = (sq + BQ - 1) / BQ;
  const int heads = b * hq;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / heads);
  const int bh = static_cast<int>(blockIdx.x % heads);
  const int bi = bh / hq, h = bh % hq;
  const int kh = h / (hq / hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * BQ;
  const int off = sk - sq;                 // row i sits at position i + off
  const int q_first = q0 + off;
  const int q_last = q_first + min(BQ, sq - q0) - 1;
  // this warp's 16 rows: the first one's position and the last real one's.
  const int w0 = q0 + 16 * warp;
  const bool w_live = w0 < sq;
  const int w_first = w0 + off;
  const int w_last = min(w0 + 15, sq - 1) + off;

  const bf16* qb = q + (static_cast<size_t>(bi) * hq + h) * sq * D;
  const bf16* kb = k + (static_cast<size_t>(bi) * hkv + kh) * sk * D;
  const bf16* vb = v + (static_cast<size_t>(bi) * hkv + kh) * sk * D;
  bf16* ob = out + (static_cast<size_t>(bi) * hq + h) * sq * D;

  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < sq;
    cp_async16(q_s + r * ST + c,
               qb + (ok ? static_cast<size_t>(q0 + r) * D + c : 0), ok);
  }

  // key tiles that can hold a valid key for some row of this q tile
  const int n_tiles = (sk + BK - 1) / BK;
  int kt_end = n_tiles;
  if (causal) kt_end = q_last < 0 ? 0 : min(n_tiles, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_first - window + 1;       // the window's first key
    if (lo > 0) kt_begin = lo / BK;
  }

  // K and V rows past the end are zeros (their probabilities are 0).
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * BK;
    bf16* ks = kv_s + 2 * st * BK * ST;
    bf16* vs = ks + BK * ST;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k0 + r < sk;
      const size_t src = ok ? static_cast<size_t>(k0 + r) * D + c : 0;
      cp_async16(ks + r * ST + c, kb + src, ok);
      cp_async16(vs + r * ST + c, vb + src, ok);
    }
  };
  if (kt_begin < kt_end) load_tile(kt_begin, 0);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};  // l per thread

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait<0>();   // this tile (and q) have landed
    // one barrier a tile: every warp is done with tile kt - 1, so its
    // stage takes the next tile's copy, in flight while kt is computed.
    __syncthreads();
    if (kt + 1 < kt_end) {
      load_tile(kt + 1, st ^ 1);
      cp_async_commit();
    }
    // the tile in steps of BC keys, each skipped if wholly masked for
    // this warp's rows, and masked only if it straddles an edge.
#pragma unroll
    for (int c = 0; c < BK / BC; ++c) {
      const int k0 = kt * BK + c * BC;
      const bool skip = !w_live || (causal && k0 > w_last) ||
                        (window > 0 && k0 + BC - 1 <= w_first - window);
      if (skip) continue;
      const bf16* q_w = q_s + 16 * warp * ST;
      const bf16* ks = kv_s + (2 * st * BK + c * BC) * ST;
      const bf16* vs = ks + BK * ST;
      const bool full = k0 + BC <= sk && (!causal || k0 + BC - 1 <= w_first) &&
                        (window <= 0 || k0 > w_last - window);
      if (full)
        tile_step<D, true>(q_w, ks, vs, lane, k0, sk, w_first, causal, window,
                           scale, o, m_r, l_r);
      else
        tile_step<D, false>(q_w, ks, vs, lane, k0, sk, w_first, causal,
                            window, scale, o, m_r, l_r);
    }
  }
  cp_async_wait<0>();

  if (!w_live) return;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = w0 + g + 8 * r;
    if (row >= sq) continue;
    if (l == 0.f) l = 1.f;  // a row with no valid key -> 0
    bf16* orow = ob + static_cast<size_t>(row) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] / l, o[n][2 * r + 1] / l);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b,
              int hq, int hkv, int sq, int sk, int causal, int window,
              float scale, cudaStream_t stream) {
  using C = Tc<D>;
  static_assert(C::total <= kMaxSmem, "tiles exceed a CTA's shared memory");
  auto kern = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((sq + C::BQ - 1) / C::BQ) * hq * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), C::kThreads, C::total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), b, hq, hkv, sq,
      sk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores, fp32 on the CUDA cores.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int sk, int causal, int window,
           float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_tc<D>(q, k, v, out, b, hq, hkv, sq, sk, causal, window,
                        scale, stream);
  } else {
    constexpr size_t smem = Smem<T, D>::total;
    static_assert(smem <= kMaxSmem, "tiles exceed a CTA's shared memory");
    auto kern = flash_fwd_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, sk,
        causal, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int sq, int sk, int d, int causal, int window,
             float scale, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 192: return launch<T, 192>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, b, hq, hkv, sq, sk, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dim the kernel is not built for (32,
// 64, 128, 192, 256).  bf16: q, k, v and out are bf16 (else fp32); all
// contiguous and 16-byte aligned.  window <= 0 means no window.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int hq, int hkv, int sq, int sk, int d, int causal,
                    int window, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, sk, d,
                                   causal, window, scale, s);
  return launch_d<float>(q, k, v, out, b, hq, hkv, sq, sk, d, causal, window,
                         scale, s);
}

}  // extern "C"
