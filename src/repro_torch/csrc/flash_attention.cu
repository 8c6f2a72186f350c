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
// blocks run in no order, so one CTA of 256 threads owns one (batch, q
// head, 64-row q tile) and loops over 64-key tiles itself, skipping tiles
// wholly in the future (causal) or wholly before the window.  The q tile
// is staged once in shared memory, scaled, in fp32; each key tile's K and
// V are staged in q's dtype with 16-byte loads (K rows padded so the
// score loop reads without bank conflicts).  The 256 threads form a 16 x
// 16 grid: thread (ty, tx) owns query rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns tx + 16 c (c < d / 16), so
// a row's 64 scores lie in the 16 lanes of one half-warp and its max and
// sum are taken with shuffles; (m, l, acc) stay in registers.  P goes
// through shared memory once per tile for the P.V product.  Shared memory
// is 82 KB per CTA at d = 128 in bf16 (two CTAs per SM) and 210 KB at
// d = 256 in fp32, the most the kernel is built for.  The products run on
// the CUDA cores in fp32.  Not done yet (later work): tensor cores (mma /
// wgmma on bf16 tiles), TMA or cp.async double buffering of the K/V
// tiles, and splitting long key ranges across CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;   // 16 x 16
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kPST = kBK + 1;   // P row stride (floats)
constexpr size_t kMaxSmem = 232448;  // what one CTA may use on an H100

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// four consecutive K elements from shared memory (8- or 16-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int sk, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D>::total;
  static_assert(smem <= kMaxSmem, "tiles exceed a CTA's shared memory");
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, sk, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
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
