// Dense-cache decode attention for Hopper (sm_90a): flash_attention_decode.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention_decode (pallas_call at :322, body _flash_decode_kernel
// at :197).  Same function: one query per sequence, q (b, hq, 1, d),
// attends its slot cache k/v (b, hkv, S, d) in q's dtype, with the GQA
// group folded into `group` query rows per kv head; key j of sequence i
// is valid iff j <= pos[i] (ring: or pos[i] >= window, the rolled
// sliding-window cache, S == window; band: and j > pos[i] - window); the
// masked score NEG_INF = -1e30, q scaled in fp32 before the dot, 0 for a
// row with no valid key, and the output in q's dtype.
//
// What bounds it on an H100: bytes.  A decode step reads every live key
// and value once (2 * d bytes each in bf16) and does ~4 * group flops per
// byte, far below the ~295 flop/byte at which the tensor cores would
// become the limit.  The least time is the live K/V bytes over HBM
// bandwidth (3.35 TB/s on the SXM part).
//
// Design.  The Pallas grid carries (m, l, acc) across its sequential kv
// blocks; CUDA blocks run in no order, so one CTA owns one (sequence, kv
// head) and loops over its own slot cache in tiles of 64 keys, keeping
// (m, l, acc) in shared memory.  Tiles wholly in the future or outside
// the band are not read (in a ring every tile is live once pos >= window).
// A tile is staged into shared memory as fp32 with 16-byte vector loads,
// several issued per thread before any is used; scores take one thread
// per (row, key) pair over a padded K tile (no bank conflicts), the
// online-softmax update one warp per row, and P.V one thread per output
// column.  Not done yet (later work): split-KV across CTAs with a
// log-sum-exp combine (b * hkv CTAs leave SMs idle at small batch),
// cp.async/TMA double buffering, wgmma, and reading an int8 cache with its
// scales directly (the caller dequantizes the whole cache first today).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kTileKeys = 64;
constexpr int kLoadUnroll = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool key_valid(int kpos, int pos, int window,
                                          bool ring) {
  if (ring) return kpos <= pos || pos >= window;
  bool ok = kpos <= pos;
  if (window > 0) ok = ok && kpos > pos - window;
  return ok;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_arr,
                    T* __restrict__ out, int hq, int hkv, int S, int d,
                    int window, int ring, float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int bi = blockIdx.y;
  const int group = hq / hkv;
  const int rows = group;

  float* q_s = smem;                      // rows * d
  float* acc_s = q_s + rows * d;          // rows * d
  float* k_s = acc_s + rows * d;          // kTileKeys * (d + 1), padded rows
  float* v_s = k_s + kTileKeys * (d + 1);  // kTileKeys * d
  float* p_s = v_s + kTileKeys * d;       // rows * kTileKeys
  float* m_s = p_s + rows * kTileKeys;    // rows
  float* l_s = m_s + rows;                // rows
  float* a_s = l_s + rows;                // rows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = kThreads >> 5;
  const int pos = pos_arr[bi];
  const bool is_ring = ring != 0;

  // the group's query rows: row g is head kh * group + g.
  for (int i = tid; i < rows * d; i += kThreads) {
    const int g = i / d, e = i - (i / d) * d;
    q_s[i] = to_f(q[(static_cast<size_t>(bi) * hq + kh * group + g) * d + e]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const size_t slab = (static_cast<size_t>(bi) * hkv + kh) * S * d;
  const uint4* k4 = reinterpret_cast<const uint4*>(k + slab);
  const uint4* v4 = reinterpret_cast<const uint4*>(v + slab);

  for (int t0 = 0; t0 < S; t0 += kTileKeys) {
    const int n = min(kTileKeys, S - t0);
    // tiles with no valid key are not read (uniform across the block).
    bool active;
    if (is_ring) {
      active = t0 <= pos || pos >= window;
    } else {
      active = t0 <= pos;
      if (window > 0) active = active && (t0 + n - 1 > pos - window);
    }
    if (!active) continue;
    __syncthreads();  // the previous tile's P.V is done with k_s, v_s, p_s

    {
      const int nvec = n * d / V;
      const int base = t0 * d / V;
      for (int v0 = tid; v0 < nvec; v0 += kThreads * kLoadUnroll) {
        uint4 kr[kLoadUnroll], vr[kLoadUnroll];
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int w = v0 + u * kThreads;
          if (w < nvec) {
            kr[u] = k4[base + w];
            vr[u] = v4[base + w];
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int w = v0 + u * kThreads;
          if (w >= nvec) continue;
          const T* ke = reinterpret_cast<const T*>(&kr[u]);
          const T* ve = reinterpret_cast<const T*>(&vr[u]);
          const int key = w * V / d, col = w * V - key * d;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            k_s[key * (d + 1) + col + i] = to_f(ke[i]);
            v_s[w * V + i] = to_f(ve[i]);
          }
        }
      }
    }
    __syncthreads();

    // scores: one thread per (row, key) pair.
    for (int pr = tid; pr < rows * n; pr += kThreads) {
      const int rr = pr / n, c = pr - rr * n;
      const float* qrow = q_s + rr * d;
      const float* krow = k_s + c * (d + 1);
      float acc4[4] = {0.f, 0.f, 0.f, 0.f};
      int e = 0;
      for (; e + 4 <= d; e += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc4[u] += qrow[e + u] * krow[e + u];
      }
      for (; e < d; ++e) acc4[0] += qrow[e] * krow[e];
      const float dot = (acc4[0] + acc4[1]) + (acc4[2] + acc4[3]);
      p_s[rr * kTileKeys + c] =
          key_valid(t0 + c, pos, window, is_ring) ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row.
    for (int rr = warp; rr < rows; rr += nwarp) {
      float* prow = p_s + rr * kTileKeys;
      float mx = kNegInf;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, prow[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < n; c += 32) {
        const float pv = key_valid(t0 + c, pos, window, is_ring)
                             ? expf(prow[c] - m_new) : 0.f;
        prow[c] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[rr] = alpha;
        l_s[rr] = l_s[rr] * alpha + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, one thread per (row, column).
    for (int i = tid; i < rows * d; i += kThreads) {
      const int rr = i / d, e = i - (i / d) * d;
      const float* prow = p_s + rr * kTileKeys;
      float a2[2] = {0.f, 0.f};
      for (int c = 0; c < n; ++c) a2[c & 1] += prow[c] * v_s[c * d + e];
      acc_s[i] = acc_s[i] * a_s[rr] + (a2[0] + a2[1]);
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * d; i += kThreads) {
    const int g = i / d, e = i - (i / d) * d;
    float l = l_s[g];
    if (l == 0.f) l = 1.f;  // a row with no valid key outputs 0
    store_f(acc_s[i] / l, &out[(static_cast<size_t>(bi) * hq + kh * group + g) * d + e]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, int b, int hq, int hkv, int S, int d, int window,
           int ring, float scale, cudaStream_t stream) {
  const int rows = hq / hkv;
  const size_t smem = sizeof(float) * (2 * rows * d + kTileKeys * (2 * d + 1) +
                                       rows * kTileKeys + 3 * rows);
  auto kern = flash_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), hq, hkv, S, d,
      window, ring, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// bf16: q, k, v and out are bf16 (else fp32).  window <= 0 means no
// window; ring != 0 needs window > 0 and S == window.
int flash_decode(const void* q, const void* k, const void* v, const int* pos,
                 void* out, int b, int hq, int hkv, int S, int d, int window,
                 int ring, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, pos, out, b, hq, hkv, S, d, window,
                                 ring, scale, s);
  return launch<float>(q, k, v, pos, out, b, hq, hkv, S, d, window, ring,
                       scale, s);
}

}  // extern "C"
