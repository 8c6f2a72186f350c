// Paged decode attention for Hopper (sm_90a): flash_attention_decode_paged.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention_decode_paged (pallas_call at :523, body
// _flash_decode_paged_kernel at :347).  Same function: q (b, hq, sq, d)
// attends the K/V pages a per-sequence block table names in shared pools
// (n_pages, hkv, page, d), with the GQA group folded into sq*group query
// rows (position-major: row rr sits at pos + rr / group), optional
// sliding window, optional ring page_base (negative = never written),
// optional int8 pages times bf16 per-position scales, the masked score
// NEG_INF = -1e30, q scaled in fp32 before the dot, 0 for a row with no
// valid key, and the output in q's dtype.
//
// What bounds it on an H100: bytes.  A decode step reads every live K/V
// page once (2 * page * d bytes per page and kv head in bf16) and does
// ~4 * rows flops per byte, far below the ~295 flop/byte at which the
// tensor cores would become the limit.  The least time is the live K/V
// bytes over HBM bandwidth (3.35 TB/s on the SXM part).
//
// Design.  The Pallas grid runs in order and carries (m, l, acc) across
// its kv steps; CUDA blocks run in no order, so here one CTA owns one
// (sequence, kv head) and loops over its own block-table row, keeping
// (m, l, acc) in shared memory.  Per iteration it stages a tile of up to
// 64 keys (several pages, only the live ones are read) from device
// memory into shared memory as fp32, scores them with one thread per
// (row, key) pair, runs the online-softmax update with one warp per
// row, and accumulates P.V with one thread per output column.  Pages in
// the future, outside the window or never written are not read at all.
// Loads are 16-byte vectors, coalesced along d, several issued per thread
// before any is used, so a tile costs about one memory latency.  Not done yet (later work): split-KV across
// CTAs with a log-sum-exp combine (with b * hkv CTAs a small batch fills
// only part of the 132 SMs), cp.async/TMA double buffering, wgmma.

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
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool key_valid(int kpos, int qpos, bool has_base,
                                          int window) {
  bool ok = kpos <= qpos;
  if (has_base) ok = ok && kpos >= 0;
  if (window > 0) ok = ok && kpos > qpos - window;
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

template <typename QT, typename PT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                          const PT* __restrict__ vp,
                          const __nv_bfloat16* __restrict__ ks,
                          const __nv_bfloat16* __restrict__ vs,
                          const int* __restrict__ block_tab,
                          const int* __restrict__ pos_arr,
                          const int* __restrict__ page_base,
                          QT* __restrict__ out, int hq, int hkv, int sq, int d,
                          int n_pages, int page, int n_blocks, int tile_pages,
                          int window, float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int bi = blockIdx.y;
  const int group = hq / hkv;
  const int rows = sq * group;
  const int tile = tile_pages * page;  // keys per tile
  const bool has_base = page_base != nullptr;

  float* q_s = smem;                   // rows * d
  float* acc_s = q_s + rows * d;       // rows * d
  float* k_s = acc_s + rows * d;       // tile * (d + 1), padded rows
  float* v_s = k_s + tile * (d + 1);   // tile * d
  float* p_s = v_s + tile * d;         // rows * tile
  float* m_s = p_s + rows * tile;      // rows
  float* l_s = m_s + rows;             // rows
  float* a_s = l_s + rows;             // rows
  int* kstart_s = reinterpret_cast<int*>(a_s + rows);  // tile_pages
  int* phys_s = kstart_s + tile_pages;                 // tile_pages (-1 = skip)
  __shared__ int any_active;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = kThreads >> 5;
  const int pos = pos_arr[bi];

  // q rows, position-major: row rr = t * group + g is head kh * group + g
  // at query position t.
  for (int i = tid; i < rows * d; i += kThreads) {
    const int rr = i / d, e = i - (i / d) * d;
    const int t = rr / group, g = rr - t * group;
    const size_t qi = ((static_cast<size_t>(bi) * hq + kh * group + g) * sq + t) * d + e;
    q_s[i] = to_f(q[qi]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int j0 = 0; j0 < n_blocks; j0 += tile_pages) {
    __syncthreads();
    if (tid == 0) any_active = 0;
    __syncthreads();
    if (tid < tile_pages) {
      const int j = j0 + tid;
      int phys = -1;
      int k_start = 0;
      if (j < n_blocks) {
        k_start = has_base ? page_base[bi * n_blocks + j] : j * page;
        bool active = k_start <= pos + (sq - 1);            // future pages
        if (has_base) active = active && k_start >= 0;      // never written
        if (window > 0) active = active && (k_start + page - 1 > pos - window);
        if (active) {
          // table entries past the pool (unallocated) clamp to a real page.
          phys = min(max(block_tab[bi * n_blocks + j], 0), n_pages - 1);
          atomicExch(&any_active, 1);
        }
      }
      kstart_s[tid] = k_start;
      phys_s[tid] = phys;
    }
    __syncthreads();
    if (!any_active) continue;  // uniform across the block

    // stage the tile's live pages (dead slots are zero-filled, masked):
    // 16-byte vector loads, kLoadUnroll of them issued before any is
    // used, so each thread keeps several loads in flight.
    {
      constexpr int V = 16 / sizeof(PT);            // elements per vector
      const int vec_per_page = page * d / V;
      const int nvec = tile_pages * vec_per_page;
      const uint4* k4 = reinterpret_cast<const uint4*>(kp);
      const uint4* v4 = reinterpret_cast<const uint4*>(vp);
      for (int v0 = tid; v0 < nvec; v0 += kThreads * kLoadUnroll) {
        uint4 kr[kLoadUnroll], vr[kLoadUnroll];
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int v = v0 + u * kThreads;
          kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
          if (v < nvec) {
            const int tp = v / vec_per_page;
            const int phys = phys_s[tp];
            if (phys >= 0) {
              const size_t slab =
                  (static_cast<size_t>(phys) * hkv + kh) * vec_per_page;
              kr[u] = k4[slab + (v - tp * vec_per_page)];
              vr[u] = v4[slab + (v - tp * vec_per_page)];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int v = v0 + u * kThreads;
          if (v >= nvec) continue;
          float ksc = 1.f, vsc = 1.f;
          if (QUANT) {
            const int tp = v / vec_per_page;
            const int phys = phys_s[tp];
            if (phys >= 0) {
              const int row = (v - tp * vec_per_page) * V / d;
              const size_t srow = (static_cast<size_t>(phys) * hkv + kh) * page + row;
              ksc = __bfloat162float(ks[srow]);
              vsc = __bfloat162float(vs[srow]);
            }
          }
          const PT* ke = reinterpret_cast<const PT*>(&kr[u]);
          const PT* ve = reinterpret_cast<const PT*>(&vr[u]);
          const int key = v * V / d, col = v * V - key * d;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            k_s[key * (d + 1) + col + i] = to_f(ke[i]) * ksc;
            v_s[v * V + i] = to_f(ve[i]) * vsc;
          }
        }
      }
    }
    __syncthreads();

    // scores: one thread per (row, key) pair over the padded K tile
    // (conflict-free: neighbouring keys sit in neighbouring banks).
    for (int pr = tid; pr < rows * tile; pr += kThreads) {
      const int rr = pr / tile, c = pr - rr * tile;
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
      const int tp = c / page;
      const int kpos = kstart_s[tp] + (c - tp * page);
      const bool ok = phys_s[tp] >= 0 &&
                      key_valid(kpos, pos + rr / group, has_base, window);
      p_s[pr] = ok ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row.
    for (int rr = warp; rr < rows; rr += nwarp) {
      float mx = kNegInf;
      for (int c = lane; c < tile; c += 32) mx = fmaxf(mx, p_s[rr * tile + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < tile; c += 32) {
        const int tp = c / page;
        const int kpos = kstart_s[tp] + (c - tp * page);
        const bool ok = phys_s[tp] >= 0 &&
                        key_valid(kpos, pos + rr / group, has_base, window);
        const float pv = ok ? expf(p_s[rr * tile + c] - m_new) : 0.f;
        p_s[rr * tile + c] = pv;
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
      const float* prow = p_s + rr * tile;
      float a2[2] = {0.f, 0.f};
      for (int c = 0; c < tile; ++c) a2[c & 1] += prow[c] * v_s[c * d + e];
      acc_s[i] = acc_s[i] * a_s[rr] + (a2[0] + a2[1]);
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * d; i += kThreads) {
    const int rr = i / d, e = i - (i / d) * d;
    const int t = rr / group, g = rr - t * group;
    float l = l_s[rr];
    if (l == 0.f) l = 1.f;  // a row with no valid key outputs 0
    const size_t oi = ((static_cast<size_t>(bi) * hq + kh * group + g) * sq + t) * d + e;
    store_f(acc_s[i] / l, &out[oi]);
  }
}

template <typename QT, typename PT, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* bt, const int* pos, const int* page_base,
           void* out, int b, int hq, int hkv, int sq, int d, int n_pages,
           int page, int n_blocks, int window, float scale,
           cudaStream_t stream) {
  const int rows = sq * (hq / hkv);
  const int tile_pages = page >= kTileKeys ? 1 : kTileKeys / page;
  const int tile = tile_pages * page;
  const size_t smem = sizeof(float) * (2 * rows * d + tile * (2 * d + 1) +
                                       rows * tile + 3 * rows) +
                      sizeof(int) * 2 * tile_pages;
  auto kern = flash_decode_paged_kernel<QT, PT, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), bt, pos, page_base,
      static_cast<QT*>(out), hq, hkv, sq, d, n_pages, page, n_blocks,
      tile_pages, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// q_bf16: q/out are bf16 (else fp32).  quantized: pools are int8 with bf16
// scale pages (else bf16 pools, scales unused).  page_base may be null.
// window <= 0 means no window.
int flash_decode_paged(const void* q, const void* k_pages, const void* v_pages,
                       const void* k_scale, const void* v_scale,
                       const int* block_tab, const int* pos,
                       const int* page_base, void* out, int b, int hq, int hkv,
                       int sq, int d, int n_pages, int page, int n_blocks,
                       int window, float scale, int q_bf16, int quantized,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k_pages, v_pages, k_scale, v_scale, block_tab, pos, page_base, \
             out, b, hq, hkv, sq, d, n_pages, page, n_blocks, window, scale, s
  if (q_bf16) {
    if (quantized) return launch<__nv_bfloat16, int8_t, true>(ARGS);
    return launch<__nv_bfloat16, __nv_bfloat16, false>(ARGS);
  }
  if (quantized) return launch<float, int8_t, true>(ARGS);
  return launch<float, __nv_bfloat16, false>(ARGS);
#undef ARGS
}

}  // extern "C"
