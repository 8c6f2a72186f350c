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
// Design, as the paged kernel's (csrc/flash_decode_paged.cu).  The Pallas
// grid runs in order and carries (m, l, acc) across its kv blocks; CUDA
// blocks run in no order.  Here the grid is (n_split, hkv, b): the
// wrapper picks n_split on the host from the shapes and the SM count only
// (kernels/flash_attention.py :: dense_splits; never from pos, which
// would cost a device sync per decode step), so that a small batch still
// fills the card.  Each CTA reads pos itself, finds the 64-key tiles that
// can hold a live key (no window: [0, pos]; band: from the window's first
// key to pos; ring: the whole cache once pos >= window, else [0, pos];
// always clamped to S, since a finished slot may sit at pos >= S) and
// takes its even share of them.  Within that share it loops over its
// tiles keeping (m, l, acc) in shared memory: the next tile's K/V rows
// are copied by cp.async into a second stage while the current tile is
// scored, and are converted to fp32 as they are read.  One thread scores
// one (row, key) pair over 16-byte reads of a K row (rows padded by 16
// bytes, so the reads are free of bank conflicts), one warp per row runs
// the online-softmax update, and one thread per four output columns
// accumulates P.V: three barriers a tile.  Keys past S are zero-filled and
// masked.  With n_split > 1 each CTA writes its partial (m, l,
// unnormalised acc) in fp32 to a scratch the wrapper allocates, and a
// second kernel, enqueued by the same C call, combines them: o = sum_s
// e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s (an empty split has m =
// NEG_INF, l = 0 and weight 0; a row empty in every split writes 0).
// With n_split == 1 the CTA writes the output itself.  Where two stages of
// 64-key fp32 tiles would exceed a block's shared memory (fp32 at d =
// 256), the C call halves the tile.
//
// A cache split over the sequence on a mesh (each rank holds S slots of
// it) is one more split of the same split-KV scheme.  key_offset is the
// global position of the shard's first slot: each CTA compares its keys
// with pos - key_offset, so the mask stays global and a shard that lies
// wholly past pos visits no tile.  In partials mode (out_acc / out_ml
// given) nothing is normalised: the shard's own (acc, m, l) per query row
// are written in fp32, by the CTA itself at n_split == 1 or by the
// combine kernel, which then takes M = max m_s, l = sum e^(m_s - M) l_s and
// acc = sum e^(m_s - M) acc_s over the splits.  A row with no valid key in
// the shard gives m = NEG_INF, l = 0 and acc = 0.  The caller gathers every
// shard's partials and combines them in a fixed order
// (kernels/flash_attention.py :: combine_decode_partials).  Not done yet (later work): reading an
// int8 cache with its scales directly (the caller dequantizes the whole
// cache first today), TMA copies on an mbarrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kTileKeys = 64;
constexpr size_t kMaxSmem = 232448;  // a block's most on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}

// four consecutive cache elements from shared memory, as fp32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__host__ __device__ constexpr size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the shared-memory sections, each 16-byte aligned.
struct Layout {
  size_t q, acc, kraw, vraw, p, m, l, a, total;
  int kst, vst;  // K / V row strides in bytes
};

__host__ __device__ inline Layout layout(int rows, int d, int tile,
                                         int esize) {
  Layout L;
  L.kst = d * esize + 16;   // K rows padded: conflict-free row reads
  L.vst = d * esize;
  size_t o = 0;
  L.q = o;      o += up16(sizeof(float) * rows * d);
  L.acc = o;    o += up16(sizeof(float) * rows * d);
  L.kraw = o;   o += up16(static_cast<size_t>(2) * tile * L.kst);  // 2 stages
  L.vraw = o;   o += up16(static_cast<size_t>(2) * tile * L.vst);
  L.p = o;      o += up16(sizeof(float) * rows * tile);
  L.m = o;      o += up16(sizeof(float) * rows);
  L.l = o;      o += up16(sizeof(float) * rows);
  L.a = o;      o += up16(sizeof(float) * rows);
  L.total = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_arr,
                    T* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, float* __restrict__ out_acc,
                    float* __restrict__ out_ml, int hq, int hkv, int S, int d,
                    int tile, int window, int ring, int key_offset,
                    float scale) {
  extern __shared__ uint4 smem_u4[];
  char* base = reinterpret_cast<char*>(smem_u4);
  const int split = blockIdx.x, n_split = gridDim.x;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int rows = hq / hkv;  // the group
  const Layout L = layout(rows, d, tile, sizeof(T));
  float* q_s = reinterpret_cast<float*>(base + L.q);       // rows * d
  float* acc_s = reinterpret_cast<float*>(base + L.acc);   // rows * d
  char* kraw = base + L.kraw;                              // 2 x tile x kst
  char* vraw = base + L.vraw;                              // 2 x tile x vst
  float* p_s = reinterpret_cast<float*>(base + L.p);       // rows * tile
  float* m_s = reinterpret_cast<float*>(base + L.m);
  float* l_s = reinterpret_cast<float*>(base + L.l);
  float* a_s = reinterpret_cast<float*>(base + L.a);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = kThreads >> 5;
  // the position relative to this shard's first slot (key_offset 0 for a
  // whole cache; a ring is never split).
  const int pos = pos_arr[bi] - key_offset;
  const bool is_ring = ring != 0;

  // this split's even share of the tiles that can hold a live key.
  const int n_tiles = (S + tile - 1) / tile;
  int t_lo = 0, t_hi = n_tiles;
  if (!(is_ring && pos >= window)) {
    t_hi = pos < 0 ? 0 : min(n_tiles, pos / tile + 1);
    if (!is_ring && window > 0 && pos - window + 1 > 0)
      t_lo = min(t_hi, (pos - window + 1) / tile);
  }
  const int per = (t_hi - t_lo + n_split - 1) / n_split;
  const int my_lo = t_lo + split * per;
  const int my_hi = min(t_hi, my_lo + per);

  // the group's query rows: row g is head kh * group + g.
  for (int i = tid; i < rows * d; i += kThreads) {
    const int g = i / d, e = i - (i / d) * d;
    q_s[i] = to_f(q[(static_cast<size_t>(bi) * hq + kh * rows + g) * d + e]) * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  const size_t slab = (static_cast<size_t>(bi) * hkv + kh) * S * d;
  const T* kb = k + slab;
  const T* vb = v + slab;

  // copy tile t's K/V rows into stage st (keys past S zero-filled).
  auto load = [&](int t, int st) {
    const int cpr = d / V;  // chunks per row
    char* kd = kraw + static_cast<size_t>(st) * tile * L.kst;
    char* vd = vraw + static_cast<size_t>(st) * tile * L.vst;
    for (int c = tid; c < tile * cpr; c += kThreads) {
      const int key = c / cpr, cc = c - key * cpr;
      const int kpos = t * tile + key;
      const bool ok = kpos < S;
      const size_t src = ok ? static_cast<size_t>(kpos) * d + cc * V : 0;
      cp_async16(kd + key * L.kst + cc * 16, kb + src, ok);
      cp_async16(vd + key * L.vst + cc * 16, vb + src, ok);
    }
  };

  if (my_lo < my_hi) {
    load(my_lo, 0);
    cp_async_commit();
  }

  for (int t = my_lo; t < my_hi; ++t) {
    const int st = (t - my_lo) & 1;
    const int t0 = t * tile;
    cp_async_wait_all();
    // tile t has landed; every thread is done with tile t - 1, so its
    // stage is free.
    __syncthreads();
    if (t + 1 < my_hi) {
      load(t + 1, st ^ 1);
      cp_async_commit();
    }

    // scores: one thread per (row, key) pair, 16-byte reads of the K row.
    {
      const char* kd = kraw + static_cast<size_t>(st) * tile * L.kst;
      for (int pr = tid; pr < rows * tile; pr += kThreads) {
        const int rr = pr / tile, c = pr - rr * tile;
        const int kpos = t0 + c;
        float dot = kNegInf;
        if (kpos < S && key_valid(kpos, pos, window, is_ring)) {
          const float* qrow = q_s + rr * d;
          const uint4* krow = reinterpret_cast<const uint4*>(kd + c * L.kst);
          float acc4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int cc = 0; cc < d / V; ++cc) {
            const uint4 raw = krow[cc];
            const T* ke = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int u = 0; u < V; u += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qrow + cc * V + u);
              acc4[0] += qv.x * to_f(ke[u]);
              acc4[1] += qv.y * to_f(ke[u + 1]);
              acc4[2] += qv.z * to_f(ke[u + 2]);
              acc4[3] += qv.w * to_f(ke[u + 3]);
            }
          }
          dot = (acc4[0] + acc4[1]) + (acc4[2] + acc4[3]);
        }
        p_s[pr] = dot;
      }
    }
    __syncthreads();

    // online softmax: one warp per row.
    for (int rr = warp; rr < rows; rr += nwarp) {
      float* prow = p_s + rr * tile;
      float mx = kNegInf;
      for (int c = lane; c < tile; c += 32) mx = fmaxf(mx, prow[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < tile; c += 32) {
        const int kpos = t0 + c;
        const bool ok = kpos < S && key_valid(kpos, pos, window, is_ring);
        const float pv = ok ? expf(prow[c] - m_new) : 0.f;
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

    // acc = acc * alpha + P.V, one thread per (row, four columns).
    {
      const char* vd = vraw + static_cast<size_t>(st) * tile * L.vst;
      const int ncg = d / 4;
      for (int i4 = tid; i4 < rows * ncg; i4 += kThreads) {
        const int rr = i4 / ncg, e = (i4 - rr * ncg) * 4;
        const float* prow = p_s + rr * tile;
        float a2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int c = 0; c < tile; ++c) {
          const float pv = prow[c];
          float vv[4];
          load4(reinterpret_cast<const T*>(vd + c * L.vst) + e, vv);
#pragma unroll
          for (int x = 0; x < 4; ++x) a2[c & 1][x] += pv * vv[x];
        }
        const float alpha = a_s[rr];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          acc_s[rr * d + e + x] = acc_s[rr * d + e + x] * alpha + (a2[0][x] + a2[1][x]);
      }
    }
  }
  __syncthreads();

  if (part_acc != nullptr) {   // partials, combined by the second kernel
    const size_t pb = ((static_cast<size_t>(bi) * hkv + kh) * n_split + split) * rows;
    for (int i = tid; i < rows * d; i += kThreads) part_acc[pb * d + i] = acc_s[i];
    for (int r = tid; r < rows; r += kThreads) {
      part_ml[(pb + r) * 2] = m_s[r];
      part_ml[(pb + r) * 2 + 1] = l_s[r];
    }
    return;
  }
  if (out_acc != nullptr) {    // the shard's partials, not normalised
    const size_t ob = (static_cast<size_t>(bi) * hq + kh * rows);
    for (int i = tid; i < rows * d; i += kThreads) out_acc[ob * d + i] = acc_s[i];
    for (int r = tid; r < rows; r += kThreads) {
      out_ml[(ob + r) * 2] = m_s[r];
      out_ml[(ob + r) * 2 + 1] = l_s[r];
    }
    return;
  }
  for (int i = tid; i < rows * d; i += kThreads) {
    const int g = i / d, e = i - (i / d) * d;
    float l = l_s[g];
    if (l == 0.f) l = 1.f;  // a row with no valid key outputs 0
    store_f(acc_s[i] / l, &out[(static_cast<size_t>(bi) * hq + kh * rows + g) * d + e]);
  }
}

// o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits of one
// (sequence, kv head); a row with l = 0 in every split writes 0.  With
// out_acc, the sums and M are written unnormalised instead (partials mode).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     float* __restrict__ out_acc, float* __restrict__ out_ml,
                     int hq, int hkv, int d, int n_split) {
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int rows = hq / hkv;
  const size_t pb = (static_cast<size_t>(bi) * hkv + kh) * n_split;
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int rr = i / d, e = i - (i / d) * d;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, part_ml[((pb + s) * rows + rr) * 2]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t r = (pb + s) * rows + rr;
      const float w = expf(part_ml[r * 2] - M);
      den += w * part_ml[r * 2 + 1];
      num += w * part_acc[r * d + e];
    }
    if (out_acc != nullptr) {
      const size_t o = static_cast<size_t>(bi) * hq + kh * rows + rr;
      out_acc[o * d + e] = num;
      if (e == 0) {
        out_ml[o * 2] = M;
        out_ml[o * 2 + 1] = den;
      }
      continue;
    }
    if (den == 0.f) den = 1.f;
    store_f(num / den, &out[(static_cast<size_t>(bi) * hq + kh * rows + rr) * d + e]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* part_acc, float* part_ml, float* out_acc,
           float* out_ml, int b, int hq, int hkv, int S, int d, int n_split,
           int window, int ring, int key_offset, float scale,
           cudaStream_t stream) {
  const int rows = hq / hkv;
  int tile = kTileKeys;
  while (tile > 8 && layout(rows, d, tile, sizeof(T)).total > kMaxSmem)
    tile /= 2;
  const size_t smem = layout(rows, d, tile, sizeof(T)).total;
  auto kern = flash_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool parts = n_split > 1;
  dim3 grid(n_split, hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out),
      parts ? part_acc : nullptr, parts ? part_ml : nullptr, out_acc, out_ml,
      hq, hkv, S, d, tile, window, ring, key_offset, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !parts) return static_cast<int>(err);
  flash_decode_combine<T><<<dim3(hkv, b), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), out_acc, out_ml, hq, hkv, d,
      n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (with n_split > 1, the split kernel and then the
// combine kernel); returns cudaGetLastError() after the launches.  bf16:
// q, k, v and out are bf16 (else fp32).  window <= 0 means no window;
// ring != 0 needs window > 0, S == window and key_offset 0.  part_acc
// (b, hkv, n_split, hq / hkv, d) and part_ml (the same rows, 2) are fp32
// scratch, unused when n_split == 1.  key_offset: the global position of
// the cache's first slot.  out_acc (b, hq, d) and out_ml (b, hq, 2), fp32,
// given together, select partials mode (out unused).
int flash_decode(const void* q, const void* k, const void* v, const int* pos,
                 void* out, void* part_acc, void* part_ml, int b, int hq,
                 int hkv, int S, int d, int n_split, int window, int ring,
                 float scale, int bf16, void* stream, int key_offset,
                 void* out_acc, void* out_ml) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (out_acc == nullptr) != (out_ml == nullptr) ||
      (ring != 0 && key_offset != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* oa = static_cast<float*>(out_acc);
  float* om = static_cast<float*>(out_ml);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, pos, out, pa, pm, oa, om, b, hq,
                                 hkv, S, d, n_split, window, ring, key_offset,
                                 scale, s);
  return launch<float>(q, k, v, pos, out, pa, pm, oa, om, b, hq, hkv, S, d,
                       n_split, window, ring, key_offset, scale, s);
}

}  // extern "C"
