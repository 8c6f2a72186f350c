// A design of B1 that was tried and not shipped (kept for
// scripts/kernel_variants.py b1, which times it beside the shipped kernel):
// for a verify span (sq > 1) each thread scores one key against 4 query
// rows and sums P.V for 4 rows, so each K/V read is converted once per row
// group instead of once per row; at sq = 1 one row per thread, with the
// P.V keys taken two at a time.  Same C interface and, row by row, the
// same sums as the shipped kernel; more registers (98-128 against 64-80),
// and slower but at int8 verify spans (PERF.md, section 6).
//
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
// its kv steps; CUDA blocks run in no order.  Here the grid is (n_split,
// hkv, b): the wrapper picks n_split on the host from the shapes and the
// SM count only (never from pos or the table, which would cost a device
// sync per decode step), so that a small batch still fills the card.
// Each CTA reads pos itself, finds the 64-key tiles that can hold a live
// key (with a flat table, those from the window's first key to pos + sq;
// with a ring page_base, the whole table) and takes its even share of
// them.  Within that share it loops over its tiles keeping (m, l, acc) in
// shared memory: the next tile's raw page bytes (bf16, or int8 and their
// bf16 scales) are copied by cp.async into a second stage while the
// current tile is scored, and are converted to fp32 (times the scale) as
// they are read, as the first design did when it staged them.  One thread
// scores one key against RPT query rows (rows rg, rg + G, ...; G row
// groups side by side): each 16-byte read of the K row (rows padded by 16
// bytes, so the reads are free of bank conflicts) is converted once and
// dotted with each of its rows.  One warp per row runs the online-softmax
// update, and one thread per four output columns accumulates P.V for RPT
// rows, each V read converted once: three barriers a tile.  RPT is 1 at
// sq = 1 (the shipped design) and kSpanRows for a verify span (sq > 1, rows
// = sq * group), which so reads and converts each tile once per row group,
// not once per row.  Per row, every sum runs in the same order in both.
// Pages in the future, outside the window or never written are not read.  With n_split > 1 each CTA
// writes its partial (m, l, unnormalised acc) in fp32 to a scratch the
// wrapper allocates, and a second kernel, enqueued by the same C call,
// combines them: o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s (an
// empty split has m = NEG_INF, l = 0 and weight 0; a row empty in every
// split writes 0).  With n_split == 1 the CTA writes the output itself.
// Not done yet (later work): tensor-core products for long verify spans,
// TMA page copies on an mbarrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kTileKeys = 64;
constexpr int kSpanRows = 4;   // query rows a thread takes in a verify span

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void store_f(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}

// four consecutive pool elements from shared memory, as fp32
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* v) {
  const char4 r = *reinterpret_cast<const char4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
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
  size_t q, acc, kraw, vraw, p, m, l, a, ksc, vsc, kstart, phys, total;
  int kst, vst, tile_pad;  // K / V row strides in bytes; scales per stage
};

__host__ __device__ inline Layout layout(int rows, int d, int tile,
                                         int tile_pages, int pt_bytes) {
  Layout L;
  L.kst = d * pt_bytes + 16;   // K rows padded: conflict-free row reads
  L.vst = d * pt_bytes;
  L.tile_pad = (tile + 7) & ~7;
  size_t o = 0;
  L.q = o;      o += up16(sizeof(float) * rows * d);
  L.acc = o;    o += up16(sizeof(float) * rows * d);
  L.kraw = o;   o += up16(static_cast<size_t>(2) * tile * L.kst);  // 2 stages
  L.vraw = o;   o += up16(static_cast<size_t>(2) * tile * L.vst);
  L.p = o;      o += up16(sizeof(float) * rows * tile);
  L.m = o;      o += up16(sizeof(float) * rows);
  L.l = o;      o += up16(sizeof(float) * rows);
  L.a = o;      o += up16(sizeof(float) * rows);
  L.ksc = o;    o += up16(sizeof(bf16) * 2 * L.tile_pad);
  L.vsc = o;    o += up16(sizeof(bf16) * 2 * L.tile_pad);
  L.kstart = o; o += up16(sizeof(int) * 3 * tile_pages);   // 3 slots
  L.phys = o;   o += up16(sizeof(int) * 3 * tile_pages);
  L.total = o;
  return L;
}

template <typename QT, typename PT, bool QUANT, int RPT>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                          const PT* __restrict__ vp,
                          const bf16* __restrict__ ks,
                          const bf16* __restrict__ vs,
                          const int* __restrict__ block_tab,
                          const int* __restrict__ pos_arr,
                          const int* __restrict__ page_base,
                          QT* __restrict__ out, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int hq, int hkv, int sq,
                          int d, int n_pages, int page, int n_blocks,
                          int tile_pages, int window, float scale,
                          int scale_async) {
  extern __shared__ uint4 smem_u4[];
  char* base = reinterpret_cast<char*>(smem_u4);
  const int split = blockIdx.x, n_split = gridDim.x;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = hq / hkv;
  const int rows = sq * group;
  const int tile = tile_pages * page;  // keys per tile
  const bool has_base = page_base != nullptr;
  const Layout L = layout(rows, d, tile, tile_pages, sizeof(PT));
  float* q_s = reinterpret_cast<float*>(base + L.q);       // rows * d
  float* acc_s = reinterpret_cast<float*>(base + L.acc);   // rows * d
  char* kraw = base + L.kraw;                              // 2 x tile x kst
  char* vraw = base + L.vraw;                              // 2 x tile x vst
  float* p_s = reinterpret_cast<float*>(base + L.p);       // rows * tile
  float* m_s = reinterpret_cast<float*>(base + L.m);
  float* l_s = reinterpret_cast<float*>(base + L.l);
  float* a_s = reinterpret_cast<float*>(base + L.a);
  bf16* ksc_s = reinterpret_cast<bf16*>(base + L.ksc);     // 2 x tile_pad
  bf16* vsc_s = reinterpret_cast<bf16*>(base + L.vsc);
  int* kstart_s = reinterpret_cast<int*>(base + L.kstart);  // 3 x tile_pages
  int* phys_s = reinterpret_cast<int*>(base + L.phys);      // -1 = skip

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = kThreads >> 5;
  const int pos = pos_arr[bi];

  // this split's even share of the tiles that can hold a live key.
  const int n_tiles = (n_blocks + tile_pages - 1) / tile_pages;
  int t_lo = 0, t_hi = n_tiles;
  if (!has_base) {
    t_hi = min(n_tiles, max(pos + sq - 1, 0) / tile + 1);
    if (window > 0 && pos - window + 1 > 0)
      t_lo = min(t_hi, (pos - window + 1) / tile);
  }
  const int per = (t_hi - t_lo + n_split - 1) / n_split;
  const int my_lo = t_lo + split * per;
  const int my_hi = min(t_hi, my_lo + per);

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

  // tile t's pages into meta slot `slot` (threads tid < tile_pages).
  auto meta = [&](int t, int slot) {
    const int j = t * tile_pages + tid;
    int phys = -1;
    int k_start = 0;
    if (j < n_blocks) {
      k_start = has_base ? page_base[bi * n_blocks + j] : j * page;
      bool active = k_start <= pos + (sq - 1);            // future pages
      if (has_base) active = active && k_start >= 0;      // never written
      if (window > 0) active = active && (k_start + page - 1 > pos - window);
      // table entries past the pool (unallocated) clamp to a real page.
      if (active) phys = min(max(block_tab[bi * n_blocks + j], 0), n_pages - 1);
    }
    kstart_s[slot * tile_pages + tid] = k_start;
    phys_s[slot * tile_pages + tid] = phys;
  };

  // copy the live pages of the tile in meta slot `slot` into stage `st`
  // (dead slots are zero-filled, and masked).
  auto load = [&](int slot, int st) {
    constexpr int V = 16 / sizeof(PT);       // elements per 16-byte chunk
    const int cpr = d / V;                   // chunks per row
    const int cpp = page * cpr;              // chunks per page
    const int* phys_t = phys_s + slot * tile_pages;
    char* kd = kraw + static_cast<size_t>(st) * tile * L.kst;
    char* vd = vraw + static_cast<size_t>(st) * tile * L.vst;
    for (int c = tid; c < tile_pages * cpp; c += kThreads) {
      const int tp = c / cpp, w = c - tp * cpp;
      const int row = w / cpr, cc = w - row * cpr;
      const int phys = phys_t[tp];
      const size_t src =
          phys >= 0 ? ((static_cast<size_t>(phys) * hkv + kh) * page + row) * d + cc * V : 0;
      const int key = tp * page + row;
      cp_async16(kd + key * L.kst + cc * 16, kp + src, phys >= 0);
      cp_async16(vd + key * L.vst + cc * 16, vp + src, phys >= 0);
    }
    if (QUANT) {
      bf16* kscd = ksc_s + st * L.tile_pad;
      bf16* vscd = vsc_s + st * L.tile_pad;
      if (scale_async) {                     // page % 8 == 0, aligned
        const int spp = page / 8;            // 16-byte chunks per page
        for (int c = tid; c < tile_pages * spp; c += kThreads) {
          const int tp = c / spp, w = c - tp * spp;
          const int phys = phys_t[tp];
          const size_t src =
              phys >= 0 ? (static_cast<size_t>(phys) * hkv + kh) * page + w * 8 : 0;
          cp_async16(kscd + tp * page + w * 8, ks + src, phys >= 0);
          cp_async16(vscd + tp * page + w * 8, vs + src, phys >= 0);
        }
      } else {
        for (int i = tid; i < tile; i += kThreads) {
          const int tp = i / page, row = i - tp * page;
          const int phys = phys_t[tp];
          const size_t srow = (static_cast<size_t>(max(phys, 0)) * hkv + kh) * page + row;
          kscd[i] = phys >= 0 ? ks[srow] : __float2bfloat16_rn(0.f);
          vscd[i] = phys >= 0 ? vs[srow] : __float2bfloat16_rn(0.f);
        }
      }
    }
  };

  if (my_lo < my_hi) {
    if (tid < tile_pages) meta(my_lo, 0);
    __syncthreads();
    load(0, 0);
    cp_async_commit();
    if (tid < tile_pages && my_lo + 1 < my_hi) meta(my_lo + 1, 1);
  }

  for (int t = my_lo; t < my_hi; ++t) {
    const int i = t - my_lo, st = i & 1, slot = i % 3;
    cp_async_wait_all();
    // tile t has landed and its meta is visible; every thread is done
    // with tile t - 1, so its stage and meta slot are free.
    __syncthreads();
    if (t + 1 < my_hi) {
      load((i + 1) % 3, st ^ 1);
      cp_async_commit();
    }
    if (tid < tile_pages && t + 2 < my_hi) meta(t + 2, (i + 2) % 3);
    const int* phys_t = phys_s + slot * tile_pages;
    const int* kst_t = kstart_s + slot * tile_pages;
    bool any = false;
    for (int tp = 0; tp < tile_pages; ++tp) any = any || phys_t[tp] >= 0;
    if (!any) continue;  // uniform across the block

    // scores: one thread per (key, row group), 16-byte reads of the K row,
    // each converted once for the group's rows rg, rg + G, ... .
    {
      constexpr int V = 16 / sizeof(PT);
      const int G = max(1, kThreads / tile);
      const char* kd = kraw + static_cast<size_t>(st) * tile * L.kst;
      const bf16* kscd = ksc_s + st * L.tile_pad;
      for (int pr = tid; pr < G * tile; pr += kThreads) {
        const int rg = pr / tile, c = pr - rg * tile;
        const int tp = c / page;
        const int kpos = kst_t[tp] + (c - tp * page);
        const bool live = phys_t[tp] >= 0;
        const float ksc = QUANT ? __bfloat162float(kscd[c]) : 1.f;
        const uint4* krow = reinterpret_cast<const uint4*>(kd + c * L.kst);
        for (int r0 = rg; r0 < rows; r0 += G * RPT) {
          const int nr = min(RPT, (rows - r0 + G - 1) / G);
          bool ok[RPT];
          bool any_ok = false;
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            ok[j] = j < nr && live &&
                    key_valid(kpos, pos + (r0 + j * G) / group, has_base, window);
            any_ok = any_ok || ok[j];
          }
          float acc4[RPT][4] = {};
          if (any_ok) {
            for (int cc = 0; cc < d / V; ++cc) {
              const uint4 raw = krow[cc];
              const PT* ke = reinterpret_cast<const PT*>(&raw);
#pragma unroll
              for (int u = 0; u < V; u += 4) {
                float kv[4];
#pragma unroll
                for (int x = 0; x < 4; ++x)
                  kv[x] = QUANT ? to_f(ke[u + x]) * ksc : to_f(ke[u + x]);
#pragma unroll
                for (int j = 0; j < RPT; ++j) {
                  if (j < nr) {
                    const float4 qv = *reinterpret_cast<const float4*>(
                        q_s + (r0 + j * G) * d + cc * V + u);
                    acc4[j][0] += qv.x * kv[0];
                    acc4[j][1] += qv.y * kv[1];
                    acc4[j][2] += qv.z * kv[2];
                    acc4[j][3] += qv.w * kv[3];
                  }
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < RPT; ++j)
            if (j < nr)
              p_s[(r0 + j * G) * tile + c] =
                  ok[j] ? (acc4[j][0] + acc4[j][1]) + (acc4[j][2] + acc4[j][3])
                        : kNegInf;
        }
      }
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
        const int kpos = kst_t[tp] + (c - tp * page);
        const bool ok = phys_t[tp] >= 0 &&
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

    // acc = acc * alpha + P.V, one thread per (four columns, row group),
    // each V read converted once for the group's rows.
    {
      const char* vd = vraw + static_cast<size_t>(st) * tile * L.vst;
      const bf16* vscd = vsc_s + st * L.tile_pad;
      const int ncg = d / 4;
      const int G = max(1, kThreads / ncg);
      for (int i4 = tid; i4 < G * ncg; i4 += kThreads) {
        const int rg = i4 / ncg, e = (i4 - rg * ncg) * 4;
        for (int r0 = rg; r0 < rows; r0 += G * RPT) {
          const int nr = min(RPT, (rows - r0 + G - 1) / G);
          // even and odd keys in two sums per column (two chains of
          // adds), added at the end.
          float ev[RPT][4] = {}, od[RPT][4] = {};
          for (int c = 0; c < tile; c += 2) {
            const bool two = c + 1 < tile;
            float v0[4], v1[4] = {0.f, 0.f, 0.f, 0.f};
            load4(reinterpret_cast<const PT*>(vd + c * L.vst) + e, v0);
            if (two) load4(reinterpret_cast<const PT*>(vd + (c + 1) * L.vst) + e, v1);
            if (QUANT) {
              const float s0 = __bfloat162float(vscd[c]);
              const float s1 = two ? __bfloat162float(vscd[c + 1]) : 0.f;
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                v0[x] *= s0;
                v1[x] *= s1;
              }
            }
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
              if (j < nr) {
                const float* prow = p_s + (r0 + j * G) * tile;
                const float p0 = prow[c];
#pragma unroll
                for (int x = 0; x < 4; ++x) ev[j][x] += p0 * v0[x];
                if (two) {
                  const float p1 = prow[c + 1];
#pragma unroll
                  for (int x = 0; x < 4; ++x) od[j][x] += p1 * v1[x];
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            if (j < nr) {
              const int rr = r0 + j * G;
              const float alpha = a_s[rr];
#pragma unroll
              for (int x = 0; x < 4; ++x)
                acc_s[rr * d + e + x] =
                    acc_s[rr * d + e + x] * alpha + (ev[j][x] + od[j][x]);
            }
          }
        }
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
  for (int i = tid; i < rows * d; i += kThreads) {
    const int rr = i / d, e = i - (i / d) * d;
    const int t = rr / group, g = rr - t * group;
    float l = l_s[rr];
    if (l == 0.f) l = 1.f;  // a row with no valid key outputs 0
    const size_t oi = ((static_cast<size_t>(bi) * hq + kh * group + g) * sq + t) * d + e;
    store_f(acc_s[i] / l, &out[oi]);
  }
}

// o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits of one
// (sequence, kv head); a row with l = 0 in every split writes 0.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_combine(const float* __restrict__ part_acc,
                           const float* __restrict__ part_ml,
                           QT* __restrict__ out, int hq, int hkv, int sq,
                           int d, int n_split) {
  const int kh = blockIdx.x, bi = blockIdx.y;
  const int group = hq / hkv;
  const int rows = sq * group;
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
    if (den == 0.f) den = 1.f;
    const int t = rr / group, g = rr - t * group;
    const size_t oi = ((static_cast<size_t>(bi) * hq + kh * group + g) * sq + t) * d + e;
    store_f(num / den, &out[oi]);
  }
}

template <typename QT, typename PT, bool QUANT, int RPT>
int launch_rows(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* bt, const int* pos, const int* page_base,
           void* out, float* part_acc, float* part_ml, int b, int hq, int hkv,
           int sq, int d, int n_pages, int page, int n_blocks, int n_split,
           int window, float scale, cudaStream_t stream) {
  const int rows = sq * (hq / hkv);
  const int tile_pages = page >= kTileKeys ? 1 : kTileKeys / page;
  const size_t smem =
      layout(rows, d, tile_pages * page, tile_pages, sizeof(PT)).total;
  auto kern = flash_decode_paged_kernel<QT, PT, QUANT, RPT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int scale_async = QUANT && page % 8 == 0 &&
                          reinterpret_cast<uintptr_t>(ks) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(vs) % 16 == 0;
  const bool parts = n_split > 1;
  dim3 grid(n_split, hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), bt, pos, page_base, static_cast<QT*>(out),
      parts ? part_acc : nullptr, parts ? part_ml : nullptr, hq, hkv, sq, d,
      n_pages, page, n_blocks, tile_pages, window, scale, scale_async);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !parts) return static_cast<int>(err);
  flash_decode_paged_combine<QT><<<dim3(hkv, b), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<QT*>(out), hq, hkv, sq, d, n_split);
  return static_cast<int>(cudaGetLastError());
}

// a verify span (sq > 1) shares each K/V read among kSpanRows rows.
template <typename QT, typename PT, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* bt, const int* pos, const int* page_base,
           void* out, float* part_acc, float* part_ml, int b, int hq, int hkv,
           int sq, int d, int n_pages, int page, int n_blocks, int n_split,
           int window, float scale, cudaStream_t stream) {
  auto fn = sq > 1 ? launch_rows<QT, PT, QUANT, kSpanRows>
                   : launch_rows<QT, PT, QUANT, 1>;
  return fn(q, kp, vp, ks, vs, bt, pos, page_base, out, part_acc, part_ml, b,
            hq, hkv, sq, d, n_pages, page, n_blocks, n_split, window, scale,
            stream);
}

}  // namespace

extern "C" {

// Launches on `stream` (with n_split > 1, the split kernel and then the
// combine kernel); returns cudaGetLastError() after the launches.  q_bf16:
// q/out are bf16 (else fp32).  quantized: pools are int8 with bf16 scale
// pages (else bf16 pools, scales unused).  page_base may be null.  window
// <= 0 means no window.  part_acc (b, hkv, n_split, sq * hq / hkv, d) and
// part_ml (the same rows, 2) are fp32 scratch, unused when n_split == 1.
int flash_decode_paged(const void* q, const void* k_pages, const void* v_pages,
                       const void* k_scale, const void* v_scale,
                       const int* block_tab, const int* pos,
                       const int* page_base, void* out, void* part_acc,
                       void* part_ml, int b, int hq, int hkv, int sq, int d,
                       int n_pages, int page, int n_blocks, int n_split,
                       int window, float scale, int q_bf16, int quantized,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
#define ARGS q, k_pages, v_pages, k_scale, v_scale, block_tab, pos, page_base, \
             out, static_cast<float*>(part_acc), static_cast<float*>(part_ml), \
             b, hq, hkv, sq, d, n_pages, page, n_blocks, n_split, window, scale, s
  if (q_bf16) {
    if (quantized) return launch<bf16, int8_t, true>(ARGS);
    return launch<bf16, bf16, false>(ARGS);
  }
  if (quantized) return launch<float, int8_t, true>(ARGS);
  return launch<float, bf16, false>(ARGS);
#undef ARGS
}

}  // extern "C"
