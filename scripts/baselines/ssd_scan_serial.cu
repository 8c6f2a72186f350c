// Mamba2 SSD chunked scan for Hopper (sm_90a): ssd_scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py :: ssd_scan
// (pallas_call at :88, body _ssd_kernel at :29-65).  Same function, per
// (batch, head), over the chunks of Q = `chunk` positions in order, with
// the state S (ds x dh, fp32) carried from one chunk to the next:
//
//   cum_i = sum_{k<=i} dt_k A                       (within the chunk)
//   y_i   = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
//           + exp(cum_i) (C_i . S)
//   S'    = exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
//
// x, y (b, s, h, dh), dt (b, s, h), A (h,), B, C (b, s, ds) [ngroups = 1],
// all fp32 (the model casts to fp32 before the scan, models/ssm.py).  The
// plain twin is kernels/ref.py::ssd_chunked_batch; both sum in another
// order than the other (the prefix sum of dt A, the dot products), so
// they agree to fp32 rounding, not bit for bit.
//
// What bounds it on an H100: operations.  Per chunk and (b, h) the two
// Q x Q products over the causal triangle take Q(Q+1)(ds + dh) flops and
// the two state products 4 Q ds dh: 21 MFLOP at Q 256, ds 128, dh 64,
// against ~0.3 MB of x, y, B, C and dt, so at 67 TFLOP/s fp32 (CUDA
// cores; TF32 tensor cores would round past the reference's tolerance)
// the flops take ~8x longer than the bytes at 3.35 TB/s.
//
// Design.  The Pallas kernel runs a sequential grid (b*h, n_chunks) and
// carries S in VMEM scratch.  Here one CTA of 256 threads owns one
// (b, h) and a slab of DHS of its dh columns (the columns of S and y are
// independent; a slab recomputes C . B^T), and loops over the chunks
// itself with S in shared memory.  Per chunk: one warp prefix-sums dt A
// (serial runs per lane, then a shuffle scan of the lane totals); the
// chunk's rows go in 64-row tiles.  For each output tile I the CTA forms
// exp(cum_i) (C_I . S) and then, for each J <= I, G = C_I . B_J^T in
// registers (4 x 4 per thread), masks it to W = G exp(cum_i - cum_j) dt_j
// for j <= i -- the exp is taken only there: above the diagonal
// cum_i - cum_j > 0 can overflow to inf, which the reference selects away
// after the exp -- stages W in shared memory and adds W . x_J.  The state
// update rides on the last tile's J loop (every J tile is loaded there):
// each thread keeps its S entries in registers and writes them back after
// every output row of the chunk has read the old S.  B and C are read at
// (b, s, ds) directly, by every head (from L2), and x, y, dt in their
// (b, s, h, .) layout: nothing is transposed or broadcast in memory.
// Everything is fp32 on the CUDA cores.  Not done yet (later work):
// tensor-core products (3xTF32 or bf16 splits that keep the tolerance),
// double-buffered cp.async/TMA tile loads, the triangle's skipped half
// inside diagonal tiles, and more than one CTA per SM (this one takes
// ~140 KB of shared memory at ds 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows of a tile (i and j)
constexpr int kTP = kT + 4;     // stride of the transposed tiles (floats)
constexpr int kMaxDs = 128;     // state rows: 16 threads x 8 registers
constexpr int kMaxChunk = 1024;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  int s, h, dh, ds, chunk;
};

size_t smem_floats(int dhs, int ds, int chunk) {
  const int nq = (chunk + kT - 1) / kT * kT;
  return static_cast<size_t>(ds) * dhs + 2 * static_cast<size_t>(ds) * kTP +
         kT * dhs + kT * kTP + 4 * static_cast<size_t>(nq);
}

template <int DHS>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(Args a) {
  constexpr int CD = DHS / 16;  // y and S columns per thread
  extern __shared__ float4 smem4[];
  const int ds = a.ds, Q = a.chunk, h = a.h, s = a.s, dh = a.dh;
  const int nqt = (Q + kT - 1) / kT;
  const int ks = ds / 16;       // S rows per thread
  float* S = reinterpret_cast<float*>(smem4);  // [ds][DHS]
  float* CT = S + ds * DHS;     // [ds][kTP]  C rows of tile I, transposed
  float* BT = CT + ds * kTP;    // [ds][kTP]  B rows of tile J, transposed
  float* XS = BT + ds * kTP;    // [kT][DHS]  x rows of tile J (this slab)
  float* WT = XS + kT * DHS;    // [kT][kTP]  W of (I, J), WT[j][i]
  float* cum = WT + kT * kTP;   // [nqt kT]   cumsum of dt A
  float* ecum = cum + nqt * kT;  //           exp(cum_i)
  float* wj = ecum + nqt * kT;  //            exp(cum_last - cum_j) dt_j
  float* dts = wj + nqt * kT;   //            dt_j

  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  const int d0 = blockIdx.x * DHS, hi = blockIdx.y, bi = blockIdx.z;
  const float Av = a.A[hi];
  const size_t row0 = static_cast<size_t>(bi) * s;  // (b, t) row of t = 0

  for (int e = t; e < ds * DHS; e += kThreads) S[e] = 0.f;

  for (int t0 = 0; t0 < s; t0 += Q) {
    // --- dt and the prefix sum of dt A over the chunk -------------------
    for (int e = t; e < nqt * kT; e += kThreads)
      dts[e] = e < Q ? a.dt[(row0 + t0 + e) * h + hi] : 0.f;
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
    for (int e = t; e < nqt * kT; e += kThreads) {
      const float ce = e < Q ? cum[e] : cl;
      ecum[e] = expf(ce);
      wj[e] = e < Q ? expf(cl - ce) * dts[e] : 0.f;
    }

    float sacc[8][CD];          // this thread's S rows tr + 16 k, new value
    for (int I = 0; I < nqt; ++I) {
      const int i0 = I * kT;
      const bool last = I == nqt - 1;
      for (int e = t; e < kT * ds; e += kThreads) {
        const int r = e / ds, c = e % ds;
        CT[c * kTP + r] =
            i0 + r < Q ? a.C[(row0 + t0 + i0 + r) * ds + c] : 0.f;
      }
      __syncthreads();

      // y_I = exp(cum_i) (C_I . S), with the state the chunk found.
      float acc[4][CD];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < CD; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < ds; ++k) {
        const float4 c4 = *reinterpret_cast<const float4*>(
            &CT[k * kTP + tr * 4]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        float sv[CD];
#pragma unroll
        for (int q = 0; q < CD; ++q) sv[q] = S[k * DHS + tc * CD + q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CD; ++q) acc[r][q] += cv[r] * sv[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ec = ecum[i0 + tr * 4 + r];
#pragma unroll
        for (int q = 0; q < CD; ++q) acc[r][q] *= ec;
      }
      if (last) {
        const float el = expf(cl);
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int q = 0; q < CD; ++q)
            sacc[k][q] = k < ks ? S[(tr + 16 * k) * DHS + tc * CD + q] * el
                                : 0.f;
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * kT;
        __syncthreads();        // the previous J's BT, XS and WT are read
        for (int e = t; e < kT * ds; e += kThreads) {
          const int r = e / ds, c = e % ds;
          BT[c * kTP + r] =
              j0 + r < Q ? a.B[(row0 + t0 + j0 + r) * ds + c] : 0.f;
        }
        for (int e = t; e < kT * DHS; e += kThreads) {
          const int r = e / DHS, c = e % DHS;
          XS[e] = j0 + r < Q
                      ? a.x[((row0 + t0 + j0 + r) * h + hi) * dh + d0 + c]
                      : 0.f;
        }
        __syncthreads();

        // G = C_I . B_J^T, masked and decayed into W, staged as WT[j][i].
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[r][q] = 0.f;
#pragma unroll 4
        for (int k = 0; k < ds; ++k) {
          const float4 c4 = *reinterpret_cast<const float4*>(
              &CT[k * kTP + tr * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(
              &BT[k * kTP + tc * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) g[r][q] += cv[r] * bv[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tc * 4 + q;
          float w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + tr * 4 + r;
            w[r] = 0.f;         // j > i: never exp'd, never inf * 0
            if (j <= i && i < Q)
              w[r] = g[r][q] * expf(cum[i] - cum[j]) * dts[j];
          }
          *reinterpret_cast<float4*>(&WT[(tc * 4 + q) * kTP + tr * 4]) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();

        // y_I += W . x_J; on the last tile also S' += B_J^T diag(wj) x_J.
        for (int jj = 0; jj < kT; ++jj) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              &WT[jj * kTP + tr * 4]);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
          float xv[CD];
#pragma unroll
          for (int q = 0; q < CD; ++q) xv[q] = XS[jj * DHS + tc * CD + q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < CD; ++q) acc[r][q] += wv[r] * xv[q];
          if (last) {
            const float wjv = wj[j0 + jj];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (k < ks) {
                const float bw = BT[(tr + 16 * k) * kTP + jj] * wjv;
#pragma unroll
                for (int q = 0; q < CD; ++q) sacc[k][q] += bw * xv[q];
              }
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + tr * 4 + r;
        if (i < Q) {
          float* yo = a.y + ((row0 + t0 + i) * h + hi) * dh + d0 + tc * CD;
#pragma unroll
          for (int q = 0; q < CD; ++q) yo[q] = acc[r][q];
        }
      }
      __syncthreads();          // CT and S are read; the next tile reloads
    }

    // every row of the chunk has read the old S: write the new one.
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < ks)
#pragma unroll
        for (int q = 0; q < CD; ++q)
          S[(tr + 16 * k) * DHS + tc * CD + q] = sacc[k][q];
    __syncthreads();
  }
}

template <int DHS>
int launch(const Args& a, int b, int slabs, cudaStream_t stream) {
  const size_t bytes = smem_floats(DHS, a.ds, a.chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<DHS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<DHS><<<dim3(slabs, a.h, b), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take: the
// wrapper checks them first).  x, y: (b, s, h, dh); dt: (b, s, h);
// A: (h,); B, C: (b, s, ds); all fp32, contiguous.  s % chunk == 0,
// chunk <= 1024, ds % 16 == 0 and ds <= 128, dh % 16 == 0.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* y, int b, int s, int h, int dh, int ds,
             int chunk, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || s % chunk || ds <= 0 ||
      ds % 16 || ds > kMaxDs || dh <= 0 || dh % 16 || h > 65535 ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A),  static_cast<const float*>(B),
         static_cast<const float*>(C),  static_cast<float*>(y),
         s, h, dh, ds, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the widest slab that divides dh, halved while twice the CTAs would
  // still fit in one wave over the SMs (the long single-sequence case:
  // a slab recomputes C . B^T, so halving costs work as well as gaining
  // CTAs).
  int dhs = dh % 64 == 0 ? 64 : dh % 32 == 0 ? 32 : 16;
  while (dhs > 16 && 2L * b * h * (dh / dhs) <= sms) dhs /= 2;
  switch (dhs) {
    case 64: return launch<64>(a, b, dh / 64, st);
    case 32: return launch<32>(a, b, dh / 32, st);
    default: return launch<16>(a, b, dh / 16, st);
  }
}

}  // extern "C"
