// Flash attention for Hopper (sm_90a), CUDA C++: forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of
// deepspeedsyclsupport_tpu/ops/flash_attention.py that training runs:
//   flash_fwd_kernel  <- _fwd_kernel (:145), launched by _fwd_call (:481)
//   flash_dq_kernel   <- _dq_kernel  (:208), launched by _bwd_call (:535)
//   flash_dkv_kernel  <- _dkv_kernel (:273), launched by _bwd_call (:535)
// The fourth kernel of that file, _dbias_kernel (:330), is not ported here.
//
// What they compute. q [B, Sq, H, D], k/v [B, Skv, KVH, D] and o/do/dq/dk/dv
// are read and written in place through (batch, seq, head) strides with a
// unit innermost stride: no transpose and no padding copy. Ragged edges
// (rows past Sq, columns past Skv) are masked in the kernels. Scores are
// s = scale * q.k (+ slope[q head] * (k_pos - q_pos) with ALiBi), scale =
// 1/sqrt(D). Entry (i, j) is visible iff seg_q[i] == seg_k[j] and, when
// causal, k_pos[j] <= q_pos[i] and (window) q_pos[i] - k_pos[j] < window:
// the Pallas `_mask` rules. Positions default to q_pos = i + (Skv - Sq),
// k_pos = j; segments default to 0. GQA: q head h reads kv head
// h / (H / KVH).
//   forward: O = softmax(s) V online in float32 (m from -1e30, l, acc),
//     LSE[b, h, i] = m + log(max(l, 1e-30)); a row with nothing visible
//     gets O = 0 and LSE ~ -1e30, as the Pallas kernel does.
//   dQ: p = visible ? exp(s - LSE) : 0, dp = dO.V^T, ds = p (dp - delta),
//     dQ = scale * ds K, with delta = rowsum(dO * O) computed by the caller.
//   dK/dV: the same p and ds, dV = p^T dO, dK = scale * ds^T Q, summed over
//     the G q heads of the kv head inside the kernel (the Pallas kernel
//     writes per-q-head fp32 dK/dV and group-sums outside).
// All products accumulate in float32; outputs are stored in the inputs'
// type (float32, bfloat16 or float16), LSE in float32.
//
// Design (first, simple version). 256 threads as 16 x 16; each thread owns
// an RI x CJ tile of the score block and RI rows x D/16 columns of its
// accumulators, as in csrc/paged_attention.cu.
//   forward: one CTA per (q tile of 64 rows, q head, batch); walks the KV
//     tiles its rows can see (cut by causality and the window when the
//     positions are the default ones), online softmax per row in a warp.
//   dQ: one CTA per (q tile, q head, batch); walks the same KV range.
//   dK/dV: one CTA per (kv tile, kv head, batch); loops over the G q heads
//     of its kv head and the q tiles that can see its keys, and writes the
//     group sum once: no [B, H, S, D] fp32 intermediate and no atomics.
// Nothing crosses CTAs, so results do not depend on scheduling: the same
// inputs give the same bits (activation checkpointing relies on that).
//
// What bounds it on an H100. At training lengths (S = 4096, D = 128)
// attention does ~S/2 flops per byte it must move, far above the card's
// ~295 flop/byte line: the bound is tensor-core flops (989 TFLOP/s
// bf16/fp16). This version runs every product on the float32 CUDA cores
// (67 TFLOP/s peak) with operands staged in shared memory: no mma.sync or
// wgmma, no TMA or cp.async pipelining, no double buffering, one or two CTAs
// per SM (65-215 KB of shared memory), and dQ recomputes p and dp that the
// dK/dV kernel also computes (no fused single-pass backward). Those are the
// later PRs' work.
//
// Interface: one plain C function per kernel, loaded with ctypes. Each
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTY = 16;
constexpr int kTX = 16;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // NEG_INF of the Pallas kernels

enum Operand { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kNumOperands };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;      // dO (backward)
  void* o;               // forward output
  void* dq;
  void* dk;
  void* dv;
  float* lse_out;        // forward output [B, H, Sq]
  const float* lse;      // backward input [B, H, Sq]
  const float* delta;    // backward input [B, H, Sq]
  const int* seg_q;      // [B, Sq] or null (all 0)
  const int* seg_k;      // [B, Skv] or null (all 0)
  const int* pos_q;      // [B, Sq] or null (i + Skv - Sq)
  const int* pos_k;      // [B, Skv] or null (j)
  const float* alibi;    // [H] or null
  long long st[kNumOperands][3];  // (batch, seq, head) strides, elements
  int b, sq, skv, h, kvh, d;
  int causal, window;    // window <= 0: none
  int offset;            // Skv - Sq
  int default_pos;       // both position arrays null
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ size_t at(const Args& p, int t, int b, int s,
                                     int h) {
  return (size_t)(b * p.st[t][0] + s * p.st[t][1] + h * p.st[t][2]);
}
__device__ __forceinline__ int qpos_of(const Args& p, int b, int i) {
  return p.pos_q ? p.pos_q[(size_t)b * p.sq + i] : i + p.offset;
}
__device__ __forceinline__ int kpos_of(const Args& p, int b, int j) {
  return p.pos_k ? p.pos_k[(size_t)b * p.skv + j] : j;
}
__device__ __forceinline__ int qseg_of(const Args& p, int b, int i) {
  return p.seg_q ? p.seg_q[(size_t)b * p.sq + i] : 0;
}
__device__ __forceinline__ int kseg_of(const Args& p, int b, int j) {
  return p.seg_k ? p.seg_k[(size_t)b * p.skv + j] : 0;
}
__device__ __forceinline__ bool visible(const Args& p, int qpos, int kpos,
                                        int qseg, int kseg) {
  bool ok = qseg == kseg;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok;
}

// KV columns that rows [i0, i1) can see: [lo, hi). Only the default
// positions give a bound by index; otherwise every column is walked and the
// mask decides. Correctness never depends on the cut.
__device__ __forceinline__ void kv_range(const Args& p, int i0, int i1,
                                         int& lo, int& hi) {
  lo = 0;
  hi = p.skv;
  if (p.default_pos && p.causal) {
    hi = min(hi, i1 - 1 + p.offset + 1);
    if (p.window > 0) lo = max(0, i0 + p.offset - p.window + 1);
  }
}
// q rows that can see KV rows [j0, j1): [lo, hi).
__device__ __forceinline__ void q_range(const Args& p, int j0, int j1,
                                        int& lo, int& hi) {
  lo = 0;
  hi = p.sq;
  if (p.default_pos && p.causal) {
    lo = max(0, j0 - p.offset);
    if (p.window > 0) hi = min(hi, j1 - 1 - p.offset + p.window);
  }
}

// Load rows [r0, r0 + n) of operand t (batch b, head hh) into a float tile
// with row pitch `pitch`; rows at or past `rend` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const Args& p, const T* src, int t,
                                          int b, int hh, int r0, int n,
                                          int rend, float* dst, int pitch) {
  const int D = p.d;
  for (int x = threadIdx.x; x < n * D; x += kThreads) {
    const int r = x / D, dd = x % D, s = r0 + r;
    dst[r * pitch + dd] = s < rend ? to_f(src[at(p, t, b, s, hh) + dd]) : 0.f;
  }
}

// ------------------------------------------------------------------ forward
template <typename T, int DMAX, int RI, int CJ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args p) {
  constexpr int BR = kTY * RI, BC = kTX * CJ, DJ = DMAX / kTX;
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int i0 = blockIdx.x * BR, hq = blockIdx.y, b = blockIdx.z;
  const int kh = hq / (p.h / p.kvh);
  const int D = p.d, DP = D + 1;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  extern __shared__ float smem[];
  float* qs = smem;                 // [BR][DP]
  float* ks = qs + BR * DP;         // [BC][DP]
  float* vs = ks + BC * DP;         // [BC][D]
  float* ps = vs + BC * D;          // [BR][BC + 1]
  float* m_s = ps + BR * (BC + 1);  // [BR]
  float* l_s = m_s + BR;            // [BR]
  float* al_s = l_s + BR;           // [BR]

  load_tile(p, q, kQ, b, hq, i0, BR, p.sq, qs, DP);
  for (int r = tid; r < BR; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  int qpos[RI], qseg[RI];
  bool qlive[RI];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int i = i0 + ty + kTY * ii;
    qlive[ii] = i < p.sq;
    qpos[ii] = qlive[ii] ? qpos_of(p, b, i) : 0;
    qseg[ii] = qlive[ii] ? qseg_of(p, b, i) : 0;
  }
  const float slope = p.alibi ? p.alibi[hq] : 0.f;
  float acc[RI][DJ];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] = 0.f;

  int lo, hi;
  kv_range(p, i0, min(i0 + BR, p.sq), lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BC) {
    __syncthreads();  // the previous tile's readers are done
    for (int x = tid; x < BC * D; x += kThreads) {
      const int c = x / D, dd = x % D, j = j0 + c;
      float kx = 0.f, vx = 0.f;  // zero past hi: p is 0 there and V must
      if (j < hi) {              // not be NaN garbage
        kx = to_f(kp[at(p, kK, b, j, kh) + dd]);
        vx = to_f(vp[at(p, kV, b, j, kh) + dd]);
      }
      ks[c * DP + dd] = kx;
      vs[c * D + dd] = vx;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int ii = 0; ii < RI; ++ii)
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) s[ii][jj] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int ii = 0; ii < RI; ++ii) qv[ii] = qs[(ty + kTY * ii) * DP + dd];
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) kv[jj] = ks[(tx + kTX * jj) * DP + dd];
#pragma unroll
      for (int ii = 0; ii < RI; ++ii)
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj)
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const int c = tx + kTX * jj, j = j0 + c;
      const bool jlive = j < hi;
      const int kpos = jlive ? kpos_of(p, b, j) : 0;
      const int kseg = jlive ? kseg_of(p, b, j) : 0;
#pragma unroll
      for (int ii = 0; ii < RI; ++ii) {
        const bool ok = jlive && qlive[ii] &&
                        visible(p, qpos[ii], kpos, qseg[ii], kseg);
        const float x = s[ii][jj] * p.scale +
                        slope * (float)(kpos - qpos[ii]);
        ps[(ty + kTY * ii) * (BC + 1) + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    const int warp = tid / 32, wl = tid % 32;
    for (int r = warp; r < BR; r += kWarps) {
      float* prow = ps + r * (BC + 1);
      float mx = kNegInf;
      for (int c = wl; c < BC; c += 32) mx = fmaxf(mx, prow[c]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = wl; c < BC; c += 32) {
        const float x = prow[c];
        const float e = x == -INFINITY ? 0.f : expf(x - m_new);
        prow[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (wl == 0) {
        const float alpha = expf(m_old - m_new);
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int ii = 0; ii < RI; ++ii) {
      const float alpha = al_s[ty + kTY * ii];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] *= alpha;
    }
    const int cn = min(BC, hi - j0);
    for (int c = 0; c < cn; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int ii = 0; ii < RI; ++ii) pv[ii] = ps[(ty + kTY * ii) * (BC + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int dd = tx + kTX * jj;
        vv[jj] = dd < D ? vs[c * D + dd] : 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < RI; ++ii)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[ii][jj] = fmaf(pv[ii], vv[jj], acc[ii][jj]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int r = ty + kTY * ii, i = i0 + r;
    if (i >= p.sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    const size_t base = at(p, kO, b, i, hq);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int dd = tx + kTX * jj;
      if (dd < D) o[base + dd] = from_f<T>(acc[ii][jj] / denom);
    }
    if (tx == 0)
      p.lse_out[((size_t)b * p.h + hq) * p.sq + i] = m_s[r] + logf(denom);
  }
}

// ----------------------------------------------------------------------- dQ
template <typename T, int DMAX, int RI, int CJ>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Args p) {
  constexpr int BR = kTY * RI, BC = kTX * CJ, DJ = DMAX / kTX;
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int i0 = blockIdx.x * BR, hq = blockIdx.y, b = blockIdx.z;
  const int kh = hq / (p.h / p.kvh);
  const int D = p.d, DP = D + 1;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const T* dop = static_cast<const T*>(p.dout);
  T* dq = static_cast<T*>(p.dq);

  extern __shared__ float smem[];
  float* qs = smem;                 // [BR][DP]
  float* dos = qs + BR * DP;        // [BR][DP]
  float* ks = dos + BR * DP;        // [BC][DP]
  float* vs = ks + BC * DP;         // [BC][DP]
  float* dss = vs + BC * DP;        // [BR][BC + 1]

  load_tile(p, q, kQ, b, hq, i0, BR, p.sq, qs, DP);
  load_tile(p, dop, kDO, b, hq, i0, BR, p.sq, dos, DP);
  int qpos[RI], qseg[RI];
  bool qlive[RI];
  float lse_r[RI], dl_r[RI];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int i = i0 + ty + kTY * ii;
    qlive[ii] = i < p.sq;
    const size_t row = ((size_t)b * p.h + hq) * p.sq + i;
    qpos[ii] = qlive[ii] ? qpos_of(p, b, i) : 0;
    qseg[ii] = qlive[ii] ? qseg_of(p, b, i) : 0;
    lse_r[ii] = qlive[ii] ? p.lse[row] : 0.f;
    dl_r[ii] = qlive[ii] ? p.delta[row] : 0.f;
  }
  const float slope = p.alibi ? p.alibi[hq] : 0.f;
  float acc[RI][DJ];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] = 0.f;

  int lo, hi;
  kv_range(p, i0, min(i0 + BR, p.sq), lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BC) {
    __syncthreads();
    load_tile(p, kp, kK, b, kh, j0, BC, hi, ks, DP);
    load_tile(p, vp, kV, b, kh, j0, BC, hi, vs, DP);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int ii = 0; ii < RI; ++ii)
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qv[RI], gv[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int ii = 0; ii < RI; ++ii) {
        qv[ii] = qs[(ty + kTY * ii) * DP + dd];
        gv[ii] = dos[(ty + kTY * ii) * DP + dd];
      }
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        kv[jj] = ks[(tx + kTX * jj) * DP + dd];
        vv[jj] = vs[(tx + kTX * jj) * DP + dd];
      }
#pragma unroll
      for (int ii = 0; ii < RI; ++ii)
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
          dp[ii][jj] = fmaf(gv[ii], vv[jj], dp[ii][jj]);
        }
    }
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const int c = tx + kTX * jj, j = j0 + c;
      const bool jlive = j < hi;
      const int kpos = jlive ? kpos_of(p, b, j) : 0;
      const int kseg = jlive ? kseg_of(p, b, j) : 0;
#pragma unroll
      for (int ii = 0; ii < RI; ++ii) {
        const bool ok = jlive && qlive[ii] &&
                        visible(p, qpos[ii], kpos, qseg[ii], kseg);
        const float x = s[ii][jj] * p.scale +
                        slope * (float)(kpos - qpos[ii]);
        const float pr = ok ? expf(x - lse_r[ii]) : 0.f;
        dss[(ty + kTY * ii) * (BC + 1) + c] = pr * (dp[ii][jj] - dl_r[ii]);
      }
    }
    __syncthreads();

    const int cn = min(BC, hi - j0);
    for (int c = 0; c < cn; ++c) {
      float dsv[RI], kv[DJ];
#pragma unroll
      for (int ii = 0; ii < RI; ++ii) dsv[ii] = dss[(ty + kTY * ii) * (BC + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int dd = tx + kTX * jj;
        kv[jj] = dd < D ? ks[c * DP + dd] : 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < RI; ++ii)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[ii][jj] = fmaf(dsv[ii], kv[jj], acc[ii][jj]);
    }
  }

#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int i = i0 + ty + kTY * ii;
    if (i >= p.sq) continue;
    const size_t base = at(p, kDQ, b, i, hq);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int dd = tx + kTX * jj;
      if (dd < D) dq[base + dd] = from_f<T>(acc[ii][jj] * p.scale);
    }
  }
}

// -------------------------------------------------------------------- dK/dV
// Rows of the thread tile are keys (RI), columns are queries (CJ).
template <typename T, int DMAX, int RI, int CJ>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Args p) {
  constexpr int BR = kTY * RI, BC = kTX * CJ, DJ = DMAX / kTX;
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int j0 = blockIdx.x * BR, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.h / p.kvh;
  const int D = p.d, DP = D + 1;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const T* dop = static_cast<const T*>(p.dout);
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);

  extern __shared__ float smem[];
  float* ks = smem;                   // [BR][DP]
  float* vs = ks + BR * DP;           // [BR][DP]
  float* qs = vs + BR * DP;           // [BC][DP]
  float* dos = qs + BC * DP;          // [BC][DP]
  float* pss = dos + BC * DP;         // [BR][BC + 1]
  float* dss = pss + BR * (BC + 1);   // [BR][BC + 1]
  float* lse_s = dss + BR * (BC + 1); // [BC]
  float* dl_s = lse_s + BC;           // [BC]
  int* qpos_s = reinterpret_cast<int*>(dl_s + BC);  // [BC]
  int* qseg_s = qpos_s + BC;                        // [BC]

  load_tile(p, kp, kK, b, kh, j0, BR, p.skv, ks, DP);
  load_tile(p, vp, kV, b, kh, j0, BR, p.skv, vs, DP);
  int kpos[RI], kseg[RI];
  bool klive[RI];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int j = j0 + ty + kTY * ii;
    klive[ii] = j < p.skv;
    kpos[ii] = klive[ii] ? kpos_of(p, b, j) : 0;
    kseg[ii] = klive[ii] ? kseg_of(p, b, j) : 0;
  }
  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc_k[ii][jj] = acc_v[ii][jj] = 0.f;

  int lo, hi;
  q_range(p, j0, min(j0 + BR, p.skv), lo, hi);
  for (int g = 0; g < G; ++g) {
    const int hq = kh * G + g;
    const float slope = p.alibi ? p.alibi[hq] : 0.f;
    for (int i0 = lo; i0 < hi; i0 += BC) {
      __syncthreads();
      load_tile(p, q, kQ, b, hq, i0, BC, hi, qs, DP);
      load_tile(p, dop, kDO, b, hq, i0, BC, hi, dos, DP);
      for (int c = tid; c < BC; c += kThreads) {
        const int i = i0 + c;
        const bool live = i < hi;
        const size_t row = ((size_t)b * p.h + hq) * p.sq + i;
        lse_s[c] = live ? p.lse[row] : 0.f;
        dl_s[c] = live ? p.delta[row] : 0.f;
        qpos_s[c] = live ? qpos_of(p, b, i) : 0;
        qseg_s[c] = live ? qseg_of(p, b, i) : 0;
      }
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int ii = 0; ii < RI; ++ii)
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
      for (int dd = 0; dd < D; ++dd) {
        float kv[RI], vv[RI], qv[CJ], gv[CJ];
#pragma unroll
        for (int ii = 0; ii < RI; ++ii) {
          kv[ii] = ks[(ty + kTY * ii) * DP + dd];
          vv[ii] = vs[(ty + kTY * ii) * DP + dd];
        }
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          qv[jj] = qs[(tx + kTX * jj) * DP + dd];
          gv[jj] = dos[(tx + kTX * jj) * DP + dd];
        }
#pragma unroll
        for (int ii = 0; ii < RI; ++ii)
#pragma unroll
          for (int jj = 0; jj < CJ; ++jj) {
            s[ii][jj] = fmaf(kv[ii], qv[jj], s[ii][jj]);
            dp[ii][jj] = fmaf(vv[ii], gv[jj], dp[ii][jj]);
          }
      }
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const int c = tx + kTX * jj;
        const bool ilive = i0 + c < hi;
#pragma unroll
        for (int ii = 0; ii < RI; ++ii) {
          const bool ok = ilive && klive[ii] &&
                          visible(p, qpos_s[c], kpos[ii], qseg_s[c], kseg[ii]);
          const float x = s[ii][jj] * p.scale +
                          slope * (float)(kpos[ii] - qpos_s[c]);
          const float pr = ok ? expf(x - lse_s[c]) : 0.f;
          const int e = (ty + kTY * ii) * (BC + 1) + c;
          pss[e] = pr;
          dss[e] = pr * (dp[ii][jj] - dl_s[c]);
        }
      }
      __syncthreads();

      const int cn = min(BC, hi - i0);
      for (int c = 0; c < cn; ++c) {
        float pv[RI], dsv[RI], gv[DJ], qv[DJ];
#pragma unroll
        for (int ii = 0; ii < RI; ++ii) {
          const int e = (ty + kTY * ii) * (BC + 1) + c;
          pv[ii] = pss[e];
          dsv[ii] = dss[e];
        }
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const int dd = tx + kTX * jj;
          gv[jj] = dd < D ? dos[c * DP + dd] : 0.f;
          qv[jj] = dd < D ? qs[c * DP + dd] : 0.f;
        }
#pragma unroll
        for (int ii = 0; ii < RI; ++ii)
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj) {
            acc_v[ii][jj] = fmaf(pv[ii], gv[jj], acc_v[ii][jj]);
            acc_k[ii][jj] = fmaf(dsv[ii], qv[jj], acc_k[ii][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int j = j0 + ty + kTY * ii;
    if (j >= p.skv) continue;
    const size_t bk = at(p, kDK, b, j, kh), bv = at(p, kDV, b, j, kh);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int dd = tx + kTX * jj;
      if (dd < D) {
        dk[bk + dd] = from_f<T>(acc_k[ii][jj] * p.scale);
        dv[bv + dd] = from_f<T>(acc_v[ii][jj]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// shared memory in floats for a D-wide head
template <int RI, int CJ>
size_t smem_bytes(Kind kind, int d) {
  const size_t BR = kTY * RI, BC = kTX * CJ, DP = d + 1;
  size_t f = 0;
  if (kind == kFwd) f = BR * DP + BC * DP + BC * d + BR * (BC + 1) + 3 * BR;
  if (kind == kDq) f = 2 * BR * DP + 2 * BC * DP + BR * (BC + 1);
  if (kind == kDkv) f = 2 * BR * DP + 2 * BC * DP + 2 * BR * (BC + 1) + 4 * BC;
  return f * sizeof(float);
}

template <int KIND, typename T, int DMAX, int RI, int CJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  void (*kernel)(const Args);
  if constexpr (KIND == kFwd) kernel = flash_fwd_kernel<T, DMAX, RI, CJ>;
  else if constexpr (KIND == kDq) kernel = flash_dq_kernel<T, DMAX, RI, CJ>;
  else kernel = flash_dkv_kernel<T, DMAX, RI, CJ>;
  const size_t smem = smem_bytes<RI, CJ>(static_cast<Kind>(KIND), a.d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = KIND == kDkv ? a.skv : a.sq;
  const int heads = KIND == kDkv ? a.kvh : a.h;
  const dim3 grid((rows + kTY * RI - 1) / (kTY * RI), heads, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Tile shapes: 64 x 64 up to D = 128; at D = 256 the dQ kernel walks 32
// keys per tile and the dK/dV kernel owns 32 keys, to stay inside the
// 227 KB of shared memory a CTA may use.
template <int KIND, typename T, int DMAX>
cudaError_t dispatch_shape(const Args& a, cudaStream_t s) {
  if constexpr (DMAX <= 128 || KIND == kFwd)
    return launch<KIND, T, DMAX, 4, 4>(a, s);
  else if constexpr (KIND == kDq)
    return launch<KIND, T, DMAX, 4, 2>(a, s);
  else
    return launch<KIND, T, DMAX, 2, 4>(a, s);
}

template <int KIND, typename T>
cudaError_t dispatch_dim(const Args& a, cudaStream_t s) {
  if (a.d <= 64) return dispatch_shape<KIND, T, 64>(a, s);
  if (a.d <= 128) return dispatch_shape<KIND, T, 128>(a, s);
  return dispatch_shape<KIND, T, 256>(a, s);
}

template <int KIND>
cudaError_t dispatch_type(const Args& a, int dtype, cudaStream_t s) {
  if (dtype == 0) return dispatch_dim<KIND, float>(a, s);
  if (dtype == 1) return dispatch_dim<KIND, __nv_bfloat16>(a, s);
  return dispatch_dim<KIND, __half>(a, s);
}

int run(Kind kind, Args& a, const long long* strides, int b, int sq, int skv,
        int h, int kvh, int d, int causal, int window, float scale,
        int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 ||
      d > 256 || dtype < 0 || dtype > 2 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < kNumOperands; ++t)
    for (int x = 0; x < 3; ++x) a.st[t][x] = strides[3 * t + x];
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.h = h;
  a.kvh = kvh;
  a.d = d;
  a.causal = causal;
  a.window = window;
  a.offset = skv - sq;
  a.default_pos = a.pos_q == nullptr && a.pos_k == nullptr;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kFwd) return (int)dispatch_type<kFwd>(a, dtype, s);
  if (kind == kDq) return (int)dispatch_type<kDq>(a, dtype, s);
  return (int)dispatch_type<kDkv>(a, dtype, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 24 int64, the
// (batch, seq, head) element strides of q, k, v, o, do, dq, dk, dv in that
// order (entries of operands a kernel does not use are ignored). Null
// seg/pos/alibi pointers take the defaults. window <= 0: none. Each returns
// a cudaError_t (0 = launched).
int dsst_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* seg_q, const int* seg_k,
                   const int* pos_q, const int* pos_k, const float* alibi,
                   const long long* strides, int b, int sq, int skv, int h,
                   int kvh, int d, int causal, int window, float scale,
                   int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
  a.seg_q = seg_q;
  a.seg_k = seg_k;
  a.pos_q = pos_q;
  a.pos_k = pos_k;
  a.alibi = alibi;
  return run(kFwd, a, strides, b, sq, skv, h, kvh, d, causal, window, scale,
             dtype, stream);
}

int dsst_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, const int* seg_q, const int* seg_k,
                  const int* pos_q, const int* pos_k, const float* alibi,
                  const long long* strides, int b, int sq, int skv, int h,
                  int kvh, int d, int causal, int window, float scale,
                  int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.seg_q = seg_q;
  a.seg_k = seg_k;
  a.pos_q = pos_q;
  a.pos_k = pos_k;
  a.alibi = alibi;
  return run(kDq, a, strides, b, sq, skv, h, kvh, d, causal, window, scale,
             dtype, stream);
}

int dsst_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, const int* seg_q, const int* seg_k,
                   const int* pos_q, const int* pos_k, const float* alibi,
                   const long long* strides, int b, int sq, int skv, int h,
                   int kvh, int d, int causal, int window, float scale,
                   int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.seg_q = seg_q;
  a.seg_k = seg_k;
  a.pos_q = pos_q;
  a.pos_k = pos_k;
  a.alibi = alibi;
  return run(kDkv, a, strides, b, sq, skv, h, kvh, d, causal, window, scale,
             dtype, stream);
}

const char* dsst_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
