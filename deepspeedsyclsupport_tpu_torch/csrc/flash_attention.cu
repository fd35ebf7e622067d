// Flash attention for Hopper (sm_90a), CUDA C++: forward, dQ, dK/dV and the
// reduced pair-bias gradient.
//
// Replaces the four Pallas TPU kernels of
// deepspeedsyclsupport_tpu/ops/flash_attention.py:
//   flash_fwd_sm90_kernel (bfloat16, float16) and
//   flash_fwd_kernel (float32)
//                      <- _fwd_kernel   (:145), launched by _fwd_call (:481)
//   flash_dq_sm90_kernel (bfloat16, float16 at D <= 128) and
//   flash_dq_kernel (float32; bfloat16, float16 above D = 128)
//                      <- _dq_kernel    (:208), launched by _bwd_call (:535)
//   flash_dkv_sm90_kernel / flash_dkv_kernel, the same split
//                      <- _dkv_kernel   (:273), launched by _bwd_call (:535)
//   flash_dbias_sm90_kernel / flash_dbias_kernel, the same split
//                      <- _dbias_kernel (:330), launched by _dbias_call (:384)
//
// What they compute. q [B, Sq, H, D], k/v [B, Skv, KVH, D] and o/do/dq/dk/dv
// are read and written in place through (batch, seq, head) strides with a
// unit innermost stride: no transpose and no padding copy. Ragged edges
// (rows past Sq, columns past Skv) are masked in the kernels. Scores are
// s = scale * q.k (+ slope[q head] * (k_pos - q_pos) with ALiBi)
// (+ bias[b / rb, h / rh, i, j]) (+ kbias[b / rkb, j]), scale = 1/sqrt(D),
// in that order (`_bias`, `_add_biases`): a float32 pair bias [Bb, Hb, Sq,
// Skv] broadcast over contiguous groups of rb = B / Bb batches and rh = H / Hb
// heads, and a float32 k-row bias [Bk, Skv] over groups of rkb = B / Bk
// batches (the `_bias_specs` index maps). Entry (i, j) is visible iff
// seg_q[i] == seg_k[j] and, when causal, k_pos[j] <= q_pos[i] and (window)
// q_pos[i] - k_pos[j] < window: the Pallas `_mask` rules; with a block
// layout [Hl, nq, nkv] also layout[Hl > 1 ? h : 0, i / block_q, j / block_k]
// != 0, element by element (the Pallas kernel skips whole tiles, and its
// tile is the layout block; these kernels' 64 x 64 tiles are not, so the
// lookup is per element and a tile is skipped only when every layout block
// it touches is dead). Positions default to q_pos = i + (Skv - Sq),
// k_pos = j; segments default to 0. GQA: q head h reads kv head
// h / (H / KVH).
//   forward: O = softmax(s) V online in float32 (m from -1e30, l, acc),
//     LSE[b, h, i] = m + log(max(l, 1e-30)); a row with nothing visible
//     (or only -inf biases) gets O = 0 and LSE ~ -1e30, as the Pallas
//     kernel does.
//   dQ: p = visible ? exp(s - LSE) : 0, dp = dO.V^T, ds = p (dp - delta),
//     dQ = scale * ds K, with delta = rowsum(dO * O) computed by the caller.
//     Optionally it also writes ds, the gradient of a full-shape pair bias,
//     into a float32 [B, H, Sq, Skv] buffer the caller zero-filled (tiles
//     it skips stay zero, as `_dq_kernel` zeroes its dead tiles).
//   dK/dV: the same p and ds, dV = p^T dO, dK = scale * ds^T Q, summed over
//     the G q heads of the kv head inside the kernel (the Pallas kernel
//     writes per-q-head fp32 dK/dV and group-sums outside).
//   dbias: the gradient of a broadcast pair bias, [Bb, Hb, Sq, Skv] float32,
//     = sum over the rb * rh (batch, head) replicas that read each bias entry
//     of p (dp - delta); the per-replica [B, H, Sq, Skv] tensor never reaches
//     memory (for the evoformer's pair bias, shared by N MSA rows).
// All products accumulate in float32; outputs are stored in the inputs'
// type (float32, bfloat16 or float16), LSE and dbias in float32.
//
// The bfloat16 / float16 forward, and their dQ, dK/dV and reducing dbias
// at D <= 128, are Hopper designs of their own (wgmma, TMA, mbarriers, warp
// specialisation): see flash_fwd_sm90_kernel, flash_dq_sm90_kernel and
// flash_dbias_sm90_kernel below. Design of the others (first, simple
// version). 256 threads as 16 x 16;
// each thread owns an RI x CJ tile of the score block and RI rows x D/16
// columns of its accumulators, as in csrc/paged_attention.cu.
//   forward (float32): one CTA per (q tile of 64 rows, q head, batch); walks the KV
//     tiles its rows can see (cut by causality and the window when the
//     positions are the default ones), online softmax per row in a warp.
//   dQ: one CTA per (q tile, q head, batch); walks the same KV range.
//   dK/dV: one CTA per (kv tile, kv head, batch); loops over the G q heads
//     of its kv head and the q tiles that can see its keys, and writes the
//     group sum once: no [B, H, S, D] fp32 intermediate and no atomics.
//   dbias: one CTA per (q tile, k tile, bias entry, chunk of replicas). The
//     TPU kernel's sequential replica grid axis becomes a loop inside the
//     CTA: for each replica of its chunk it loads the q, dO, K and V tiles,
//     recomputes s and dp, and adds p (dp - delta) to a 64 x 64 register
//     accumulator, then writes the tile once. The replicas are cut into
//     `chunks` fixed ranges, a count the wrapper takes from the shapes
//     alone, so that the grid fills the card (one chunk leaves ~1 wave of
//     288 CTAs at the evoformer MSA shape), and a second kernel sums the
//     chunks' partial tiles in chunk order. No atomics, so the same inputs
//     give the same bits on any card.
// Nothing crosses CTAs, so results do not depend on scheduling: the same
// inputs give the same bits (activation checkpointing relies on that).
// The biases are read from global memory per score element (coalesced
// along j), the layout per element from its small int32 table; with none
// of them a uniform per-tile branch takes an instance without those reads
// (per-element null tests cost the dK/dV kernel 5 %).
//
// What bounds it on an H100. At training lengths (S = 4096, D = 128)
// attention does ~S/2 flops per byte it must move, far above the card's
// ~295 flop/byte line: the bound is tensor-core flops (989 TFLOP/s
// bf16/fp16). The CUDA-core kernels run every product on the float32 cores
// (67 TFLOP/s peak) with operands staged in shared memory: no mma.sync or
// wgmma, no TMA or cp.async pipelining, no double buffering, one or two CTAs
// per SM (65-215 KB of shared memory), and dQ recomputes p and dp that the
// dK/dV kernel also computes (no fused single-pass backward). Those are the
// later PRs' work.
//
// What bounds the dbias kernel. At the evoformer MSA shape (B*N = 512 rows
// of S = 384, H = 8, D = 32, bf16) it must read q, k, v and dO once (4 x
// 100.7 MB, ~0.12 ms at 3.35 TB/s) and do 4 * D flops per visible (i, j),
// head and replica (77 GFLOP, ~0.08 ms at 989 TFLOP/s): bytes bound. The
// CUDA-core version (float32, D > 128) re-reads K and V per (q tile,
// replica) and runs its products on the CUDA cores like the others; neither
// version takes a block layout (the API refuses a layout with a broadcast
// bias, as the JAX package does), and both recompute p and dp that the dQ
// kernel also computes.
//
// Interface: one plain C function per kernel, loaded with ctypes. Each
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from
                   // cudaGetDriverEntryPoint: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90_common.cuh"

// The build compiles this source as DSST_PARTS units at once (ops/_build.py
// passes -DDSST_PART=k): unit k instantiates the launches of Kind k, and
// unit 3 also holds the C interface. Without DSST_PART one unit holds all.
#define DSST_PARTS 4
#ifdef DSST_PART
#define DSST_OWNS(k) (DSST_PART == (k))
#else
#define DSST_OWNS(k) 1
#endif

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
  const float* bias;     // pair bias [Bb, Hb, Sq, Skv] contiguous, or null
  const float* kbias;    // k-row bias [Bk, Skv] contiguous, or null
  const int* layout;     // block layout [Hl, lay_nq, lay_nkv], or null
  float* dbias;          // dQ: full-shape ds [B, H, Sq, Skv] (or null);
                         // dbias kernel: [chunks, Bb, Hb, Sq, Skv] partial
                         // sums (the result itself when chunks == 1)
  long long st[kNumOperands][3];  // (batch, seq, head) strides, elements
  int b, sq, skv, h, kvh, d;
  int causal, window;    // window <= 0: none
  int offset;            // Skv - Sq
  int default_pos;       // both position arrays null
  float scale;
  int bias_b, bias_h;    // Bb, Hb
  int bias_rb, bias_rh;  // B / Bb, H / Hb: (b, h) reads bias[b / rb, h / rh]
  int kbias_rb;          // B / Bk
  int lay_h, lay_nq, lay_nkv, lay_bq, lay_bk;  // Hl, blocks, block sizes
  int chunks;            // dbias kernel: replica chunks per bias entry
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

// What the scores of batch b and q head h get beyond the mask: the [Sq,
// Skv] pair-bias plane, the [Skv] k-row bias and the [nq, nkv] layout plane
// they read, each null when absent.
struct Extra {
  const float* bp;
  const float* kb;
  const int* lp;
  __device__ bool any() const { return bp || kb || lp; }
};
__device__ __forceinline__ Extra extra_of(const Args& p, int b, int h) {
  Extra e{nullptr, nullptr, nullptr};
  if (p.bias)
    e.bp = p.bias + ((size_t)(b / p.bias_rb) * p.bias_h + h / p.bias_rh) *
                        p.sq * p.skv;
  if (p.kbias) e.kb = p.kbias + (size_t)(b / p.kbias_rb) * p.skv;
  if (p.layout)
    e.lp = p.layout + (size_t)(p.lay_h > 1 ? h : 0) * p.lay_nq * p.lay_nkv;
  return e;
}
// Entry (i, j)'s score: x (scaled, +ALiBi) plus the biases in the order of
// the Pallas kernel, or -INFINITY where the mask (ok) or the layout hides
// it. Callers branch once per tile on Extra::any(), so the path without
// biases or a layout runs EXTRA = false and pays nothing per element.
template <bool EXTRA>
__device__ __forceinline__ float score(const Args& p, const Extra& e, bool ok,
                                       float x, int i, int j) {
  if constexpr (EXTRA) {
    if (!ok ||
        (e.lp && e.lp[(i / p.lay_bq) * p.lay_nkv + j / p.lay_bk] == 0))
      return -INFINITY;
    if (e.bp) x += e.bp[(size_t)i * p.skv + j];
    if (e.kb) x += e.kb[j];
    return x;
  } else {
    return ok ? x : -INFINITY;
  }
}
// s[ii][jj] (q . k of row i0 + ty + 16 ii, column j0 + tx + 16 jj) becomes
// that entry's score (see `score`), for the kernels whose thread tile rows
// are queries.
template <bool EXTRA, int RI, int CJ>
__device__ __forceinline__ void row_scores(const Args& p, const Extra& e,
                                           float (&s)[RI][CJ],
                                           const int (&qpos)[RI],
                                           const int (&qseg)[RI],
                                           const bool (&qlive)[RI],
                                           float slope, int b, int i0, int j0,
                                           int hi) {
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
#pragma unroll
  for (int jj = 0; jj < CJ; ++jj) {
    const int j = j0 + tx + kTX * jj;
    const bool jlive = j < hi;
    const int kpos = jlive ? kpos_of(p, b, j) : 0;
    const int kseg = jlive ? kseg_of(p, b, j) : 0;
#pragma unroll
    for (int ii = 0; ii < RI; ++ii) {
      const bool ok = jlive && qlive[ii] &&
                      visible(p, qpos[ii], kpos, qseg[ii], kseg);
      const float x = s[ii][jj] * p.scale + slope * (float)(kpos - qpos[ii]);
      s[ii][jj] = score<EXTRA>(p, e, ok, x, i0 + ty + kTY * ii, j);
    }
  }
}
// The same for the dK/dV kernel, whose thread tile rows are keys
// (j0 + ty + 16 ii) and columns queries (i0 + tx + 16 jj, their positions
// and segments in shared memory).
template <bool EXTRA, int RI, int CJ>
__device__ __forceinline__ void key_scores(const Args& p, const Extra& e,
                                           float (&s)[RI][CJ],
                                           const int (&kpos)[RI],
                                           const int (&kseg)[RI],
                                           const bool (&klive)[RI],
                                           const int* qpos_s,
                                           const int* qseg_s, float slope,
                                           int i0, int j0, int hi) {
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
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
      s[ii][jj] = score<EXTRA>(p, e, ok, x, i0 + c, j0 + ty + kTY * ii);
    }
  }
}
// Whether any layout block under the non-empty rows [i0, i1) x columns
// [j0, j1) is live; the same answer in every thread, so a CTA skips a tile
// as a whole.
__device__ __forceinline__ bool layout_tile_live(const Args& p, const int* lp,
                                                 int i0, int i1, int j0,
                                                 int j1) {
  if (lp == nullptr) return true;
  for (int bi = i0 / p.lay_bq; bi <= (i1 - 1) / p.lay_bq; ++bi)
    for (int bj = j0 / p.lay_bk; bj <= (j1 - 1) / p.lay_bk; ++bj)
      if (lp[bi * p.lay_nkv + bj] != 0) return true;
  return false;
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
  const Extra e = extra_of(p, b, hq);
  float acc[RI][DJ];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] = 0.f;

  int lo, hi;
  const int i1 = min(i0 + BR, p.sq);
  kv_range(p, i0, i1, lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BC) {
    if (!layout_tile_live(p, e.lp, i0, i1, j0, min(j0 + BC, hi))) continue;
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
    if (e.any())
      row_scores<true>(p, e, s, qpos, qseg, qlive, slope, b, i0, j0, hi);
    else
      row_scores<false>(p, e, s, qpos, qseg, qlive, slope, b, i0, j0, hi);
#pragma unroll
    for (int ii = 0; ii < RI; ++ii)
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj)
        ps[(ty + kTY * ii) * (BC + 1) + tx + kTX * jj] = s[ii][jj];
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
  const Extra e = extra_of(p, b, hq);
  float* dbp = p.dbias ? p.dbias + ((size_t)b * p.h + hq) * p.sq * p.skv
                       : nullptr;
  float acc[RI][DJ];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[ii][jj] = 0.f;

  int lo, hi;
  const int i1 = min(i0 + BR, p.sq);
  kv_range(p, i0, i1, lo, hi);
  for (int j0 = lo; j0 < hi; j0 += BC) {
    if (!layout_tile_live(p, e.lp, i0, i1, j0, min(j0 + BC, hi))) continue;
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
    if (e.any())
      row_scores<true>(p, e, s, qpos, qseg, qlive, slope, b, i0, j0, hi);
    else
      row_scores<false>(p, e, s, qpos, qseg, qlive, slope, b, i0, j0, hi);
#pragma unroll
    for (int ii = 0; ii < RI; ++ii)
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj)   // p = exp(s - LSE), 0 where hidden
        dss[(ty + kTY * ii) * (BC + 1) + tx + kTX * jj] =
            expf(s[ii][jj] - lse_r[ii]) * (dp[ii][jj] - dl_r[ii]);
    __syncthreads();

    const int cn = min(BC, hi - j0);
    if (dbp) {  // s = scaled qk + bias, so the bias gradient is ds itself
      for (int x = tid; x < BR * BC; x += kThreads) {
        const int r = x / BC, c = x % BC, i = i0 + r;
        if (i < p.sq && c < cn)
          dbp[(size_t)i * p.skv + j0 + c] = dss[r * (BC + 1) + c];
      }
    }
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
  const int j1 = min(j0 + BR, p.skv);
  q_range(p, j0, j1, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int hq = kh * G + g;
    const float slope = p.alibi ? p.alibi[hq] : 0.f;
    const Extra e = extra_of(p, b, hq);
    for (int i0 = lo; i0 < hi; i0 += BC) {
      if (!layout_tile_live(p, e.lp, i0, min(i0 + BC, hi), j0, j1)) continue;
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
      if (e.any())
        key_scores<true>(p, e, s, kpos, kseg, klive, qpos_s, qseg_s, slope,
                         i0, j0, hi);
      else
        key_scores<false>(p, e, s, kpos, kseg, klive, qpos_s, qseg_s, slope,
                          i0, j0, hi);
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const int c = tx + kTX * jj;
#pragma unroll
        for (int ii = 0; ii < RI; ++ii) {
          const float pr = expf(s[ii][jj] - lse_s[c]);  // 0 where hidden
          const int x = (ty + kTY * ii) * (BC + 1) + c;
          pss[x] = pr;
          dss[x] = pr * (dp[ii][jj] - dl_s[c]);
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

// ------------------------------------------------------------ reduced dbias
// One CTA per (q tile, k tile, bias entry (bb, hb), chunk); the replica loop
// runs over the chunk's share of the batches bb * rb + r / rh and q heads
// hb * rh + r % rh that read the entry, in a fixed order.
template <typename T, int RI, int CJ>
__global__ void __launch_bounds__(kThreads) flash_dbias_kernel(const Args p) {
  constexpr int BR = kTY * RI, BC = kTX * CJ;
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int i0 = blockIdx.x * BR, j0 = blockIdx.y * BC;
  const int entries = p.bias_b * p.bias_h;
  const int chunk = blockIdx.z / entries, entry = blockIdx.z % entries;
  const int bb = entry / p.bias_h, hb = entry % p.bias_h;
  const int G = p.h / p.kvh;
  const int D = p.d, DP = D + 1;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const T* dop = static_cast<const T*>(p.dout);

  extern __shared__ float smem[];
  float* qs = smem;                 // [BR][DP]
  float* dos = qs + BR * DP;        // [BR][DP]
  float* ks = dos + BR * DP;        // [BC][DP]
  float* vs = ks + BC * DP;         // [BC][DP]

  float acc[RI][CJ];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) acc[ii][jj] = 0.f;

  int lo, hi;
  kv_range(p, i0, min(i0 + BR, p.sq), lo, hi);
  const long long nrep = (long long)p.bias_rb * p.bias_rh;
  const int r0 = (int)(nrep * chunk / p.chunks);
  const int r1 = (int)(nrep * (chunk + 1) / p.chunks);
  // a tile outside the columns its rows can see is zero
  for (int r = r0; r < r1 && j0 + BC > lo && j0 < hi; ++r) {
    const int b = bb * p.bias_rb + r / p.bias_rh;
    const int hq = hb * p.bias_rh + r % p.bias_rh;
    const int kh = hq / G;
    const float slope = p.alibi ? p.alibi[hq] : 0.f;
    Extra e = extra_of(p, b, hq);
    e.lp = nullptr;  // no layout here (refused): its code folds away
    __syncthreads();  // the previous replica's readers are done
    load_tile(p, q, kQ, b, hq, i0, BR, p.sq, qs, DP);
    load_tile(p, dop, kDO, b, hq, i0, BR, p.sq, dos, DP);
    load_tile(p, kp, kK, b, kh, j0, BC, hi, ks, DP);
    load_tile(p, vp, kV, b, kh, j0, BC, hi, vs, DP);
    __syncthreads();

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
    row_scores<true>(p, e, s, qpos, qseg, qlive, slope, b, i0, j0, hi);
#pragma unroll
    for (int ii = 0; ii < RI; ++ii)
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj)   // p = exp(s - LSE), 0 where hidden
        acc[ii][jj] = fmaf(expf(s[ii][jj] - lse_r[ii]),
                           dp[ii][jj] - dl_r[ii], acc[ii][jj]);
  }

  float* out = p.dbias + ((size_t)chunk * entries + entry) * p.sq * p.skv;
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int i = i0 + ty + kTY * ii;
    if (i >= p.sq) continue;
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const int j = j0 + tx + kTX * jj;
      if (j < p.skv) out[(size_t)i * p.skv + j] = acc[ii][jj];
    }
  }
}

#if DSST_OWNS(3)
// out[e] = sum over the chunks c, in order, of part[c][e].
__global__ void __launch_bounds__(kThreads) flash_dbias_sum_kernel(
    const float* part, float* out, long long n, int chunks) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += part[c * n + e];
    out[e] = acc;
  }
}
#endif

// ------------------------------------------------ forward on Hopper (sm_90a)
// flash_fwd_sm90_kernel: the bfloat16 / float16 forward, with the Args,
// semantics and outputs of flash_fwd_kernel, which keeps float32 (TF32 would
// break the float32 contracts). Its products run on the tensor cores.
//   CTA: 128 q rows of one (q head, batch), three warpgroups. Warpgroups 0
//     and 1 consume, 64 rows each; one thread of warpgroup 2 issues every
//     copy. setmaxnreg moves registers from the producer (40 a thread) to
//     the consumers (232).
//   Shared memory: Q once and a two-stage ring of K and V tiles (BC = 128
//     keys up to DMAX 128, 64 at DMAX 256), all in T. A row is cut into
//     64-column (128-byte) chunks stored [chunk][row][64] with the 128-byte
//     swizzle: 80 KB at DMAX 64, 160 KB at 128, 192 KB at 256.
//   TMA: rank-4 tensor maps (D, head, seq, batch) over the caller's strides,
//     built on the host at each launch. Rows past S and columns past D
//     arrive as zeros, so ragged S and any D <= DMAX need no masked loads.
//     One full and one empty mbarrier per stage.
//   S = Q K^T: wgmma m64n{BC}k16, both operands K-major in shared memory.
//   Scores: scale, ALiBi, biases, layout and mask on the accumulator
//     fragment (a thread owns two rows and one column pair of every 8)
//     through visible() and score<EXTRA>(). A tile that every row of the
//     warpgroup sees whole, with default positions and no segments, ALiBi,
//     biases or layout, only takes the scale: only diagonal and edge tiles
//     mask. Online softmax in registers: the row max over the 4 threads of
//     a row with two shuffles; the row sum stays per thread until the end.
//   O += P V: P in registers is wgmma's A operand (the S fragment of 16
//     columns is the A fragment of one k step) as two operands, hi = T(P)
//     and lo = T(P - hi), into the same accumulator; V is an MN-major B
//     operand in shared memory (the transpose bit).
// The split keeps ~16 bits of P where one operand in T would keep 8 (bf16)
// or 11 (fp16): the reference keeps P in float32, and a P rounded to T
// moves the end-to-end dQ through delta (ROADMAP C2). It costs one more
// sweep of P V.
// Nothing crosses CTAs: the same inputs give the same bits. Bound at
// llama2-1b (S = 4096, D = 128, causal): 137 GFLOP on the tensor cores,
// 0.139 ms at 989 TFLOP/s. Only the two warpgroups overlap
// each other's softmax with products; a warpgroup waits for its own S
// before its softmax and for its P V before the next tile. Left for later:
// ordering the two warpgroups' products with named barriers, a persistent
// grid, biases and layouts read per tile rather than per element.
constexpr int kFwdThreads = 384;     // 2 consumer warpgroups + the producer's
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;   // 128 x 40 + 256 x 232 <= 65536
constexpr float kLog2e = 1.4426950408889634f;

template <int DMAX>
struct FwdTiles {
  static constexpr int BR = 128;                      // q rows
  static constexpr int BC = DMAX <= 128 ? 128 : 64;   // keys per tile
  static constexpr int CH = DMAX / 64;                // 128-byte row chunks
  static constexpr int Q_BYTES = CH * BR * 128;
  static constexpr int KV_BYTES = CH * BC * 128;      // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 4 * KV_BYTES;   // 2 x (K, V)
  // barriers: q full, full[2], empty[2]; 1024 for the swizzle's alignment
  static constexpr int SMEM = BAR_OFF + 5 * 8 + 1024;
};

// Row row of an m64nN accumulator fragment (acc[4 jb + 2 rr + c] is column
// 8 jb + 2 t4 + c), times mul, in T into the first d columns of `out`;
// pairs when the row is 4-byte aligned.
template <typename T, int N>
__device__ __forceinline__ void store_fragment_row(T* out,
                                                   const float (&acc)[N],
                                                   int rr, int t4, int d,
                                                   float mul, bool pairs) {
#pragma unroll
  for (int jb = 0; jb < N / 4; ++jb) {
    const int c = 8 * jb + 2 * t4;
    const float x0 = acc[4 * jb + 2 * rr] * mul;
    const float x1 = acc[4 * jb + 2 * rr + 1] * mul;
    if (pairs && c + 1 < d) {
      *reinterpret_cast<uint32_t*>(out + c) = pack2<T>(x0, x1);
    } else {
      if (c < d) out[c] = from_f<T>(x0);
      if (c + 1 < d) out[c + 1] = from_f<T>(x1);
    }
  }
}

// Whether output t can be stored in pairs of T (4-byte aligned rows).
__device__ __forceinline__ bool pair_aligned(const void* base, const Args& p,
                                             int t) {
  return reinterpret_cast<uintptr_t>(base) % 4 == 0 && p.st[t][0] % 2 == 0 &&
         p.st[t][1] % 2 == 0 && p.st[t][2] % 2 == 0;
}

// The scores of one S fragment: s[4 jb + 2 rr + c] is q . k of row
// row0 + 8 rr and column j0 + 8 jb + 2 t4 + c.
template <bool EXTRA, int N>
__device__ __forceinline__ void fragment_scores(
    const Args& p, const Extra& e, float (&s)[N], const int (&qpos)[2],
    const int (&qseg)[2], const bool (&qlive)[2], float slope, int b,
    int row0, int j0, int hi, int t4) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const int jb = x / 2, c = x % 2;
    const int j = j0 + 8 * jb + 2 * t4 + c;
    const bool jlive = j < hi;
    const int kpos = jlive ? kpos_of(p, b, j) : 0;
    const int kseg = jlive ? kseg_of(p, b, j) : 0;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float& v = s[4 * jb + 2 * rr + c];
      const bool ok = jlive && qlive[rr] &&
                      visible(p, qpos[rr], kpos, qseg[rr], kseg);
      const float xv = v * p.scale + slope * (float)(kpos - qpos[rr]);
      v = score<EXTRA>(p, e, ok, xv, row0 + 8 * rr, j);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_fwd_sm90_kernel(
    const Args p, const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  using L = FwdTiles<DMAX>;
  constexpr int BR = L::BR, BC = L::BC, CH = L::CH;
  constexpr int OH = DMAX > 128 ? 2 : 1;          // P V products per k step
  constexpr int OW = (DMAX > 128 ? 128 : DMAX) / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + L::Q_BYTES;          // [stage][chunk][BC][64]
  const uint32_t v_s = k_s + 2 * L::KV_BYTES;
  const uint32_t bar_q = q_s + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 24;   // + 8 s

  // the longest causal rows first: q tiles in reverse, each over every
  // (head, batch)
  const int per_tile = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
  const int qt = gridDim.x - 1 - lin / per_tile;
  const int hq = lin % per_tile % gridDim.y, b = lin % per_tile / gridDim.y;
  const int i0 = qt * BR, i1 = min(i0 + BR, p.sq);
  const int kh = hq / (p.h / p.kvh);
  const Extra e = extra_of(p, b, hq);
  // chunks holding columns < D: the others are neither loaded nor multiplied
  // (their shared memory is never read into a written output)
  const int chl = (p.d + 63) / 64;
  int lo, hi;
  kv_range(p, i0, i1, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, chl * BR * 128);
      for (int c = 0; c < chl; ++c)
        tma_load(q_s + c * BR * 128, &tq, bar_q, 64 * c, hq, i0, b);
      int t = 0;
      for (int j0 = lo; j0 < hi; j0 += BC) {
        if (!layout_tile_live(p, e.lp, i0, i1, j0, min(j0 + BC, hi)))
          continue;
        const int s = t & 1, round = t >> 1;
        if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * chl * BC * 128);
        for (int c = 0; c < chl; ++c) {
          const uint32_t off = s * L::KV_BYTES + c * BC * 128;
          tma_load(k_s + off, &tk, full, 64 * c, kh, j0, b);
          tma_load(v_s + off, &tv, full, 64 * c, kh, j0, b);
        }
        ++t;
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wr0 = i0 + 64 * wg;                 // the warpgroup's rows
    const int row0 = wr0 + 16 * warp + g;         // mine: row0, row0 + 8
    int qpos[2], qseg[2];
    bool qlive[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = row0 + 8 * rr;
      qlive[rr] = i < p.sq;
      qpos[rr] = qlive[rr] ? qpos_of(p, b, i) : 0;
      qseg[rr] = qlive[rr] ? qseg_of(p, b, i) : 0;
    }
    const float slope = p.alibi ? p.alibi[hq] : 0.f;
    const bool plain = p.default_pos && p.seg_q == nullptr &&
                       p.alibi == nullptr && !e.any();
    float s[BC / 2], o[OH][OW];
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int h = 0; h < OH; ++h)
#pragma unroll
      for (int i = 0; i < OW; ++i) o[h][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t q_wg = q_s + wg * 64 * 128;

    mbar_wait(bar_q, 0);
    int t = 0;
    for (int j0 = lo; j0 < hi; j0 += BC) {
      if (!layout_tile_live(p, e.lp, i0, i1, j0, min(j0 + BC, hi))) continue;
      const int st = t & 1;
      mbar_wait(bar_full + 8 * st, (t >> 1) & 1);
      const uint32_t ks = k_s + st * L::KV_BYTES, vs = v_s + st * L::KV_BYTES;

      wg_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)      // 16 columns of D per step
          if (c < chl)
            wgmma_ss<T, BC>(
                s, sw128_desc(q_wg + c * BR * 128 + kk * 32, 16, 1024),
                sw128_desc(ks + c * BC * 128 + kk * 32, 16, 1024),
                c + kk > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      const bool whole =
          plain && wr0 + 64 <= p.sq && j0 + BC <= hi &&
          (!p.causal || j0 + BC - 1 <= wr0 + p.offset) &&
          (p.window <= 0 || wr0 + 63 + p.offset - j0 < p.window);
      if (whole) {
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) s[i] *= p.scale;
      } else if (e.any()) {
        fragment_scores<true>(p, e, s, qpos, qseg, qlive, slope, b, row0, j0,
                              hi, t4);
      } else {
        fragment_scores<false>(p, e, s, qpos, qseg, qlive, slope, b, row0,
                               j0, hi, t4);
      }

      // online softmax; s[i] belongs to row rr = (i / 2) % 2
      float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < BC / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        alpha[rr] = exp2f((m[rr] - mx[rr]) * kLog2e);
        m[rr] = mx[rr];
      }
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {   // exp2(-inf) = 0 where hidden
        s[i] = exp2f((s[i] - mx[(i >> 1) & 1]) * kLog2e);
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + sum[rr];
#pragma unroll
      for (int h = 0; h < OH; ++h)
#pragma unroll
        for (int i = 0; i < OW; ++i) o[h][i] *= alpha[(i >> 1) & 1];

      // P in T: the S fragment of columns [16 kk, 16 kk + 16) is the A
      // fragment of k step kk; P as hi + lo, two products
      uint32_t pa[BC / 16][4], pl[BC / 16][4];
      pack_split<T>(pa, pl, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)   // 16 keys per step
#pragma unroll
        for (int h = 0; h < OH; ++h)         // 128 columns of D per product
          wgmma_rs<T, 2 * OW>(
              o[h], pa[kk],
              sw128_desc(vs + kk * 16 * 128 + h * 2 * BC * 128, BC * 128,
                         1024));
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
        for (int h = 0; h < OH; ++h)
          wgmma_rs<T, 2 * OW>(
              o[h], pl[kk],
              sw128_desc(vs + kk * 16 * 128 + h * 2 * BC * 128, BC * 128,
                         1024));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int h = 0; h < OH; ++h) fence_regs(o[h]);
      mbar_arrive(bar_empty + 8 * st);
      ++t;
    }

    // O / max(l, 1e-30) in T through the output strides, LSE
    T* out = static_cast<T*>(p.o);
    const bool pairs = pair_aligned(out, p, kO);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      const int i = row0 + 8 * rr;
      if (!qlive[rr]) continue;
      const float denom = fmaxf(l[rr], 1e-30f);
      T* row = out + at(p, kO, b, i, hq);
#pragma unroll
      for (int h = 0; h < OH; ++h)
#pragma unroll
        for (int jb = 0; jb < OW / 4; ++jb) {
          const int c = 128 * h + 8 * jb + 2 * t4;
          const float x0 = o[h][4 * jb + 2 * rr] / denom;
          const float x1 = o[h][4 * jb + 2 * rr + 1] / denom;
          if (pairs && c + 1 < p.d) {
            *reinterpret_cast<uint32_t*>(row + c) = pack2<T>(x0, x1);
          } else {
            if (c < p.d) row[c] = from_f<T>(x0);
            if (c + 1 < p.d) row[c + 1] = from_f<T>(x1);
          }
        }
      if (t4 == 0)
        p.lse_out[((size_t)b * p.h + hq) * p.sq + i] = m[rr] + logf(denom);
    }
  }
}

// ----------------------------------------------- backward on Hopper (sm_90a)
// flash_dq_sm90_kernel and flash_dkv_sm90_kernel: the bfloat16 / float16
// backward at D <= 128 (bwd_on_sm90), with the Args, semantics and outputs
// of flash_dq_kernel and flash_dkv_kernel, which keep float32 (TF32 would
// break the float32 contracts) and D > 128 (at DMAX 256 dK and dV alone
// would be 256 float32 registers a thread). Built like the forward: 384
// threads, warpgroups 0 and 1 consume 64 rows each, one thread (dQ) or one
// warp (dK/dV) of warpgroup 2 fills the ring; setmaxnreg 40 / 232; tiles in
// T as 64-column (128-byte) chunks [chunk][row][64] with the 128-byte
// swizzle, loaded by TMA; one full and one empty mbarrier per stage.
//   dQ: 128 q rows of one (q head, batch), q tiles in reverse (the long
//     causal rows first). Q and dO are loaded once, LSE and delta of the two
//     rows a thread owns go to registers, and a two-stage ring brings K and
//     V in tiles of BC = 64 keys over kv_range. Per tile: S = Q K^T and dP =
//     dO V^T (wgmma, both operands K-major); the scores on the fragment as
//     in the forward (a whole tile only takes the scale); P = exp(s - LSE)
//     and dS = P (dP - delta) in registers, dS stored in float32 to the
//     full-shape dbias when asked; dQ += dS K with dS as hi + lo register
//     A operands in T and K read MN-major (the forward's V).
//   dK/dV: 128 keys of one (kv head, batch), key tiles in order (tile 0 has
//     the most q tiles under causality). K and V are loaded once; a
//     two-stage ring brings (Q, dO) tiles of BQ = 64 q rows over the G q
//     heads of the kv head and q_range, and the producer warp stores those
//     rows' LSE and delta into the stage. Per tile: S^T = K Q^T and dP^T =
//     V dO^T (all four K-major as stored); the scores on a
//     fragment whose rows are keys and columns queries
//     (fragment_key_scores); then dV += P^T dO and dK += dS^T Q with P^T and
//     dS^T as register A operands, dO and Q read MN-major. The group sum
//     stays in the CTA's registers; keys no query sees are written as
//     zeros.
// P and dS go into the three products as hi + lo operands in T, as the
// forward's P does, since the reference keeps both in float32: one more
// sweep of dQ, dV and dK (8 D and 12 D flops per pair for dQ and dK/dV
// instead of 6 D and 8 D). Nothing crosses CTAs and
// every sum runs in a fixed order, so the same inputs give the same bits: no
// dQ atomics, hence no fused single-pass backward (10 D flops per pair
// against these kernels' 14 D) until dQ can be accumulated in order.
// Bound at llama2-1b (S = 4096, D = 128, causal): 206 GFLOP (dQ) and 275
// GFLOP (dK/dV) on the tensor cores, 0.208 + 0.278 ms at 989 TFLOP/s. A
// warpgroup waits for its own products before each epilogue and before it
// releases a stage; only the two warpgroups overlap each other.
template <int DMAX>
struct BwdTiles {
  static constexpr int BR = 128;     // rows a CTA owns: q rows / keys
  static constexpr int BT = 64;      // rows of a ring tile: keys / q rows
  static constexpr int CH = DMAX / 64;
  static constexpr int OWN_BYTES = CH * BR * 128;   // Q, dO / K, V
  static constexpr int TILE_BYTES = CH * BT * 128;  // K, V / Q, dO
  // dK/dV: LSE and delta of each stage's rows, float [2 stages][BT] each
  static constexpr int ROWS_OFF = 2 * OWN_BYTES + 4 * TILE_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + 2 * 2 * BT * 4;
  // barriers: loaded-once full, full[2], empty[2]; 1024 for the swizzle
  static constexpr int SMEM = BAR_OFF + 5 * 8 + 1024;
};

// The scores of one S^T fragment (dK/dV): s[4 jb + 2 rr + c] is k . q of key
// key0 + 8 rr and query i0 + 8 jb + 2 t4 + c; queries at or past hi are
// hidden by index.
template <bool EXTRA, int N>
__device__ __forceinline__ void fragment_key_scores(
    const Args& p, const Extra& e, float (&s)[N], const int (&kpos)[2],
    const int (&kseg)[2], const bool (&klive)[2], float slope, int b,
    int key0, int i0, int hi, int t4) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const int jb = x / 2, c = x % 2;
    const int i = i0 + 8 * jb + 2 * t4 + c;
    const bool ilive = i < hi;
    const int qpos = ilive ? qpos_of(p, b, i) : 0;
    const int qseg = ilive ? qseg_of(p, b, i) : 0;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float& v = s[4 * jb + 2 * rr + c];
      const bool ok = ilive && klive[rr] &&
                      visible(p, qpos, kpos[rr], qseg, kseg[rr]);
      const float xv = v * p.scale + slope * (float)(kpos[rr] - qpos);
      v = score<EXTRA>(p, e, ok, xv, i, key0 + 8 * rr);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_dq_sm90_kernel(
    const Args p, const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  using L = BwdTiles<DMAX>;
  constexpr int BR = L::BR, BC = L::BT, CH = L::CH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + L::OWN_BYTES;
  const uint32_t k_s = do_s + L::OWN_BYTES;       // [stage][chunk][BC][64]
  const uint32_t v_s = k_s + 2 * L::TILE_BYTES;
  const uint32_t bar_q = q_s + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_q + 24;   // + 8 s

  // the longest causal rows first: q tiles in reverse, each over every
  // (head, batch)
  const int per_tile = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
  const int qt = gridDim.x - 1 - lin / per_tile;
  const int hq = lin % per_tile % gridDim.y, b = lin % per_tile / gridDim.y;
  const int i0 = qt * BR, i1 = min(i0 + BR, p.sq);
  const int kh = hq / (p.h / p.kvh);
  const Extra e = extra_of(p, b, hq);
  int lo, hi;
  kv_range(p, i0, i1, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, 2 * L::OWN_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load(q_s + c * BR * 128, &tq, bar_q, 64 * c, hq, i0, b);
        tma_load(do_s + c * BR * 128, &tdo, bar_q, 64 * c, hq, i0, b);
      }
      int t = 0;
      for (int j0 = lo; j0 < hi; j0 += BC) {
        if (!layout_tile_live(p, e.lp, i0, i1, j0, min(j0 + BC, hi)))
          continue;
        const int s = t & 1, round = t >> 1;
        if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::TILE_BYTES);
        for (int c = 0; c < CH; ++c) {
          const uint32_t off = s * L::TILE_BYTES + c * BC * 128;
          tma_load(k_s + off, &tk, full, 64 * c, kh, j0, b);
          tma_load(v_s + off, &tv, full, 64 * c, kh, j0, b);
        }
        ++t;
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wr0 = i0 + 64 * wg;                 // the warpgroup's rows
    const int row0 = wr0 + 16 * warp + g;         // mine: row0, row0 + 8
    int qpos[2], qseg[2];
    bool qlive[2];
    float lse[2], dl[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = row0 + 8 * rr;
      qlive[rr] = i < p.sq;
      const size_t row = ((size_t)b * p.h + hq) * p.sq + i;
      qpos[rr] = qlive[rr] ? qpos_of(p, b, i) : 0;
      qseg[rr] = qlive[rr] ? qseg_of(p, b, i) : 0;
      lse[rr] = qlive[rr] ? p.lse[row] : 0.f;
      dl[rr] = qlive[rr] ? p.delta[row] : 0.f;
    }
    const float slope = p.alibi ? p.alibi[hq] : 0.f;
    const bool plain = p.default_pos && p.seg_q == nullptr &&
                       p.alibi == nullptr && !e.any();
    float* dbp = p.dbias ? p.dbias + ((size_t)b * p.h + hq) * p.sq * p.skv
                         : nullptr;
    float s[BC / 2], dp[BC / 2], dq[DMAX / 2];
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) dq[i] = 0.f;
    const uint32_t q_wg = q_s + wg * 64 * 128, do_wg = do_s + wg * 64 * 128;

    mbar_wait(bar_q, 0);
    int t = 0;
    for (int j0 = lo; j0 < hi; j0 += BC) {
      if (!layout_tile_live(p, e.lp, i0, i1, j0, min(j0 + BC, hi))) continue;
      const int st = t & 1;
      mbar_wait(bar_full + 8 * st, (t >> 1) & 1);
      const uint32_t ks = k_s + st * L::TILE_BYTES;
      const uint32_t vs = v_s + st * L::TILE_BYTES;

      wg_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)      // 16 columns of D per step
          wgmma_ss<T, BC>(
              s, sw128_desc(q_wg + c * BR * 128 + kk * 32, 16, 1024),
              sw128_desc(ks + c * BC * 128 + kk * 32, 16, 1024), c + kk > 0);
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<T, BC>(
              dp, sw128_desc(do_wg + c * BR * 128 + kk * 32, 16, 1024),
              sw128_desc(vs + c * BC * 128 + kk * 32, 16, 1024), c + kk > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // s - LSE, then dS = P (dP - delta) into s; s[i] belongs to row
      // rr = (i / 2) % 2. LSE is subtracted before the scaling by log2(e):
      // a row whose visible scores carry a -1e9 bias has LSE ~ -1e9, and
      // s log2(e) - LSE log2(e) would lose the difference to rounding.
      const bool whole =
          plain && wr0 + 64 <= p.sq && j0 + BC <= hi &&
          (!p.causal || j0 + BC - 1 <= wr0 + p.offset) &&
          (p.window <= 0 || wr0 + 63 + p.offset - j0 < p.window);
      if (whole) {   // every row of the warpgroup sees the tile whole
#pragma unroll
        for (int i = 0; i < BC / 2; ++i)
          s[i] = fmaf(s[i], p.scale, -lse[(i >> 1) & 1]);
      } else {
        if (e.any())
          fragment_scores<true>(p, e, s, qpos, qseg, qlive, slope, b, row0,
                                j0, hi, t4);
        else
          fragment_scores<false>(p, e, s, qpos, qseg, qlive, slope, b, row0,
                                 j0, hi, t4);
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) s[i] -= lse[(i >> 1) & 1];
      }
#pragma unroll
      for (int i = 0; i < BC / 2; ++i)     // exp2(-inf) = 0 where hidden
        s[i] = exp2f(s[i] * kLog2e) * (dp[i] - dl[(i >> 1) & 1]);
      if (dbp) {  // s = scaled qk + bias, so the bias gradient is dS itself
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) {
          const int rr = (i >> 1) & 1;
          const int j = j0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (qlive[rr] && j < hi)
            dbp[(size_t)(row0 + 8 * rr) * p.skv + j] = s[i];
        }
      }
      uint32_t da[BC / 16][4], dlo[BC / 16][4];
      pack_split<T>(da, dlo, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)   // 16 keys per step
        wgmma_rs<T, DMAX>(dq, da[kk],
                          sw128_desc(ks + kk * 16 * 128, BC * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        wgmma_rs<T, DMAX>(dq, dlo[kk],
                          sw128_desc(ks + kk * 16 * 128, BC * 128, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(dq);
      mbar_arrive(bar_empty + 8 * st);
      ++t;
    }

    // dQ scale in T through the output strides
    T* out = static_cast<T*>(p.dq);
    const bool pairs = pair_aligned(out, p, kDQ);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (qlive[rr])
        store_fragment_row<T>(out + at(p, kDQ, b, row0 + 8 * rr, hq), dq,
                              rr, t4, p.d, p.scale, pairs);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_dkv_sm90_kernel(
    const Args p, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo) {
  using L = BwdTiles<DMAX>;
  constexpr int BR = L::BR, BQ = L::BT, CH = L::CH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + L::OWN_BYTES;
  const uint32_t q_s = v_s + L::OWN_BYTES;        // [stage][chunk][BQ][64]
  const uint32_t do_s = q_s + 2 * L::TILE_BYTES;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (k_s - raw) +
                                          L::ROWS_OFF);   // [stage][BQ]
  float* dl_s = lse_s + 2 * BQ;                           // [stage][BQ]
  const uint32_t bar_kv = k_s + L::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_kv + 24;

  // key tiles in order (tile 0 has the most q tiles under causality), each
  // over every (kv head, batch)
  const int per_tile = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
  const int kt = lin / per_tile;
  const int kh = lin % per_tile % gridDim.y, b = lin % per_tile / gridDim.y;
  const int j0 = kt * BR, j1 = min(j0 + BR, p.skv);
  const int G = p.h / p.kvh;
  int lo, hi;
  q_range(p, j0, j1, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 32);        // the producer warp
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::OWN_BYTES);
        for (int c = 0; c < CH; ++c) {
          tma_load(k_s + c * BR * 128, &tk, bar_kv, 64 * c, kh, j0, b);
          tma_load(v_s + c * BR * 128, &tv, bar_kv, 64 * c, kh, j0, b);
        }
      }
      int t = 0;
      for (int g = 0; g < G; ++g) {
        const int hq = kh * G + g;
        const Extra e = extra_of(p, b, hq);
        const size_t rows = ((size_t)b * p.h + hq) * p.sq;
        for (int i0 = lo; i0 < hi; i0 += BQ) {
          if (!layout_tile_live(p, e.lp, i0, min(i0 + BQ, hi), j0, j1))
            continue;
          const int s = t & 1, round = t >> 1;
          if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
          for (int r = lane; r < BQ; r += 32) {
            const int i = i0 + r;
            lse_s[s * BQ + r] = i < p.sq ? p.lse[rows + i] : 0.f;
            dl_s[s * BQ + r] = i < p.sq ? p.delta[rows + i] : 0.f;
          }
          const uint32_t full = bar_full + 8 * s;
          if (lane == 0) {   // its arrival carries the copies' bytes
            mbar_expect_tx(full, 2 * L::TILE_BYTES);
            for (int c = 0; c < CH; ++c) {
              const uint32_t off = s * L::TILE_BYTES + c * BQ * 128;
              tma_load(q_s + off, &tq, full, 64 * c, hq, i0, b);
              tma_load(do_s + off, &tdo, full, 64 * c, hq, i0, b);
            }
          } else {
            mbar_arrive(full);
          }
          ++t;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    const int g4 = lane / 4, t4 = lane % 4;
    const int kr0 = j0 + 64 * wg;                 // the warpgroup's keys
    const int key0 = kr0 + 16 * warp + g4;        // mine: key0, key0 + 8
    int kpos[2], kseg[2];
    bool klive[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = key0 + 8 * rr;
      klive[rr] = j < p.skv;
      kpos[rr] = klive[rr] ? kpos_of(p, b, j) : 0;
      kseg[rr] = klive[rr] ? kseg_of(p, b, j) : 0;
    }
    float s[BQ / 2], dp[BQ / 2], dk[DMAX / 2], dv[DMAX / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_wg = k_s + wg * 64 * 128, v_wg = v_s + wg * 64 * 128;

    mbar_wait(bar_kv, 0);
    int t = 0;
    for (int g = 0; g < G; ++g) {
      const int hq = kh * G + g;
      const float slope = p.alibi ? p.alibi[hq] : 0.f;
      const Extra e = extra_of(p, b, hq);
      const bool plain = p.default_pos && p.seg_q == nullptr &&
                         p.alibi == nullptr && !e.any();
      for (int i0 = lo; i0 < hi; i0 += BQ) {
        if (!layout_tile_live(p, e.lp, i0, min(i0 + BQ, hi), j0, j1))
          continue;
        const int st = t & 1;
        mbar_wait(bar_full + 8 * st, (t >> 1) & 1);
        const uint32_t qs = q_s + st * L::TILE_BYTES;
        const uint32_t dos = do_s + st * L::TILE_BYTES;

        wg_fence();
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<T, BQ>(
                s, sw128_desc(k_wg + c * BR * 128 + kk * 32, 16, 1024),
                sw128_desc(qs + c * BQ * 128 + kk * 32, 16, 1024),
                c + kk > 0);
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<T, BQ>(
                dp, sw128_desc(v_wg + c * BR * 128 + kk * 32, 16, 1024),
                sw128_desc(dos + c * BQ * 128 + kk * 32, 16, 1024),
                c + kk > 0);
        wg_commit();
        wg_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // a tile whose every query sees every key of the warpgroup only
        // takes the scale; LSE is subtracted before the scaling by log2(e)
        // (see the dQ kernel)
        const bool whole =
            plain && kr0 + 64 <= p.skv && i0 + BQ <= hi &&
            (!p.causal || i0 + p.offset >= kr0 + 63) &&
            (p.window <= 0 || i0 + BQ - 1 + p.offset - kr0 < p.window);
        if (!whole) {
          if (e.any())
            fragment_key_scores<true>(p, e, s, kpos, kseg, klive, slope, b,
                                      key0, i0, hi, t4);
          else
            fragment_key_scores<false>(p, e, s, kpos, kseg, klive, slope, b,
                                       key0, i0, hi, t4);
        }
        const float mul = whole ? p.scale : 1.f;
        // P^T into s, dS^T into dp; s[x] is query column 8 (x / 4) + 2 t4
        // + (x % 2) of the stage
        const float* ls = lse_s + st * BQ;
        const float* dls = dl_s + st * BQ;
#pragma unroll
        for (int x = 0; x < BQ / 2; ++x) {
          const int col = 8 * (x / 4) + 2 * t4 + (x & 1);
          s[x] = exp2f(fmaf(s[x], mul, -ls[col]) * kLog2e);  // 0 if hidden
          dp[x] = s[x] * (dp[x] - dls[col]);
        }
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        uint32_t pl[BQ / 16][4], dlo[BQ / 16][4];
        pack_split<T>(pa, pl, s);
        pack_split<T>(da, dlo, dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {   // 16 q rows per step
          wgmma_rs<T, DMAX>(dv, pa[kk],
                            sw128_desc(dos + kk * 16 * 128, BQ * 128, 1024));
          wgmma_rs<T, DMAX>(dk, da[kk],
                            sw128_desc(qs + kk * 16 * 128, BQ * 128, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs<T, DMAX>(dv, pl[kk],
                            sw128_desc(dos + kk * 16 * 128, BQ * 128, 1024));
          wgmma_rs<T, DMAX>(dk, dlo[kk],
                            sw128_desc(qs + kk * 16 * 128, BQ * 128, 1024));
        }
        wg_commit();
        wg_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        mbar_arrive(bar_empty + 8 * st);
        ++t;
      }
    }

    // dK scale and dV in T through the output strides (zeros for keys no
    // query sees: the wrapper does not fill them)
    T* dko = static_cast<T*>(p.dk);
    T* dvo = static_cast<T*>(p.dv);
    const bool kpairs = pair_aligned(dko, p, kDK);
    const bool vpairs = pair_aligned(dvo, p, kDV);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!klive[rr]) continue;
      const int j = key0 + 8 * rr;
      store_fragment_row<T>(dko + at(p, kDK, b, j, kh), dk, rr, t4, p.d,
                            p.scale, kpairs);
      store_fragment_row<T>(dvo + at(p, kDV, b, j, kh), dv, rr, t4, p.d,
                            1.f, vpairs);
    }
  }
}

// ------------------------------------------ reduced dbias on Hopper (sm_90a)
// flash_dbias_sm90_kernel: the bfloat16 / float16 reducing dbias at D <= 128
// (bwd_on_sm90), with the Args, semantics and output of flash_dbias_kernel,
// which keeps float32 (TF32 would break its 1e-4 contract) and D > 128.
//   CTA: 128 q rows by 64 keys of one bias entry (bb, hb) and one chunk of
//     its replicas; 384 threads: warpgroups 0 and 1 own 64 rows each, one
//     warp of warpgroup 2 fills the ring (setmaxnreg 40 / 232).
//   Replica loop, in order, inside the CTA (the counterpart of the Pallas
//     kernel's sequential innermost grid axis): the producer warp brings
//     each replica's Q and dO rows (boxes at (0, hq, i0, b)) and K and V
//     rows ((0, hq / G, j0, b)) by TMA into a ring of STAGES stages, and
//     stores the replica's LSE and delta of the 128 rows and its k-row bias
//     of the 64 keys into the stage beside them (BwdTiles::ROWS_OFF's way).
//   Products: S = Q K^T and dP = dO V^T by wgmma m64n64k16, both K-major as
//     stored, skipping the k steps wholly past D (D = 32: half of the
//     64-column chunk is the TMA's zero fill).
//   Scores on the fragment: the pair-bias tile is the same for every
//     replica of the CTA, so it is read once into registers before the
//     loop; the k-row bias comes from the stage. A tile every row of the
//     warpgroup sees whole (default positions, no segments or ALiBi) takes
//     s scale + bias + kbias; any other the mask rules of visible() per
//     element. Then s - LSE before the scaling by log2(e) (LSE ~ -1e9 under
//     -1e9 keys) and acc += p (dp - delta) in float32 registers: no dS
//     operand is rounded, so P and dS stay float32 as in the reference.
//   Chunks: the wrapper cuts each entry's replicas into a count of fixed
//     ranges taken from the shapes alone (dbias_chunks), and
//     flash_dbias_sum_kernel adds the chunks' partial tiles in chunk order:
//     the bits depend on the inputs and shapes only, on any card.
// A tile outside the keys its rows can see (kv_range) is written as zeros.
// Bound at the evoformer MSA shape (512 replicas of S = 384, H = 8, D =
// 32): 4 x 100.7 MB of q, k, v, dO read once, 0.127 ms at 3.35 TB/s; 4 D
// flops per (i, j, replica) on the tensor cores, 0.078 ms; 604 M exps at 16
// an SM a clock, ~0.15 ms; each CTA re-reads its replicas' tiles from L2
// (24 KB a replica, ~1.8 GB in all).
template <int DMAX>
struct DbiasTiles {
  static constexpr int BR = 128;     // q rows: two warpgroups of 64
  static constexpr int BC = 64;      // keys
  static constexpr int CH = DMAX / 64;
  static constexpr int STAGES = DMAX <= 64 ? 4 : 2;
  static constexpr int Q_BYTES = CH * BR * 128;      // Q or dO of a stage
  static constexpr int K_BYTES = CH * BC * 128;      // K or V of a stage
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 2 * K_BYTES;
  // per stage: LSE [BR], delta [BR], k-row bias [BC], float
  static constexpr int ROW_FLOATS = 2 * BR + BC;
  static constexpr int ROWS_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * ROW_FLOATS * 4;
  // barriers: full[STAGES], empty[STAGES]; 1024 for the swizzle
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_dbias_sm90_kernel(
    const Args p, const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  using L = DbiasTiles<DMAX>;
  constexpr int BR = L::BR, BC = L::BC, CH = L::CH, NS = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;    // [stage][q, dO, k, v]
  float* rows_s = reinterpret_cast<float*>(smem_raw + (ring - raw) +
                                           L::ROWS_OFF);  // [stage][rows]
  const uint32_t bar_full = ring + L::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * NS;

  const int i0 = blockIdx.x * BR, j0 = blockIdx.y * BC;
  const int i1 = min(i0 + BR, p.sq);
  const int entries = p.bias_b * p.bias_h;
  const int chunk = blockIdx.z / entries, entry = blockIdx.z % entries;
  const int bb = entry / p.bias_h, hb = entry % p.bias_h;
  const int G = p.h / p.kvh;
  const long long nrep = (long long)p.bias_rb * p.bias_rh;
  const int r0 = (int)(nrep * chunk / p.chunks);
  const int r1 = (int)(nrep * (chunk + 1) / p.chunks);
  int lo, hi;
  kv_range(p, i0, i1, lo, hi);
  // a tile outside the columns its rows can see is zero: no replica runs
  const bool live = j0 < hi && j0 + BC > lo;
  // k steps of 16 columns that hold columns < D
  const int ksteps = (p.d + 15) / 16;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 32);        // the producer warp
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x < 256 + 32 && live) {
      const int lane = threadIdx.x - 256;
      for (int r = r0, t = 0; r < r1; ++r, ++t) {
        const int b = bb * p.bias_rb + r / p.bias_rh;
        const int hq = hb * p.bias_rh + r % p.bias_rh;
        const int s = t % NS, round = t / NS;
        // every load of the replica's rows issued before any store (and
        // before the wait for the stage), so their latencies overlap: one
        // round trip to L2 a replica, not one per 32 rows
        const size_t rows = ((size_t)b * p.h + hq) * p.sq;
        const float* kb = p.kbias ? p.kbias + (size_t)(b / p.kbias_rb) *
                                                  p.skv
                                  : nullptr;
        float lv[BR / 32], dv[BR / 32], kv[BC / 32];
#pragma unroll
        for (int u = 0; u < BR / 32; ++u) {
          const int i = i0 + lane + 32 * u;
          lv[u] = i < p.sq ? p.lse[rows + i] : 0.f;
          dv[u] = i < p.sq ? p.delta[rows + i] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < BC / 32; ++u) {
          const int j = j0 + lane + 32 * u;
          kv[u] = kb && j < p.skv ? kb[j] : 0.f;
        }
        if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
        float* rs = rows_s + s * L::ROW_FLOATS;
#pragma unroll
        for (int u = 0; u < BR / 32; ++u) {
          rs[lane + 32 * u] = lv[u];
          rs[BR + lane + 32 * u] = dv[u];
        }
#pragma unroll
        for (int u = 0; u < BC / 32; ++u) rs[2 * BR + lane + 32 * u] = kv[u];
        const uint32_t full = bar_full + 8 * s;
        if (lane == 0) {   // its arrival carries the copies' bytes
          mbar_expect_tx(full, L::STAGE_BYTES);
          const uint32_t st = ring + s * L::STAGE_BYTES;
          const int kh = hq / G;
          for (int c = 0; c < CH; ++c) {
            tma_load(st + c * BR * 128, &tq, full, 64 * c, hq, i0, b);
            tma_load(st + L::Q_BYTES + c * BR * 128, &tdo, full, 64 * c, hq,
                     i0, b);
            tma_load(st + 2 * L::Q_BYTES + c * BC * 128, &tk, full, 64 * c,
                     kh, j0, b);
            tma_load(st + 2 * L::Q_BYTES + L::K_BYTES + c * BC * 128, &tv,
                     full, 64 * c, kh, j0, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    const int g = lane / 4, t4 = lane % 4;
    const int wr0 = i0 + 64 * wg;                 // the warpgroup's rows
    const int row0 = wr0 + 16 * warp + g;         // mine: row0, row0 + 8
    bool qlive[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) qlive[rr] = row0 + 8 * rr < p.sq;
    // acc[4 jb + 2 rr + c] is row row0 + 8 rr, key j0 + 8 jb + 2 t4 + c
    float acc[BC / 2], breg[BC / 2], s[BC / 2], dp[BC / 2];
    const float* bp = p.bias + (size_t)entry * p.sq * p.skv;
#pragma unroll
    for (int x = 0; x < BC / 2; ++x) {
      const int rr = (x >> 1) & 1;
      const int i = row0 + 8 * rr, j = j0 + 8 * (x / 4) + 2 * t4 + (x & 1);
      acc[x] = s[x] = dp[x] = 0.f;
      breg[x] = live && qlive[rr] && j < p.skv ? bp[(size_t)i * p.skv + j]
                                               : 0.f;
    }
    const bool plain = p.default_pos && p.seg_q == nullptr &&
                       p.alibi == nullptr;
    const bool whole =
        plain && wr0 + 64 <= p.sq && j0 + BC <= hi && j0 >= lo &&
        (!p.causal || j0 + BC - 1 <= wr0 + p.offset) &&
        (p.window <= 0 || wr0 + 63 + p.offset - j0 < p.window);
    const uint32_t q_wg = 64 * wg * 128;          // within a stage's Q, dO

    for (int r = r0, t = 0; live && r < r1; ++r, ++t) {
      const int b = bb * p.bias_rb + r / p.bias_rh;
      const int hq = hb * p.bias_rh + r % p.bias_rh;
      const int st = t % NS;
      mbar_wait(bar_full + 8 * st, (t / NS) & 1);
      const uint32_t qs = ring + st * L::STAGE_BYTES + q_wg;
      const uint32_t dos = qs + L::Q_BYTES;
      const uint32_t ks = ring + st * L::STAGE_BYTES + 2 * L::Q_BYTES;
      const uint32_t vs = ks + L::K_BYTES;

      wg_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)      // 16 columns of D per step
          if (4 * c + kk < ksteps)
            wgmma_ss<T, BC>(
                s, sw128_desc(qs + c * BR * 128 + kk * 32, 16, 1024),
                sw128_desc(ks + c * BC * 128 + kk * 32, 16, 1024),
                c + kk > 0);
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (4 * c + kk < ksteps)
            wgmma_ss<T, BC>(
                dp, sw128_desc(dos + c * BR * 128 + kk * 32, 16, 1024),
                sw128_desc(vs + c * BC * 128 + kk * 32, 16, 1024),
                c + kk > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);

      const float* rs = rows_s + st * L::ROW_FLOATS;
      float lse[2], dl[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        lse[rr] = rs[row0 + 8 * rr - i0];
        dl[rr] = rs[BR + row0 + 8 * rr - i0];
      }
      const float* kbs = rs + 2 * BR;
      if (whole) {
#pragma unroll
        for (int x = 0; x < BC / 2; ++x) {
          const float v = s[x] * p.scale + breg[x] +
                          kbs[8 * (x / 4) + 2 * t4 + (x & 1)];
          s[x] = v - lse[(x >> 1) & 1];
        }
      } else {
        // the mask rules and scores of score<true>, the pair bias from
        // registers and the k-row bias from the stage
        const float slope = p.alibi ? p.alibi[hq] : 0.f;
        int qpos[2], qseg[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = row0 + 8 * rr;
          qpos[rr] = qlive[rr] ? qpos_of(p, b, i) : 0;
          qseg[rr] = qlive[rr] ? qseg_of(p, b, i) : 0;
        }
#pragma unroll
        for (int jb = 0; jb < BC / 8; ++jb) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * jb + 2 * t4 + c, j = j0 + col;
            const bool jlive = j < hi;
            const int kpos = jlive ? kpos_of(p, b, j) : 0;
            const int kseg = jlive ? kseg_of(p, b, j) : 0;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int e = 4 * jb + 2 * rr + c;
              const bool ok = jlive && qlive[rr] &&
                              visible(p, qpos[rr], kpos, qseg[rr], kseg);
              float v = s[e] * p.scale + slope * (float)(kpos - qpos[rr]);
              v = ok ? v + breg[e] + kbs[col] : -INFINITY;
              s[e] = v - lse[rr];
            }
          }
        }
      }
#pragma unroll
      for (int x = 0; x < BC / 2; ++x)     // exp2(-inf) = 0 where hidden
        acc[x] = fmaf(exp2f(s[x] * kLog2e), dp[x] - dl[(x >> 1) & 1],
                      acc[x]);
      mbar_arrive(bar_empty + 8 * st);
    }

    float* out = p.dbias + ((size_t)chunk * entries + entry) * p.sq * p.skv;
    const bool pairs = p.skv % 2 == 0;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!qlive[rr]) continue;
      float* row = out + (size_t)(row0 + 8 * rr) * p.skv;
#pragma unroll
      for (int jb = 0; jb < BC / 8; ++jb) {
        const int j = j0 + 8 * jb + 2 * t4;
        const float x0 = acc[4 * jb + 2 * rr], x1 = acc[4 * jb + 2 * rr + 1];
        if (pairs && j + 1 < p.skv) {
          *reinterpret_cast<float2*>(row + j) = make_float2(x0, x1);
        } else {
          if (j < p.skv) row[j] = x0;
          if (j + 1 < p.skv) row[j + 1] = x1;
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch
enum Kind { kFwd = 0, kDq = 1, kDkv = 2, kDbias = 3 };

// shared memory in floats for a D-wide head
template <int RI, int CJ>
size_t smem_bytes(Kind kind, int d) {
  const size_t BR = kTY * RI, BC = kTX * CJ, DP = d + 1;
  size_t f = 0;
  if (kind == kFwd) f = BR * DP + BC * DP + BC * d + BR * (BC + 1) + 3 * BR;
  if (kind == kDq) f = 2 * BR * DP + 2 * BC * DP + BR * (BC + 1);
  if (kind == kDkv) f = 2 * BR * DP + 2 * BC * DP + 2 * BR * (BC + 1) + 4 * BC;
  if (kind == kDbias) f = 2 * BR * DP + 2 * BC * DP;
  return f * sizeof(float);
}

template <typename Kernel>
cudaError_t start(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, typename T, int DMAX, int RI, int CJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  void (*kernel)(const Args);
  if constexpr (KIND == kFwd) kernel = flash_fwd_kernel<T, DMAX, RI, CJ>;
  else if constexpr (KIND == kDq) kernel = flash_dq_kernel<T, DMAX, RI, CJ>;
  else kernel = flash_dkv_kernel<T, DMAX, RI, CJ>;
  const int rows = KIND == kDkv ? a.skv : a.sq;
  const int heads = KIND == kDkv ? a.kvh : a.h;
  const dim3 grid((rows + kTY * RI - 1) / (kTY * RI), heads, a.b);
  return start(kernel, grid,
               smem_bytes<RI, CJ>(static_cast<Kind>(KIND), a.d), a, stream);
}

// The dbias kernel's products loop over D at run time, so it is
// instantiated per type and tile only: 64 x 64 up to D = 128, 32 x 32 above.
template <typename T, int RI, int CJ>
cudaError_t launch_dbias(const Args& a, cudaStream_t stream) {
  const long long entries = (long long)a.bias_b * a.bias_h;
  const dim3 grid((a.sq + kTY * RI - 1) / (kTY * RI),
                  (a.skv + kTX * CJ - 1) / (kTX * CJ),
                  (unsigned)(entries * a.chunks));
  if (grid.y > 65535 || entries * a.chunks > 65535)
    return cudaErrorInvalidConfiguration;
  return start(flash_dbias_kernel<T, RI, CJ>, grid,
               smem_bytes<RI, CJ>(kDbias, a.d), a, stream);
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
  if constexpr (KIND == kDbias) {
    if (a.d <= 128) return launch_dbias<T, 4, 4>(a, s);
    return launch_dbias<T, 2, 2>(a, s);
  } else {
    if (a.d <= 64) return dispatch_shape<KIND, T, 64>(a, s);
    if (a.d <= 128) return dispatch_shape<KIND, T, 128>(a, s);
    return dispatch_shape<KIND, T, 256>(a, s);
  }
}

// The tensor map of operand t (16-bit, [B, rows, heads, D] through its
// strides) in boxes of 64 columns x box_rows rows of one (head, batch), with
// the 128-byte swizzle and zeros out of bounds. TMA needs a 16-byte aligned
// base and byte strides that are positive multiples of 16 (the wrapper
// copies an operand that has not); a dimension of extent 1 never steps, so
// its stride is replaced by a valid one.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, const Args& a,
                       int t, int heads, int rows, int box_rows, int dtype) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)a.d, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)a.b};
  const long long st[3] = {a.st[t][2], a.st[t][1], a.st[t][0]};
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  cuuint64_t widest = (a.d * es + 15) / 16 * 16;
  for (int x = 0; x < 3; ++x) {
    if (dims[x + 1] == 1) continue;
    if (st[x] <= 0 || st[x] * es % 16) return cudaErrorInvalidValue;
    widest = st[x] * es > widest ? st[x] * es : widest;
  }
  cuuint64_t strides[3];
  for (int x = 0; x < 3; ++x)
    strides[x] = dims[x + 1] == 1 ? widest : st[x] * es;
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// cudaFuncSetAttribute for the dynamic shared memory `kernel` takes, once
// per device (`allowed` holds one bit per device, per instance).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<unsigned long long>& allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  return cudaSuccess;
}

template <typename T, int DMAX>
cudaError_t launch_fwd_sm90(const Args& a, int dtype, cudaStream_t stream) {
  using L = FwdTiles<DMAX>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, a.q, a, kQ, a.h, a.sq, L::BR, dtype);
  if (err == cudaSuccess)
    err = tensor_map(&tk, a.k, a, kK, a.kvh, a.skv, L::BC, dtype);
  if (err == cudaSuccess)
    err = tensor_map(&tv, a.v, a, kV, a.kvh, a.skv, L::BC, dtype);
  if (err != cudaSuccess) return err;
  const auto kernel = flash_fwd_sm90_kernel<T, DMAX>;
  static std::atomic<unsigned long long> allowed{0};
  err = allow_smem(kernel, L::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + L::BR - 1) / L::BR, a.h, a.b);
  kernel<<<grid, kFwdThreads, L::SMEM, stream>>>(a, tq, tk, tv);
  return cudaGetLastError();
}

// dQ: q and dO in boxes of the CTA's 128 rows, k and v of the ring's 64;
// dK/dV: k and v of 128, q and dO of 64. One CTA per (128 rows, head,
// batch): q rows and q heads for dQ, keys and kv heads for dK/dV.
template <int KIND, typename T, int DMAX>
cudaError_t launch_bwd_sm90(const Args& a, int dtype, cudaStream_t stream) {
  using L = BwdTiles<DMAX>;
  constexpr bool dq_kind = KIND == kDq;
  const int own_heads = dq_kind ? a.h : a.kvh;
  const int own_rows = dq_kind ? a.sq : a.skv;
  const int ring_heads = dq_kind ? a.kvh : a.h;
  const int ring_rows = dq_kind ? a.skv : a.sq;
  CUtensorMap m[4];
  cudaError_t err = tensor_map(&m[0], dq_kind ? a.q : a.k, a,
                               dq_kind ? kQ : kK, own_heads, own_rows, L::BR,
                               dtype);
  if (err == cudaSuccess)
    err = tensor_map(&m[1], dq_kind ? a.dout : a.v, a, dq_kind ? kDO : kV,
                     own_heads, own_rows, L::BR, dtype);
  if (err == cudaSuccess)
    err = tensor_map(&m[2], dq_kind ? a.k : a.q, a, dq_kind ? kK : kQ,
                     ring_heads, ring_rows, L::BT, dtype);
  if (err == cudaSuccess)
    err = tensor_map(&m[3], dq_kind ? a.v : a.dout, a, dq_kind ? kV : kDO,
                     ring_heads, ring_rows, L::BT, dtype);
  if (err != cudaSuccess) return err;
  const auto kernel = dq_kind ? flash_dq_sm90_kernel<T, DMAX>
                              : flash_dkv_sm90_kernel<T, DMAX>;
  static std::atomic<unsigned long long> allowed{0};
  err = allow_smem(kernel, L::SMEM, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((own_rows + L::BR - 1) / L::BR, own_heads, a.b);
  kernel<<<grid, kFwdThreads, L::SMEM, stream>>>(a, m[0], m[1], m[2], m[3]);
  return cudaGetLastError();
}

// The reducing dbias on Hopper: q and dO in boxes of the CTA's 128 rows, k
// and v of its 64 keys; one CTA per (q tile, key tile, bias entry, chunk).
template <typename T, int DMAX>
cudaError_t launch_dbias_sm90(const Args& a, int dtype, cudaStream_t stream) {
  using L = DbiasTiles<DMAX>;
  const long long entries = (long long)a.bias_b * a.bias_h;
  const dim3 grid((a.sq + L::BR - 1) / L::BR, (a.skv + L::BC - 1) / L::BC,
                  (unsigned)(entries * a.chunks));
  if (grid.y > 65535 || entries * a.chunks > 65535)
    return cudaErrorInvalidConfiguration;
  CUtensorMap m[4];
  cudaError_t err = tensor_map(&m[0], a.q, a, kQ, a.h, a.sq, L::BR, dtype);
  if (err == cudaSuccess)
    err = tensor_map(&m[1], a.dout, a, kDO, a.h, a.sq, L::BR, dtype);
  if (err == cudaSuccess)
    err = tensor_map(&m[2], a.k, a, kK, a.kvh, a.skv, L::BC, dtype);
  if (err == cudaSuccess)
    err = tensor_map(&m[3], a.v, a, kV, a.kvh, a.skv, L::BC, dtype);
  if (err != cudaSuccess) return err;
  const auto kernel = flash_dbias_sm90_kernel<T, DMAX>;
  static std::atomic<unsigned long long> allowed{0};
  err = allow_smem(kernel, L::SMEM, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFwdThreads, L::SMEM, stream>>>(a, m[0], m[1], m[2], m[3]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sm90(const Args& a, int dtype, cudaStream_t s) {
  if (a.d <= 64) return launch_fwd_sm90<T, 64>(a, dtype, s);
  if (a.d <= 128) return launch_fwd_sm90<T, 128>(a, dtype, s);
  return launch_fwd_sm90<T, 256>(a, dtype, s);
}

// The routes, decided here and nowhere else (dispatch_type and
// dsst_flash_kernel both ask): the bfloat16 / float16 forward takes
// flash_fwd_sm90_kernel at every D, their dQ, dK/dV and reducing dbias the
// sm90 kernels at D <= 128; float32, and bfloat16 / float16 dQ, dK/dV and
// dbias above D = 128, the CUDA cores.
bool fwd_on_sm90(int dtype) { return dtype == 1 || dtype == 2; }
bool bwd_on_sm90(int dtype, int d) { return fwd_on_sm90(dtype) && d <= 128; }

template <int KIND, typename T>
cudaError_t dispatch_bwd_sm90(const Args& a, int dtype, cudaStream_t s) {
  if (a.d <= 64) return launch_bwd_sm90<KIND, T, 64>(a, dtype, s);
  return launch_bwd_sm90<KIND, T, 128>(a, dtype, s);
}

template <int KIND>
cudaError_t dispatch_type(const Args& a, int dtype, cudaStream_t s) {
  if constexpr (KIND == kFwd) {
    if (!fwd_on_sm90(dtype)) return dispatch_dim<KIND, float>(a, s);
    if (dtype == 1) return dispatch_sm90<__nv_bfloat16>(a, dtype, s);
    return dispatch_sm90<__half>(a, dtype, s);
  } else if constexpr (KIND == kDbias) {
    if (dtype == 0) return dispatch_dim<KIND, float>(a, s);
    if (bwd_on_sm90(dtype, a.d)) {
      if (dtype == 1) {
        if (a.d <= 64) return launch_dbias_sm90<__nv_bfloat16, 64>(a, dtype, s);
        return launch_dbias_sm90<__nv_bfloat16, 128>(a, dtype, s);
      }
      if (a.d <= 64) return launch_dbias_sm90<__half, 64>(a, dtype, s);
      return launch_dbias_sm90<__half, 128>(a, dtype, s);
    }
    if (dtype == 1) return dispatch_dim<KIND, __nv_bfloat16>(a, s);
    return dispatch_dim<KIND, __half>(a, s);
  } else {
    if (dtype == 0) return dispatch_dim<KIND, float>(a, s);
    if (bwd_on_sm90(dtype, a.d)) {
      if (dtype == 1)
        return dispatch_bwd_sm90<KIND, __nv_bfloat16>(a, dtype, s);
      return dispatch_bwd_sm90<KIND, __half>(a, dtype, s);
    }
    // bfloat16 / float16 above D = 128: the CUDA-core kernel at DMAX 256
    if (dtype == 1) return dispatch_shape<KIND, __nv_bfloat16, 256>(a, s);
    return dispatch_shape<KIND, __half, 256>(a, s);
  }
}

}  // namespace

// One kind's launches (dispatch_type<kind>), in the unit that owns the kind.
#define DSST_LAUNCH(K)                                                    \
  extern "C" int dsst_flash_launch_##K(const void* a, int dtype, void* s)
#define DSST_LAUNCH_BODY(KIND)                                            \
  {                                                                       \
    return (int)dispatch_type<KIND>(*static_cast<const Args*>(a), dtype,  \
                                    static_cast<cudaStream_t>(s));        \
  }
DSST_LAUNCH(0);
DSST_LAUNCH(1);
DSST_LAUNCH(2);
DSST_LAUNCH(3);
#if DSST_OWNS(0)
DSST_LAUNCH(0) DSST_LAUNCH_BODY(kFwd)
#endif
#if DSST_OWNS(1)
DSST_LAUNCH(1) DSST_LAUNCH_BODY(kDq)
#endif
#if DSST_OWNS(2)
DSST_LAUNCH(2) DSST_LAUNCH_BODY(kDkv)
#endif
#if DSST_OWNS(3)
DSST_LAUNCH(3) DSST_LAUNCH_BODY(kDbias)

namespace {

// bias_dims: Bb, Hb, Bk, Hl, lay_nq, lay_nkv, lay_bq, lay_bk (entries of
// absent inputs are ignored).
int run(Kind kind, Args& a, const long long* strides, const int* bias_dims,
        int b, int sq, int skv, int h, int kvh, int d, int causal,
        int window, float scale, int dtype, void* stream) {
  // the batch rides gridDim.z and the heads gridDim.y (at most 65535 each)
  if (b <= 0 || sq <= 0 || skv <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 ||
      d > 256 || b > 65535 || h > 65535 || dtype < 0 || dtype > 2 ||
      strides == nullptr || bias_dims == nullptr)
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
  a.bias_b = bias_dims[0];
  a.bias_h = bias_dims[1];
  if (a.bias != nullptr || kind == kDbias) {
    if (a.bias == nullptr || a.bias_b <= 0 || a.bias_h <= 0 ||
        b % a.bias_b != 0 || h % a.bias_h != 0 ||
        (kind == kDbias && a.dbias == nullptr))
      return (int)cudaErrorInvalidValue;
    a.bias_rb = b / a.bias_b;
    a.bias_rh = h / a.bias_h;
  }
  if (a.kbias != nullptr) {
    if (bias_dims[2] <= 0 || b % bias_dims[2] != 0)
      return (int)cudaErrorInvalidValue;
    a.kbias_rb = b / bias_dims[2];
  }
  if (a.layout != nullptr) {
    a.lay_h = bias_dims[3];
    a.lay_nq = bias_dims[4];
    a.lay_nkv = bias_dims[5];
    a.lay_bq = bias_dims[6];
    a.lay_bk = bias_dims[7];
    if ((a.lay_h != 1 && a.lay_h != h) || a.lay_bq <= 0 || a.lay_bk <= 0 ||
        a.lay_nq < (sq + a.lay_bq - 1) / a.lay_bq ||
        a.lay_nkv < (skv + a.lay_bk - 1) / a.lay_bk || kind == kDbias)
      return (int)cudaErrorInvalidValue;
  }
  if (kind == kFwd) return dsst_flash_launch_0(&a, dtype, stream);
  if (kind == kDq) return dsst_flash_launch_1(&a, dtype, stream);
  if (kind == kDkv) return dsst_flash_launch_2(&a, dtype, stream);
  return dsst_flash_launch_3(&a, dtype, stream);
}

// The reduced dbias: partial sums per chunk of replicas into `scratch`
// ([chunks, Bb, Hb, Sq, Skv]), then their sum in chunk order into `dbias`;
// with one chunk straight into `dbias`.
int run_dbias(Args& a, float* dbias, float* scratch, const long long* strides,
              const int* bias_dims, int b, int sq, int skv, int h, int kvh,
              int d, int causal, int window, float scale, int dtype,
              void* stream) {
  const int chunks = bias_dims == nullptr ? 0 : bias_dims[8];
  if (chunks < 1 || dbias == nullptr || (chunks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  a.chunks = chunks;
  a.dbias = chunks > 1 ? scratch : dbias;
  int err = run(kDbias, a, strides, bias_dims, b, sq, skv, h, kvh, d, causal,
                window, scale, dtype, stream);
  if (err != 0 || chunks == 1) return err;
  const long long n = (long long)a.bias_b * a.bias_h * sq * skv;
  const long long blocks = (n + kThreads - 1) / kThreads;
  flash_dbias_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scratch, dbias, n, chunks);
  return (int)cudaGetLastError();
}

void set_inputs(Args& a, const int* seg_q, const int* seg_k, const int* pos_q,
                const int* pos_k, const float* alibi, const float* bias,
                const float* kbias, const int* layout) {
  a.seg_q = seg_q;
  a.seg_k = seg_k;
  a.pos_q = pos_q;
  a.pos_k = pos_k;
  a.alibi = alibi;
  a.bias = bias;
  a.kbias = kbias;
  a.layout = layout;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 24 int64, the
// (batch, seq, head) element strides of q, k, v, o, do, dq, dk, dv in that
// order (entries of operands a kernel does not use are ignored). bias_dims:
// 9 int32, (Bb, Hb) of the pair bias, Bk of the k-row bias, (Hl, nq, nkv,
// block_q, block_k) of the layout, the dbias kernel's replica chunks. Null
// seg/pos/alibi/bias/kbias/layout pointers take the defaults (none).
// window <= 0: none. Each returns a cudaError_t (0 = launched).
int dsst_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* seg_q, const int* seg_k,
                   const int* pos_q, const int* pos_k, const float* alibi,
                   const float* bias, const float* kbias, const int* layout,
                   const long long* strides, const int* bias_dims, int b,
                   int sq, int skv, int h, int kvh, int d, int causal,
                   int window, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
  set_inputs(a, seg_q, seg_k, pos_q, pos_k, alibi, bias, kbias, layout);
  return run(kFwd, a, strides, bias_dims, b, sq, skv, h, kvh, d, causal,
             window, scale, dtype, stream);
}

// dbias: null, or a zero-filled float32 [B, H, Sq, Skv] that receives ds.
int dsst_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, float* dbias, const int* seg_q, const int* seg_k,
                  const int* pos_q, const int* pos_k, const float* alibi,
                  const float* bias, const float* kbias, const int* layout,
                  const long long* strides, const int* bias_dims, int b,
                  int sq, int skv, int h, int kvh, int d, int causal,
                  int window, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dbias = dbias;
  set_inputs(a, seg_q, seg_k, pos_q, pos_k, alibi, bias, kbias, layout);
  return run(kDq, a, strides, bias_dims, b, sq, skv, h, kvh, d, causal,
             window, scale, dtype, stream);
}

int dsst_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, const int* seg_q, const int* seg_k,
                   const int* pos_q, const int* pos_k, const float* alibi,
                   const float* bias, const float* kbias, const int* layout,
                   const long long* strides, const int* bias_dims, int b,
                   int sq, int skv, int h, int kvh, int d, int causal,
                   int window, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  set_inputs(a, seg_q, seg_k, pos_q, pos_k, alibi, bias, kbias, layout);
  return run(kDkv, a, strides, bias_dims, b, sq, skv, h, kvh, d, causal,
             window, scale, dtype, stream);
}

// dbias: float32 [Bb, Hb, Sq, Skv], every entry written; scratch: float32
// [chunks, Bb, Hb, Sq, Skv] (unused, may be null, with one chunk). bias is
// required; a layout is refused.
int dsst_flash_dbias(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dbias, float* scratch, const int* seg_q,
                     const int* seg_k,
                     const int* pos_q, const int* pos_k, const float* alibi,
                     const float* bias, const float* kbias,
                     const int* layout, const long long* strides,
                     const int* bias_dims, int b, int sq, int skv, int h,
                     int kvh, int d, int causal, int window, float scale,
                     int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  set_inputs(a, seg_q, seg_k, pos_q, pos_k, alibi, bias, kbias, layout);
  return run_dbias(a, dbias, scratch, strides, bias_dims, b, sq, skv, h, kvh,
                   d, causal, window, scale, dtype, stream);
}

// The kernel dsst_flash_<kind> launches for (dtype, d): kind 0 = fwd,
// 1 = dq, 2 = dkv, 3 = dbias; dtype as above. Null for an unknown kind.
const char* dsst_flash_kernel(int kind, int dtype, int d) {
  switch (kind) {
    case kFwd:
      return fwd_on_sm90(dtype) ? "flash_fwd_sm90_kernel" : "flash_fwd_kernel";
    case kDq:
      return bwd_on_sm90(dtype, d) ? "flash_dq_sm90_kernel" : "flash_dq_kernel";
    case kDkv:
      return bwd_on_sm90(dtype, d) ? "flash_dkv_sm90_kernel"
                                   : "flash_dkv_kernel";
    case kDbias:
      return bwd_on_sm90(dtype, d) ? "flash_dbias_sm90_kernel"
                                   : "flash_dbias_kernel";
  }
  return nullptr;
}

const char* dsst_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif  // DSST_OWNS(3)
