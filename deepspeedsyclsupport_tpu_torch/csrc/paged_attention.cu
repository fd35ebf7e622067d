// Ragged paged attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_prefill_kernel`
// (deepspeedsyclsupport_tpu/ops/paged_attention.py:96) and, through its
// BQ=1 call, `paged_decode_attention_pallas` (same file, :39).
//
// What it computes. The batch is cut into atoms: up to BQ query rows of ONE
// sequence, row r at position pos0 + r, qlen live rows (qlen == 0: a dead
// atom). Each row attends over its sequence's KV, found through the atom's
// block-table row in the flat-slot pool [num_slots, KVH, D] (slot =
// table[pos / block_size] * block_size + pos % block_size), with per-row
// causality pos <= pos0 + r, GQA (q head kh*G + gi reads kv head kh), an
// optional ALiBi bias slope[q head] * (pos - qpos) and an optional sliding
// window qpos - pos < window. Softmax runs online in float32: masked
// scores are -inf and contribute exactly 0, a row with nothing visible
// (dead atom, row >= qlen) writes exact zeros. Lane l of kv head kh is q
// row l / G, head kh*G + l % G, as in the Pallas kernel's [KVH, BQ*G, D]
// grouping; a CTA owns a range of lanes of one (atom, kv head) and loads its
// own pos0 / qlen / table row (no scalar prefetch). Its KV range is cut to
// what its rows can see, [kv_lo, kv_hi) (`kv_span`).
//
// Three routes, decided in `route_of` (dsst_paged_kernel names them):
//
// paged_decode_split_kernel + paged_decode_combine_kernel, every dtype,
//   when an atom has at most 16 lanes (BQ * G <= 16: decode, BQ = 1).
//   Decode does ~2 flops per KV byte: it is bound by device-memory bandwidth
//   (3.35 TB/s), and tensor cores would not help. One CTA of 4 warps per
//   (atom, kv head, tile of lanes, chunk of kChunk = 256 KV positions): the
//   chunk length is a constant, never the SM count, so the same inputs give
//   the same bits on any card, and the grid, ceil(Bps * block_size / 256)
//   chunks per atom, follows host-known shapes (no device-to-host read);
//   CTAs whose chunk lies outside the lanes' KV range exit at once. Each warp
//   streams its quarter of the chunk (64 positions, whose slots it reads
//   from the table once) in groups of 64 bytes of K and of V per thread: a
//   row is D / 32 columns per thread in one vector load, kept as raw words
//   until used, so every load of a group is in flight before the first
//   use; q . k in float32 with a warp reduction for each of the CTA's lanes
//   (the G heads of a GQA group share the loaded rows; 1, 4 or 1024 / DMAX
//   lanes an instance), and a per-warp online softmax. The
//   four warps merge in shared memory in warp order; a single-chunk range
//   writes O itself, otherwise the CTA writes its partial (m, l, acc) in
//   float32 to scratch the wrapper allocates, and the combine kernel folds
//   one (atom, kv head, lane tile)'s chunks in chunk order: no atomics.
//
// paged_prefill_sm90_kernel<T, DMAX in {64, 128}>, bfloat16 / float16, D <=
//   128 and a multiple of 8, block_size a multiple or a divisor (>= 8) of 64,
//   G dividing 128, q and pool readable by TMA in place (16-byte aligned).
//   Long prefill does O(BQ) flops per KV byte: it is bound by the tensor
//   cores (989 TFLOP/s). 384 threads as in flash_fwd_sm90_kernel
//   (csrc/flash_attention.cu): warpgroups 0 and 1 consume 64 lanes each,
//   one thread of warpgroup 2 issues every copy; setmaxnreg 40 / 232, so
//   registers, not the 97 KB of shared memory (DMAX 128), hold it to one
//   CTA per SM.
//   One CTA per (atom, kv head, 128 lanes = 128 / G rows x G heads).
//     Q: once, by TMA, a rank-4 map over [A, BQ, H, D] with box (64 cols, G
//       heads, 128 / G rows, 1): shared memory holds lanes in the order
//       r * G + gi. Rows past BQ arrive as zeros.
//     K / V: a two-stage ring of 64-token tiles. A pool block of block_size
//       slots is contiguous, so a tile is 64 / min(block_size, 64) boxes of
//       (64 cols, 1 kv head, min(block_size, 64) slots) at slot table[j] *
//       block_size (+ the offset inside a block of 128 or more), each box
//       1024-byte aligned in shared memory (the swizzle's period). Table
//       entries are read by the producer; a tile past the table's capacity
//       re-reads its last block (finite, and masked). expect_tx counts whole
//       boxes. The pool is never copied.
//     Per tile: S = Q K^T by wgmma (K-major), scale, ALiBi and the causal /
//       window mask on the accumulator fragment (a tile every lane of the
//       warpgroup sees whole only takes the scale; a tile none of them sees
//       is not multiplied), register online softmax, O += P V by wgmma with
//       P as two register A operands of T, hi = T(P) and lo = T(P - hi), and
//       V MN-major: P to ~16 bits, as the reference keeps it in float32, for
//       one more sweep of P V (ROADMAP C2).
//
// paged_attention_kernel, the CUDA-core version (the first design), for what
//   the others do not take: float32 prefill, D > 128, a pool TMA cannot
//   read in place, other block sizes or groups. One CTA of 256 threads per
//   (atom, kv head, 64 lanes): q staged in shared memory as float32, K and V
//   gathered per element through the table, S and P V on the float32 cores.
//
// Nothing crosses CTAs except the split route's partials, which are summed
// in a fixed order: the same inputs give the same bits on every route.
//
// Interface: a plain C function loaded with ctypes. It launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (0 on
// success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "sm90_common.cuh"

// The build compiles this source as DSST_PARTS units at once (ops/_build.py
// passes -DDSST_PART=k): unit k instantiates the launches of Route k, and
// unit 2 also holds the C interface. Without DSST_PART one unit holds all.
#define DSST_PARTS 3
#ifdef DSST_PART
#define DSST_OWNS(k) (DSST_PART == (k))
#else
#define DSST_OWNS(k) 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // NEG_INF of the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;        // [A, BQ, H, D]
  const void* k;        // [num_slots, KVH, D], one layer of the pool
  const void* v;
  void* out;            // [A, BQ, H, D]
  const int* tables;    // [A, bps]
  const int* pos0;      // [A], or null with seq_lens
  const int* qlen;      // [A], or null with seq_lens
  const int* seq_lens;  // decode (BQ = 1): [A] cached tokens per slot, the
                        // atom's pos0 = max(len - 1, 0), qlen = len > 0
  const float* alibi;   // [H] or null
  float* scratch;       // split route: partials (see split_plan), else null
  int bq, h, kvh, d, bps, block_size, window;  // window <= 0: none
  int num_atoms, num_slots;
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
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Atom a's first position and live rows.
__device__ __forceinline__ void atom_rows(const Args& p, int a, int& pos0,
                                          int& qlen) {
  if (p.seq_lens != nullptr) {
    const int n = p.seq_lens[a];
    pos0 = max(n - 1, 0);
    qlen = n > 0 ? 1 : 0;
  } else {
    pos0 = p.pos0[a];
    qlen = p.qlen[a];
  }
}

// The rows and KV positions lanes [lane_lo, lane_hi) of an atom can touch:
// live rows [row_lo, row_hi), positions [kv_lo, kv_hi) (above the last
// row's causal limit and below the first row's window nothing is visible).
// `empty`: nothing visible (dead atom, rows past qlen, or past the table).
struct Span {
  int row_lo, row_hi, kv_lo, kv_hi;
  bool empty;
};
__device__ __forceinline__ Span kv_span(const Args& p, int pos0, int qlen,
                                        int lane_lo, int lane_hi, int g) {
  Span s;
  s.row_lo = lane_lo / g;
  s.row_hi = min((lane_hi - 1) / g + 1, qlen);
  s.kv_hi = min(pos0 + s.row_hi, p.bps * p.block_size);
  s.kv_lo = p.window > 0 ? max(pos0 + s.row_lo + 1 - p.window, 0) : 0;
  s.empty = s.row_lo >= s.row_hi || s.kv_lo >= s.kv_hi;
  return s;
}

// q / out offset of (atom a, lane, column dd) for kv head kh
__device__ __forceinline__ size_t qo_at(const Args& p, int a, int kh, int g,
                                        int lane, int dd) {
  return (((size_t)a * p.bq + lane / g) * p.h + kh * g + lane % g) * p.d + dd;
}

// Exact zeros for lanes [lane_lo, lane_hi) of atom a, kv head kh.
template <typename T>
__device__ void write_zeros(const Args& p, int a, int kh, int g, int lane_lo,
                            int lane_hi, int tid, int nthreads) {
  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < (lane_hi - lane_lo) * p.d; i += nthreads)
    out[qo_at(p, a, kh, g, lane_lo + i / p.d, i % p.d)] = from_f<T>(0.f);
}

// -------------------------------------------------------------- CUDA cores
// Shared memory (floats): q tile [RT][D+1], K tile [TK][D+1], V tile
// [TK][D], P tile [RT][TK+1], row m/l/alpha [RT] each, slot ids [TK] (int).
template <int RT, int TK>
__host__ __device__ constexpr size_t smem_floats_fixed() {
  return (size_t)RT * (TK + 1) + 3 * RT + TK;
}
template <int RT, int TK>
__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)RT * (d + 1) + (size_t)TK * (d + 1) + (size_t)TK * d +
          smem_floats_fixed<RT, TK>());
}

// TY x TX threads; each thread owns RI rows x CJ kv columns of S and RI
// rows x DJ head-dim columns of the accumulator (DJ * TX >= D).
template <typename T, int TY, int TX, int RI, int CJ, int DJ>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args p) {
  static_assert(TY * TX == kThreads, "thread tile");
  constexpr int RT = TY * RI;  // q lanes per CTA
  constexpr int TK = TX * CJ;  // kv tokens per tile
  const int a = blockIdx.x;
  const int kh = blockIdx.y;
  const int lane0 = blockIdx.z * RT;
  const int D = p.d;
  const int DP = D + 1;
  const int g = p.h / p.kvh;
  const int lanes = p.bq * g;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ kp = static_cast<const T*>(p.k);
  const T* __restrict__ vp = static_cast<const T*>(p.v);
  T* __restrict__ out = static_cast<T*>(p.out);

  int pos0, qlen;
  atom_rows(p, a, pos0, qlen);
  const int lane_end = min(lane0 + RT, lanes);
  const int row_lo = lane0 / g;
  const int row_hi = min((lane_end - 1) / g + 1, qlen);  // live rows < qlen
  // kv positions any row of this tile can see: [kv_lo, kv_hi)
  const int kv_hi = min(pos0 + row_hi, p.bps * p.block_size);
  const int kv_lo = p.window > 0 ? max(pos0 + row_lo + 1 - p.window, 0) : 0;

  // q / out element (lane, dd) of this CTA's kv head
  auto qo_index = [&](int lane, int dd) -> size_t {
    const int head = kh * g + lane % g;
    return (((size_t)a * p.bq + lane / g) * p.h + head) * D + dd;
  };

  if (row_lo >= row_hi || kv_lo >= kv_hi) {
    // dead atom, rows past qlen, or nothing visible: exact zeros
    for (int i = tid; i < RT * D; i += kThreads) {
      const int lane = lane0 + i / D;
      if (lane < lanes) out[qo_index(lane, i % D)] = from_f<T>(0.f);
    }
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;                   // [RT][DP]
  float* ks = qs + RT * DP;           // [TK][DP]
  float* vs = ks + TK * DP;           // [TK][D]
  float* ps = vs + TK * D;            // [RT][TK + 1]
  float* m_s = ps + RT * (TK + 1);    // [RT]
  float* l_s = m_s + RT;              // [RT]
  float* al_s = l_s + RT;             // [RT]
  int* slot_s = reinterpret_cast<int*>(al_s + RT);  // [TK]

  for (int i = tid; i < RT * D; i += kThreads) {
    const int lane = lane0 + i / D;
    float x = 0.f;
    if (lane < lanes && lane / g < qlen) x = to_f(q[qo_index(lane, i % D)]);
    qs[(i / D) * DP + i % D] = x;
  }
  for (int i = tid; i < RT; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // per-thread row facts for the S tile
  int row_qpos[RI];
  bool row_live[RI];
  float row_slope[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int lane = lane0 + ty + TY * i;
    row_live[i] = lane < lanes && lane / g < qlen;
    row_qpos[i] = pos0 + lane / g;
    row_slope[i] = (p.alibi != nullptr && lane < lanes)
                       ? p.alibi[kh * g + lane % g] : 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const size_t slot_stride = (size_t)p.kvh * D;
  const int* table = p.tables + (size_t)a * p.bps;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += TK) {
    __syncthreads();  // previous tile's readers are done with ks/vs/ps
    for (int c = tid; c < TK; c += kThreads) {
      const int pos = t0 + c;
      slot_s[c] = pos < kv_hi
          ? table[pos / p.block_size] * p.block_size + pos % p.block_size
          : -1;
    }
    __syncthreads();
    for (int i = tid; i < TK * D; i += kThreads) {
      const int c = i / D, dd = i % D;
      const int slot = slot_s[c];
      float kx = 0.f, vx = 0.f;  // zero past kv_hi: P is 0 there, V must
      if (slot >= 0) {           // not be NaN garbage
        const size_t off = (size_t)slot * slot_stride + (size_t)kh * D + dd;
        kx = to_f(kp[off]);
        vx = to_f(vp[off]);
      }
      ks[c * DP + dd] = kx;
      vs[c * D + dd] = vx;
    }
    __syncthreads();

    // S = Q K^T on this thread's RI x CJ tile
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + TY * i) * DP + dd];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + TX * j) * DP + dd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    // scale, ALiBi, mask; masked entries are -inf (exactly 0 after exp)
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = row_qpos[i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + TX * j;
        const int pos = t0 + c;
        float x = s[i][j] * p.scale;
        if (p.alibi != nullptr) x += row_slope[i] * (float)(pos - qpos);
        const bool ok = row_live[i] && pos < kv_hi && pos <= qpos &&
                        (p.window <= 0 || qpos - pos < p.window);
        ps[(ty + TY * i) * (TK + 1) + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    const int warp = tid / 32, wl = tid % 32;
    for (int r = warp; r < RT; r += kWarps) {
      float* prow = ps + r * (TK + 1);
      float mx = kNegInf;
      for (int c = wl; c < TK; c += 32) mx = fmaxf(mx, prow[c]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = wl; c < TK; c += 32) {
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

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = al_s[ty + TY * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    const int tk_live = min(TK, kv_hi - t0);
    for (int c = 0; c < tk_live; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + TY * i) * (TK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int dd = tx + TX * j;
        vv[j] = dd < D ? vs[c * D + dd] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // out = acc / max(l, 1e-30): rows with nothing visible come out 0
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + TY * i;
    const int lane = lane0 + r;
    if (lane >= lanes) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int dd = tx + TX * j;
      if (dd < D) out[qo_index(lane, dd)] = from_f<T>(acc[i][j] / denom);
    }
  }
}


// ------------------------------------------------- prefill on Hopper (sm90)
constexpr int kSm90Threads = 384;   // 2 consumer warpgroups + the producer's
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65536
constexpr int kLanes = 128;         // q lanes per CTA, 64 per warpgroup
constexpr int kTok = 64;            // KV positions per tile
constexpr int kStages = 2;          // K / V tiles in flight (four were no
                                    // faster on an H100 at serve shapes)

template <int DMAX>
struct PrefillTiles {
  static constexpr int CH = DMAX / 64;                  // 128-byte chunks
  static constexpr int Q_BYTES = CH * kLanes * 128;
  static constexpr int KV_BYTES = CH * kTok * 128;      // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  // barriers: q full, full[kStages], empty[kStages]; 1024 for the
  // swizzle's alignment
  static constexpr int SMEM = BAR_OFF + (1 + 2 * kStages) * 8 + 1024;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kSm90Threads, 1) paged_prefill_sm90_kernel(
    const Args p, const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  using L = PrefillTiles<DMAX>;
  constexpr int CH = L::CH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + L::Q_BYTES;     // [stage][chunk][kTok][64]
  const uint32_t v_s = k_s + kStages * L::KV_BYTES;
  const uint32_t bar_q = q_s + L::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                     // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;       // + 8 s

  const int a = blockIdx.x, kh = blockIdx.y;
  const int g = p.h / p.kvh;
  const int lanes = p.bq * g;
  const int lane0 = blockIdx.z * kLanes;
  const int lane_end = min(lane0 + kLanes, lanes);
  int pos0, qlen;
  atom_rows(p, a, pos0, qlen);
  const Span sp = kv_span(p, pos0, qlen, lane0, lane_end, g);
  if (sp.empty) {   // the same answer in every thread
    write_zeros<T>(p, a, kh, g, lane0, lane_end, threadIdx.x, kSm90Threads);
    return;
  }
  const int t_lo = sp.kv_lo / kTok, t_hi = (sp.kv_hi + kTok - 1) / kTok;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
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
      mbar_expect_tx(bar_q, CH * kLanes * 128);
      for (int c = 0; c < CH; ++c)
        tma_load(q_s + c * kLanes * 128, &tq, bar_q, 64 * c, kh * g,
                 blockIdx.z * (kLanes / g), a);
      const int bs = p.block_size;
      const int bk = min(bs, kTok), nb = kTok / bk;
      const int* table = p.tables + (size_t)a * p.bps;
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(bar_empty + 8 * s, (round - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * CH * kTok * 128);
        for (int x = 0; x < nb; ++x) {
          const int pos = t * kTok + x * bk;
          const int slot = table[min(pos / bs, p.bps - 1)] * bs + pos % bs;
          for (int c = 0; c < CH; ++c) {
            const uint32_t off = s * L::KV_BYTES + c * kTok * 128 + x * bk * 128;
            tma_load(k_s + off, &tk, full, 64 * c, kh, slot, 0);
            tma_load(v_s + off, &tv, full, 64 * c, kh, slot, 0);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int wl0 = lane0 + 64 * wg;              // the warpgroup's lanes
    const int my0 = wl0 + 16 * warp + gq;         // mine: my0, my0 + 8
    int qpos[2];
    bool live[2];
    float slope[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int l = my0 + 8 * rr;
      live[rr] = l < lanes && l / g < qlen;
      qpos[rr] = pos0 + l / g;
      slope[rr] = (p.alibi != nullptr && l < lanes) ? p.alibi[kh * g + l % g]
                                                    : 0.f;
    }
    // the warpgroup's live rows [wr_lo, wr_hi): tiles none of them sees are
    // skipped, tiles all of them see whole only take the scale
    const int wr_lo = wl0 / g;
    const int wr_hi = min((min(wl0 + 64, lanes) - 1) / g + 1, qlen);
    const bool wg_dead = wl0 >= lanes || wr_lo >= wr_hi;
    const int q_min = pos0 + wr_lo, q_max = pos0 + wr_hi - 1;
    const bool full_rows = wl0 + 64 <= lanes && (wl0 + 63) / g < qlen &&
                           p.alibi == nullptr;
    float s[kTok / 2], o[DMAX / 2];
#pragma unroll
    for (int i = 0; i < kTok / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t q_wg = q_s + wg * 64 * 128;

    mbar_wait(bar_q, 0);
    for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
      const int st = i % kStages;
      mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
      const int j0 = t * kTok;
      const bool unseen = wg_dead || j0 > q_max ||
                          (p.window > 0 && j0 + kTok - 1 <= q_min - p.window);
      if (!unseen) {
        const uint32_t ks = k_s + st * L::KV_BYTES;
        const uint32_t vs = v_s + st * L::KV_BYTES;
        wg_fence();
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)      // 16 columns of D per step
            wgmma_ss<T, kTok>(
                s, sw128_desc(q_wg + c * kLanes * 128 + kk * 32, 16, 1024),
                sw128_desc(ks + c * kTok * 128 + kk * 32, 16, 1024),
                c + kk > 0);
        wg_commit();
        wg_wait_all();
        fence_regs(s);

        const bool whole = full_rows && j0 + kTok <= sp.kv_hi &&
                           j0 + kTok - 1 <= q_min &&
                           (p.window <= 0 || q_max - j0 < p.window);
        if (whole) {
#pragma unroll
          for (int x = 0; x < kTok / 2; ++x) s[x] *= p.scale;
        } else {
          // s[4 jb + 2 rr + c] is lane my0 + 8 rr, position j0 + 8 jb +
          // 2 t4 + c
#pragma unroll
          for (int x = 0; x < kTok / 2; ++x) {
            const int jb = x / 4, rr = (x / 2) % 2, c = x % 2;
            const int pos = j0 + 8 * jb + 2 * t4 + c;
            const bool ok = live[rr] && pos < sp.kv_hi && pos <= qpos[rr] &&
                            (p.window <= 0 || qpos[rr] - pos < p.window);
            s[x] = ok ? s[x] * p.scale + slope[rr] * (float)(pos - qpos[rr])
                      : -INFINITY;
          }
        }

        // online softmax; s[i] belongs to row rr = (i / 2) % 2
        float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
        for (int x = 0; x < kTok / 2; ++x)
          mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          alpha[rr] = exp2f((m[rr] - mx[rr]) * kLog2e);
          m[rr] = mx[rr];
        }
#pragma unroll
        for (int x = 0; x < kTok / 2; ++x) {   // exp2(-inf) = 0 where hidden
          s[x] = exp2f((s[x] - mx[(x >> 1) & 1]) * kLog2e);
          sum[(x >> 1) & 1] += s[x];
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + sum[rr];
#pragma unroll
        for (int x = 0; x < DMAX / 2; ++x) o[x] *= alpha[(x >> 1) & 1];

        // P as hi + lo in T: the S fragment of columns [16 kk, 16 kk + 16)
        // is the A fragment of k step kk; two products, P to ~16 bits
        uint32_t pa[kTok / 16][4], pl[kTok / 16][4];
        pack_split<T>(pa, pl, s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kTok / 16; ++kk) {   // 16 positions per step
          wgmma_rs<T, DMAX>(o, pa[kk],
                            sw128_desc(vs + kk * 16 * 128, kTok * 128, 1024));
          wgmma_rs<T, DMAX>(o, pl[kk],
                            sw128_desc(vs + kk * 16 * 128, kTok * 128, 1024));
        }
        wg_commit();
        wg_wait_all();
        fence_regs(o);
      }
      mbar_arrive(bar_empty + 8 * st);
    }

    // O / max(l, 1e-30) in T: lanes with nothing visible come out 0
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      const int ln = my0 + 8 * rr;
      if (ln >= lanes) continue;
      const float denom = fmaxf(l[rr], 1e-30f);
      T* row = out + qo_at(p, a, kh, g, ln, 0);
#pragma unroll
      for (int jb = 0; jb < DMAX / 8; ++jb) {
        const int c = 8 * jb + 2 * t4;        // D % 8 == 0: c + 1 < D too
        if (c < p.d)
          *reinterpret_cast<uint32_t*>(row + c) =
              pack2<T>(o[4 * jb + 2 * rr] / denom,
                       o[4 * jb + 2 * rr + 1] / denom);
      }
    }
  }
}

// ------------------------------------------------------ split-KV decode
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kChunk = 256;         // KV positions per CTA, on every card

__host__ __device__ constexpr int split_dmax(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}
// Lanes per CTA: each thread holds D / 32 columns of every lane's q and
// accumulator, 32 floats of each at most.
__host__ __device__ constexpr int split_lanes(int dmax) { return 1024 / dmax; }

// The grid of the split route: nch chunks per atom, ltiles tiles of lt
// lanes; the scratch holds [A, KVH * ltiles, nch, lt, D + 2] floats (m, l,
// then acc of each lane's partial).
struct SplitPlan {
  int nch, lt, ltiles;
  long long scratch_floats;
};
SplitPlan split_plan(const Args& p) {
  SplitPlan s;
  const int lanes = p.bq * (p.h / p.kvh);
  s.nch = (p.bps * p.block_size + kChunk - 1) / kChunk;
  s.lt = min(split_lanes(split_dmax(p.d)), lanes);
  s.ltiles = (lanes + s.lt - 1) / s.lt;
  s.scratch_floats = (long long)p.num_atoms * p.kvh * s.ltiles * s.nch *
                     s.lt * (p.d + 2);
  return s;
}

// E consecutive T of one row, kept as W raw 32-bit words until used: a
// load is issued well before the arithmetic that waits for it.
template <typename T, int E>
struct Row {
  static constexpr int W = E * (int)sizeof(T) / 4;
  uint32_t w[W];
};

// One vector load when `vec` (row and column aligned to E * sizeof(T)
// bytes), else element by element up to `n` columns; zeros past them.
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* src, Row<T, E>& r,
                                         bool vec, int n) {
  constexpr int B = E * (int)sizeof(T);
  if (vec && n >= E) {
    if constexpr (B >= 16) {
#pragma unroll
      for (int i = 0; i < B / 16; ++i) {
        const uint4 x = reinterpret_cast<const uint4*>(src)[i];
        r.w[4 * i] = x.x;
        r.w[4 * i + 1] = x.y;
        r.w[4 * i + 2] = x.z;
        r.w[4 * i + 3] = x.w;
      }
    } else if constexpr (B == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      r.w[0] = x.x;
      r.w[1] = x.y;
    } else {
      r.w[0] = *reinterpret_cast<const uint32_t*>(src);
    }
  } else if constexpr (sizeof(T) == 4) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int e = 0; e < E; ++e) r.w[e] = e < n ? u[e] : 0u;
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < Row<T, E>::W; ++i)
      r.w[i] = (2 * i < n ? (uint32_t)u[2 * i] : 0u) |
               (2 * i + 1 < n ? (uint32_t)u[2 * i + 1] << 16 : 0u);
  }
}
template <typename T, int E>
__device__ __forceinline__ void zero_row(Row<T, E>& r) {
#pragma unroll
  for (int i = 0; i < Row<T, E>::W; ++i) r.w[i] = 0u;
}
// The row's values as floats.
template <typename T, int E>
__device__ __forceinline__ void unpack(const Row<T, E>& r, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < Row<T, E>::W; ++i) {
    const uint32_t w = r.w[i];
    if constexpr (std::is_same<T, float>::value) {
      x[i] = __uint_as_float(w);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      x[2 * i] = __uint_as_float(w << 16);
      x[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    } else {
      x[2 * i] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
      x[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
    }
  }
}

// LM: lanes per CTA at most: 1 (MHA decode), 4 (GQA groups up to 4) or
// split_lanes(DMAX). Up to 4 lanes a thread needs ~100 registers (three
// CTAs an SM); the widest instance is held to 2 so that it does not spill.
template <typename T, int DMAX, int LM>
__global__ void __launch_bounds__(kSplitThreads, LM <= 4 ? 3 : 2)
paged_decode_split_kernel(const Args p, int nch, int lt, int ltiles) {
  constexpr int E = DMAX / 32;               // columns per thread
  constexpr int TG = 64 / (E * (int)sizeof(T));   // positions per step:
                                                  // 64 bytes of K and of V
  constexpr int kPer = kChunk / kSplitWarps;      // positions per warp
  static_assert(kPer == 64 && kPer % TG == 0, "warp range");
  __shared__ float sm_m[kSplitWarps][LM], sm_l[kSplitWarps][LM];
  __shared__ float sm_acc[kSplitWarps][LM][DMAX];

  const int ch = blockIdx.x, y = blockIdx.y, a = blockIdx.z;
  const int kh = y / ltiles;
  const int g = p.h / p.kvh, lanes = p.bq * g;
  const int lane0 = (y % ltiles) * lt, lane_end = min(lane0 + lt, lanes);
  const int nl = lane_end - lane0;
  int pos0, qlen;
  atom_rows(p, a, pos0, qlen);
  const Span sp = kv_span(p, pos0, qlen, lane0, lane_end, g);
  if (sp.empty) {
    if (ch == 0)
      write_zeros<T>(p, a, kh, g, lane0, lane_end, threadIdx.x,
                     kSplitThreads);
    return;
  }
  const int ch_lo = sp.kv_lo / kChunk;
  const int ch_hi = (sp.kv_hi + kChunk - 1) / kChunk;
  if (ch < ch_lo || ch >= ch_hi) return;     // outside the lanes' range
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int col0 = ln * E, ncols = p.d - col0;   // this thread's columns

  // this warp's quarter of the chunk, cut to the lanes' range, and the
  // slot of each of its positions (two per thread, read once)
  const int w0 = max(ch * kChunk + warp * kPer, sp.kv_lo);
  const int w1 = min(ch * kChunk + (warp + 1) * kPer, sp.kv_hi);
  const int* table = p.tables + (size_t)a * p.bps;
  const int bs = p.block_size;
  int slot_of[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = w0 + 32 * hh + ln;
    slot_of[hh] = pos < w1 ? table[pos / bs] * bs + pos % bs : 0;
  }

  const T* q = static_cast<const T*>(p.q);
  float qv[LM][E], m[LM], l[LM], acc[LM][E];
  int qpos[LM];
  bool live[LM];
  float slope[LM];
  const bool qvec = p.d % E == 0 &&
                    reinterpret_cast<uintptr_t>(q) % (E * sizeof(T)) == 0;
#pragma unroll
  for (int li = 0; li < LM; ++li) {
    const int lane = lane0 + li;
    const bool in = li < nl;
    live[li] = in && lane / g < qlen;
    qpos[li] = pos0 + lane / g;
    slope[li] = (p.alibi != nullptr && in) ? p.alibi[kh * g + lane % g] : 0.f;
    Row<T, E> qr;
    if (in && ncols > 0)
      load_row<T, E>(q + qo_at(p, a, kh, g, lane, col0), qr, qvec, ncols);
    else
      zero_row(qr);
    unpack(qr, qv[li]);
    m[li] = kNegInf;
    l[li] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[li][e] = 0.f;
  }

  const T* kp = static_cast<const T*>(p.k) + (size_t)kh * p.d + col0;
  const T* vp = static_cast<const T*>(p.v) + (size_t)kh * p.d + col0;
  const size_t slot_stride = (size_t)p.kvh * p.d;
  const bool vec = p.d % E == 0 &&
      reinterpret_cast<uintptr_t>(p.k) % (E * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(p.v) % (E * sizeof(T)) == 0;

  for (int j0 = w0; j0 < w1; j0 += TG) {
    Row<T, E> kr[TG], vr[TG];
#pragma unroll
    for (int i = 0; i < TG; ++i) {       // every load before the first use
      const int t = j0 - w0 + i;         // < kPer, the same in every lane
      const size_t off =
          (size_t)__shfl_sync(0xffffffffu, t < 32 ? slot_of[0] : slot_of[1],
                              t & 31) * slot_stride;
      if (j0 + i < w1 && ncols > 0) {
        load_row<T, E>(kp + off, kr[i], vec, ncols);
        load_row<T, E>(vp + off, vr[i], vec, ncols);
      } else {   // zeros: P is 0 there and V must not be NaN garbage
        zero_row(kr[i]);
        zero_row(vr[i]);
      }
    }
#pragma unroll
    for (int li = 0; li < LM; ++li) {
      if (li >= nl) break;                   // the same in every thread
      float sc[TG], mx = m[li];
#pragma unroll
      for (int i = 0; i < TG; ++i) {
        float kx[E];
        unpack(kr[i], kx);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[li][e], kx[e], dot);
        dot = warp_sum(dot);
        const int pos = j0 + i;
        const bool ok = live[li] && pos < w1 && pos <= qpos[li] &&
                        (p.window <= 0 || qpos[li] - pos < p.window);
        sc[i] = ok ? dot * p.scale + slope[li] * (float)(pos - qpos[li])
                   : -INFINITY;
        mx = fmaxf(mx, sc[i]);
      }
      const float alpha = exp2f((m[li] - mx) * kLog2e);
      l[li] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[li][e] *= alpha;
#pragma unroll
      for (int i = 0; i < TG; ++i) {         // exp2(-inf) = 0 where hidden
        const float pe = exp2f((sc[i] - mx) * kLog2e);
        float vx[E];
        unpack(vr[i], vx);
        l[li] += pe;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[li][e] = fmaf(pe, vx[e], acc[li][e]);
      }
      m[li] = mx;
    }
  }

  // the four warps' partials, merged in warp order
#pragma unroll
  for (int li = 0; li < LM; ++li) {
    if (ln == 0) {
      sm_m[warp][li] = m[li];
      sm_l[warp][li] = l[li];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][li][col0 + e] = acc[li][e];
  }
  __syncthreads();
  const bool single = ch_hi - ch_lo == 1;
  T* out = static_cast<T*>(p.out);
  float* part = p.scratch + (((size_t)a * gridDim.y + y) * nch + ch) * lt *
                                (p.d + 2);
  for (int i = threadIdx.x; i < nl * p.d; i += kSplitThreads) {
    const int li = i / p.d, col = i % p.d;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mm = fmaxf(mm, sm_m[w][li]);
    float ls = 0.f, av = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float e = exp2f((sm_m[w][li] - mm) * kLog2e);
      ls += sm_l[w][li] * e;
      av += sm_acc[w][li][col] * e;
    }
    if (single) {
      out[qo_at(p, a, kh, g, lane0 + li, col)] =
          from_f<T>(av / fmaxf(ls, 1e-30f));
    } else {
      float* pl = part + (size_t)li * (p.d + 2);
      if (col == 0) {
        pl[0] = mm;
        pl[1] = ls;
      }
      pl[2 + col] = av;
    }
  }
}

// One (atom, kv head, lane tile) whose range spans several chunks: its
// partials folded in chunk order into O.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_combine_kernel(const Args p, int nch, int lt, int ltiles) {
  const int a = blockIdx.x, y = blockIdx.y;
  const int kh = y / ltiles;
  const int g = p.h / p.kvh, lanes = p.bq * g;
  const int lane0 = (y % ltiles) * lt, lane_end = min(lane0 + lt, lanes);
  int pos0, qlen;
  atom_rows(p, a, pos0, qlen);
  const Span sp = kv_span(p, pos0, qlen, lane0, lane_end, g);
  if (sp.empty) return;
  const int ch_lo = sp.kv_lo / kChunk;
  const int ch_hi = (sp.kv_hi + kChunk - 1) / kChunk;
  if (ch_hi - ch_lo <= 1) return;            // written by the split kernel
  T* out = static_cast<T*>(p.out);
  const size_t stride = (size_t)lt * (p.d + 2);
  const float* base = p.scratch + ((size_t)a * gridDim.y + y) * nch * stride;
  for (int i = threadIdx.x; i < (lane_end - lane0) * p.d;
       i += kSplitThreads) {
    const int li = i / p.d, col = i % p.d;
    const float* pl = base + (size_t)li * (p.d + 2);
    float mm = kNegInf;
    for (int c = ch_lo; c < ch_hi; ++c) mm = fmaxf(mm, pl[c * stride]);
    float ls = 0.f, av = 0.f;
    for (int c = ch_lo; c < ch_hi; ++c) {
      const float* pc = pl + c * stride;
      const float e = exp2f((pc[0] - mm) * kLog2e);
      ls += pc[1] * e;
      av += pc[2 + col] * e;
    }
    out[qo_at(p, a, kh, g, lane0 + li, col)] =
        from_f<T>(av / fmaxf(ls, 1e-30f));
  }
}

// ------------------------------------------------------------------ launch
template <typename T, int TY, int TX, int RI, int CJ, int DJ>
cudaError_t launch_core(const Args& args, cudaStream_t stream) {
  constexpr int RT = TY * RI;
  constexpr int TK = TX * CJ;
  auto kernel = paged_attention_kernel<T, TY, TX, RI, CJ, DJ>;
  const size_t smem = smem_bytes<RT, TK>(args.d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int lanes = args.bq * (args.h / args.kvh);
  const dim3 grid(args.num_atoms, args.kvh, (lanes + RT - 1) / RT);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// 64 lanes x 64 kv tokens, a 4x4 S tile per thread
template <typename T>
cudaError_t dispatch_core(const Args& args, cudaStream_t s) {
  if (args.d <= 64) return launch_core<T, 16, 16, 4, 4, 4>(args, s);
  if (args.d <= 128) return launch_core<T, 16, 16, 4, 4, 8>(args, s);
  return launch_core<T, 16, 16, 4, 4, 16>(args, s);
}

template <typename T, int DMAX>
cudaError_t launch_split(const Args& args, const SplitPlan& sp,
                         cudaStream_t stream) {
  const int y = args.kvh * sp.ltiles;
  const dim3 grid(sp.nch, y, args.num_atoms);
  constexpr int kWide = split_lanes(DMAX);
  if (sp.lt == 1)
    paged_decode_split_kernel<T, DMAX, 1>
        <<<grid, kSplitThreads, 0, stream>>>(args, sp.nch, sp.lt, sp.ltiles);
  else if (kWide > 4 && sp.lt <= 4)
    paged_decode_split_kernel<T, DMAX, (kWide > 4 ? 4 : kWide)>
        <<<grid, kSplitThreads, 0, stream>>>(args, sp.nch, sp.lt, sp.ltiles);
  else
    paged_decode_split_kernel<T, DMAX, kWide>
        <<<grid, kSplitThreads, 0, stream>>>(args, sp.nch, sp.lt, sp.ltiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sp.nch == 1) return err;
  paged_decode_combine_kernel<T>
      <<<dim3(args.num_atoms, y), kSplitThreads, 0, stream>>>(
          args, sp.nch, sp.lt, sp.ltiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_split(const Args& args, long long scratch_floats,
                           cudaStream_t s) {
  const SplitPlan sp = split_plan(args);
  if (args.scratch == nullptr || scratch_floats < sp.scratch_floats ||
      args.kvh * sp.ltiles > 65535 || args.num_atoms > 65535)
    return cudaErrorInvalidValue;
  if (args.d <= 64) return launch_split<T, 64>(args, sp, s);
  if (args.d <= 128) return launch_split<T, 128>(args, sp, s);
  return launch_split<T, 256>(args, sp, s);
}

// A rank-4 map of 16-bit elements with the 128-byte swizzle and zeros out
// of bounds. byte_strides: of dims 1..3; a dimension of extent 1 never
// steps, so its stride is replaced by a valid one (TMA needs positive
// multiples of 16).
cudaError_t map_2byte(CUtensorMap* map, const void* ptr,
                      const cuuint64_t (&dims)[4],
                      const cuuint64_t (&byte_strides)[3],
                      const cuuint32_t (&box)[4], int dtype) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t widest = 16, strides[3];
  for (int x = 0; x < 3; ++x)
    if (dims[x + 1] > 1) {
      if (byte_strides[x] == 0 || byte_strides[x] % 16)
        return cudaErrorInvalidValue;
      widest = byte_strides[x] > widest ? byte_strides[x] : widest;
    }
  for (int x = 0; x < 3; ++x)
    strides[x] = dims[x + 1] > 1 ? byte_strides[x] : widest;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int DMAX>
cudaError_t launch_sm90(const Args& a, int dtype, cudaStream_t stream) {
  using L = PrefillTiles<DMAX>;
  const int g = a.h / a.kvh;
  const cuuint64_t es = 2, d = (cuuint64_t)a.d;
  CUtensorMap tq, tk, tv;
  const cuuint64_t qdims[4] = {d, (cuuint64_t)a.h, (cuuint64_t)a.bq,
                               (cuuint64_t)a.num_atoms};
  const cuuint64_t qst[3] = {d * es, a.h * d * es, a.bq * a.h * d * es};
  const cuuint32_t qbox[4] = {64, (cuuint32_t)g, (cuuint32_t)(kLanes / g), 1};
  const cuuint64_t kdims[4] = {d, (cuuint64_t)a.kvh, (cuuint64_t)a.num_slots,
                               1};
  const cuuint64_t kst[3] = {d * es, a.kvh * d * es,
                             a.num_slots * a.kvh * d * es};
  const cuuint32_t kbox[4] = {64, 1, (cuuint32_t)min(a.block_size, kTok), 1};
  cudaError_t err = map_2byte(&tq, a.q, qdims, qst, qbox, dtype);
  if (err == cudaSuccess) err = map_2byte(&tk, a.k, kdims, kst, kbox, dtype);
  if (err == cudaSuccess) err = map_2byte(&tv, a.v, kdims, kst, kbox, dtype);
  if (err != cudaSuccess) return err;
  const auto kernel = paged_prefill_sm90_kernel<T, DMAX>;
  static std::atomic<unsigned long long> allowed{0};   // one bit per device
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  const int rt = kLanes / g;
  const dim3 grid(a.num_atoms, a.kvh, (a.bq + rt - 1) / rt);
  kernel<<<grid, kSm90Threads, L::SMEM, stream>>>(a, tq, tk, tv);
  return cudaGetLastError();
}

// The routes, decided here and nowhere else (dsst_paged_attention and
// dsst_paged_kernel both ask). `aligned`: q, k and v start on 16 bytes.
enum Route { kSplit = 0, kSm90 = 1, kCore = 2 };
Route route_of(int dtype, int bq, int g, int d, int block_size,
               bool aligned) {
  if (bq * g <= 16) return kSplit;
  const bool blocks = block_size % kTok == 0 ||
                      (kTok % block_size == 0 && block_size >= 8);
  if ((dtype == 1 || dtype == 2) && d <= 128 && d % 8 == 0 && aligned &&
      blocks && kLanes % g == 0)
    return kSm90;
  return kCore;
}
const char* route_name(Route r) {
  return r == kSplit ? "paged_decode_split_kernel"
       : r == kSm90 ? "paged_prefill_sm90_kernel" : "paged_attention_kernel";
}

bool aligned16(const void* q, const void* k, const void* v) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

}  // namespace

// One route's launches for every dtype, in the unit that owns the route.
#define DSST_LAUNCH(R)                                                    \
  extern "C" int dsst_paged_launch_##R(const void* a, int dtype,          \
                                       long long scratch_floats, void* s)
DSST_LAUNCH(0);
DSST_LAUNCH(1);
DSST_LAUNCH(2);

#if DSST_OWNS(0)
DSST_LAUNCH(0) {  // kSplit
  const Args& args = *static_cast<const Args*>(a);
  cudaStream_t st = static_cast<cudaStream_t>(s);
  if (dtype == 0) return (int)dispatch_split<float>(args, scratch_floats, st);
  if (dtype == 1)
    return (int)dispatch_split<__nv_bfloat16>(args, scratch_floats, st);
  return (int)dispatch_split<__half>(args, scratch_floats, st);
}
#endif

#if DSST_OWNS(1)
DSST_LAUNCH(1) {  // kSm90: route_of picks it for bfloat16 / float16 only
  if (dtype == 0) return dsst_paged_launch_2(a, dtype, scratch_floats, s);
  const Args& args = *static_cast<const Args*>(a);
  cudaStream_t st = static_cast<cudaStream_t>(s);
  if (dtype == 1) {
    if (args.d <= 64)
      return (int)launch_sm90<__nv_bfloat16, 64>(args, dtype, st);
    return (int)launch_sm90<__nv_bfloat16, 128>(args, dtype, st);
  }
  if (args.d <= 64) return (int)launch_sm90<__half, 64>(args, dtype, st);
  return (int)launch_sm90<__half, 128>(args, dtype, st);
}
#endif

#if DSST_OWNS(2)
DSST_LAUNCH(2) {  // kCore
  const Args& args = *static_cast<const Args*>(a);
  cudaStream_t st = static_cast<cudaStream_t>(s);
  if (dtype == 0) return (int)dispatch_core<float>(args, st);
  if (dtype == 1) return (int)dispatch_core<__nv_bfloat16>(args, st);
  return (int)dispatch_core<__half>(args, st);
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Atoms' first positions
// and live rows: pos0 and qlen, or (decode, BQ = 1, both null) seq_lens,
// the cached tokens per slot. window <= 0: no sliding window. alibi: float32 [H] or null. scratch: float32, at least
// scratch_floats entries, for the split route (BQ * H / KVH <= 16; see
// split_plan), else may be null. Returns a cudaError_t (0 = launched).
int dsst_paged_attention(const void* q, const void* k, const void* v,
                         void* out, const int* tables, const int* pos0,
                         const int* qlen, const int* seq_lens,
                         const float* alibi, float* scratch,
                         long long scratch_floats, int num_atoms, int bq,
                         int h, int kvh, int d, int bps, int block_size,
                         int num_slots, int window, float scale, int dtype,
                         void* stream) {
  if (num_atoms <= 0 || bq <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 ||
      d > 256 || bps <= 0 || block_size <= 0 || num_slots <= 0 ||
      dtype < 0 || dtype > 2 || kvh > 65535 ||
      (seq_lens == nullptr ? pos0 == nullptr || qlen == nullptr : bq != 1))
    return (int)cudaErrorInvalidValue;
  Args args{q, k, v, out, tables, pos0, qlen, seq_lens, alibi, scratch,
            bq, h, kvh, d, bps, block_size, window, num_atoms, num_slots,
            scale};
  const Route r = route_of(dtype, bq, h / kvh, d, block_size,
                           aligned16(q, k, v));
  if (r == kSplit)
    return dsst_paged_launch_0(&args, dtype, scratch_floats, stream);
  if (r == kSm90)
    return dsst_paged_launch_1(&args, dtype, scratch_floats, stream);
  return dsst_paged_launch_2(&args, dtype, scratch_floats, stream);
}

// The kernel dsst_paged_attention launches for these shapes, dtype and
// alignment (aligned: q, k and v start on 16 bytes).
const char* dsst_paged_kernel(int bq, int h, int kvh, int d, int block_size,
                              int dtype, int aligned) {
  if (bq <= 0 || kvh <= 0 || h % kvh != 0) return nullptr;
  return route_name(route_of(dtype, bq, h / kvh, d, block_size, aligned != 0));
}

const char* dsst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif  // DSST_OWNS(2)
