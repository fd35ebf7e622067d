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
// (dead atom, row >= qlen) writes exact zeros.
//
// Design (first, simple version). One CTA of 256 threads per (atom, kv
// head, tile of RT q lanes); lane l of kv head kh is q row l / G, head
// kh*G + l % G, as in the Pallas kernel's [KVH, BQ*G, D] grouping. The CTA
// loads its own pos0/qlen/table row (no scalar prefetch), stages its q tile
// in shared memory as float32, and walks its KV range in tiles of TK
// tokens: gather K and V rows through the table into shared memory, S =
// QK^T on CUDA cores with a register tile per thread, one warp per row for
// the online-softmax update, then acc = acc * alpha + P V with the
// accumulator in registers. The KV range of a tile of rows is cut to what
// those rows can see: above the last row's causal limit and below the first
// row's window nothing is read, and the trip count follows the data, so
// dead atoms cost one zero-fill. Two shapes: RT=64 lanes for prefill atoms,
// RT=4 lanes for decode (BQ=1: one lane for MHA, G lanes for GQA).
//
// What bounds it on an H100. Decode reads each live sequence's K and V
// once per layer and does ~2 flops per byte: it is bound by device-memory
// bandwidth (3.35 TB/s). Long prefill does O(BQ) flops per KV byte and is
// bound by the tensor cores (989 TFLOP/s bf16). This version uses neither
// well: S and PV run on the float32 CUDA cores (no wgmma, no mma.sync), K/V
// are gathered with plain element loads (no TMA, no cp.async pipeline, no
// double buffering), decode does not split the KV range across CTAs
// (split-KV), so a short batch fills few SMs, and the prefill shape uses
// ~116 KB of shared memory, one CTA per SM. Those are the later PRs' work.
//
// Interface: a plain C function loaded with ctypes. It launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // NEG_INF of the Pallas kernel

struct Args {
  const void* q;        // [A, BQ, H, D]
  const void* k;        // [num_slots, KVH, D], one layer of the pool
  const void* v;
  void* out;            // [A, BQ, H, D]
  const int* tables;    // [A, bps]
  const int* pos0;      // [A]
  const int* qlen;      // [A]
  const float* alibi;   // [H] or null
  int bq, h, kvh, d, bps, block_size, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

  const int pos0 = p.pos0[a];
  const int qlen = p.qlen[a];
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

template <typename T, int TY, int TX, int RI, int CJ, int DJ>
cudaError_t launch(const Args& args, int num_atoms, cudaStream_t stream) {
  constexpr int RT = TY * RI;
  constexpr int TK = TX * CJ;
  auto kernel = paged_attention_kernel<T, TY, TX, RI, CJ, DJ>;
  const size_t smem = smem_bytes<RT, TK>(args.d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int lanes = args.bq * (args.h / args.kvh);
  const dim3 grid(num_atoms, args.kvh, (lanes + RT - 1) / RT);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// prefill shape: 64 lanes x 64 kv tokens, 4x4 S tile per thread;
// decode shape: 4 lanes x 64 kv tokens, one S entry per thread
template <typename T, int DMAX>
cudaError_t dispatch_shape(const Args& args, int num_atoms, bool small,
                           cudaStream_t stream) {
  if (small) return launch<T, 4, 64, 1, 1, (DMAX + 63) / 64>(args, num_atoms, stream);
  return launch<T, 16, 16, 4, 4, DMAX / 16>(args, num_atoms, stream);
}

template <typename T>
cudaError_t dispatch_dim(const Args& args, int num_atoms, bool small,
                         cudaStream_t stream) {
  if (args.d <= 64) return dispatch_shape<T, 64>(args, num_atoms, small, stream);
  if (args.d <= 128) return dispatch_shape<T, 128>(args, num_atoms, small, stream);
  return dispatch_shape<T, 256>(args, num_atoms, small, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no sliding window.
// alibi: float32 [H] or null. Returns a cudaError_t (0 = launched).
int dsst_paged_attention(const void* q, const void* k, const void* v,
                         void* out, const int* tables, const int* pos0,
                         const int* qlen, const float* alibi, int num_atoms,
                         int bq, int h, int kvh, int d, int bps,
                         int block_size, int window, float scale, int dtype,
                         void* stream) {
  if (num_atoms <= 0 || bq <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 ||
      d > 256 || bps <= 0 || block_size <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args args{q, k, v, out, tables, pos0, qlen, alibi,
            bq, h, kvh, d, bps, block_size, window, scale};
  const bool small = bq * (h / kvh) <= 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dim<float>(args, num_atoms, small, s);
  return (int)dispatch_dim<__nv_bfloat16>(args, num_atoms, small, s);
}

const char* dsst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
