// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// repro/kernels/flash_attention/flash_attention.py (_kernel, launched by
// _run over a (B*H, q blocks, kv blocks) grid whose kv axis runs in order
// on one core, carrying the running max, normaliser and accumulator in
// VMEM scratch).  For each query row i of head h:
//   s[j]  = (q_i . k_j) * scale                       (f32 products and sums)
//   s[j]  = -1e30 where key j is masked
//   o_i   = sum_j exp(s[j] - m) v_j / max(sum_j exp(s[j] - m), 1e-30)
// with the max m, the normaliser and the accumulator kept in f32 and
// updated online tile by tile (flash_attention.py:51-77), and o cast to
// q's type once.  Key j is masked for row i when j >= kv_len[b] (the
// ragged kv / decode length) or, under `causal`, when j > q_offset + s(i):
// q_offset is the absolute position of query row 0, so the Pallas
// kernel's decode offset (valid_k - valid_q, flash_attention.py:36) is
// q_offset = T - S and repro/models/lm/model.py::_chunked_attention's
// contract is taken as is.  GQA: query head h reads KV head h / (Hq / Hkv)
// in place; nothing is repeated (flash_attention.py:124-126 and
// model.py:165-167 repeat).
//
// Layout.  q is (B, S, Hq, D) and k/v (B, T, Hkv, D), as the LM model
// holds them and its KV cache stores them; the kernels take element
// strides for the batch, sequence and head axes (the last axis is
// contiguous), so a permuted view of the (B, H, S, D) layout, or a cache
// longer than kv_len, is read in place with no copy.  The output has its
// own strides.  Every block takes one (b, KV head) pair and a tile of its
// flattened (position, head-in-group) query rows, position-major, so the
// group's heads share every K/V tile it loads.  Tiles wholly past the
// causal frontier of the block's last row or past kv_len are never
// loaded; keys at or past kv_len are never read (zero-filled).
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s).
// llama3.2-3b prefill_32k (S = T = 32,768, 24 heads over 8, D 128,
// causal): 4 D per kept (query, key) pair, 6.6 TFLOP a layer, bound by
// operations (6.7 ms).  gemma-2b prefill at 8k (8 heads over 1, D 256):
// 0.28 ms, operations.  Decode (one row per head): bound by bytes, the
// cache read once: 1.07 GB a layer at decode_32k B 8 (0.32 ms), 2.15 GB
// at long_500k (0.64 ms).
//
// bf16 (the serving path): two kernels, both on the tensor cores with
// bf16 operands and f32 accumulators.  K and V stay bf16 in shared
// memory (never widened), copied by cp.async into a ring of stages, in a
// 128-byte XOR swizzle, so ldmatrix (and ldmatrix.trans for V) or the
// wgmma descriptors read them without bank conflicts.
//  * The tile kernel (prefill, and any call with more than 16 rows per
//    KV head), one block per SM:
//    - fa_wgmma (D 64-256): a producer warpgroup fills a ring of 3
//      stages of K and V tiles (mbarriers for full and free stages);
//      consumer warpgroups of 64 rows run S = Q.K^T with wgmma from
//      shared memory (Q and K K-major), the online softmax on S in
//      registers, and O += P.V with wgmma, P from registers and V from
//      shared memory read transposed (MN-major).  Up to D 128: two
//      consumer warpgroups (128 rows) and 128-key tiles (225 KB at D
//      128).  At D 256: one consumer warpgroup (64 rows) and 64-key
//      tiles, because a 384-thread block leaves 168 registers a thread
//      and the 64 x 256 accumulator alone takes 128 (a 256-thread block
//      allows 255).  gemma's MQA K/V at 8k (8 MB) stays in L2, so 64-row
//      blocks cost little there.
//    - fa_mma (D 32, whose 64-byte rows are below the 128-byte swizzle):
//      8 warps of 16 rows, mma.sync.m16n8k16 with ldmatrix and
//      ldmatrix.trans, 64-key tiles in a ring of 3 stages.
//    In both, the score fragment is the A fragment of P.V: P never
//    leaves registers.
//  * fa_decode (at most 16 rows per (b, KV head): 3 for llama, 8 for
//    gemma's MQA): the group's rows fill one 16-row mma.sync tile and the
//    4 warps split each 64-key tile 16 keys apiece, so the block streams
//    K and V once through a ring of 3 stages (96 KB at D 128: two blocks
//    per SM) and the idle MMA rows cost no bytes; the warps' softmax
//    states are combined in shared memory at the end.
//  Scores are f32 sums of exact products (bf16 x bf16 is exact in f32),
//  as the reference's f32 einsum; only the order of the sums differs.
//  P.V runs on P split in two: P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//  two products into one f32 accumulator, so P carries 16 bits (within
//  2^-16 of each weight).  P rounded once to bf16 (up to 2^-8 off) would
//  put outputs near zero past the one-bf16-step check's floor of 1e-4 of
//  the largest; the split costs 1.5x the bound's operations.  The online
//  softmax is f32 with the reference's -1e30 mask (exp as exp2 of
//  log2(e)-scaled scores; keys masked so far weigh 0); no atomic touches
//  a value (the split fold counts arrivals only), so a run repeats
//  bitwise.
//
// f32 (checks against the CPU, small cases): fa_fwd, FP32 pipes, no
// tensor cores.  A block of 256 threads takes 64 rows (RPT = 4 per
// thread), or 16 (RPT = 1) when the group has at most 16 rows; it loads
// each 64-key K/V tile into shared memory (rows padded so the 16-byte
// reads of the score loop do not collide in banks), computes scores on
// the FP32 pipes (no TF32), reduces the row max and sum over the 16
// lanes that share a row, passes P through shared memory and
// accumulates P.V in f32 registers.
//
// Split-KV (all kernels).  On a GPU the Pallas kernel's in-order kv axis
// becomes a loop inside the block.  When the blocks alone cannot fill the
// card (decode: 8 blocks at long_500k, each over 524,288 keys), the
// wrapper splits the kv tiles over `splits` blocks; each writes its
// partial (m, l, acc) in f32 to a workspace the wrapper allocates, and
// the same launch folds them (fold_splits): every block of a (row tile,
// b, KV head) group, an empty split's too (m -1e30, l 0, acc 0), fences
// its writes and adds one to the group's int32 counter (acq_rel, gpu
// scope); the block that sees splits - 1 is the last, reads all the
// partials through L2 (ld.global.cg: L1 is not coherent across SMs) in
// split order and writes
//   M = max_s m_s,  L = sum_s l_s e^(m_s - M),  o = sum_s acc_s e^(m_s - M) / max(L, 1e-30)
// in q's type, then resets the counter to 0 (the wrapper's buffer stays
// zero between launches).  Which block arrives last changes from run to
// run; what it computes does not, since it reads every split from memory
// in a fixed order, and no atomic touches a value: a run still repeats
// bitwise.  Every valid row sees key 0, so the first split's max is a
// real score and a split whose keys are all masked for a row weighs
// e^(-1e30 - M) = 0.  What bounds the fold on this card is latency, not
// bytes: the last block's chain of L2 reads, about 6 KB a (b, KV head) at
// decode_32k (4 splits x 3 rows x 128 x 4 bytes of acc), after its own
// tiles.  Its loads go out 8 splits at a time, so the chain is 2 round
// trips at decode_32k's 4 splits and 10 at long_500k's 33; the separate
// merge launch it replaces cost one more launch and its wrapper's host
// work on every decode call.
//
// Training route (lse non-null; flash_attention.py's flash_attention_lse,
// under lm_loss).  The tile kernels (fa_wgmma, fa_mma, fa_fwd) at one
// split also write each row's logsumexp in natural units, lse = m + log(l)
// with m the row's max of the scaled scores and l its sum of e^(s - m)
// (the exp2 form computes the same l), to an f32 (B, Hkv, rows) buffer:
// csrc/flash_attention_bwd.cu forms P = e^(s - lse) from it.  A tile
// kernel's launch with splits > 1 refuses an lse.
//
// Decode route with lse (flash_attention.py's flash_attention_decode_lse,
// a rank's block of a sequence-sharded KV cache under the decode rules).
// fa_decode takes two options: lse, each row's logsumexp in the same
// natural units, m + log(l) from its warps' combine at one split, M +
// log(L) from fold_splits after a split launch; and out_f32, the output
// rows written in f32 before any rounding (to an f32 tensor with its own
// strides).  A cross-rank fold (distributed/collectives.py::fold_seq)
// weighs each rank's f32 rows by e^(lse - max lse) and rounds once, as
// the fold of one launch's splits does.  Serving passes neither: the
// bf16 output is computed by the same instructions and is bitwise what
// it was.
//
// Head dims 32, 64, 112, 128, 256 (templates).  Shared memory is dynamic.
// Head dim 112 (kimi-k2: 7168 / 64): its 224-byte rows are no whole
// number of the 128-byte swizzle's 64-column atoms, so the bf16 kernels
// run it on their D 128 tiles
// (template D 128, DV 112 valid columns): cp.async copies 14 of a row's 16
// chunks and zero-fills the last 2 (source size 0), so Q.K^T sums 112
// products plus exact zeros and P.V leaves 16 zero columns, which are
// never written; the fold reads and writes only the 112 (its workspace
// keeps the tile's width).  Every other head dim runs DV = D, the code as
// it was.  The f32 kernel takes 112 as it is (its rows need only 16-byte
// multiples).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
using namespace hopper;

#define NT 256                  // threads per block of fa_fwd: 16 x 16
#define BK 64                   // keys per tile of fa_fwd
#define NEG_INF (-1e30f)

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);     // round to nearest even, as astype
}

// 16 bytes of a row (4 f32 values) from device memory into shared memory
// at dst (16-byte aligned).
__device__ __forceinline__ void load16(const float* __restrict__ src,
                                       float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void zero16(float* dst, int n) {
  for (int e = 0; e < n; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// max and sum over the 16 lanes (tx = 0..15) that hold one row
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

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int B, S, Hq, Hkv;
  long long qsb, qss, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, oss, osh;
  int causal, q_offset;
  const int* kv_len;            // (B,) or null
  int kv_max;                   // keys considered: min(T, an int kv_len)
  float scale;
  int splits;
  float* ws_m; float* ws_l; float* ws_acc;   // (splits, B, Hkv, rows[, D])
  int* counters;                // (B * Hkv * row tiles,), zero at launch
  int n_counters;
  float* lse;                   // (B, Hkv, rows) or null: splits 1 only,
                                // but for fa_decode
  int out_f32;                  // fa_decode: o is f32, written unrounded
};

// The training route's logsumexp of row r, in natural units (the
// scores' own, s = q.k * scale): lse = m + log(l), m the row's max and l
// its sum of e^(s - m).  The backward forms P = e^(s - lse) from it.
__device__ __forceinline__ void write_lse(const Args& a, int b, int kvh,
                                          int rows, int r, float m,
                                          float l) {
  a.lse[((long long)b * a.Hkv + kvh) * rows + r] = m + logf(l);
}

// The split-KV fold (the source note's "Split-KV").  Every block of a
// split launch calls it right after writing its partials, with all NTH
// threads that take part (t: 0..NTH-1); the block's rows are [r0, r0 +
// BQ) of its (b, KV head).  The last block of the group writes the
// output rows from all the splits' partials, column quads to threads,
// exactly as a separate merge over them would: the same f32 operations in
// the same (split) order.
template <typename T, int D, int NTH, int BAR, int DV = D>
__device__ __forceinline__ void fold_splits(const Args& a, int b, int kvh,
                                            int rep, int rows, int r0,
                                            int BQ, int t) {
  __threadfence();                      // this thread's partials are out
  bar_sync<NTH, BAR>();                 // ... and every writer's
  int* cnt = a.counters + (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const bool last =
      bar_or<NTH, BAR>(t == 0 && arrive(cnt) == a.splits - 1);
  if (!last) return;
  __threadfence();
  const int nr = min(BQ, rows - r0);
  const long long stride = (long long)a.B * a.Hkv * rows;
  const long long w0 = ((long long)b * a.Hkv + kvh) * rows + r0;
  // Splits are read FU at a time, every load of a group issued before the
  // first use, so a group costs one L2 round trip, not FU: the tail is a
  // chain of 2 * ceil(splits / FU) round trips.  Slots past the last split
  // load nothing and change nothing (fmaxf(M, -1e30) is M).
  constexpr int FU = 8;
  for (int i = t; i < nr * (DV / 4); i += NTH) {
    const int rr = i / (DV / 4), c = 4 * (i % (DV / 4));
    const long long w = w0 + rr;
    float M = NEG_INF;
    for (int s0 = 0; s0 < a.splits; s0 += FU) {
      float m[FU];
#pragma unroll
      for (int j = 0; j < FU; ++j)
        m[j] = s0 + j < a.splits ? __ldcg(a.ws_m + w + (s0 + j) * stride)
                                 : NEG_INF;
#pragma unroll
      for (int j = 0; j < FU; ++j) M = fmaxf(M, m[j]);
    }
    float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < a.splits; s0 += FU) {
      float m[FU], l[FU];
      float4 x[FU];
#pragma unroll
      for (int j = 0; j < FU; ++j) {
        if (s0 + j < a.splits) {
          const long long ws = w + (s0 + j) * stride;
          m[j] = __ldcg(a.ws_m + ws);
          l[j] = __ldcg(a.ws_l + ws);
          x[j] = __ldcg(reinterpret_cast<const float4*>(a.ws_acc + ws * D
                                                        + c));
        }
      }
#pragma unroll
      for (int j = 0; j < FU; ++j) {
        if (s0 + j < a.splits) {
          const float e = expf(m[j] - M);
          L += l[j] * e;
          A[0] += x[j].x * e;
          A[1] += x[j].y * e;
          A[2] += x[j].z * e;
          A[3] += x[j].w * e;
        }
      }
    }
    const int r = r0 + rr;
    const long long off = b * a.osb + (r / rep) * a.oss
                          + (kvh * rep + r % rep) * a.osh + c;
    if (a.out_f32) {
      float* o = static_cast<float*>(a.o) + off;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = A[e] / fmaxf(L, 1e-30f);
    } else {
      T* o = static_cast<T*>(a.o) + off;
#pragma unroll
      for (int e = 0; e < 4; ++e) put(o + e, A[e] / fmaxf(L, 1e-30f));
    }
    if (a.lse && c == 0) write_lse(a, b, kvh, rows, r, M, L);
  }
  if (t == 0) atomicExch(cnt, 0);       // zero for the next launch
}

// A split launch's grid must fit the wrapper's counters.
static bool counters_fit(int splits, const dim3& grid, int n_counters) {
  return splits == 1 || (long long)grid.x * grid.y <= n_counters;
}

template <int D> struct Smem {
  static constexpr int QS = D + 4;        // padded row of Q and K tiles
  static constexpr int PS = BK + 4;       // padded row of the P tile
};

template <int D, int RPT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(16 * RPT * Smem<D>::QS + BK * Smem<D>::QS
                                  + BK * D + 16 * RPT * Smem<D>::PS);
}

template <typename T, int D, int RPT>
__global__ void __launch_bounds__(NT, 1) fa_fwd(Args a) {
  constexpr int BQ = 16 * RPT;
  constexpr int QS = Smem<D>::QS, PS = Smem<D>::PS;
  constexpr int CS = BK / 16;             // keys per thread in a tile
  constexpr int CO = D / 16;              // output columns per thread
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;   // the heaviest causal tiles first
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int split = blockIdx.z;
  const int rep = a.Hq / a.Hkv;
  const int rows = a.S * rep;             // flattened (position, head) rows
  const int r0 = qt * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.qsb;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  // this block's keys: [0, hi), tiles [t_lo, t_hi)
  int kv_end = a.kv_max;
  if (a.kv_len) kv_end = min(kv_end, a.kv_len[b]);
  const int last_row = min(r0 + BQ, rows) - 1;
  int hi = kv_end;
  if (a.causal) hi = min(hi, a.q_offset + last_row / rep + 1);
  const int n_all = (a.kv_max + BK - 1) / BK;
  const int per = (n_all + a.splits - 1) / a.splits;
  const int t_lo = split * per;
  const int t_hi = min((hi + BK - 1) / BK, t_lo + per);

  // Q tile -> shared memory (f32), zero rows past the end
  for (int c = tid; c < BQ * (D / VEC); c += NT) {
    const int rr = c / (D / VEC), d = (c % (D / VEC)) * VEC;
    const int r = r0 + rr;
    float* dst = sQ + rr * QS + d;
    if (r < rows) {
      const int s = r / rep, h = kvh * rep + r % rep;
      load16(q + s * a.qss + h * a.qsh + d, dst);
    } else {
      zero16(dst, VEC);
    }
  }

  float m[RPT], l[RPT], acc[RPT][CO];
  int pos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    pos[i] = a.q_offset + (r0 + ty * RPT + i) / rep;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int j0 = t * BK;
    __syncthreads();                      // last tile's readers are done
    for (int c = tid; c < BK * (D / VEC); c += NT) {
      const int jj = c / (D / VEC), d = (c % (D / VEC)) * VEC;
      const int j = j0 + jj;
      if (j < kv_end) {
        load16(kp + (long long)j * a.kst + d, sK + jj * QS + d);
        load16(vp + (long long)j * a.vst + d, sV + jj * D + d);
      } else {
        zero16(sK + jj * QS + d, VEC);
        zero16(sV + jj * D + d, VEC);
      }
    }
    __syncthreads();

    // scores: rows ty*RPT + i, keys tx + 16c
    float s[RPT][CS];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CS; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[CS];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * RPT + i) * QS + d);
#pragma unroll
      for (int c = 0; c < CS; ++c)
        kv[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * QS + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

    // mask, online softmax, P -> shared memory
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int j = j0 + tx + 16 * c;
        const bool ok = j < kv_end && (!a.causal || j <= pos[i]);
        s[i][c] = ok ? s[i][c] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        sP[(ty * RPT + i) * PS + tx + 16 * c] = p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        p[i] = *reinterpret_cast<const float4*>(sP + (ty * RPT + i) * PS + j);
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float v0 = sV[(j + 0) * D + tx + 16 * c];
        const float v1 = sV[(j + 1) * D + tx + 16 * c];
        const float v2 = sV[(j + 2) * D + tx + 16 * c];
        const float v3 = sV[(j + 3) * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][c] = fmaf(p[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(p[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(p[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(p[i].w, v3, acc[i][c]);
        }
      }
    }
  }

  // write the output rows, or this split's partials
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty * RPT + i;
    if (r >= rows) continue;
    if (a.splits == 1) {
      const int s_ = r / rep, h = kvh * rep + r % rep;
      T* o = static_cast<T*>(a.o) + b * a.osb + s_ * a.oss + h * a.osh;
      const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CO; ++c) put(o + tx + 16 * c, acc[i][c] * inv_l);
      if (a.lse && tx == 0) write_lse(a, b, kvh, rows, r, m[i], l[i]);
    } else {
      const long long w = (((long long)split * a.B + b) * a.Hkv + kvh) * rows + r;
      if (tx == 0) {
        a.ws_m[w] = m[i];
        a.ws_l[w] = l[i];
      }
#pragma unroll
      for (int c = 0; c < CO; ++c) a.ws_acc[w * D + tx + 16 * c] = acc[i][c];
    }
  }
  if (a.splits > 1)
    fold_splits<T, D, NT, 0>(a, b, kvh, rep, rows, r0, BQ, tid);
}

template <typename T, int D, int RPT>
static cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D, RPT>();
  const int rows = a.S * (a.Hq / a.Hkv);
  dim3 grid((rows + 16 * RPT - 1) / (16 * RPT), a.B * a.Hkv, a.splits);
  if (!counters_fit(a.splits, grid, a.n_counters))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd<T, D, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  fa_fwd<T, D, RPT><<<grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
static cudaError_t launch_rpt(const Args& a, int rpt, cudaStream_t st) {
  return rpt == 1 ? launch_fwd<T, D, 1>(a, st) : launch_fwd<T, D, 4>(a, st);
}

template <typename T>
static cudaError_t launch_d(const Args& a, int D, int rpt, cudaStream_t st) {
  switch (D) {
    case 32: return launch_rpt<T, 32>(a, rpt, st);
    case 64: return launch_rpt<T, 64>(a, rpt, st);
    case 112: return launch_rpt<T, 112>(a, rpt, st);
    case 128: return launch_rpt<T, 128>(a, rpt, st);
    case 256: return launch_rpt<T, 256>(a, rpt, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int BKT = 64;                 // keys per K/V tile
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of 16-byte chunk c of row r in a tile of rows of D bf16
// values.  The chunk index is XORed with the row (a 128-byte swizzle), so
// the 8 rows an ldmatrix reads at one logical chunk sit in 8 different
// bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CH = D / 8;             // chunks per row
  const int p = CH >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));
  return (uint32_t)(r * D * 2 + p * 16);
}

__device__ __forceinline__ void ldm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldm4t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// p (two f32 weights) as hi = bf16(p) and lo = bf16(p - hi): hi + lo
// carries about 16 bits of p (p - hi is exact in f32).
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// Rows [0, R) of a K or V tile (keys j0 + r) into the swizzled tile at
// dst; keys at or past j_end, and columns at or past DV, are zeroed, never
// read.
template <int D, int R, int NTH, int DV = D>
__device__ __forceinline__ void load_kv(uint32_t dst, const bf16* g,
                                        long long stride, int j0, int j_end,
                                        int tid) {
  constexpr int CH = D / 8;
  static_assert(R * CH % NTH == 0, "whole chunks per thread");
#pragma unroll
  for (int k = 0; k < R * CH / NTH; ++k) {
    const int i = tid + k * NTH;
    const int r = i / CH, c = i % CH, j = j0 + r;
    const bool ok = j < j_end && (DV == D || c * 8 < DV);
    cp16(dst + swz<D>(r, c), ok ? g + (long long)j * stride + c * 8 : g, ok);
  }
}

// Rows [r0, r0 + R) of the block's flattened (position, head-in-group)
// query rows into the swizzled tile at dst; rows past `rows`, and columns
// at or past DV, are zeroed.
template <int D, int R, int NTH, int DV = D>
__device__ __forceinline__ void load_q(uint32_t dst, const bf16* q,
                                       const Args& a, int kvh, int rep,
                                       int r0, int rows, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int k = 0; k < (R * CH + NTH - 1) / NTH; ++k) {
    const int i = tid + k * NTH;
    if (i >= R * CH) break;
    const int rr = i / CH, c = i % CH, r = r0 + rr;
    const bool ok = r < rows && (DV == D || c * 8 < DV);
    const bf16* src = q;
    if (ok) src = q + (r / rep) * a.qss + (kvh * rep + r % rep) * a.qsh + c * 8;
    cp16(dst + swz<D>(rr, c), src, ok);
  }
}

// The online-softmax state of one warp's 16 rows: this thread holds rows
// g and g + 8 (g = lane / 4), output columns 8 n + 2 (lane % 4) + {0, 1}.
template <int D>
struct Rows {
  float m[2], l[2];                     // l: this thread's columns only
  float acc[D / 8][4];
  __device__ __forceinline__ void init() {
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
};

// One warp, one tile of scores s (16 rows x 8 NB keys, raw q.k): scaled,
// masked, folded into the running max and sums; s becomes P (f32), and
// alpha the factor that rescales the accumulator (rescale).  Key of
// s[n][e]: kbase + 8 n + 2 (lane % 4) + (e & 1); row position
// pos[e >> 1].  The accumulator has the same fragment layout (mma.sync's
// C, or a warp's share of wgmma's).
template <int D, int NB>
__device__ __forceinline__ void softmax_step(Rows<D>& st, float (&s)[NB][4],
                                             const Args& a, bool need_mask,
                                             int kbase, int kv_end,
                                             const int (&pos)[2], int lane,
                                             float (&alpha)[2]) {
  const int t4 = lane & 3;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * a.scale;
      if (need_mask) {
        const int j = kbase + 8 * n + 2 * t4 + (e & 1);
        const bool ok = j < kv_end && (!a.causal || j <= pos[e >> 1]);
        x = ok ? x : NEG_INF;
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(st.m[i], mx[i]);
    // every key so far masked: weigh them 0, not e^0
    ms[i] = m_new == NEG_INF ? 0.f : m_new * LOG2E;
    alpha[i] = exp2f(st.m[i] * LOG2E - ms[i]);
    st.m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[n][e], LOG2E, -ms[e >> 1]));
      s[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * alpha[i] + sum[i];
}

// The accumulator's rows rescaled by softmax_step's alpha (its new max).
template <int D>
__device__ __forceinline__ void rescale(Rows<D>& st, const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.acc[n][0] *= alpha[0];
    st.acc[n][1] *= alpha[0];
    st.acc[n][2] *= alpha[1];
    st.acc[n][3] *= alpha[1];
  }
}

// acc += (P_hi + P_lo) V for one warp's 16 rows and 8 NB keys of P (the
// score fragments after softmax_step).  v_s: the V tile's shared
// address, v_row0: the tile row of this warp's first key.
template <int D, int NB>
__device__ __forceinline__ void pv_mma(Rows<D>& st, const float (&s)[NB][4],
                                       uint32_t v_s, int v_row0, int lane) {
  // the score fragment of keys 16 kk.. is the A fragment of the product,
  // V^T comes from ldmatrix.trans: the score fragment of keys 16 kk.. is the A
  // fragment of the product, V^T comes from ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t ph[4], pl[4];
    split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
    const int vr = v_row0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      uint32_t b[4];
      ldm4t(v_s + swz<D>(vr, 2 * db + (lane >> 4)), b);
      mma(st.acc[2 * db], ph, b[0], b[1]);
      mma(st.acc[2 * db], pl, b[0], b[1]);
      mma(st.acc[2 * db + 1], ph, b[2], b[3]);
      mma(st.acc[2 * db + 1], pl, b[2], b[3]);
    }
  }
}

// s (16 x 8 NB) = Q (16 rows at q_row0 of the Q tile) . K^T (keys at tile
// rows k_row0..), Q's A fragments from registers (qf) or shared memory.
template <int D, int NB, bool QREG>
__device__ __forceinline__ void scores(float (&s)[NB][4],
                                       const uint32_t (&qf)[QREG ? D / 16
                                                                 : 1][4],
                                       uint32_t q_s, int q_row0, uint32_t k_s,
                                       int k_row0, int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4];
    if constexpr (QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = qf[kd][e];
    } else {
      ldm4(q_s + swz<D>(q_row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        2 * kd + (lane >> 4)), af);
    }
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      ldm4(k_s + swz<D>(k_row0 + 16 * nb + (lane & 7) + ((lane >> 4) & 1) * 8,
                        2 * kd + ((lane >> 3) & 1)), b);
      mma(s[2 * nb], af, b[0], b[1]);
      mma(s[2 * nb + 1], af, b[2], b[3]);
    }
  }
}

template <int D, bool QREG>
__device__ __forceinline__ void load_qf(uint32_t (&qf)[QREG ? D / 16 : 1][4],
                                        uint32_t q_s, int q_row0, int lane) {
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldm4(q_s + swz<D>(q_row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        2 * kd + (lane >> 4)), qf[kd]);
  }
}

// This block's keys: [0, kv_end) masked by kv_len, tiles [t_lo, t_hi)
// of its split, cut at the causal frontier of the block's last row.
struct Range { int kv_end, t_lo, t_hi; };
template <int BN = BKT>
__device__ __forceinline__ Range key_range(const Args& a, int b, int split,
                                           int last_row, int rep) {
  Range r;
  r.kv_end = a.kv_max;
  if (a.kv_len) r.kv_end = min(r.kv_end, a.kv_len[b]);
  int hi = r.kv_end;
  if (a.causal) hi = min(hi, a.q_offset + last_row / rep + 1);
  const int n_all = (a.kv_max + BN - 1) / BN;
  const int per = (n_all + a.splits - 1) / a.splits;
  r.t_lo = split * per;
  r.t_hi = min((hi + BN - 1) / BN, r.t_lo + per);
  return r;
}

// Writes a finished row (o = acc / max(l, 1e-30) in bf16) or this split's
// partial (m, l, acc in f32).  l must already be the whole row's sum.
// Columns at or past DV (a padded head dim's) are not written.
template <int D, int DV = D>
__device__ __forceinline__ void write_row(const Args& a, int b, int kvh,
                                          int split, int rep, int rows, int r,
                                          float m, float l, float x0, float x1,
                                          int col) {
  // x0, x1: the accumulator at columns col, col + 1
  if (r >= rows) return;
  if constexpr (DV < D) {
    if (col >= DV) return;
  }
  if (a.splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const long long off = b * a.osb + (r / rep) * a.oss
                          + (kvh * rep + r % rep) * a.osh + col;
    if (a.out_f32) {
      *reinterpret_cast<float2*>(static_cast<float*>(a.o) + off) =
          make_float2(x0 * inv, x1 * inv);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.o) + off) =
          __floats2bfloat162_rn(x0 * inv, x1 * inv);
    }
  } else {
    const long long w = (((long long)split * a.B + b) * a.Hkv + kvh) * rows + r;
    if (col == 0) {
      a.ws_m[w] = m;
      a.ws_l[w] = l;
    }
    *reinterpret_cast<float2*>(a.ws_acc + w * D + col) =
        make_float2(x0, x1);
  }
}

// The logsumexp of one thread's two rows (r and r + 8), with the whole
// rows' sums in l: the training route's, at splits 1 (write_lse).
template <int D>
__device__ __forceinline__ void rows_lse(const Args& a, int b, int kvh,
                                         int rows, int r, const Rows<D>& rs) {
  if (r < rows) write_lse(a, b, kvh, rows, r, rs.m[0], rs.l[0]);
  if (r + 8 < rows) write_lse(a, b, kvh, rows, r + 8, rs.m[1], rs.l[1]);
}

// The tile kernel at head dim 32 (fa_wgmma takes the others).  A block of
// 8 warps takes one (b, KV head) pair and 128 of its flattened query rows;
// warp w owns rows 16 w .. 16 w + 15 and every key of each 64-key tile.
// K and V tiles stream through a ring of STAGES stages by cp.async.
template <int D, int STAGES>
__global__ void __launch_bounds__(256, 1) fa_mma(Args a) {
  constexpr int NW = 8, NTH = 32 * NW, BQ = 16 * NW;
  constexpr int TILE = BKT * D * 2;     // bytes of a K or V tile
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t ring = q_s + BQ * D * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;    // the heaviest tiles first
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int split = blockIdx.z;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, r0 = qt * BQ;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
  const Range kr = key_range(a, b, split, min(r0 + BQ, rows) - 1, rep);

  load_q<D, BQ, NTH>(q_s, q, a, kvh, rep, r0, rows, tid);
#pragma unroll
  for (int sg = 0; sg < STAGES - 1; ++sg) {
    const int t = kr.t_lo + sg;
    if (t < kr.t_hi) {
      load_kv<D, BKT, NTH>(ring + sg * 2 * TILE, kp, a.kst, t * BKT,
                           kr.kv_end, tid);
      load_kv<D, BKT, NTH>(ring + sg * 2 * TILE + TILE, vp, a.vst, t * BKT,
                           kr.kv_end, tid);
    }
    cp_commit();
  }

  const int g = lane >> 2, wr = warp * 16;
  const int pos[2] = {a.q_offset + (r0 + wr + g) / rep,
                      a.q_offset + (r0 + wr + g + 8) / rep};
  const int first_pos = a.q_offset + r0 / rep;
  const int warp_last_pos = a.q_offset + (r0 + wr + 15) / rep;
  Rows<D> rs;
  rs.init();
  uint32_t qf[QREG ? D / 16 : 1][4];

  for (int t = kr.t_lo; t < kr.t_hi; ++t) {
    const int it = t - kr.t_lo;
    cp_wait<STAGES - 2>();
    __syncthreads();                    // tile t is in; tile t-1 is done
    {
      const int tn = t + STAGES - 1, sn = (it + STAGES - 1) % STAGES;
      if (tn < kr.t_hi) {
        load_kv<D, BKT, NTH>(ring + sn * 2 * TILE, kp, a.kst, tn * BKT,
                             kr.kv_end, tid);
        load_kv<D, BKT, NTH>(ring + sn * 2 * TILE + TILE, vp, a.vst,
                             tn * BKT, kr.kv_end, tid);
      }
      cp_commit();
    }
    if (it == 0) load_qf<D, QREG>(qf, q_s, wr, lane);
    const int j0 = t * BKT;
    if (a.causal && warp_last_pos < j0) continue;   // all masked: adds 0
    const uint32_t k_s = ring + (it % STAGES) * 2 * TILE;
    float s[BKT / 8][4];
    scores<D, BKT / 8, QREG>(s, qf, q_s, wr, k_s, 0, lane);
    const bool need_mask =
        j0 + BKT > kr.kv_end || (a.causal && j0 + BKT - 1 > first_pos);
    float alpha[2];
    softmax_step<D, BKT / 8>(rs, s, a, need_mask, j0, kr.kv_end, pos, lane,
                             alpha);
    rescale(rs, alpha);
    pv_mma<D, BKT / 8>(rs, s, k_s + TILE, 0, lane);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs.l[i] += __shfl_xor_sync(0xffffffffu, rs.l[i], 1);
    rs.l[i] += __shfl_xor_sync(0xffffffffu, rs.l[i], 2);
  }
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    write_row<D>(a, b, kvh, split, rep, rows, r0 + wr + g, rs.m[0], rs.l[0],
                 rs.acc[n][0], rs.acc[n][1], 8 * n + col);
    write_row<D>(a, b, kvh, split, rep, rows, r0 + wr + g + 8, rs.m[1],
                 rs.l[1], rs.acc[n][2], rs.acc[n][3], 8 * n + col);
  }
  if (a.lse && col == 0) rows_lse(a, b, kvh, rows, r0 + wr + g, rs);
  if (a.splits > 1)
    fold_splits<bf16, D, NTH, 0>(a, b, kvh, rep, rows, r0, BQ, tid);
}

// Decode: at most 16 query rows per (b, KV head), a long kv range.  A
// block of 4 warps takes one (b, KV head, split); the group's rows fill
// one 16-row MMA tile, and warp w takes keys 16 w .. 16 w + 15 of each
// 64-key tile, so the block streams K and V (a ring of STAGES tiles, by
// cp.async) and every byte is read once.  The 4 warps' softmax states are
// combined through shared memory at the end.
template <int D, int STAGES, int DV = D>
__global__ void __launch_bounds__(128) fa_decode(Args a) {
  constexpr int NW = 4, NTH = 32 * NW, BQ = 16;
  constexpr int TILE = BKT * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  unsigned char* ring_p = smem + BQ * D * 2;
  const uint32_t ring = smem_u32(ring_p);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int split = blockIdx.z;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
  const Range kr = key_range(a, b, split, rows - 1, rep);

  load_q<D, BQ, NTH, DV>(q_s, q, a, kvh, rep, 0, rows, tid);
#pragma unroll
  for (int sg = 0; sg < STAGES - 1; ++sg) {
    const int t = kr.t_lo + sg;
    if (t < kr.t_hi) {
      load_kv<D, BKT, NTH, DV>(ring + sg * 2 * TILE, kp, a.kst, t * BKT,
                               kr.kv_end, tid);
      load_kv<D, BKT, NTH, DV>(ring + sg * 2 * TILE + TILE, vp, a.vst,
                               t * BKT, kr.kv_end, tid);
    }
    cp_commit();
  }

  const int g = lane >> 2;
  const int pos[2] = {a.q_offset + g / rep, a.q_offset + (g + 8) / rep};
  const int first_pos = a.q_offset;
  Rows<D> rs;
  rs.init();
  constexpr bool QREG = D <= 128;        // at D 256: registers for acc
  uint32_t qf[QREG ? D / 16 : 1][4];

  for (int t = kr.t_lo; t < kr.t_hi; ++t) {
    const int it = t - kr.t_lo;
    cp_wait<STAGES - 2>();
    __syncthreads();
    {
      const int tn = t + STAGES - 1, sn = (it + STAGES - 1) % STAGES;
      if (tn < kr.t_hi) {
        load_kv<D, BKT, NTH, DV>(ring + sn * 2 * TILE, kp, a.kst, tn * BKT,
                                 kr.kv_end, tid);
        load_kv<D, BKT, NTH, DV>(ring + sn * 2 * TILE + TILE, vp, a.vst,
                                 tn * BKT, kr.kv_end, tid);
      }
      cp_commit();
    }
    if (it == 0) load_qf<D, QREG>(qf, q_s, 0, lane);
    const int j0 = t * BKT;
    const uint32_t k_s = ring + (it % STAGES) * 2 * TILE;
    float s[2][4];
    scores<D, 2, QREG>(s, qf, q_s, 0, k_s, 16 * warp, lane);
    const bool need_mask =
        j0 + BKT > kr.kv_end || (a.causal && j0 + BKT - 1 > first_pos);
    float alpha[2];
    softmax_step<D, 2>(rs, s, a, need_mask, j0 + 16 * warp, kr.kv_end, pos,
                       lane, alpha);
    rescale(rs, alpha);
    pv_mma<D, 2>(rs, s, k_s + TILE, 16 * warp, lane);
  }
  cp_wait<0>();
  __syncthreads();                      // the ring is free: combine there

  // per warp: m and l (16 rows), acc (16 x D), f32
  float* cm = reinterpret_cast<float*>(ring_p);
  float* cl = cm + NW * BQ;
  float* cacc = cl + NW * BQ;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs.l[i] += __shfl_xor_sync(0xffffffffu, rs.l[i], 1);
    rs.l[i] += __shfl_xor_sync(0xffffffffu, rs.l[i], 2);
    if ((lane & 3) == 0) {
      cm[warp * BQ + g + 8 * i] = rs.m[i];
      cl[warp * BQ + g + 8 * i] = rs.l[i];
    }
  }
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* p0 = cacc + (warp * BQ + g) * D + 8 * n + col;
    *reinterpret_cast<float2*>(p0) = make_float2(rs.acc[n][0], rs.acc[n][1]);
    *reinterpret_cast<float2*>(p0 + 8 * D) =
        make_float2(rs.acc[n][2], rs.acc[n][3]);
  }
  __syncthreads();
  for (int i = tid; i < BQ * DV / 2; i += NTH) {
    const int r = i / (DV / 2), c = 2 * (i % (DV / 2));
    if (r >= rows) break;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, cm[w * BQ + r]);
    float L = 0.f, A[2] = {0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(cm[w * BQ + r] - M);
      L += cl[w * BQ + r] * e;
      const float2 x = *reinterpret_cast<const float2*>(
          cacc + (w * BQ + r) * D + c);
      A[0] += x.x * e;
      A[1] += x.y * e;
    }
    write_row<D, DV>(a, b, kvh, split, rep, rows, r, M, L, A[0], A[1], c);
    if (a.lse && a.splits == 1 && c == 0) write_lse(a, b, kvh, rows, r, M, L);
  }
  if (a.splits > 1)
    fold_splits<bf16, D, NTH, 0, DV>(a, b, kvh, rep, rows, 0, BQ, tid);
}

// --- wgmma: fa_wgmma (its helpers are in hopper.cuh) -------------------

// Prefill and any tile of many rows, head dims 64-256.  A block takes one
// (b, KV head) pair and 64 NC of its flattened query rows: a producer
// warpgroup (warps 0-3) and NC consumer warpgroups of 64 rows.  The
// producer copies K and V tiles of BN keys (cp.async, zero-filled past
// kv_len) into a ring of STAGES stages and signals each on an mbarrier;
// the consumers free a stage on another.  Per tile a consumer warpgroup
// runs S = Q.K^T (wgmma, Q and K from shared memory), the online softmax
// on S in registers, and O += P_hi.V + P_lo.V (wgmma, P from registers,
// V from shared memory, transposed).
template <int D, int NC, int BN, int STAGES, int DV = D>
__global__ void __launch_bounds__(128 * (NC + 1), 1) fa_wgmma(Args a) {
  constexpr int BQ = 64 * NC;
  constexpr int TILE = BN * D * 2, QBYTES = BQ * D * 2;
  constexpr int CH = D / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring = q_s + QBYTES;
  const uint32_t bars = ring + STAGES * 2 * TILE;
  // bars: full[STAGES], empty[STAGES], then the Q tile's
  const uint32_t q_full = bars + 16 * STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;    // the heaviest tiles first
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int split = blockIdx.z;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, r0 = qt * BQ;
  const Range kr = key_range<BN>(a, b, split, min(r0 + BQ, rows) - 1, rep);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 128);                // the producer's threads
      mbar_init(bars + 8 * (STAGES + s), 4 * NC);  // the consumer warps
    }
    mbar_init(q_full, 128);
  }
  __syncthreads();

  if (warp < 4) {                                  // the producer
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb;
    const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
    const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
#pragma unroll 1
    for (int i = tid; i < BQ * CH; i += 128) {
      const int rr = i / CH, c = i % CH, r = r0 + rr;
      const bool ok = r < rows && (DV == D || c * 8 < DV);
      const bf16* src = q;
      if (ok)
        src = q + (r / rep) * a.qss + (kvh * rep + r % rep) * a.qsh + c * 8;
      cp16(q_s + sw128<BQ>(rr, c), src, ok);
    }
    mbar_cp_arrive(q_full);
#pragma unroll 1
    for (int t = kr.t_lo; t < kr.t_hi; ++t) {
      const int it = t - kr.t_lo, s = it % STAGES, f = it / STAGES;
      if (f > 0) mbar_wait(bars + 8 * (STAGES + s), (f - 1) & 1);
      const uint32_t k_s = ring + s * 2 * TILE;
#pragma unroll 2
      for (int i = tid; i < BN * CH; i += 128) {
        const int r = i / CH, c = i % CH, j = t * BN + r;
        const bool ok = j < kr.kv_end && (DV == D || c * 8 < DV);
        cp16(k_s + sw128<BN>(r, c), ok ? kp + (long long)j * a.kst + c * 8
                                       : kp, ok);
        cp16(k_s + TILE + sw128<BN>(r, c),
             ok ? vp + (long long)j * a.vst + c * 8 : vp, ok);
      }
      mbar_cp_arrive(bars + 8 * s);
    }
    cp_wait<0>();
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
  const int wg = (warp >> 2) - 1, g = lane >> 2;
  const int rw = 64 * wg + 16 * (warp & 3);        // this warp's first row
  const int pos[2] = {a.q_offset + (r0 + rw + g) / rep,
                      a.q_offset + (r0 + rw + g + 8) / rep};
  const int first_pos = a.q_offset + r0 / rep;
  const int wg_last_pos = a.q_offset + (r0 + 64 * wg + 63) / rep;
  Rows<D> rs;
  rs.init();
  mbar_wait(q_full, 0);

  for (int t = kr.t_lo; t < kr.t_hi; ++t) {
    const int it = t - kr.t_lo, s = it % STAGES, f = it / STAGES;
    const int j0 = t * BN;
    mbar_wait(bars + 8 * s, f & 1);
    if (!(a.causal && wg_last_pos < j0)) {         // else all masked: adds 0
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t k_s = ring + s * 2 * TILE, v_s = k_s + TILE;
      float sc[BN / 8][4];
      reg_fence(sc);
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        wgmma_qk<BN>(sc,
                     gdesc(q_s + (kd >> 2) * BQ * 128 + wg * 64 * 128
                           + (kd & 3) * 32, 16, 1024),
                     gdesc(k_s + (kd >> 2) * BN * 128 + (kd & 3) * 32, 16,
                           1024),
                     kd > 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(sc);
      const bool need_mask =
          j0 + BN > kr.kv_end || (a.causal && j0 + BN - 1 > first_pos);
      float alpha[2];
      softmax_step<D, BN / 8>(rs, sc, a, need_mask, j0, kr.kv_end, pos,
                              lane, alpha);
      rescale(rs, alpha);
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        split2(sc[2 * kk][0], sc[2 * kk][1], ph[kk][0], pl[kk][0]);
        split2(sc[2 * kk][2], sc[2 * kk][3], ph[kk][1], pl[kk][1]);
        split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
        split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
      }
      reg_fence(rs.acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t vd = gdesc(v_s + kk * 16 * 128, BN * 128, 1024);
        wgmma_pv<D>(rs.acc, ph[kk], vd);
        wgmma_pv<D>(rs.acc, pl[kk], vd);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(rs.acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs.l[i] += __shfl_xor_sync(0xffffffffu, rs.l[i], 1);
    rs.l[i] += __shfl_xor_sync(0xffffffffu, rs.l[i], 2);
  }
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    write_row<D, DV>(a, b, kvh, split, rep, rows, r0 + rw + g, rs.m[0],
                     rs.l[0], rs.acc[n][0], rs.acc[n][1], 8 * n + col);
    write_row<D, DV>(a, b, kvh, split, rep, rows, r0 + rw + g + 8, rs.m[1],
                     rs.l[1], rs.acc[n][2], rs.acc[n][3], 8 * n + col);
  }
  if (a.lse && col == 0) rows_lse(a, b, kvh, rows, r0 + rw + g, rs);
  // the producer warpgroup has returned: the consumers meet on barrier 1
  if (a.splits > 1)
    fold_splits<bf16, D, 128 * NC, 1, DV>(a, b, kvh, rep, rows, r0, BQ,
                                          tid - 128);
}

constexpr int MMA_STAGES = 3;           // fa_mma's ring of 64-key tiles
template <int D>
constexpr size_t mma_smem() {
  return 128 * D * 2 + MMA_STAGES * 2 * BKT * D * 2;
}
constexpr int DECODE_STAGES = 3;
template <int D>
constexpr size_t decode_smem() {
  return 16 * D * 2 + DECODE_STAGES * 2 * BKT * D * 2;
}

template <int D>
static cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  constexpr size_t bytes = mma_smem<D>();
  const int rows = a.S * (a.Hq / a.Hkv);
  dim3 grid((rows + 127) / 128, a.B * a.Hkv, a.splits);
  if (!counters_fit(a.splits, grid, a.n_counters))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_mma<D, MMA_STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  fa_mma<D, MMA_STAGES><<<grid, 256, bytes, st>>>(a);
  return cudaGetLastError();
}

// fa_wgmma: up to D 128 two consumer warpgroups and 128-key tiles; at D
// 256 one, with 64-key tiles, so that the 64 x 256 accumulator has the
// registers of a 256-thread block (a 384-thread block allows 168).
template <int D> constexpr int wgmma_nc() { return D <= 128 ? 2 : 1; }
template <int D> constexpr int wgmma_bn() { return D <= 128 ? 128 : 64; }
constexpr int WGMMA_STAGES = 3;
template <int D>
constexpr size_t wgmma_smem() {
  // tiles, the mbarriers, and room to align the tiles on 1,024 bytes
  return 64 * wgmma_nc<D>() * D * 2 + WGMMA_STAGES * 2 * wgmma_bn<D>() * D * 2
         + 8 * (2 * WGMMA_STAGES + 1) + 1024;
}

// DV: the valid head dim when it is below the tiles' D (112 on D 128).
template <int D, int DV = D>
static cudaError_t launch_wgmma(const Args& a, cudaStream_t st) {
  constexpr int NC = wgmma_nc<D>(), BN = wgmma_bn<D>();
  constexpr size_t bytes = wgmma_smem<D>();
  const int rows = a.S * (a.Hq / a.Hkv);
  dim3 grid((rows + 64 * NC - 1) / (64 * NC), a.B * a.Hkv, a.splits);
  if (!counters_fit(a.splits, grid, a.n_counters))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_wgmma<D, NC, BN, WGMMA_STAGES, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  fa_wgmma<D, NC, BN, WGMMA_STAGES, DV>
      <<<grid, 128 * (NC + 1), bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D, int DV = D>
static cudaError_t launch_decode(const Args& a, cudaStream_t st) {
  constexpr size_t bytes = decode_smem<D>();
  static_assert(DECODE_STAGES * 2 * BKT * D * 2 >= (4 * 16 * (D + 2)) * 4,
                "the combine must fit in the ring");
  dim3 grid(1, a.B * a.Hkv, a.splits);
  if (a.S * (a.Hq / a.Hkv) > 16
      || !counters_fit(a.splits, grid, a.n_counters))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_decode<D, DECODE_STAGES, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  fa_decode<D, DECODE_STAGES, DV><<<grid, 128, bytes, st>>>(a);
  return cudaGetLastError();
}

// The tile kernel (DECODE false): wgmma at D 64-256, mma.sync at D 32
// (rows of 64 bytes, below the 128-byte swizzle); or the decode kernel.
// D 112 runs either on the D 128 tiles (the source note's "Head dim 112").
template <bool DECODE>
static cudaError_t launch_bf16(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 32: return DECODE ? launch_decode<32>(a, st) : launch_mma<32>(a, st);
    case 64:
      return DECODE ? launch_decode<64>(a, st) : launch_wgmma<64>(a, st);
    case 112:
      return DECODE ? launch_decode<128, 112>(a, st)
                    : launch_wgmma<128, 112>(a, st);
    case 128:
      return DECODE ? launch_decode<128>(a, st) : launch_wgmma<128>(a, st);
    case 256:
      return DECODE ? launch_decode<256>(a, st) : launch_wgmma<256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

static Args make_args(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Hq, int Hkv,
                      const long long* st, int causal, int q_offset,
                      const int* kv_len, int kv_max, float scale, int splits,
                      float* ws_m, float* ws_l, float* ws_acc, int* counters,
                      int n_counters, float* lse, int out_f32 = 0) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv;
  a.qsb = st[0]; a.qss = st[1]; a.qsh = st[2];
  a.ksb = st[3]; a.kst = st[4]; a.ksh = st[5];
  a.vsb = st[6]; a.vst = st[7]; a.vsh = st[8];
  a.osb = st[9]; a.oss = st[10]; a.osh = st[11];
  a.causal = causal; a.q_offset = q_offset;
  a.kv_len = kv_len; a.kv_max = kv_max; a.scale = scale;
  a.splits = splits;
  a.ws_m = ws_m; a.ws_l = ws_l; a.ws_acc = ws_acc;
  a.counters = counters; a.n_counters = n_counters;
  a.lse = lse;
  a.out_f32 = out_f32;
  return a;
}

// What every entry refuses: no output, a bad head grouping, a split
// launch without its workspace and counters, or, from a tile kernel, an
// lse with splits (the training route runs at one split; only fa_decode's
// fold writes lse).
static bool bad_args(void* o, int Hq, int Hkv, int splits, const float* ws_m,
                     const float* ws_l, const float* ws_acc,
                     const int* counters, const float* lse,
                     bool fold_lse = false) {
  return !o || splits < 1 || Hkv < 1 || Hq % Hkv
         || (splits > 1 && (!ws_m || !ws_l || !ws_acc || !counters
                            || (lse && !fold_lse)));
}

extern "C" {

// Common arguments.  strides: 12 element strides (q b/s/h, k b/t/h, v
// b/t/h, o b/s/h), in host memory.  Every launch writes o.  With splits > 1
// it also leaves the f32 partials in ws_* and folds them (the source
// note's "Split-KV"): counters holds n_counters int32 zeros, at least
// B * Hkv * the grid's row tiles, and is zero again when the launch ends.
// lse: null, or (B, Hkv, rows) f32 for each row's logsumexp (write_lse),
// at splits 1 on the tile kernels (the training route) and at any split
// on fa_decode (a rank's block of a sequence-sharded cache); serving
// passes null and its outputs do not change.

// f32 inputs, the FP32-pipe kernel; rpt: 1 or 4.
int flash_attention_f32_launch(int D, const void* q, const void* k,
                               const void* v, void* o, int B, int S, int Hq,
                               int Hkv, const long long* strides, int causal,
                               int q_offset, const int* kv_len, int kv_max,
                               float scale, int rpt, int splits, float* ws_m,
                               float* ws_l, float* ws_acc, int* counters,
                               int n_counters, float* lse, void* stream) {
  if ((rpt != 1 && rpt != 4)
      || bad_args(o, Hq, Hkv, splits, ws_m, ws_l, ws_acc, counters, lse))
    return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, o, B, S, Hq, Hkv, strides, causal, q_offset,
                     kv_len, kv_max, scale, splits, ws_m, ws_l, ws_acc,
                     counters, n_counters, lse);
  return launch_d<float>(a, D, rpt, static_cast<cudaStream_t>(stream));
}

// bf16 inputs: `decode` 0 for the tensor-core tile kernel (fa_wgmma,
// fa_mma at D 32), 1 for the streaming decode kernel (fa_decode: S * Hq /
// Hkv <= 16; it takes an lse at any split, and out_f32).
static int bf16_launch(int decode, int D, const void* q, const void* k,
                       const void* v, void* o, int B, int S, int Hq, int Hkv,
                       const long long* strides, int causal, int q_offset,
                       const int* kv_len, int kv_max, float scale, int splits,
                       float* ws_m, float* ws_l, float* ws_acc, int* counters,
                       int n_counters, float* lse, int out_f32,
                       void* stream) {
  if (bad_args(o, Hq, Hkv, splits, ws_m, ws_l, ws_acc, counters, lse,
               decode) || (out_f32 && !decode))
    return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, o, B, S, Hq, Hkv, strides, causal, q_offset,
                     kv_len, kv_max, scale, splits, ws_m, ws_l, ws_acc,
                     counters, n_counters, lse, out_f32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return decode ? tc::launch_bf16<true>(a, D, st)
                : tc::launch_bf16<false>(a, D, st);
}

int flash_attention_mma_launch(int D, const void* q, const void* k,
                               const void* v, void* o, int B, int S, int Hq,
                               int Hkv, const long long* strides, int causal,
                               int q_offset, const int* kv_len, int kv_max,
                               float scale, int splits, float* ws_m,
                               float* ws_l, float* ws_acc, int* counters,
                               int n_counters, float* lse, void* stream) {
  return bf16_launch(0, D, q, k, v, o, B, S, Hq, Hkv, strides, causal,
                     q_offset, kv_len, kv_max, scale, splits, ws_m, ws_l,
                     ws_acc, counters, n_counters, lse, 0, stream);
}

// out_f32: o is f32 (its strides in f32 elements), each row written
// unrounded; with lse non-null, each row's logsumexp, at one split or
// after the fold.
int flash_attention_decode_launch(int D, const void* q, const void* k,
                                  const void* v, void* o, int B, int S,
                                  int Hq, int Hkv, const long long* strides,
                                  int causal, int q_offset,
                                  const int* kv_len, int kv_max, float scale,
                                  int splits, float* ws_m, float* ws_l,
                                  float* ws_acc, int* counters,
                                  int n_counters, float* lse, int out_f32,
                                  void* stream) {
  return bf16_launch(1, D, q, k, v, o, B, S, Hq, Hkv, strides, causal,
                     q_offset, kv_len, kv_max, scale, splits, ws_m, ws_l,
                     ws_acc, counters, n_counters, lse, out_f32, stream);
}

// Dynamic shared memory of a bf16 kernel (decode 0: the tile kernel, 1:
// fa_decode) at head dim D; 0 for a head dim it does not take.
int flash_attention_smem(int decode, int D) {
  switch (D) {
    case 32: return (int)(decode ? tc::decode_smem<32>() : tc::mma_smem<32>());
    case 64:
      return (int)(decode ? tc::decode_smem<64>() : tc::wgmma_smem<64>());
    case 112:                           // runs on the D 128 tiles
    case 128:
      return (int)(decode ? tc::decode_smem<128>() : tc::wgmma_smem<128>());
    case 256:
      return (int)(decode ? tc::decode_smem<256>() : tc::wgmma_smem<256>());
    default: return 0;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
