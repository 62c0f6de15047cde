// Flash attention, backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the TPU package has no backward kernel of its
// own (repro/kernels/flash_attention/flash_attention.py has no custom_vjp),
// and the reference trains its LMs through jax.vjp of the plain
// repro/models/lm/model.py::_chunked_attention (:152-206).  This file
// computes that VJP for what lm_loss calls: causal, q_offset 0, no
// kv_len, S = T.  Given q (B, S, Hq, D), k and v (B, S, Hkv, D), the
// forward's output o and its gradient dO (B, S, Hq, D), and the forward's
// per-row logsumexp lse (natural units, written by the forward kernels'
// training route, csrc/flash_attention.cu write_lse), with
//   P  = exp(s * scale - lse)       s = q . k, masked keys weigh 0
//   Di = rowsum(dO o O)             (from the forward's output, in q's type)
//   dS = P o (dO . V^T - Di)
// it writes dQ = scale dS K, dK = scale dS^T Q and dV = P^T dO in q's type;
// under GQA and MQA dK and dV sum over the query heads of each KV group.
//
// Layout.  All eight tensors are contiguous (B, S, H, D) (the wrapper
// makes them so).  As in the forward, a (b, KV head) pair has rows =
// S * (Hq / Hkv) flattened (position, head-in-group) query rows,
// position-major: row r sits at position r / rep and reads query head
// kvh * rep + r % rep, so one pass over the rows is the loop over the
// group's heads and its causal query tiles.  lse and Di are f32 (B, Hkv,
// rows).
//
// Passes (no atomics on values: every sum runs in a fixed order, so a run
// repeats bitwise).
//  1. dq: one block per (64-row tile, b, KV head).  Its consumer
//     warpgroup first forms Di for its rows from O and dO (16-byte loads,
//     f32 products, two lanes a row, in a fixed order) and writes it;
//     then it walks the key tiles up to its rows' causal frontier,
//     recomputing S = Q K^T and dP = dO V^T, and sums dS K into f32
//     registers.
//  2. dkdv: one block per (64-key tile, row range, b, KV head), after
//     pass 1 (it reads Di).  K and V stay in shared memory for the whole
//     row loop; per 64-row tile the consumer warpgroup forms S^T = K Q^T
//     and dP^T = V dO^T, then P^T and dS^T in registers, and sums
//     dV += P^T dO and dK += dS^T Q into f32 registers.
//  Both passes recompute S and dP: 14 D operations per kept (query, key)
//  pair against the 10 D the five products need, the price of no atomics.
//
// Row splits (dkdv).  The wrapper's plan (flash_attention.py::bwd_plan)
// cuts each key tile's row tiles into ranges of near-equal length, as many
// as the key tile's causal length needs, so that long key tiles (the first
// ones, which every later row sees) do not set the critical path and MQA's
// few (b, KV head) pairs still fill the card (gemma-2b at S 4,096: 64 key
// tiles of one KV head, 512 row tiles for key tile 0).  It passes the
// blocks' ranges as a table, the longest first.  A block of a key tile with
// one range writes dK and dV itself; a block of a split key tile writes its
// f32 partial sums to a workspace the wrapper allocates, fences them and
// adds one to the group's int32 counter (atom.acq_rel.gpu; one counter per
// (key tile, b, KV head)); the block that sees splits - 1 is the last, reads
// every partial through L2 in split order, sums them from 0, and writes
// dK * scale and dV in q's type, then sets the counter back to 0 (the
// wrapper's buffer stays zero between launches).  Which block arrives last
// changes from run to run; what it computes does not.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 67 TFLOP/s FP32):
// operations.  olmo-1b at B 1, S 4,096 (16 heads, D 128): 10 D per kept
// pair, 0.17 TFLOP a layer, 0.174 ms; the bytes (q, k, v, o, dO, lse read
// once, dq, dk, dv written once) are 0.10 GB, 0.03 ms.
//
// bf16: all five products on wgmma (bf16 operands, f32 accumulators), as
// csrc/flash_attention.cu's fa_wgmma, with its helpers (csrc/hopper.cuh).
// A block is a producer warpgroup (warps 0-3) and one consumer warpgroup
// (warps 4-7) of 64 rows or keys.  The producer copies tiles by cp.async
// with per-row offsets (a flattened tile of rows spans positions and heads,
// which no one TMA box covers when rep does not divide 64) into the
// 128-byte-swizzle layout, in a ring of stages (3 up to D 128, 2 at D 256),
// and signals each on an mbarrier; the consumer frees a stage on another.
// A producer thread copies one 16-byte column of every eighth (D 128) row
// and steps the row's (position, head) pair, so a row's offset costs it no
// division: the producer's warps share the SM's schedulers with the
// consumer's, and offsets worked out per 16-byte chunk slowed the dkdv
// pass by a third in a trial build.
// S = Q K^T, dP = dO V^T, S^T = K Q^T and dP^T = V dO^T read both operands
// from shared memory, K-major (wgmma_qk<64>); dQ += dS K, dV += P^T dO and
// dK += dS^T Q take dS, P^T or dS^T from registers, the score accumulator
// mapped onto the A fragment as the forward's P.V does, and K, dO or Q
// from shared memory, MN-major (wgmma_pv<D>).  dP (dP^T) runs while P
// (P^T) is formed, and dV while dS^T is.  P, P^T, dS and dS^T are rounded
// once to bf16, as those A operands (the scores and dP are f32 sums of
// exact products); exp2 is ex2.approx.ftz (2^-22 relative, far below that
// rounding).  A dkdv row tile also carries lse and Di (16-byte cp.async
// where rows is a multiple of 4, else 4-byte).  Di comes from the bf16 O
// (the reference's o is f32): within 2^-8 of |dO| . |O|
// (tests/test_torch_flash_attention_bwd.py bounds what that does to dQ).
// Registers (ptxas, no spills): one warpgroup holds both 64 x D
// accumulators of the dkdv pass up to D 128 (250 registers a thread at D
// 128); at D 256 the two would take 256 for themselves, so the dkdv pass
// keeps two modes, dV then dK, one accumulator a launch (MODE 1 and 2,
// 205 and 238 registers; MODE 0 takes both).  The dq pass holds dQ beside
// S and dP of 64-key tiles (168 registers at D 128, 234 at D 256).  A
// block of 256 threads may take 255 registers a thread; a second consumer
// warpgroup (384 threads) caps them at 168: in a trial build with
// setmaxnreg moving the producer's registers to the consumers, ptxas still
// built the consumers at 168 with spills and serialised wgmma, and the
// dkdv pass ran slower.
// D 32 (rows of 64 bytes, below the 128-byte swizzle) runs the D 64
// kernels and D 112 (kimi-k2; rows of 224 bytes, 14 16-byte chunks) the D
// 128 kernels, with the head dim zero-padded in shared memory: the
// producer copies a row's DG / 8 chunks and zero-fills the rest of the
// tile's, as the forward does at D 112.  The padding adds exact zeros to
// S and dP, so the sums are the unpadded ones; its dQ, dK, dV columns are
// zeros and are not written (store_rows and the fold stop at DG columns:
// a 128-column store would overrun into the next 224-byte row).  Di sums
// DG columns.  A split key tile's f32 partials keep the tile's width
// (slots, B * Hkv, 64, 128 at D 112): store_partial writes whole
// accumulator rows, and the fold reads and writes DG columns of them.
//
// f32 (the card-vs-CPU checks): FP32 pipes, no tensor cores, no TF32,
// blocks of 16 x 16 threads over 16-row and 16-key tiles, P and dS
// through shared memory, exp as expf; any head dim a multiple of 16 with
// rows on 16 bytes (D 112: 7 columns a thread).
//
// Head dims 32, 64, 112, 128, 256 (templates).  Shared memory is dynamic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
using namespace hopper;

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o;
  const void* dout;
  void* dq; void* dk; void* dv;
  const float* lse;             // (B, Hkv, rows), natural log
  float* di;                    // (B, Hkv, rows): pass 1 writes, 2 reads
  int B, S, Hq, Hkv;
  float scale;
  int mode;                     // dkdv: 0 dK and dV, 1 dV only, 2 dK only
  // bf16 dkdv: the plan's table, 4 ints a block (key tile, first row
  // tile, end row tile, split), then 2 a key tile (first workspace slot,
  // splits); the partials (slots, B * Hkv, 64 keys, D) f32 of dK and dV
  // (null where no key tile splits); one zero counter a (key tile, b, KV
  // head)
  const int* plan;
  float* ws_k; float* ws_v;
  int* counters;
};

// Element offset of row r's head vector: (b, position r / rep, head
// kvh * rep + r % rep) of a contiguous (B, S, Hq, D) tensor.
__device__ __forceinline__ long long qrow(const BwdArgs& a, int b, int kvh,
                                          int rep, int r, int D) {
  return (((long long)b * a.S + r / rep) * a.Hq + kvh * rep + r % rep) * D;
}
// ... and key j's of a contiguous (B, S, Hkv, D) tensor.
__device__ __forceinline__ long long krow(const BwdArgs& a, int b, int kvh,
                                          int j, int D) {
  return (((long long)b * a.S + j) * a.Hkv + kvh) * D;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

__device__ __forceinline__ uint32_t bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 4 bytes into shared memory, asynchronously; ok false zero-fills.
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// The A fragments (16 columns a step) of an f32 accumulator of 64 rows x
// 8 NB columns, rounded once to bf16: fa_wgmma's P mapping.
template <int NB>
__device__ __forceinline__ void to_a(uint32_t (&x)[NB / 2][4],
                                     const float (&s)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    x[kk][0] = bf2(s[2 * kk][0], s[2 * kk][1]);
    x[kk][1] = bf2(s[2 * kk][2], s[2 * kk][3]);
    x[kk][2] = bf2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    x[kk][3] = bf2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// R rows of one or two tiles of D-value rows (the kernel's head dim; DG
// of them in device memory, the rest zeros) into the 128-byte-swizzle
// layout at d1 (and d2), by the producer's 128 threads: thread t copies
// chunk t % (D / 8) of every (128 / (D / 8))-th row from t / (D / 8), so
// neighbouring threads read neighbouring 16 bytes of a row and a thread
// works out a row's offset once for both tiles.  rows.at(i): the element
// offset of the current row in g1 (and g2), or -1 for zeros, after
// rows.start(i, n) at row i; rows.next() moves it on by n rows.
template <int D, int DG, int R, bool TWO, typename Rows>
__device__ __forceinline__ void load_tiles(uint32_t d1, const bf16* g1,
                                           uint32_t d2, const bf16* g2,
                                           Rows rows, int tid) {
  constexpr int CH = D / 8, STEP = 128 / CH;
  const int c = tid % CH;
  const bool col = c < DG / 8;
  rows.start(tid / CH, STEP);
#pragma unroll 4
  for (int i = tid / CH; i < R; i += STEP) {
    const long long off = rows.at();
    const bool ok = col && off >= 0;
    cp16(d1 + sw128<R>(i, c), ok ? g1 + off + c * 8 : g1, ok);
    if constexpr (TWO)
      cp16(d2 + sw128<R>(i, c), ok ? g2 + off + c * 8 : g2, ok);
    rows.next();
  }
}

// Flattened rows r0 + i of one (b, KV head) in a contiguous (B, S, Hq, DG)
// tensor: position and head-in-group kept as a pair and stepped, so a row
// costs no division.
struct QRows {
  long long base;               // element offset of (b, 0, kvh * rep)
  int r0, rows, rep, hq, dg;
  int pos, head, dpos, dhead;
  __device__ __forceinline__ void start(int i, int n) {
    pos = (r0 + i) / rep;
    head = (r0 + i) % rep;
    dpos = n / rep;
    dhead = n % rep;
  }
  __device__ __forceinline__ long long at() const {
    return pos * rep + head < rows
               ? base + ((long long)pos * hq + head) * dg : -1;
  }
  __device__ __forceinline__ void next() {
    pos += dpos;
    head += dhead;
    if (head >= rep) {
      head -= rep;
      ++pos;
    }
  }
};

// Keys j0 + i of one (b, KV head) in a contiguous (B, S, Hkv, DG) tensor.
struct KRows {
  long long base;               // element offset of (b, 0, kvh)
  int j0, S, hkv, dg;
  int j, n;
  __device__ __forceinline__ void start(int i, int step) {
    j = j0 + i;
    n = step;
  }
  __device__ __forceinline__ long long at() const {
    return j < S ? base + (long long)j * hkv * dg : -1;
  }
  __device__ __forceinline__ void next() { j += n; }
};

// S (64 x 8 NB, f32) = A (tile a_s, 64 rows) . B^T (tile b_s, 8 NB rows):
// both K-major in the head dim.
template <int D, int RA, int NB>
__device__ __forceinline__ void rowdot(float (&s)[NB][4], uint32_t a_s,
                                       uint32_t b_s) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_qk<NB * 8>(s,
                     gdesc(a_s + (kd >> 2) * RA * 128 + (kd & 3) * 32, 16,
                           1024),
                     gdesc(b_s + (kd >> 2) * NB * 8 * 128 + (kd & 3) * 32,
                           16, 1024),
                     kd > 0);
}

// acc (64 x D) += X (the A fragments of 64 x 16 KK values) . Y (tile y_s,
// 16 KK rows of D values, read MN-major).
template <int D, int KK>
__device__ __forceinline__ void acc_dot(float (&acc)[D / 8][4],
                                        const uint32_t (&x)[KK][4],
                                        uint32_t y_s) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    wgmma_pv<D>(acc, x[kk], gdesc(y_s + kk * 16 * 128, KK * 16 * 128, 1024));
}

// Writes rows g and g + 8 of a warp's 16 rows of an accumulator (times
// mul) to the (B, S, H, DG) tensor out at element offsets off0 and off1
// (negative: no row there); columns past DG are padding.
template <int D, int DG>
__device__ __forceinline__ void store_rows(bf16* out, long long off0,
                                           long long off1,
                                           const float (&acc)[D / 8][4],
                                           float mul, int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < DG / 8; ++n) {
    if (off0 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + off0 + 8 * n + col) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    if (off1 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + off1 + 8 * n + col) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// ... and both rows in f32, whole, to a workspace row pair (w, w + 8 D).
template <int D>
__device__ __forceinline__ void store_partial(float* w,
                                              const float (&acc)[D / 8][4],
                                              int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(w + 8 * n + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(w + 8 * D + 8 * n + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// Pass 1 (source note): a producer warpgroup and a consumer warpgroup of
// 64 flattened rows of one (b, KV head).  The producer copies the Q and dO
// tiles once, then K and V tiles of BN keys into a ring of STAGES.
template <int D, int DG, int BN, int STAGES>
__global__ void __launch_bounds__(256, 1) fa_bwd_dq(BwdArgs a) {
  constexpr int BQ = 64, TILE = BN * D * 2, QBYTES = BQ * D * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t do_s = q_s + QBYTES;
  const uint32_t ring = do_s + QBYTES;          // STAGES x (K, V)
  const uint32_t bars = ring + STAGES * 2 * TILE;
  // bars: full[STAGES], empty[STAGES], then the Q and dO tiles'
  const uint32_t q_full = bars + 16 * STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;    // the heaviest tiles first
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, r0 = qt * BQ;
  const int n_tiles = (min(r0 + BQ, rows) - 1) / rep / BN + 1;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 128);                // the producer's threads
      mbar_init(bars + 8 * (STAGES + s), 4);       // the consumer warps
    }
    mbar_init(q_full, 128);
  }
  __syncthreads();

  if (warp < 4) {                                  // the producer
    const QRows qr = {((long long)b * a.S * a.Hq + kvh * rep) * DG, r0, rows,
                      rep, a.Hq, DG, 0, 0, 0, 0};
    load_tiles<D, DG, BQ, true>(q_s, static_cast<const bf16*>(a.q), do_s,
                                static_cast<const bf16*>(a.dout), qr, tid);
    mbar_cp_arrive(q_full);
    KRows kr = {((long long)b * a.S * a.Hkv + kvh) * DG, 0, a.S, a.Hkv, DG,
                0, 0};
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, f = t / STAGES;
      if (f > 0) mbar_wait(bars + 8 * (STAGES + s), (f - 1) & 1);
      const uint32_t k_s = ring + s * 2 * TILE;
      kr.j0 = t * BN;
      load_tiles<D, DG, BN, true>(k_s, static_cast<const bf16*>(a.k),
                                  k_s + TILE, static_cast<const bf16*>(a.v),
                                  kr, tid);
      mbar_cp_arrive(bars + 8 * s);
    }
    cp_wait<0>();
    return;
  }

  // the consumers: warp wl owns rows 16 wl .. 16 wl + 15 of the tile, this
  // thread rows g and g + 8 of those
  const int wl = warp & 3, g = lane >> 2;
  const int rw = 16 * wl;
  const long long base = ((long long)b * a.Hkv + kvh) * rows;
  float di[2], lse2[2];
  int pos[2];
  {
    // Di of the warp's 16 rows: lanes 2i and 2i + 1 take the two halves
    // of row i's head dim in order, then add them
    const int rr = lane >> 1, h = lane & 1, r = r0 + rw + rr;
    float x = 0.f;
    if (r < rows) {
      const long long off = qrow(a, b, kvh, rep, r, DG) + h * (DG / 2);
      const uint4* po = reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(a.o) + off);
      const uint4* pd = reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(a.dout) + off);
      uint4 u[DG / 16], w[DG / 16];
#pragma unroll
      for (int c = 0; c < DG / 16; ++c) {
        u[c] = pd[c];
        w[c] = po[c];
      }
#pragma unroll
      for (int c = 0; c < DG / 16; ++c) {
        const __nv_bfloat162* x2 =
            reinterpret_cast<const __nv_bfloat162*>(&u[c]);
        const __nv_bfloat162* y2 =
            reinterpret_cast<const __nv_bfloat162*>(&w[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 p = __bfloat1622float2(x2[e]);
          const float2 q = __bfloat1622float2(y2[e]);
          x = fmaf(p.x, q.x, x);
          x = fmaf(p.y, q.y, x);
        }
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if (h == 0 && r < rows) a.di[base + r] = x;
    di[0] = __shfl_sync(0xffffffffu, x, 2 * g);
    di[1] = __shfl_sync(0xffffffffu, x, 2 * (g + 8));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rw + g + 8 * i;
    pos[i] = r < rows ? r / rep : -1;             // -1: no row, all masked
    lse2[i] = r < rows ? a.lse[base + r] * LOG2E : 0.f;
  }
  const float sl = a.scale * LOG2E;
  const int first_pos = r0 / rep;
  const bool ragged = r0 + BQ > rows;

  float acc[D / 8][4];
  zero_acc(acc);
  mbar_wait(q_full, 0);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, f = t / STAGES, j0 = t * BN;
    mbar_wait(bars + 8 * s, f & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t k_s = ring + s * 2 * TILE, v_s = k_s + TILE;
    float sc[BN / 8][4], dp[BN / 8][4];
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
    rowdot<D, BQ, BN / 8>(sc, q_s, k_s);                // S
    wg_commit();
    rowdot<D, BQ, BN / 8>(dp, do_s, v_s);               // dP
    wg_commit();
    wg_wait<1>();
    reg_fence(sc);
    const bool need_mask = ragged || j0 + BN - 1 > first_pos;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, j = j0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const float p = exp2_(fmaf(sc[n][e], sl, -lse2[i]));
        sc[n][e] = need_mask && j > pos[i] ? 0.f : p;
      }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] *= dp[n][e] - di[e >> 1];          // dS
    uint32_t ds[BN / 16][4];
    to_a<BN / 8>(ds, sc);
    reg_fence(acc);
    wg_fence();
    acc_dot<D, BN / 16>(acc, ds, k_s);              // dQ += dS K
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
  }
  const int ra = r0 + rw + g;
  store_rows<D, DG>(static_cast<bf16*>(a.dq),
                    ra < rows ? qrow(a, b, kvh, rep, ra, DG) : -1,
                    ra + 8 < rows ? qrow(a, b, kvh, rep, ra + 8, DG) : -1,
                    acc, a.scale, lane);
}

// Pass 2 (source note): a producer warpgroup and a consumer warpgroup of
// 64 keys of one (b, KV head), over the row tiles [rt_lo, rt_hi) of its
// plan entry.  The producer copies K (and V) once, then row tiles of
// 64 rows (Q, dO, lse, Di) into a ring of STAGES.  MODE 0: dK and dV, 1:
// dV, 2: dK.
template <int D, int DG, int STAGES, int MODE>
__global__ void __launch_bounds__(256, 1) fa_bwd_dkdv(BwdArgs a) {
  constexpr int BK = 64, BM = 64, KT = BK * D * 2, RT = BM * D * 2;
  constexpr int FT = 2 * BM * 4;                // lse and Di of a row tile
  constexpr bool DV = MODE != 2, DK = MODE != 1;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t k_s = (s0 + 1023) & ~1023u;
  const uint32_t v_s = k_s + KT;
  const uint32_t ring = v_s + KT;               // STAGES x (Q, dO)
  const uint32_t f_ring = ring + STAGES * 2 * RT;   // STAGES x (lse, Di)
  const uint32_t bars = f_ring + STAGES * FT;
  // bars: full[STAGES], empty[STAGES], then the K and V tiles'
  const uint32_t kv_full = bars + 16 * STAGES;
  const float* f_gen = reinterpret_cast<const float*>(smem + (f_ring - s0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* ent = a.plan + 4 * blockIdx.x;     // the longest ranges first
  const int kt = ent[0], rt_lo = ent[1], rt_hi = ent[2], split = ent[3];
  const int* grp = a.plan + 4 * gridDim.x + 2 * kt;
  const int slot0 = grp[0], n_split = grp[1];
  const int bh = blockIdx.y, b = bh / a.Hkv, kvh = bh % a.Hkv;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, j0 = kt * BK;
  const long long base = (long long)bh * rows;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 128);
      mbar_init(bars + 8 * (STAGES + s), 4);
    }
    mbar_init(kv_full, 128);
  }
  __syncthreads();

  if (warp < 4) {                                  // the producer
    const KRows kr = {((long long)b * a.S * a.Hkv + kvh) * DG, j0, a.S,
                      a.Hkv, DG, 0, 0};
    load_tiles<D, DG, BK, DK>(k_s, static_cast<const bf16*>(a.k), v_s,
                              static_cast<const bf16*>(a.v), kr, tid);
    mbar_cp_arrive(kv_full);
    QRows qr = {((long long)b * a.S * a.Hq + kvh * rep) * DG, 0, rows, rep,
                a.Hq, DG, 0, 0, 0, 0};
    // lse and Di by 16 bytes where every tile's rows start on 16 bytes
    const bool vec = (rows & 3) == 0
                     && !(reinterpret_cast<uintptr_t>(a.lse) & 15)
                     && !(reinterpret_cast<uintptr_t>(a.di) & 15);
#pragma unroll 1
    for (int rt = rt_lo; rt < rt_hi; ++rt) {
      const int it = rt - rt_lo, s = it % STAGES, f = it / STAGES;
      if (f > 0) mbar_wait(bars + 8 * (STAGES + s), (f - 1) & 1);
      const int r0 = rt * BM;
      const uint32_t q_t = ring + s * 2 * RT;
      qr.r0 = r0;
      load_tiles<D, DG, BM, true>(q_t, static_cast<const bf16*>(a.q),
                                  q_t + RT, static_cast<const bf16*>(a.dout),
                                  qr, tid);
      const uint32_t fs = f_ring + s * FT;
      if (vec) {
        if (tid < BM / 2) {                      // 16 chunks of each
          const int h = tid / (BM / 4), c = tid % (BM / 4), r = r0 + 4 * c;
          const float* src = (h ? a.di : a.lse) + base + r;
          cp16(fs + h * BM * 4 + c * 16, r < rows ? src : a.lse, r < rows);
        }
      } else {                                   // 2 BM = 128 values
        const int h = tid / BM, i = tid % BM, r = r0 + i;
        const float* src = (h ? a.di : a.lse) + base + r;
        cp4(fs + h * BM * 4 + i * 4, r < rows ? src : a.lse, r < rows);
      }
      mbar_cp_arrive(bars + 8 * s);
    }
    cp_wait<0>();
    return;
  }

  // the consumers: warp wl owns keys 16 wl .. 16 wl + 15 of the tile, this
  // thread keys g and g + 8 of those
  const int wl = warp & 3, g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const int kw = 16 * wl;
  const int key[2] = {j0 + kw + g, j0 + kw + g + 8};
  const float sl = a.scale * LOG2E;
  float acc_k[DK ? D / 8 : 1][4], acc_v[DV ? D / 8 : 1][4];
  if constexpr (DK) zero_acc(acc_k);
  if constexpr (DV) zero_acc(acc_v);
  mbar_wait(kv_full, 0);
#pragma unroll 1
  for (int rt = rt_lo; rt < rt_hi; ++rt) {
    const int it = rt - rt_lo, s = it % STAGES, f = it / STAGES;
    const int r0 = rt * BM;
    mbar_wait(bars + 8 * s, f & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t q_t = ring + s * 2 * RT, do_t = q_t + RT;
    const float* fl = f_gen + s * (FT / 4);    // lse, then Di
    float st[8][4];                            // S^T: 64 keys x 64 rows
    float dpt[DK ? 8 : 1][4];                  // dP^T
    reg_fence(st);
    if constexpr (DK) reg_fence(dpt);
    wg_fence();
    rowdot<D, BK, 8>(st, k_s, q_t);
    wg_commit();
    if constexpr (DK) {
      rowdot<D, BK, 8>(dpt, v_s, do_t);
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    reg_fence(st);
    // every key of the tile at or before its first row's position, and
    // every row real: nothing to mask
    const bool need_mask = j0 + BK - 1 > r0 / rep || r0 + BM > rows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(fl + 8 * n + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + c2 + (e & 1), r = r0 + i;
        const float p = exp2_(fmaf(st[n][e], sl,
                                   -((e & 1) ? l.y : l.x) * LOG2E));
        st[n][e] = need_mask && (r >= rows || key[e >> 1] > r / rep)
                       ? 0.f : p;                  // P^T
      }
    }
    uint32_t pa[DV ? 4 : 1][4];
    if constexpr (DV) {
      to_a<8>(pa, st);
      reg_fence(acc_v);
      wg_fence();
      acc_dot<D, 4>(acc_v, pa, do_t);            // dV += P^T dO
      wg_commit();
    }
    if constexpr (DK) {
      wg_wait<DV ? 1 : 0>();                     // dP^T (dV runs on)
      reg_fence(dpt);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d = *reinterpret_cast<const float2*>(fl + BM + 8 * n
                                                          + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[n][e] = st[n][e] * (dpt[n][e] - ((e & 1) ? d.y : d.x));
      }                                            // dS^T
      uint32_t da[4][4];
      to_a<8>(da, dpt);
      reg_fence(acc_k);
      wg_fence();
      acc_dot<D, 4>(acc_k, da, q_t);             // dK += dS^T Q
      wg_commit();
    }
    wg_wait<0>();
    if constexpr (DV) reg_fence(acc_v);
    if constexpr (DK) reg_fence(acc_k);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
  }

  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  if (n_split == 1) {
    const long long o0 = key[0] < a.S ? krow(a, b, kvh, key[0], DG) : -1;
    const long long o1 = key[1] < a.S ? krow(a, b, kvh, key[1], DG) : -1;
    if constexpr (DK) store_rows<D, DG>(dk, o0, o1, acc_k, a.scale, lane);
    if constexpr (DV) store_rows<D, DG>(dv, o0, o1, acc_v, 1.f, lane);
    return;
  }
  // a split key tile: this block's partials, then the fold (source note)
  const int BH = gridDim.y;
  const long long slot = (long long)BH * BK * D;  // one split's partials
  const long long w0 = ((long long)slot0 * BH + bh) * BK * D;
  const long long mine = w0 + split * slot + (long long)(kw + g) * D;
  if constexpr (DK) store_partial<D>(a.ws_k + mine, acc_k, lane);
  if constexpr (DV) store_partial<D>(a.ws_v + mine, acc_v, lane);
  __threadfence();                      // this thread's partials are out
  bar_sync<128, 1>();                   // ... and every writer's
  int* cnt = a.counters + (long long)kt * BH + bh;
  const int t = tid - 128;
  if (!bar_or<128, 1>(t == 0 && arrive(cnt) == n_split - 1)) return;
  __threadfence();
  // the last block: each thread sums 4 columns of a key over the splits
  // in order, FU loads in flight at a time (slots past the last: none)
  constexpr int FU = 8;
  for (int i = t; i < BK * (DG / 4); i += 128) {
    const int kl = i / (DG / 4), c = 4 * (i % (DG / 4)), j = j0 + kl;
    if (j >= a.S) break;                // the rest of the tile is past S
    const long long w = w0 + (long long)kl * D + c;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int p0 = 0; p0 < n_split; p0 += FU) {
      float4 xk[FU], xv[FU];
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        if (p0 + u < n_split) {
          const long long o = w + (p0 + u) * slot;
          if constexpr (DK)
            xk[u] = __ldcg(reinterpret_cast<const float4*>(a.ws_k + o));
          if constexpr (DV)
            xv[u] = __ldcg(reinterpret_cast<const float4*>(a.ws_v + o));
        }
      }
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        if (p0 + u < n_split) {
          if constexpr (DK) {
            sk.x += xk[u].x;
            sk.y += xk[u].y;
            sk.z += xk[u].z;
            sk.w += xk[u].w;
          }
          if constexpr (DV) {
            sv.x += xv[u].x;
            sv.y += xv[u].y;
            sv.z += xv[u].z;
            sv.w += xv[u].w;
          }
        }
      }
    }
    const long long o = krow(a, b, kvh, j, DG) + c;
    if constexpr (DK) {
      const float m = a.scale;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(sk.x * m, sk.y * m);
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 2) =
          __floats2bfloat162_rn(sk.z * m, sk.w * m);
    }
    if constexpr (DV) {
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(sv.x, sv.y);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 2) =
          __floats2bfloat162_rn(sv.z, sv.w);
    }
  }
  if (t == 0) atomicExch(cnt, 0);       // zero for the next launch
}

// the kernels' head dim (D 32 runs the D 64 kernels and D 112 the D 128
// ones, padded), key tile of pass 1 and ring depth
template <int D> constexpr int kdim() {
  return D < 64 ? 64 : D == 112 ? 128 : D;
}
constexpr int DQ_BN = 64;
template <int D> constexpr int stages() { return D <= 128 ? 3 : 2; }

template <int D> constexpr size_t dq_smem() {
  // tiles, the mbarriers, and room to align the tiles on 1,024 bytes
  return 2 * 64 * kdim<D>() * 2 + stages<D>() * 2 * DQ_BN * kdim<D>() * 2
         + 8 * (2 * stages<D>() + 1) + 1024;
}
template <int D> constexpr size_t dkdv_smem() {
  return 2 * 64 * kdim<D>() * 2
         + stages<D>() * (2 * 64 * kdim<D>() * 2 + 2 * 64 * 4)
         + 8 * (2 * stages<D>() + 1) + 1024;
}

template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
static cudaError_t launch_dq(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t bytes = dq_smem<D>();
  auto kernel = fa_bwd_dq<kdim<D>(), D, DQ_BN, stages<D>()>;
  const int rows = a.S * (a.Hq / a.Hkv);
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((rows + 63) / 64, a.B * a.Hkv), 256, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D, int MODE>
static cudaError_t launch_dkdv_mode(const BwdArgs& a, int n_blocks,
                                    cudaStream_t st) {
  constexpr size_t bytes = dkdv_smem<D>();
  auto kernel = fa_bwd_dkdv<kdim<D>(), D, stages<D>(), MODE>;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_blocks, a.B * a.Hkv), 256, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_dkdv(const BwdArgs& a, int n_blocks,
                              cudaStream_t st) {
  switch (a.mode) {
    case 0:
      if constexpr (D <= 128) return launch_dkdv_mode<D, 0>(a, n_blocks, st);
      else return cudaErrorInvalidValue;
    case 1: return launch_dkdv_mode<D, 1>(a, n_blocks, st);
    case 2: return launch_dkdv_mode<D, 2>(a, n_blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 on the FP32 pipes
// ---------------------------------------------------------------------------
namespace fp {

constexpr int T16 = 16;                 // rows and keys of a tile
template <int D> __host__ __device__ constexpr int RS() { return D + 4; }

// max and sum over the 16 lanes (tx) that share a row
__device__ __forceinline__ float sum16(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 rows of D f32 values (row i from global offset off(i), zeros where it
// is negative) into a padded shared tile.
template <int D, typename F>
__device__ __forceinline__ void load_rows(float* dst, const float* g, F off,
                                          int tid) {
  for (int c = tid; c < T16 * (D / 4); c += 256) {
    const int i = c / (D / 4), d = 4 * (c % (D / 4));
    const long long o = off(i);
    *reinterpret_cast<float4*>(dst + i * RS<D>() + d) =
        o >= 0 ? *reinterpret_cast<const float4*>(g + o + d)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    const float4 u = *reinterpret_cast<const float4*>(x + d);
    const float4 w = *reinterpret_cast<const float4*>(y + d);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
    s = fmaf(u.z, w.z, s);
    s = fmaf(u.w, w.w, s);
  }
  return s;
}

// Pass 1 in f32: a block of 16 x 16 threads takes 16 flattened rows (ty);
// per 16-key tile, thread (ty, tx) forms the score and dP of key tx, dS
// goes through shared memory, and thread (ty, tx) sums columns tx + 16 c.
template <int D>
__global__ void __launch_bounds__(256) fa_bwd_dq_f32(BwdArgs a) {
  constexpr int R = RS<D>(), CO = D / 16;
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;
  float* sDO = sQ + T16 * R;
  float* sK = sDO + T16 * R;
  float* sV = sK + T16 * R;
  float* sDS = sV + T16 * R;                    // 16 x 17
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, r0 = qt * T16;
  const float* q = static_cast<const float*>(a.q);
  const float* kp = static_cast<const float*>(a.k);
  const float* vp = static_cast<const float*>(a.v);
  const float* op = static_cast<const float*>(a.o);
  const float* dop = static_cast<const float*>(a.dout);
  auto qoff = [&](int i) -> long long {
    const int r = r0 + i;
    return r < rows ? qrow(a, b, kvh, rep, r, D) : -1;
  };
  load_rows<D>(sQ, q, qoff, tid);
  load_rows<D>(sDO, dop, qoff, tid);
  const int r = r0 + ty;
  const bool ok = r < rows;
  const int pos = r / rep;
  const long long base = ((long long)b * a.Hkv + kvh) * rows;
  float di = 0.f;
  if (ok) {
    const long long off = qrow(a, b, kvh, rep, r, D);
    for (int d = tx; d < D; d += 16) di = fmaf(dop[off + d], op[off + d], di);
  }
  di = sum16(di);
  if (ok && tx == 0) a.di[base + r] = di;
  const float lse = ok ? a.lse[base + r] : 0.f;
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
  const int n_tiles = (min(r0 + T16, rows) - 1) / rep / T16 + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * T16;
    __syncthreads();                  // the last tile's readers are done
    auto koff = [&](int i) -> long long {
      const int j = j0 + i;
      return j < a.S ? krow(a, b, kvh, j, D) : -1;
    };
    load_rows<D>(sK, kp, koff, tid);
    load_rows<D>(sV, vp, koff, tid);
    __syncthreads();
    const int j = j0 + tx;
    float ds = 0.f;
    if (ok && j <= pos) {
      const float p = expf(dot<D>(sQ + ty * R, sK + tx * R) * a.scale - lse);
      ds = p * (dot<D>(sDO + ty * R, sV + tx * R) - di);
    }
    sDS[ty * 17 + tx] = ds;
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < T16; ++kk) {
      const float x = sDS[ty * 17 + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c)
        acc[c] = fmaf(x, sK[kk * R + tx + 16 * c], acc[c]);
    }
  }
  if (ok) {
    float* dq = static_cast<float*>(a.dq) + qrow(a, b, kvh, rep, r, D);
#pragma unroll
    for (int c = 0; c < CO; ++c) dq[tx + 16 * c] = acc[c] * a.scale;
  }
}

// Pass 2 in f32: a block of 16 x 16 threads takes 16 keys (ty); per
// 16-row tile, thread (ty, tx) forms P^T and dS^T of row tx, both go
// through shared memory, and thread (ty, tx) sums columns tx + 16 c of
// dK and dV.
template <int D>
__global__ void __launch_bounds__(256) fa_bwd_dkdv_f32(BwdArgs a) {
  constexpr int R = RS<D>(), CO = D / 16;
  extern __shared__ __align__(16) float fsm[];
  float* sK = fsm;
  float* sV = sK + T16 * R;
  float* sQ = sV + T16 * R;
  float* sDO = sQ + T16 * R;
  float* sP = sDO + T16 * R;                    // 16 x 17
  float* sDS = sP + T16 * 17;                   // 16 x 17
  float* sL = sDS + T16 * 17;                   // lse, Di: 2 x 16
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, j0 = blockIdx.x * T16;
  const float* q = static_cast<const float*>(a.q);
  const float* dop = static_cast<const float*>(a.dout);
  const long long base = ((long long)b * a.Hkv + kvh) * rows;
  auto koff = [&](int i) -> long long {
    const int j = j0 + i;
    return j < a.S ? krow(a, b, kvh, j, D) : -1;
  };
  load_rows<D>(sK, static_cast<const float*>(a.k), koff, tid);
  load_rows<D>(sV, static_cast<const float*>(a.v), koff, tid);
  const int j = j0 + ty;
  float acc_k[CO], acc_v[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc_k[c] = acc_v[c] = 0.f;
  const int rt0 = j0 * rep / T16, rt1 = (rows - 1) / T16;
  for (int rt = rt0; rt <= rt1; ++rt) {
    const int r0 = rt * T16;
    __syncthreads();                  // the last tile's readers are done
    auto roff = [&](int i) -> long long {
      const int r = r0 + i;
      return r < rows ? qrow(a, b, kvh, rep, r, D) : -1;
    };
    load_rows<D>(sQ, q, roff, tid);
    load_rows<D>(sDO, dop, roff, tid);
    if (tid < T16) {
      const int r = r0 + tid;
      sL[tid] = r < rows ? a.lse[base + r] : 0.f;
      sL[T16 + tid] = r < rows ? a.di[base + r] : 0.f;
    }
    __syncthreads();
    const int r = r0 + tx;
    float p = 0.f, ds = 0.f;
    if (r < rows && j < a.S && j <= r / rep) {
      p = expf(dot<D>(sK + ty * R, sQ + tx * R) * a.scale - sL[tx]);
      ds = p * (dot<D>(sV + ty * R, sDO + tx * R) - sL[T16 + tx]);
    }
    sP[ty * 17 + tx] = p;
    sDS[ty * 17 + tx] = ds;
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < T16; ++i) {
      const float x = sP[ty * 17 + i], y = sDS[ty * 17 + i];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        acc_v[c] = fmaf(x, sDO[i * R + tx + 16 * c], acc_v[c]);
        acc_k[c] = fmaf(y, sQ[i * R + tx + 16 * c], acc_k[c]);
      }
    }
  }
  if (j < a.S) {
    const long long off = krow(a, b, kvh, j, D);
    float* dk = static_cast<float*>(a.dk) + off;
    float* dv = static_cast<float*>(a.dv) + off;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      dk[tx + 16 * c] = acc_k[c] * a.scale;
      dv[tx + 16 * c] = acc_v[c];
    }
  }
}

template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * T16 * RS<D>() + T16 * 17);
}
template <int D> constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * T16 * RS<D>() + 2 * T16 * 17 + 2 * T16);
}

template <int D>
static cudaError_t launch_dq(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t bytes = dq_smem<D>();
  const int rows = a.S * (a.Hq / a.Hkv);
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  fa_bwd_dq_f32<D><<<dim3((rows + T16 - 1) / T16, a.B * a.Hkv), 256, bytes,
                     st>>>(a);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_dkdv(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t bytes = dkdv_smem<D>();
  if (a.mode != 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkdv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  fa_bwd_dkdv_f32<D><<<dim3((a.S + T16 - 1) / T16, a.B * a.Hkv), 256, bytes,
                       st>>>(a);
  return cudaGetLastError();
}

}  // namespace fp

// pass: 1 (dq, writes Di) or 2 (dkdv); bf16 on the tensor cores, else f32
template <bool BF16>
static cudaError_t launch_pass(const BwdArgs& a, int D, int pass,
                               int n_blocks, cudaStream_t st) {
#define FA_BWD_CASE(DD)                                                   \
  case DD:                                                                \
    if constexpr (BF16)                                                   \
      return pass == 1 ? tc::launch_dq<DD>(a, st)                         \
                       : tc::launch_dkdv<DD>(a, n_blocks, st);            \
    else                                                                  \
      return pass == 1 ? fp::launch_dq<DD>(a, st)                         \
                       : fp::launch_dkdv<DD>(a, st);
  switch (D) {
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(112)
    FA_BWD_CASE(128)
    FA_BWD_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}

static BwdArgs make_args(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, void* dq, void* dk,
                         void* dv, const float* lse, float* di, int B, int S,
                         int Hq, int Hkv, float scale, int mode) {
  BwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.lse = lse; a.di = di;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.scale = scale; a.mode = mode;
  return a;
}

static bool bad_args(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* di,
                     int B, int S, int Hq, int Hkv) {
  return !q || !k || !v || !dout || !lse || !di || Hkv < 1 || Hq % Hkv
         || B < 1 || S < 1;
}

extern "C" {

// Common arguments: q, o, dout, dq (B, S, Hq, D) and k, v, dk, dv (B, S,
// Hkv, D), contiguous, in one type, 16-byte aligned; lse and di (B, Hkv,
// S * Hq / Hkv) f32.  Causal, q_offset 0, every key valid.  The dq launch
// writes dq and di; the dkdv launch reads di and writes dk and dv (mode 0
// both, 1 dV only, 2 dK only; the bf16 kernel takes mode 0 up to head dim
// 128 and modes 1 and 2 at every head dim, the f32 kernel mode 0).
int flash_attention_bwd_dq_launch(int D, const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, void* dq,
                                  const float* lse, float* di, int B, int S,
                                  int Hq, int Hkv, float scale,
                                  void* stream) {
  if (bad_args(q, k, v, dout, lse, di, B, S, Hq, Hkv) || !o || !dq)
    return cudaErrorInvalidValue;
  return launch_pass<true>(make_args(q, k, v, o, dout, dq, nullptr, nullptr,
                                     lse, di, B, S, Hq, Hkv, scale, 0),
                           D, 1, 0, static_cast<cudaStream_t>(stream));
}

// The bf16 dkdv pass over the plan's table (the wrapper's bwd_plan): plan
// holds n_blocks entries of 4 ints (key tile, first row tile, end row
// tile, split) then n_kt of 2 (first workspace slot, splits); splits is
// the largest.  Where it is above 1: ws_k (modes 0 and 2) and ws_v (modes
// 0 and 1) hold (slots, B * Hkv, 64, W) f32 each, W the kernels' tile
// width (64 at D 32, 128 at D 112, else D), and counters at least
// n_kt * B * Hkv int32 zeros, zero again when the launch ends.
int flash_attention_bwd_dkdv_launch(int D, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    void* dk, void* dv, const float* lse,
                                    float* di, int B, int S, int Hq, int Hkv,
                                    float scale, int mode, const int* plan,
                                    int n_blocks, int n_kt, int splits,
                                    float* ws_k, float* ws_v, int* counters,
                                    int n_counters, void* stream) {
  if (bad_args(q, k, v, dout, lse, di, B, S, Hq, Hkv) || !dk || !dv
      || !plan || n_blocks < 1 || n_kt < 1 || splits < 1
      || (splits > 1 && (!counters
                         || (long long)n_kt * B * Hkv > n_counters
                         || (mode != 1 && !ws_k) || (mode != 2 && !ws_v))))
    return cudaErrorInvalidValue;
  BwdArgs a = make_args(q, k, v, nullptr, dout, nullptr, dk, dv, lse, di, B,
                        S, Hq, Hkv, scale, mode);
  a.plan = plan; a.ws_k = ws_k; a.ws_v = ws_v; a.counters = counters;
  return launch_pass<true>(a, D, 2, n_blocks,
                           static_cast<cudaStream_t>(stream));
}

int flash_attention_bwd_f32_dq_launch(int D, const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, void* dq,
                                      const float* lse, float* di, int B,
                                      int S, int Hq, int Hkv, float scale,
                                      void* stream) {
  if (bad_args(q, k, v, dout, lse, di, B, S, Hq, Hkv) || !o || !dq)
    return cudaErrorInvalidValue;
  return launch_pass<false>(make_args(q, k, v, o, dout, dq, nullptr, nullptr,
                                      lse, di, B, S, Hq, Hkv, scale, 0),
                            D, 1, 0, static_cast<cudaStream_t>(stream));
}

int flash_attention_bwd_f32_dkdv_launch(int D, const void* q, const void* k,
                                        const void* v, const void* dout,
                                        void* dk, void* dv, const float* lse,
                                        float* di, int B, int S, int Hq,
                                        int Hkv, float scale, int mode,
                                        void* stream) {
  if (bad_args(q, k, v, dout, lse, di, B, S, Hq, Hkv) || !dk || !dv)
    return cudaErrorInvalidValue;
  return launch_pass<false>(make_args(q, k, v, nullptr, dout, nullptr, dk,
                                      dv, lse, di, B, S, Hq, Hkv, scale,
                                      mode),
                            D, 2, 0, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a pass (1: dq, 2: dkdv) at head dim D, bf16
// (1) or f32 (0); 0 for a head dim it does not take.
int flash_attention_bwd_smem(int bf16, int pass, int D) {
#define FA_BWD_SMEM(DD)                                                    \
  case DD:                                                                 \
    return (int)(bf16 ? (pass == 1 ? tc::dq_smem<DD>() : tc::dkdv_smem<DD>()) \
                      : (pass == 1 ? fp::dq_smem<DD>() : fp::dkdv_smem<DD>()));
  switch (D) {
    FA_BWD_SMEM(32)
    FA_BWD_SMEM(64)
    FA_BWD_SMEM(112)
    FA_BWD_SMEM(128)
    FA_BWD_SMEM(256)
    default: return 0;
  }
#undef FA_BWD_SMEM
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
