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
// Passes (no atomics: every sum runs in a fixed order, so a run repeats
// bitwise).
//  1. dq: one block per (row tile, b, KV head).  It first forms Di for its
//     rows from O and dO (f32 products, a fixed butterfly) and writes it;
//     then it loops over the key tiles up to its rows' causal frontier,
//     recomputing S and dP, and sums dS K into f32 registers.
//  2. dkdv: one block per (64-key tile, b, KV head), after pass 1 (it
//     reads Di).  Its 4 warps own 16 keys each, hold their K and V rows in
//     shared memory, and loop over the row tiles from the first that sees
//     the key tile to the last, recomputing S^T and dP^T, summing P^T dO
//     and dS^T Q into f32 registers.  At head dim 256 the two 16 x 256
//     accumulators would take 256 registers a lane, so the pass runs twice
//     (mode 1: dV only, mode 2: dK only); below, once for both.
//  Both passes recompute S and dP: 14 D operations per kept (query, key)
//  pair against the 10 D the five products need.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 67 TFLOP/s FP32):
// operations.  olmo-1b at B 1, S 4,096 (16 heads, D 128): 10 D per kept
// pair, 0.17 TFLOP a layer, 0.174 ms; the bytes (q, k, v, o, dO, lse read
// once, dq, dk, dv written once) are 0.10 GB, 0.03 ms.
//
// bf16: mma.sync.m16n8k16 with bf16 operands and f32 accumulators, tiles
// in shared memory by cp.async in a 128-byte XOR swizzle, read by
// ldmatrix (ldmatrix.trans for the B operands of dS K, P^T dO and dS^T Q),
// as csrc/flash_attention.cu's fa_mma and fa_decode.  P and dS are
// rounded once to bf16 as the A operands of their products (the scores
// and dP are f32 sums of exact products).  Di comes from the bf16 O (the
// reference's o is f32): within 2^-8 of |dO| . |O| (tests/
// test_torch_flash_attention_bwd.py bounds what that does to dQ).
// wgmma and TMA are for a later redesign.
//
// f32 (the card-vs-CPU checks): FP32 pipes, no tensor cores, no TF32,
// blocks of 16 x 16 threads over 16-row and 16-key tiles, P and dS
// through shared memory, exp as expf.
//
// Head dims 32, 64, 128, 256 (templates).  Shared memory is dynamic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes into shared memory, asynchronously; ok false zero-fills.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Byte offset of 16-byte chunk c of row r in a tile of D-value rows, the
// chunk XORed with the row (flash_attention.cu's swz).
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CH = D / 8;
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
__device__ __forceinline__ uint32_t bf2(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// R rows of D bf16 values (global rows from `row_off(i)`, or zeros where
// it is negative) into the swizzled tile at dst.
template <int D, int R, int NTH, typename F>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g,
                                          F row_off, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < R * CH; i += NTH) {
    const int r = i / CH, c = i % CH;
    const long long off = row_off(r);
    cp16(dst + swz<D>(r, c), off >= 0 ? g + off + c * 8 : g, off >= 0);
  }
}

// s (16 x 8 NB) = A (16 rows at a_row0 of tile a_s) . B^T (rows b_row0..
// of tile b_s): both tiles row-major in the head dim, the product's depth.
template <int D, int NB>
__device__ __forceinline__ void rowdot(float (&s)[NB][4], uint32_t a_s,
                                       int a_row0, uint32_t b_s, int b_row0,
                                       int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4];
    ldm4(a_s + swz<D>(a_row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                      2 * kd + (lane >> 4)), af);
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      ldm4(b_s + swz<D>(b_row0 + 16 * nb + (lane & 7) + ((lane >> 4) & 1) * 8,
                        2 * kd + ((lane >> 3) & 1)), b);
      mma(s[2 * nb], af, b[0], b[1]);
      mma(s[2 * nb + 1], af, b[2], b[3]);
    }
  }
}

// acc (16 x D) += X (16 x 8 NB, the f32 fragments of rowdot's layout,
// rounded to bf16) . Y (tile rows 0 .. 8 NB - 1 of y_s, D wide): X's
// columns run over Y's rows, read transposed.
template <int D, int NB>
__device__ __forceinline__ void acc_mma(float (&acc)[D / 8][4],
                                        const float (&x)[NB][4], uint32_t y_s,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t af[4] = {bf2(x[2 * kk][0], x[2 * kk][1]),
                            bf2(x[2 * kk][2], x[2 * kk][3]),
                            bf2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            bf2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const int yr = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      uint32_t b[4];
      ldm4t(y_s + swz<D>(yr, 2 * db + (lane >> 4)), b);
      mma(acc[2 * db], af, b[0], b[1]);
      mma(acc[2 * db + 1], af, b[2], b[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// Writes rows r and r + 8 of a 16-row accumulator (times mul) to the
// (B, S, H, D) tensor out at element offsets off0 and off1 (negative: no
// row there).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long off0,
                                           long long off1,
                                           const float (&acc)[D / 8][4],
                                           float mul, int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (off0 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + off0 + 8 * n + col) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    if (off1 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + off1 + 8 * n + col) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// Pass 1 (source note): a block of 4 warps takes 64 flattened rows of one
// (b, KV head); warp w owns rows 16 w .. 16 w + 15.  K and V tiles of BN
// keys stream through two stages.
template <int D, int BN>
__global__ void __launch_bounds__(128) fa_bwd_dq(BwdArgs a) {
  constexpr int BM = 64, NTH = 128, TILE = BN * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + BM * D * 2;
  const uint32_t ring = do_s + BM * D * 2;      // 2 x (K, V)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;    // the heaviest tiles first
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, r0 = qt * BM;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kp = static_cast<const bf16*>(a.k);
  const bf16* vp = static_cast<const bf16*>(a.v);
  const bf16* dop = static_cast<const bf16*>(a.dout);
  const bf16* op = static_cast<const bf16*>(a.o);
  auto qoff = [&](int i) -> long long {
    const int r = r0 + i;
    return r < rows ? qrow(a, b, kvh, rep, r, D) : -1;
  };
  load_tile<D, BM, NTH>(q_s, q, qoff, tid);
  load_tile<D, BM, NTH>(do_s, dop, qoff, tid);
  const int last_pos = (min(r0 + BM, rows) - 1) / rep;
  const int n_tiles = last_pos / BN + 1;
  auto koff = [&](int t) {
    return [=, &a](int i) -> long long {
      const int j = t * BN + i;
      return j < a.S ? krow(a, b, kvh, j, D) : -1;
    };
  };
  load_tile<D, BN, NTH>(ring, kp, koff(0), tid);
  load_tile<D, BN, NTH>(ring + TILE, vp, koff(0), tid);
  cp_commit();

  // Di of the warp's 16 rows: f32 products, lanes over the head dim, a
  // butterfly; this thread keeps rows g and g + 8
  const int g = lane >> 2, rw = 16 * warp;
  const long long base = ((long long)b * a.Hkv + kvh) * rows;
  float di[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f};
  bool ok[2];
  int pos[2];
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rw + rr;
    if (r >= rows) break;                       // warp-uniform
    const long long off = qrow(a, b, kvh, rep, r, D);
    float x = 0.f;
    for (int d = lane; d < D; d += 32)
      x = fmaf(__bfloat162float(dop[off + d]), __bfloat162float(op[off + d]),
               x);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
    if (lane == 0) a.di[base + r] = x;
    if (rr == g) di[0] = x;
    if (rr == g + 8) di[1] = x;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rw + g + 8 * i;
    ok[i] = r < rows;
    pos[i] = r / rep;
    lse2[i] = ok[i] ? a.lse[base + r] * LOG2E : 0.f;
  }
  const float sl = a.scale * LOG2E;
  const int warp_last = (min(r0 + rw + 16, rows) - 1) / rep;

  float acc[D / 8][4];
  zero_acc<D>(acc);
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait_all();
    __syncthreads();                  // tile t is in; tile t - 1 is done
    if (t + 1 < n_tiles) {
      const uint32_t st = ring + ((t + 1) & 1) * 2 * TILE;
      load_tile<D, BN, NTH>(st, kp, koff(t + 1), tid);
      load_tile<D, BN, NTH>(st + TILE, vp, koff(t + 1), tid);
      cp_commit();
    }
    const int j0 = t * BN;
    if (r0 + rw >= rows || warp_last < j0) continue;  // nothing to add
    const uint32_t k_s = ring + (t & 1) * 2 * TILE, v_s = k_s + TILE;
    float s[BN / 8][4], dp[BN / 8][4];
    rowdot<D, BN / 8>(s, q_s, rw, k_s, 0, lane);
    rowdot<D, BN / 8>(dp, do_s, rw, v_s, 0, lane);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, j = j0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const float p = ok[i] && j <= pos[i]
                            ? exp2f(fmaf(s[n][e], sl, -lse2[i])) : 0.f;
        s[n][e] = p * (dp[n][e] - di[i]);      // dS
      }
    acc_mma<D, BN / 8>(acc, s, k_s, lane);
  }
  cp_wait_all();
  const int ra = r0 + rw + g;
  store_rows<D>(static_cast<bf16*>(a.dq),
                ra < rows ? qrow(a, b, kvh, rep, ra, D) : -1,
                ra + 8 < rows ? qrow(a, b, kvh, rep, ra + 8, D) : -1, acc,
                a.scale, lane);
}

// Pass 2 (source note): a block of 4 warps takes 64 keys of one (b, KV
// head); warp w owns keys 16 w .. 16 w + 15.  Row tiles of BM rows (Q,
// dO, lse, Di) stream through two stages.  MODE 0: dK and dV, 1: dV, 2:
// dK.
template <int D, int BM, int MODE>
__global__ void __launch_bounds__(128) fa_bwd_dkdv(BwdArgs a) {
  constexpr int BN = 64, NTH = 128, KT = BN * D * 2, RT = BM * D * 2;
  constexpr bool DV = MODE != 2, DK = MODE != 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + KT;
  const uint32_t ring = v_s + KT;               // 2 x (Q, dO)
  float* f_ring = reinterpret_cast<float*>(smem + 2 * KT + 4 * RT);
  // f_ring: 2 x (lse * log2e, Di) of BM rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt = blockIdx.x;                    // key tile 0 is the heaviest
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int rep = a.Hq / a.Hkv, rows = a.S * rep, j0 = kt * BN;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dop = static_cast<const bf16*>(a.dout);
  const long long base = ((long long)b * a.Hkv + kvh) * rows;
  auto koff = [&](int i) -> long long {
    const int j = j0 + i;
    return j < a.S ? krow(a, b, kvh, j, D) : -1;
  };
  load_tile<D, BN, NTH>(k_s, static_cast<const bf16*>(a.k), koff, tid);
  load_tile<D, BN, NTH>(v_s, static_cast<const bf16*>(a.v), koff, tid);
  // row tiles [rt0, rt1]: the first holds row j0 * rep, the first row that
  // sees key j0
  const int rt0 = j0 * rep / BM, rt1 = (rows - 1) / BM;
  auto stage = [&](int rt, int st) {
    const int r0 = rt * BM;
    auto roff = [&](int i) -> long long {
      const int r = r0 + i;
      return r < rows ? qrow(a, b, kvh, rep, r, D) : -1;
    };
    const uint32_t s = ring + st * 2 * RT;
    load_tile<D, BM, NTH>(s, q, roff, tid);
    load_tile<D, BM, NTH>(s + RT, dop, roff, tid);
    cp_commit();
    float* f = f_ring + st * 2 * BM;
    for (int i = tid; i < BM; i += NTH) {
      const int r = r0 + i;
      f[i] = r < rows ? a.lse[base + r] * LOG2E : 0.f;
      f[BM + i] = r < rows ? a.di[base + r] : 0.f;
    }
  };
  stage(rt0, 0);

  const int g = lane >> 2, kw = 16 * warp;
  const int key[2] = {j0 + kw + g, j0 + kw + g + 8};
  const float sl = a.scale * LOG2E;
  float acc_k[DK ? D / 8 : 1][4], acc_v[DV ? D / 8 : 1][4];
  if constexpr (DK) zero_acc<D>(acc_k);
  if constexpr (DV) zero_acc<D>(acc_v);
  for (int rt = rt0; rt <= rt1; ++rt) {
    const int it = rt - rt0;
    cp_wait_all();
    __syncthreads();                  // row tile rt is in; rt - 1 is done
    if (rt < rt1) stage(rt + 1, (it + 1) & 1);
    const int r0 = rt * BM;
    // every row of the tile before the warp's first key: nothing to add
    if ((min(r0 + BM, rows) - 1) / rep < j0 + kw) continue;
    const uint32_t q_t = ring + (it & 1) * 2 * RT, do_t = q_t + RT;
    const float* f = f_ring + (it & 1) * 2 * BM;
    float s[BM / 8][4];
    rowdot<D, BM / 8>(s, k_s, kw, q_t, 0, lane);          // S^T
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * (lane & 3) + (e & 1), r = r0 + i;
        const bool ok = r < rows && key[e >> 1] <= r / rep;
        s[n][e] = ok ? exp2f(fmaf(s[n][e], sl, -f[i])) : 0.f;     // P^T
      }
    if constexpr (DV) acc_mma<D, BM / 8>(acc_v, s, do_t, lane);
    if constexpr (DK) {
      float dp[BM / 8][4];
      rowdot<D, BM / 8>(dp, v_s, kw, do_t, 0, lane);       // dP^T
#pragma unroll
      for (int n = 0; n < BM / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * n + 2 * (lane & 3) + (e & 1);
          s[n][e] *= dp[n][e] - f[BM + i];                 // dS^T
        }
      acc_mma<D, BM / 8>(acc_k, s, q_t, lane);
    }
  }
  cp_wait_all();
  const long long o0 = key[0] < a.S ? krow(a, b, kvh, key[0], D) : -1;
  const long long o1 = key[1] < a.S ? krow(a, b, kvh, key[1], D) : -1;
  if constexpr (DK)
    store_rows<D>(static_cast<bf16*>(a.dk), o0, o1, acc_k, a.scale, lane);
  if constexpr (DV)
    store_rows<D>(static_cast<bf16*>(a.dv), o0, o1, acc_v, 1.f, lane);
}

// K and V tiles of pass 1: 64 keys, 32 at head dim 256 (registers)
template <int D> constexpr int dq_bn() { return D <= 128 ? 64 : 32; }
constexpr int DKDV_BM = 32;             // rows of a pass-2 row tile

template <int D> constexpr size_t dq_smem() {
  return 2 * 64 * D * 2 + 2 * 2 * dq_bn<D>() * D * 2;
}
template <int D> constexpr size_t dkdv_smem() {
  return 2 * 64 * D * 2 + 2 * 2 * DKDV_BM * D * 2 + 2 * 2 * DKDV_BM * 4;
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
  const int rows = a.S * (a.Hq / a.Hkv);
  cudaError_t e = set_smem(fa_bwd_dq<D, dq_bn<D>()>, bytes);
  if (e != cudaSuccess) return e;
  fa_bwd_dq<D, dq_bn<D>()><<<dim3((rows + 63) / 64, a.B * a.Hkv), 128,
                             bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D, int MODE>
static cudaError_t launch_dkdv_mode(const BwdArgs& a, cudaStream_t st) {
  constexpr size_t bytes = dkdv_smem<D>();
  cudaError_t e = set_smem(fa_bwd_dkdv<D, DKDV_BM, MODE>, bytes);
  if (e != cudaSuccess) return e;
  fa_bwd_dkdv<D, DKDV_BM, MODE><<<dim3((a.S + 63) / 64, a.B * a.Hkv), 128,
                                  bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_dkdv(const BwdArgs& a, cudaStream_t st) {
  switch (a.mode) {
    case 0:
      if constexpr (D <= 128) return launch_dkdv_mode<D, 0>(a, st);
      else return cudaErrorInvalidValue;
    case 1: return launch_dkdv_mode<D, 1>(a, st);
    case 2: return launch_dkdv_mode<D, 2>(a, st);
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
                               cudaStream_t st) {
#define FA_BWD_CASE(DD)                                                   \
  case DD:                                                                \
    if constexpr (BF16)                                                   \
      return pass == 1 ? tc::launch_dq<DD>(a, st)                         \
                       : tc::launch_dkdv<DD>(a, st);                      \
    else                                                                  \
      return pass == 1 ? fp::launch_dq<DD>(a, st)                         \
                       : fp::launch_dkdv<DD>(a, st);
  switch (D) {
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(128)
    FA_BWD_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}

static int bwd_launch(int bf16, int pass, int D, const void* q,
                      const void* k, const void* v, const void* o,
                      const void* dout, void* dq, void* dk, void* dv,
                      const float* lse, float* di, int B, int S, int Hq,
                      int Hkv, float scale, int mode, void* stream) {
  if (!q || !k || !v || !dout || !lse || !di || Hkv < 1 || Hq % Hkv
      || B < 1 || S < 1 || (pass == 1 && (!o || !dq))
      || (pass == 2 && (!dk || !dv)))
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.lse = lse; a.di = di;
  a.B = B; a.S = S; a.Hq = Hq; a.Hkv = Hkv; a.scale = scale; a.mode = mode;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pass<true>(a, D, pass, st)
              : launch_pass<false>(a, D, pass, st);
}

extern "C" {

// Common arguments: q, o, dout, dq (B, S, Hq, D) and k, v, dk, dv (B, S,
// Hkv, D), contiguous, in one type; lse and di (B, Hkv, S * Hq / Hkv) f32.
// Causal, q_offset 0, every key valid.  The dq launch writes dq and di; the
// dkdv launch reads di and writes dk and dv (mode 0 both, 1 dV only, 2 dK
// only; the bf16 kernel takes mode 0 up to head dim 128 and modes 1 and 2
// at every head dim, the f32 kernel mode 0).  dout and o are read only by
// the dq launch and dout by the dkdv launch too.
int flash_attention_bwd_dq_launch(int D, const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, void* dq,
                                  const float* lse, float* di, int B, int S,
                                  int Hq, int Hkv, float scale,
                                  void* stream) {
  return bwd_launch(1, 1, D, q, k, v, o, dout, dq, nullptr, nullptr, lse, di,
                    B, S, Hq, Hkv, scale, 0, stream);
}

int flash_attention_bwd_dkdv_launch(int D, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    void* dk, void* dv, const float* lse,
                                    float* di, int B, int S, int Hq, int Hkv,
                                    float scale, int mode, void* stream) {
  return bwd_launch(1, 2, D, q, k, v, nullptr, dout, nullptr, dk, dv, lse,
                    di, B, S, Hq, Hkv, scale, mode, stream);
}

int flash_attention_bwd_f32_dq_launch(int D, const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, void* dq,
                                      const float* lse, float* di, int B,
                                      int S, int Hq, int Hkv, float scale,
                                      void* stream) {
  return bwd_launch(0, 1, D, q, k, v, o, dout, dq, nullptr, nullptr, lse, di,
                    B, S, Hq, Hkv, scale, 0, stream);
}

int flash_attention_bwd_f32_dkdv_launch(int D, const void* q, const void* k,
                                        const void* v, const void* dout,
                                        void* dk, void* dv, const float* lse,
                                        float* di, int B, int S, int Hq,
                                        int Hkv, float scale, int mode,
                                        void* stream) {
  return bwd_launch(0, 2, D, q, k, v, nullptr, dout, nullptr, dk, dv, lse,
                    di, B, S, Hq, Hkv, scale, mode, stream);
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
