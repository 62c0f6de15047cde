// EmbeddingBag forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// repro/kernels/embedding_bag/embedding_bag.py (_kernel, launched by
// _run: a (B, L) grid whose step (b, l) DMAs table row ids[b, l] and
// accumulates w[b, l] * row into out[b] in f32) and the backward of its
// custom VJP, repro/kernels/embedding_bag/ops.py::_bwd (a segment-sum of
// the weighted upstream gradient into a dense d_table, plus d weights).
// Per bag b of L ids (ids < 0 are padding):
//   w[l]   = 1{ids[b,l] >= 0} * weights[b,l]          (weights optional)
//   cnt    = max(sum_l w[l], 1e-9)                    (mean mode only)
//   out[b] = sum_l w[l] * c(table[ids[b,l]])  [/ cnt]
// accumulated in f32 and written once in the output type (the compute
// type, or f32 for a partial bag that a sum across ranks will round
// later).  c() rounds each loaded value to the compute type: with an
// f32 table and bf16 compute this equals the Pallas kernel run on the
// bf16-cast table (the cast is elementwise), without casting the whole
// table first.  The backward writes
//   d_table[v] = c(sum over (b, l) with ids[b,l] = v of g[b] * w[l] [/ cnt])
// accumulated in f32, rounded once to the compute type (ops.py:64's
// astype) and stored in the table's type (the cast's VJP), and, with
// weights, d_w[b,l] = g[b] . c(row) (sum) or g[b] . (c(row) - out[b]) / cnt
// (mean), 0 at padding.
//
// Bound on this card: bytes.  A bag does 2*L*D operations on L*D loaded
// elements; rows are random in a table of up to 1.7e10 elements (66.56
// GB at 2.6e8 x 64 f32), far past the 50 MB L2, so each valid row is one
// read from device memory.  The backward must write the dense d_table
// once (V*D elements, 6.66 GB at 2.6e7 x 64 f32) and read g once per
// valid id: bytes again, the write first.
//
// Forward design.  One warp per bag, 8 bags per block of 256 threads.
// Lane k holds columns k, k + 32, ... (CPL of them, D <= 256), so a warp
// reads one row as coalesced 128-byte segments (two of them for a
// 64-wide f32 row).  The lanes load 32 ids and weights of the bag at
// once and broadcast them with shuffles; four rows are loaded before
// they are accumulated, so each warp keeps four row reads in flight.
// Offsets are 64-bit (id * D reaches 1.66e10 > 2^31); ids are int32 and
// nothing caps them below 2^31 - 1 (the TPU's one-hot 2^24 cap does not
// arise: the rows are gathered by integer loads).
//
// Backward design: a sorted segment-sum, each d_table row written once.
// The wrapper plans the segments in plain torch on the op's stream
// (segment_plan in embedding_bag.py): the flat ids keyed by row (padding
// and ids >= V keyed V, so they sort last), a stable sort of the keys
// with their slots s = b*L + l, so each row's ids come in increasing s,
// and the first sorted position of each tile of `tile` rows.
// rows_kernel gives each warp one tile (16 rows at D 64): it walks the
// tile's sorted positions, 32 at a time, loads BU = 8 rows of g before it
// adds them, and adds each term g[b] * w_eff, rounded, to the f32 sum of
// row key - v0 in shared memory (__fmul_rn and __fadd_rn: nvcc would
// contract them into an FMA), in sorted order, as _bwd's g32 * w_eff and
// segment_sum.  Then it writes the tile, rounded through the compute
// type, as one contiguous run of 16-byte stores; a row with no id is
// written as zeros.  There is no memset, no atomic and no rounding pass
// over the table, no per-row control flow, and d_table repeats bitwise
// from run to run.
//
// Hot rows.  A tile's positions are walked by one warp, so a row that
// holds a large share of the ids would serialise the op.  Sorted
// positions are cut into pieces of `piece`; piece_kernel sums, in a warp
// of its own, every piece that lies inside one row into an f32 partial.
// Where rows_kernel's cursor meets such pieces it finds up to 32 of them
// with one ballot, adds their partials and skips them: the row's sum is
// its head ids, its pieces' partials in order, then its tail ids, a
// fixed order.
//
// d_weights (with weights only): dw_kernel, one warp per bag as the
// forward, reads the bag's rows, rounded through the compute type, and
// writes no table memory.  In mean mode count_kernel first writes each
// bag's cnt, which the other kernels read.
//
// Padding.  The TPU kernel loads row 0 for an id < 0 and multiplies it
// by weight 0; this one skips the load.  The two differ only where row 0
// holds inf or NaN.  An id >= V (never made by the model path, which
// reduces ids mod V) is skipped as padding here, where the plain version
// raises.
//
// Memory.  d_table is allocated in the table's type, with no (V, D) f32
// scratch.  The plan takes 12 bytes an id (keys and slots), 4 bytes a
// tile and the sort's own scratch, plus the partials, 4*D bytes per
// `piece` ids.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define WARPS 8
#define NT (WARPS * 32)
#define UNROLL 4
#define FULL 0xffffffffu

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);     // round to nearest even, as astype
}
// c(): round an f32 value to the compute type (bf16 when RB).
template <bool RB>
__device__ __forceinline__ float rnd(float v) {
  return RB ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// This lane's columns of table row `id`, rounded through the compute type.
template <typename T, int CPL, bool RB>
__device__ __forceinline__ void load_row(const T* __restrict__ table,
                                         int id, int D, int lane,
                                         float (&v)[CPL]) {
  const T* row = table + (long long)id * D;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = lane + 32 * c;
    v[c] = col < D ? rnd<RB>(to_f(row[col])) : 0.f;
  }
}

// Lane k (< n) takes id and effective weight number l0 + k of the bag;
// padding (and ids >= V) becomes id -1, weight 0.
__device__ __forceinline__ void bag_slice(const int* __restrict__ bid,
                                          const float* __restrict__ bw,
                                          long long V, int l0, int n,
                                          int lane, int& id, float& w) {
  id = -1;
  w = 0.f;
  if (lane < n) {
    const int x = bid[l0 + lane];
    if (x >= 0 && x < V) {
      id = x;
      w = bw ? bw[l0 + lane] : 1.f;
    }
  }
}

// Sum over l of w[l] * c(row[l]) for this lane's columns (f32, rows in
// order l = 0, 1, ...), and the lane's share of sum_l w[l].
template <typename T, int CPL, bool RB>
__device__ __forceinline__ void bag_sum(const T* __restrict__ table,
                                        long long V, int D,
                                        const int* __restrict__ bid,
                                        const float* __restrict__ bw, int L,
                                        float scale_div, int lane,
                                        float (&acc)[CPL], float& wsum) {
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  wsum = 0.f;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    int my;
    float mw;
    bag_slice(bid, bw, V, l0, n, lane, my, mw);
    wsum += mw;
    for (int j0 = 0; j0 < n; j0 += UNROLL) {   // j0 + u <= 31: n <= 32
      float v[UNROLL][CPL], w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int id = __shfl_sync(FULL, my, j0 + u);
        w[u] = __shfl_sync(FULL, mw, j0 + u) / scale_div;
        if (id >= 0) {
          load_row<T, CPL, RB>(table, id, D, lane, v[u]);
        } else {
#pragma unroll
          for (int c = 0; c < CPL; ++c) v[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] += v[u][c] * w[u];
    }
  }
}

// Forward: out (N, D) in the output type O (the compute type or f32).
template <typename T, typename O, int CPL, bool RB>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ table, long long V, int D,
           const int* __restrict__ ids, const float* __restrict__ weights,
           long long N, int L, int mean, O* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= N) return;                    // the whole warp leaves together
  const int* bid = ids + b * L;
  const float* bw = weights ? weights + b * L : nullptr;
  float acc[CPL], wsum;
  bag_sum<T, CPL, RB>(table, V, D, bid, bw, L, 1.f, lane, acc, wsum);
  const float cnt = mean ? fmaxf(warp_sum(wsum), 1e-9f) : 1.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = lane + 32 * c;
    if (col < D) put(out + b * D + col, mean ? acc[c] / cnt : acc[c]);
  }
}

// ---- backward ----------------------------------------------------------

#define BU 8             // g rows a warp keeps in flight in the backward
#define RWARPS 4         // warps per block of rows_kernel
#define TILE_FLOATS 1024 // f32 sums of one warp's tile of rows (4 KB)

// Each bag's cnt = max(sum of its valid weights, 1e-9) (mean mode).
__global__ void __launch_bounds__(NT)
count_kernel(const int* __restrict__ ids, const float* __restrict__ weights,
             long long V, long long N, int L, float* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= N) return;
  float s = 0.f;
  for (int l = lane; l < L; l += 32) {
    const int x = ids[b * L + l];
    s += (x >= 0 && x < V) ? (weights ? weights[b * L + l] : 1.f) : 0.f;
  }
  s = warp_sum(s);
  if (lane == 0) cnt[b] = fmaxf(s, 1e-9f);
}

// d_w (N, L), one warp per bag: g[b] . c(row), or, in mean mode (cnt not
// null), g[b] . (c(row) - out[b]) / cnt with the bag's output recomputed
// in f32 as _bwd does; 0 at padding.
template <typename T, typename G, int CPL, bool RB>
__global__ void __launch_bounds__(NT)
dw_kernel(const G* __restrict__ g, const T* __restrict__ table, long long V,
          int D, const int* __restrict__ ids,
          const float* __restrict__ weights, long long N, int L,
          const float* __restrict__ cnt, float* __restrict__ dw) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= N) return;
  const int* bid = ids + b * L;
  const float* bw = weights + b * L;
  float gv[CPL], o[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = lane + 32 * c;
    gv[c] = col < D ? to_f(g[b * D + col]) : 0.f;
    o[c] = 0.f;
  }
  const float n = cnt ? cnt[b] : 1.f;
  if (cnt) {
    float unused;
    bag_sum<T, CPL, RB>(table, V, D, bid, bw, L, n, lane, o, unused);
  }
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int m = min(32, L - l0);
    int my;
    float mw;
    bag_slice(bid, bw, V, l0, m, lane, my, mw);
    for (int j = 0; j < m; ++j) {
      const int id = __shfl_sync(FULL, my, j);
      float dot = 0.f;
      if (id >= 0) {
        float v[CPL];
        load_row<T, CPL, RB>(table, id, D, lane, v);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          dot += gv[c] * (cnt ? (v[c] - o[c]) / n : v[c]);
      }
      dot = warp_sum(dot);
      if (lane == 0) dw[b * L + l0 + j] = id >= 0 ? dot : 0.f;
    }
  }
}

// Lane j < n takes the slot at sorted position p + j: its bag b and its
// w_eff (w, or w / cnt[b] in mean mode).
__device__ __forceinline__ void chunk_slots(
    const long long* __restrict__ slots, const float* __restrict__ weights,
    const float* __restrict__ cnt, int L, int p, int n, int lane, int& b,
    float& w) {
  b = 0;
  w = 0.f;
  if (lane < n) {
    const int s = (int)slots[p + lane];
    b = s / L;
    w = weights ? weights[s] : 1.f;
    if (cnt) w = w / cnt[b];
  }
}

// This lane's columns of the g rows of chunk slots j0 .. j0 + BU - 1
// (j0 + BU <= 32), with their weights; zeros from slot n on.
template <typename G, int CPL>
__device__ __forceinline__ void load_g(const G* __restrict__ g, int D,
                                       int b, float w, int j0, int n,
                                       int lane, float (&v)[BU][CPL],
                                       float (&wu)[BU]) {
#pragma unroll
  for (int u = 0; u < BU; ++u) {
    const int j = j0 + u;
    const int bj = __shfl_sync(FULL, b, j);
    wu[u] = __shfl_sync(FULL, w, j);
    const G* row = g + (long long)bj * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + 32 * c;
      v[u][c] = (j < n && col < D) ? to_f(row[col]) : 0.f;
    }
  }
}

// acc += v * w, each product rounded, then added: _bwd's contrib, summed.
template <int CPL>
__device__ __forceinline__ void add_term(float (&acc)[CPL],
                                         const float (&v)[CPL], float w) {
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    acc[c] = __fadd_rn(acc[c], __fmul_rn(v[c], w));
}

// acc += the terms at sorted positions p .. q - 1, in order.
template <typename G, int CPL>
__device__ void sum_slots(const G* __restrict__ g, int D,
                          const long long* __restrict__ slots,
                          const float* __restrict__ weights,
                          const float* __restrict__ cnt, int L, int p, int q,
                          int lane, float (&acc)[CPL]) {
  for (; p < q; p += 32) {
    const int n = min(32, q - p);
    int b;
    float w;
    chunk_slots(slots, weights, cnt, L, p, n, lane, b, w);
    for (int j0 = 0; j0 < n; j0 += BU) {
      float v[BU][CPL], wu[BU];
      load_g<G, CPL>(g, D, b, w, j0, n, lane, v, wu);
#pragma unroll
      for (int u = 0; u < BU; ++u)
        if (j0 + u < n) add_term<CPL>(acc, v[u], wu[u]);
    }
  }
}

// One warp per piece p (sorted positions p*piece .. (p+1)*piece - 1): if
// the whole piece lies in one row's segment, its f32 sum in order into
// partials[p]; else nothing.
template <typename G, int CPL>
__global__ void __launch_bounds__(NT)
piece_kernel(const G* __restrict__ g, int D, int L,
             const float* __restrict__ weights, const float* __restrict__ cnt,
             const long long* __restrict__ slots,
             const int* __restrict__ keys, long long V, int piece,
             long long n_pieces, float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= n_pieces) return;
  const int a = (int)(p * piece);
  const int key = keys[a];
  if (key >= V || keys[a + piece - 1] != key) return;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  sum_slots<G, CPL>(g, D, slots, weights, cnt, L, a, a + piece, lane, acc);
  float* dst = partials + p * D;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = lane + 32 * c;
    if (col < D) dst[col] = acc[c];
  }
}

// Four f32 values of the compute type, stored in the table's type.
template <bool RB>
__device__ __forceinline__ void put4(float* p, float4 x) {
  *(float4*)p = make_float4(rnd<RB>(x.x), rnd<RB>(x.y), rnd<RB>(x.z),
                            rnd<RB>(x.w));
}
template <bool RB>
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *(unsigned*)&lo;
  u.y = *(unsigned*)&hi;
  *(uint2*)p = u;
}

// One warp per tile of d_table rows v0 .. v0 + rows - 1 (tile rows, and
// tile * D a multiple of 4 that fits the warp's TILE_FLOATS): the f32
// sums gather in shared memory, at row key - v0 of each sorted position,
// in sorted order; then the tile is written once, contiguous, 16 bytes a
// lane.  A whole piece of a hot row adds its partial where the cursor
// meets it.
template <typename T, typename G, int CPL, bool RB>
__global__ void __launch_bounds__(RWARPS * 32)
rows_kernel(const G* __restrict__ g, long long V, int D, int L,
            const float* __restrict__ weights, const float* __restrict__ cnt,
            const long long* __restrict__ slots,
            const int* __restrict__ keys, const int* __restrict__ bounds,
            long long n_tiles, int tile, const float* __restrict__ partials,
            int piece, T* __restrict__ out) {
  __shared__ __align__(16) float smem[RWARPS][TILE_FLOATS];
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * RWARPS + (threadIdx.x >> 5);
  if (t >= n_tiles) return;              // the whole warp leaves together
  float* acc = smem[threadIdx.x >> 5];
  float4* acc4 = (float4*)acc;
  for (int i = lane; i < TILE_FLOATS / 4; i += 32)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  const long long v0 = t * tile;
  const int n_el = (int)min((long long)tile, V - v0) * D;
  const int stop = bounds[t + 1];
  for (int cur = bounds[t]; cur < stop;) {  // cur, stop: warp-uniform
    if (cur % piece == 0 && cur + piece <= stop) {
      // whole pieces of one hot row from here: lane j checks piece j
      // (sorted, so those of the row's key form a prefix)
      const int key = keys[cur];
      const long long last = cur + (long long)(lane + 1) * piece - 1;
      const unsigned run =
          __ballot_sync(FULL, last < stop && keys[last] == key);
      const int m = run == FULL ? 32 : __ffs(~run) - 1;
      if (m > 0) {                       // add their partials in order
        float* dst = acc + (key - v0) * D;
        const float* src = partials + (long long)(cur / piece) * D;
        for (int i0 = 0; i0 < m; i0 += BU) {
          float v[BU][CPL];
#pragma unroll
          for (int u = 0; u < BU; ++u)
#pragma unroll
            for (int c = 0; c < CPL; ++c) {
              const int col = lane + 32 * c;
              v[u][c] = (i0 + u < m && col < D)
                            ? src[(long long)(i0 + u) * D + col] : 0.f;
            }
#pragma unroll
          for (int u = 0; u < BU; ++u) {
            if (i0 + u < m) {
#pragma unroll
              for (int c = 0; c < CPL; ++c) {
                const int col = lane + 32 * c;
                if (col < D) dst[col] = __fadd_rn(dst[col], v[u][c]);
              }
            }
          }
        }
        cur += m * piece;
        continue;
      }
    }
    // up to 32 positions, never across a piece boundary
    const int n = min(min(cur + 32, stop), (cur / piece + 1) * piece) - cur;
    int b, r = 0;
    float w;
    chunk_slots(slots, weights, cnt, L, cur, n, lane, b, w);
    if (lane < n) r = (int)(keys[cur + lane] - v0);
    for (int j0 = 0; j0 < n; j0 += BU) {
      float v[BU][CPL], wu[BU];
      load_g<G, CPL>(g, D, b, w, j0, n, lane, v, wu);
#pragma unroll
      for (int u = 0; u < BU; ++u) {
        const int row = __shfl_sync(FULL, r, j0 + u);
        if (j0 + u < n) {
          float* dst = acc + row * D;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int col = lane + 32 * c;
            if (col < D)
              dst[col] = __fadd_rn(dst[col], __fmul_rn(v[u][c], wu[u]));
          }
        }
      }
    }
    cur += n;
  }
  __syncwarp();
  T* dst = out + v0 * D;                 // 16-byte aligned: tile*D % 4 == 0
  const int n4 = n_el / 4;
  for (int i = lane; i < n4; i += 32) put4<RB>(dst + 4 * i, acc4[i]);
  for (int i = 4 * n4 + lane; i < n_el; i += 32)
    put(dst + i, rnd<RB>(acc[i]));
}

extern "C" const char* embedding_bag_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

static int cols_per_lane(int D) {
  int cpl = 1;
  while (32 * cpl < D) cpl *= 2;
  return cpl;                      // 1, 2, 4, 8 for D <= 256
}

template <typename T, typename O, bool RB>
static void fwd_cpl(int cpl, dim3 grid, cudaStream_t s, const void* table,
                    long long V, int D, const int* ids, const float* w,
                    long long N, int L, int mean, void* out) {
#define FWD(C)                                                          \
  fwd_kernel<T, O, C, RB><<<grid, NT, 0, s>>>(                          \
      (const T*)table, V, D, ids, w, N, L, mean, (O*)out)
  switch (cpl) {
    case 1: FWD(1); break;
    case 2: FWD(2); break;
    case 4: FWD(4); break;
    default: FWD(8); break;
  }
#undef FWD
}

// table (V, D) of table_dtype (0 f32, 1 bf16); ids (N, L) int32 (-1
// pad); weights (N, L) f32 or null; each row rounded through
// compute_dtype; out (N, D) of out_dtype, which is compute_dtype or f32
// (0): f32 out keeps the bag's f32 sum unrounded, for partial bags that
// are summed across ranks before their one rounding.
// Requires 1 <= D <= 256 (the wrapper checks).
extern "C" int embedding_bag_fwd_launch(
    int table_dtype, int compute_dtype, int out_dtype, const void* table,
    long long V, int D, const void* ids, const void* weights, long long N,
    int L, int mean, void* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return (int)cudaGetLastError();
  if (out_dtype != 0 && out_dtype != compute_dtype)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((N + WARPS - 1) / WARPS));
  const int cpl = cols_per_lane(D);
  const int* id = (const int*)ids;
  const float* w = (const float*)weights;
  if (table_dtype == 0 && compute_dtype == 0)
    fwd_cpl<float, float, false>(cpl, grid, s, table, V, D, id, w, N, L,
                                 mean, out);
  else if (table_dtype == 0 && out_dtype == 0)  // bf16 rows, f32 out
    fwd_cpl<float, float, true>(cpl, grid, s, table, V, D, id, w, N, L,
                                mean, out);
  else if (table_dtype == 0)
    fwd_cpl<float, __nv_bfloat16, true>(cpl, grid, s, table, V, D, id, w,
                                        N, L, mean, out);
  else if (compute_dtype == 0 || out_dtype == 0)
    fwd_cpl<__nv_bfloat16, float, false>(cpl, grid, s, table, V, D, id, w,
                                         N, L, mean, out);
  else
    fwd_cpl<__nv_bfloat16, __nv_bfloat16, false>(cpl, grid, s, table, V, D,
                                                 id, w, N, L, mean, out);
  return (int)cudaGetLastError();
}

// The backward's arguments, as the entry point takes them.
struct Bwd {
  const void* g;
  const void* table;
  long long V;
  int D;
  const int* ids;
  const float* weights;
  long long N;
  int L;
  const long long* slots;
  const int* keys;
  const int* bounds;
  int tile;
  int piece;
  float* partials;
  float* cnt;
  void* d_table;
  float* dw;
};

static unsigned warp_blocks(long long warps) {
  return (unsigned)((warps + WARPS - 1) / WARPS);
}

template <typename T, typename G, int CPL, bool RB>
static void bwd_run(const Bwd& a, cudaStream_t s) {
  const G* g = (const G*)a.g;
  if (a.cnt && a.N > 0)
    count_kernel<<<warp_blocks(a.N), NT, 0, s>>>(a.ids, a.weights, a.V, a.N,
                                                 a.L, a.cnt);
  if (a.dw && a.N > 0)
    dw_kernel<T, G, CPL, RB><<<warp_blocks(a.N), NT, 0, s>>>(
        g, (const T*)a.table, a.V, a.D, a.ids, a.weights, a.N, a.L, a.cnt,
        a.dw);
  if (!a.d_table) return;
  const long long pieces = a.N * a.L / a.piece;
  if (pieces > 0)
    piece_kernel<G, CPL><<<warp_blocks(pieces), NT, 0, s>>>(
        g, a.D, a.L, a.weights, a.cnt, a.slots, a.keys, a.V, a.piece, pieces,
        a.partials);
  const long long tiles = (a.V + a.tile - 1) / a.tile;
  if (tiles > 0)
    rows_kernel<T, G, CPL, RB>
        <<<(unsigned)((tiles + RWARPS - 1) / RWARPS), RWARPS * 32, 0, s>>>(
            g, a.V, a.D, a.L, a.weights, a.cnt, a.slots, a.keys, a.bounds,
            tiles, a.tile, a.partials, a.piece, (T*)a.d_table);
}

template <typename T, typename G, bool RB>
static void bwd_cpl(int cpl, const Bwd& a, cudaStream_t s) {
  switch (cpl) {
    case 1: bwd_run<T, G, 1, RB>(a, s); break;
    case 2: bwd_run<T, G, 2, RB>(a, s); break;
    case 4: bwd_run<T, G, 4, RB>(a, s); break;
    default: bwd_run<T, G, 8, RB>(a, s); break;
  }
}

// g (N, D) of compute_dtype; table (V, D) of table_dtype (read only for
// d_weights); ids (N, L) int32; weights (N, L) f32 or null.  The segment
// plan (null without d_table): keys (N*L) int32 and slots (N*L) int64,
// the stable sort of the keyed ids, and bounds (ceil(V / tile) + 1)
// int32, the first sorted position of each tile of `tile` rows (and the
// count of valid ids); tile*D must be a multiple of 4 and at most
// TILE_FLOATS.  partials (N*L / piece, D) f32 scratch (null when N*L <
// piece).  cnt (N) f32 scratch in mean mode, else null.  d_table (V, D)
// of table_dtype or null (then no d_table); d_weights (N, L) f32 or null
// (then none; requires weights).  Requires N*L + piece < 2^31 (the
// wrapper checks).
extern "C" int embedding_bag_bwd_launch(
    int table_dtype, int compute_dtype, const void* g, const void* table,
    long long V, int D, const void* ids, const void* weights, long long N,
    int L, const void* keys, const void* slots, const void* bounds,
    int tile, int piece, void* partials, void* cnt, void* d_table,
    void* d_weights, void* stream, int device) {
  if (d_table && (tile < 1 || tile * D > TILE_FLOATS || tile * D % 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const Bwd a{g, table, V, D, (const int*)ids, (const float*)weights, N, L,
              (const long long*)slots, (const int*)keys, (const int*)bounds,
              tile, piece, (float*)partials, (float*)cnt, d_table,
              (float*)d_weights};
  const int cpl = cols_per_lane(D);
  if (table_dtype == 0 && compute_dtype == 0)
    bwd_cpl<float, float, false>(cpl, a, s);
  else if (table_dtype == 0)
    bwd_cpl<float, __nv_bfloat16, true>(cpl, a, s);
  else if (compute_dtype == 0)
    bwd_cpl<__nv_bfloat16, float, false>(cpl, a, s);
  else
    bwd_cpl<__nv_bfloat16, __nv_bfloat16, false>(cpl, a, s);
  return (int)cudaGetLastError();
}
