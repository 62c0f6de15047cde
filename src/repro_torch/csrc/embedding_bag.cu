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
// accumulated in f32 and written once in the compute type.  c() rounds
// each loaded value to the compute type: with an f32 table and bf16
// compute this equals the Pallas kernel run on the bf16-cast table (the
// cast is elementwise), without casting the whole table first.  The
// backward writes
//   d_table[v] = c(sum over (b, l) with ids[b,l] = v of g[b] * w[l] [/ cnt])
// accumulated in f32, rounded once to the compute type (ops.py:64's
// astype) and stored in the table's type (the cast's VJP), and, with
// weights, d_w[b,l] = g[b] . c(row) (sum) or g[b] . (c(row) - out[b]) / cnt
// (mean), 0 at padding.
//
// Bound on this card: bytes.  A bag does 2*L*D operations on L*D loaded
// elements; rows are random in a table of up to 1.7e10 elements (66.56
// GB at 2.6e8 x 64 f32), far past the 50 MB L2, so each valid row is one
// read from device memory.  The backward adds one atomic read-modify-
// write per valid row element and the dense d_table: zeroed, then read
// and written once more by the rounding pass.
//
// Design.  One warp per bag, 8 bags per block of 256 threads.  Lane k
// holds columns k, k + 32, ... (CPL of them, D <= 256), so a warp reads
// one row as coalesced 128-byte segments (two of them for a 64-wide f32
// row).  The lanes load 32 ids and weights of the bag at once and
// broadcast them with shuffles; four rows are loaded before they are
// accumulated, so each warp keeps four row reads in flight.  Offsets
// are 64-bit (id * D reaches 1.66e10 > 2^31); ids are int32 and nothing
// caps them below 2^31 - 1 (the TPU's one-hot 2^24 cap does not arise:
// the rows are gathered by integer loads).
//
// Padding.  The TPU kernel loads row 0 for an id < 0 and multiplies it
// by weight 0; this one skips the load.  The two differ only where row 0
// holds inf or NaN.  An id >= V (never made by the model path, which
// reduces ids mod V) is skipped as padding here, where the plain version
// raises.
//
// Atomics.  Rows repeated across bags receive f32 atomicAdds whose order
// changes from run to run, so d_table matches the plain version within
// f32 rounding of the sums, not bitwise.
//
// Memory.  The f32 accumulator (V, D) is allocated by the wrapper for
// each backward call and not kept between steps (PyTorch's caching
// allocator hands the same block back).  For an f32 table the rounding
// pass works in place and the accumulator itself becomes d_table, so
// the backward needs V*D*4 bytes beyond its inputs, not a second copy.
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

// Forward: out (N, D) in the compute type O.
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

// Backward, one warp per bag: atomics into the f32 accumulator `acc`
// (V, D) (skipped when acc is null) and d_w (N, L) (skipped when dw is
// null; needs weights).
template <typename T, typename G, int CPL, bool RB>
__global__ void __launch_bounds__(NT)
bwd_kernel(const G* __restrict__ g, const T* __restrict__ table,
           long long V, int D, const int* __restrict__ ids,
           const float* __restrict__ weights, long long N, int L, int mean,
           float* __restrict__ acc, float* __restrict__ dw) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= N) return;
  const int* bid = ids + b * L;
  const float* bw = weights ? weights + b * L : nullptr;
  float gv[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = lane + 32 * c;
    gv[c] = col < D ? to_f(g[b * D + col]) : 0.f;
  }
  float cnt = 1.f;
  if (mean) {
    float s = 0.f;
    for (int l = lane; l < L; l += 32) {
      const int x = bid[l];
      s += (x >= 0 && x < V) ? (bw ? bw[l] : 1.f) : 0.f;
    }
    cnt = fmaxf(warp_sum(s), 1e-9f);
  }
  // the bag's output in f32 (mean mode's d_w needs it): sum of
  // c(row) * (w / cnt), as _bwd recomputes it
  float o[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) o[c] = 0.f;
  if (dw && mean) {
    float unused;
    bag_sum<T, CPL, RB>(table, V, D, bid, bw, L, cnt, lane, o, unused);
  }
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    int my;
    float mw;
    bag_slice(bid, bw, V, l0, n, lane, my, mw);
    for (int j = 0; j < n; ++j) {
      const int id = __shfl_sync(FULL, my, j);
      const float w = __shfl_sync(FULL, mw, j);
      const float weff = mean ? w / cnt : w;
      if (acc && id >= 0) {
        float* dst = acc + (long long)id * D;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int col = lane + 32 * c;
          if (col < D) atomicAdd(dst + col, gv[c] * weff);
        }
      }
      if (dw) {
        float dot = 0.f;
        if (id >= 0) {
          float v[CPL];
          load_row<T, CPL, RB>(table, id, D, lane, v);
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            dot += gv[c] * (mean ? (v[c] - o[c]) / cnt : v[c]);
        }
        dot = warp_sum(dot);
        if (lane == 0) dw[b * L + l0 + j] = id >= 0 ? dot : 0.f;
      }
    }
  }
}

// d_table = c(acc) in the table's type; in place when T is float.
template <typename T, bool RB>
__global__ void __launch_bounds__(NT)
finish_kernel(float* __restrict__ acc, T* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    put(out + i, rnd<RB>(acc[i]));
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

template <typename T, typename G, bool RB>
static void bwd_cpl(int cpl, dim3 grid, cudaStream_t s, const void* g,
                    const void* table, long long V, int D, const int* ids,
                    const float* w, long long N, int L, int mean,
                    float* acc, float* dw) {
#define BWD(C)                                                          \
  bwd_kernel<T, G, C, RB><<<grid, NT, 0, s>>>(                          \
      (const G*)g, (const T*)table, V, D, ids, w, N, L, mean, acc, dw)
  switch (cpl) {
    case 1: BWD(1); break;
    case 2: BWD(2); break;
    case 4: BWD(4); break;
    default: BWD(8); break;
  }
#undef BWD
}

// table (V, D) of table_dtype (0 f32, 1 bf16); ids (N, L) int32 (-1
// pad); weights (N, L) f32 or null; out (N, D) of compute_dtype.
// Requires 1 <= D <= 256 (the wrapper checks).
extern "C" int embedding_bag_fwd_launch(
    int table_dtype, int compute_dtype, const void* table, long long V,
    int D, const void* ids, const void* weights, long long N, int L,
    int mean, void* out, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((N + WARPS - 1) / WARPS));
  const int cpl = cols_per_lane(D);
  const int* id = (const int*)ids;
  const float* w = (const float*)weights;
  if (table_dtype == 0 && compute_dtype == 0)
    fwd_cpl<float, float, false>(cpl, grid, s, table, V, D, id, w, N, L,
                                 mean, out);
  else if (table_dtype == 0)
    fwd_cpl<float, __nv_bfloat16, true>(cpl, grid, s, table, V, D, id, w,
                                        N, L, mean, out);
  else if (compute_dtype == 0)
    fwd_cpl<__nv_bfloat16, float, false>(cpl, grid, s, table, V, D, id, w,
                                         N, L, mean, out);
  else
    fwd_cpl<__nv_bfloat16, __nv_bfloat16, false>(cpl, grid, s, table, V, D,
                                                 id, w, N, L, mean, out);
  return (int)cudaGetLastError();
}

// g (N, D) of compute_dtype; table (V, D) of table_dtype (read only for
// d_weights); acc (V, D) f32 scratch or null (then no d_table); d_table
// (V, D) of table_dtype (may be acc itself when table_dtype is f32);
// d_weights (N, L) f32 or null (then none; requires weights).
extern "C" int embedding_bag_bwd_launch(
    int table_dtype, int compute_dtype, const void* g, const void* table,
    long long V, int D, const void* ids, const void* weights, long long N,
    int L, int mean, void* acc, void* d_table, void* d_weights,
    void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  float* a = (float*)acc;
  const long long n = V * (long long)D;
  if (a) {
    e = cudaMemsetAsync(a, 0, (size_t)n * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int cpl = cols_per_lane(D);
  const int* id = (const int*)ids;
  const float* w = (const float*)weights;
  float* dw = (float*)d_weights;
  if (N > 0) {
    const dim3 grid((unsigned)((N + WARPS - 1) / WARPS));
    if (table_dtype == 0 && compute_dtype == 0)
      bwd_cpl<float, float, false>(cpl, grid, s, g, table, V, D, id, w, N,
                                   L, mean, a, dw);
    else if (table_dtype == 0)
      bwd_cpl<float, __nv_bfloat16, true>(cpl, grid, s, g, table, V, D, id,
                                          w, N, L, mean, a, dw);
    else if (compute_dtype == 0)
      bwd_cpl<__nv_bfloat16, float, false>(cpl, grid, s, g, table, V, D, id,
                                           w, N, L, mean, a, dw);
    else
      bwd_cpl<__nv_bfloat16, __nv_bfloat16, false>(cpl, grid, s, g, table, V,
                                                   D, id, w, N, L, mean, a,
                                                   dw);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // the rounding pass: needed unless both types are f32 (then d_table is
  // the accumulator as it stands)
  if (a && n > 0 && (table_dtype != 0 || compute_dtype != 0)) {
    long long blocks = (n + NT - 1) / NT;
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    if (table_dtype == 0)
      finish_kernel<float, true><<<(unsigned)blocks, NT, 0, s>>>(
          a, (float*)d_table, n);
    else if (compute_dtype == 0)
      finish_kernel<__nv_bfloat16, false><<<(unsigned)blocks, NT, 0, s>>>(
          a, (__nv_bfloat16*)d_table, n);
    else
      finish_kernel<__nv_bfloat16, true><<<(unsigned)blocks, NT, 0, s>>>(
          a, (__nv_bfloat16*)d_table, n);
  }
  return (int)cudaGetLastError();
}
