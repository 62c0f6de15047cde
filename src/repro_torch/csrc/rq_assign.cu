// Fused residual-quantization code assignment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rq_assign/rq_assign.py
// (_kernel, launched by _run / rq_assign).  For each row of x (B, d):
// L sequential nearest-code searches, d2 = (||r||^2 - 2 r.C^T) + ||C||^2,
// argmin with the lowest index winning ties (jnp.argmin), subtract the
// chosen code from the residual.  Emits codes (B, L) int32 and
// recon (B, d) f32 = 0 + C_0[k_0] + C_1[k_1] + ..., added in layer order.
//
// Bound on this card: 2*B*d*sum(n_l) FP32 operations against about
// (B*d*2 + sum(n_l)*d + B*L) * 4 bytes, so it is compute-bound on the
// FP32 pipes.  Exact FP32 on purpose: no TF32 tensor cores, because a
// flipped argmin changes a published cluster id.
//
// Design.  The cross term is an SGEMM with an argmin epilogue, so the
// kernel is laid out like one, for the FP32 pipes:
//  * A block owns BM = 128 rows and keeps their residuals resident in
//    shared memory, k-major (R[k][row]), across all L layers: the
//    residual never goes back to device memory between layers.  That
//    128 KB at d = 256 leaves one block (8 warps) an SM.
//  * A one-launch prep kernel writes every codebook transposed and
//    padded to whole code tiles (Ct_l: d x npad_l, npad_l a multiple of
//    BN) and every code norm, once per call (codebooks change every
//    train step, so nothing is cached across calls).
//  * The block streams Ct through shared memory in BK x BN = 64 x 128
//    tiles with cp.async into a two-stage ring, one barrier per stage:
//    the next tile's copy overlaps the current tile's products.  The
//    ring runs on across code tiles and layers.
//  * Each of the 256 threads holds an 8 x 8 register tile (rows ty*4+i
//    and 64+ty*4+i, codes tx*4+j and 64+tx*4+j) and, per k, reads both
//    operands as two float4 each: 64 FMAs per 4 shared loads.  Those
//    fragments are double-buffered in registers, and the next stage's
//    first k is loaded across the barrier, so a stage never starts
//    cold.  With 8 warps an SM the stage boundary is what costs (the
//    deeper the stage, the faster: PERF.md lists the variants).
//  * A code tile whose valid codes all lie in its first 64 columns
//    (n = 50 on the main path, and a layer's ragged last tile) runs a
//    half-width product: it costs 64 codes' work, not 128.
//  * Every (row, code) product sums k = 0..d-1 in order with fmaf,
//    whatever the block, tile or path, so a row's result does not
//    depend on where it falls in the grid or the chunk.  Each thread
//    visits its codes in increasing index order with a strict '<'; the
//    16 lanes of a half-warp share a row's codes and merge their
//    (d2, index) pairs with shuffles (smaller d2, then smaller index),
//    so the lowest index wins exact ties.
#include <cuda_runtime.h>
#include <math.h>

#define BM 128     // rows per block
#define BN 128     // codes per tile
#define BK 64      // dims per staged tile
#define STAGES 2   // cp.async ring depth
#define NT (2 * BM)  // threads per block: 8 rows x 8 codes each
#define MAX_L 8    // codebook layers
#define PREP_NT 256  // prep threads per block
#define MAX_DEVICES 64

struct Books {
  const float* c[MAX_L];    // (n_l, d) codebooks
  const float* ct[MAX_L];   // (d, npad_l) transposed, zero-padded
  float* nrm[MAX_L];        // (npad_l,) squared norms
  int n[MAX_L];
  int npad[MAX_L];
};

// a[l] for a runtime l, by selects: no local-memory copy of the array
template <class T>
__device__ __forceinline__ T pick(const T (&a)[MAX_L], int l) {
  T v = a[0];
#pragma unroll
  for (int i = 1; i < MAX_L; ++i)
    if (l == i) v = a[i];
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// Prep, one launch for all layers: block b takes 32 padded code columns
// of one layer; lane = code, warp w of 8 takes dims 4*(w + 8 i).  Writes
// Ct_l[k][c] (zero past n) and ||C_c||^2: each warp's partial sum in k
// order, then the 8 partials in warp order.
__global__ void __launch_bounds__(PREP_NT)
prep_kernel(const __grid_constant__ Books books, int L, int d) {
  __shared__ float part[PREP_NT / 32][32];
  int tile = blockIdx.x, l = 0;
  while (l < L && tile >= books.npad[l] / 32) { tile -= books.npad[l] / 32; ++l; }
  if (l >= L) return;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = tile * 32 + lane;
  const int n = books.n[l], np = books.npad[l];
  const float* row = books.c[l] + (long long)c * d;
  float* ct = const_cast<float*>(books.ct[l]);
  float s = 0.f;
  for (int k = 4 * w; k < d; k += PREP_NT / 8) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < n) v = *reinterpret_cast<const float4*>(row + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
    ct[(long long)(k + 0) * np + c] = v.x;
    ct[(long long)(k + 1) * np + c] = v.y;
    ct[(long long)(k + 2) * np + c] = v.z;
    ct[(long long)(k + 3) * np + c] = v.w;
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0) {
    float t = part[0][lane];
#pragma unroll
    for (int i = 1; i < PREP_NT / 32; ++i) t += part[i][lane];
    books.nrm[l][c] = t;
  }
}

// Which staged tile comes next: dims k0 of codes c0 of layer l.
struct Cursor {
  int l, c0, k0;
};

__device__ __forceinline__ void copy_stage(const Books& books,
                                           const Cursor& p, int d,
                                           float* buf, int tid) {
  const float* ct = pick(books.ct, p.l);
  const int np = pick(books.npad, p.l);
#pragma unroll
  for (int t = 0; t < BK * BN / 4 / NT; ++t) {
    const int q = tid + t * NT, kr = q / (BN / 4), c4 = (q % (BN / 4)) * 4;
    if (p.k0 + kr < d)
      cp_async16(buf + kr * BN + c4,
                 ct + (long long)(p.k0 + kr) * np + p.c0 + c4);
  }
}

__device__ __forceinline__ void advance(const Books& books, Cursor& p,
                                        int d) {
  p.k0 += BK;
  if (p.k0 >= d) {
    p.k0 = 0;
    p.c0 += BN;
    if (p.c0 >= pick(books.n, p.l)) { p.c0 = 0; ++p.l; }
  }
}

// One k of both operands: rows ty*4+i and 64+ty*4+i, codes tx*4+j and
// 64+tx*4+j, as four float4 shared loads.
struct Frag {
  float4 a0, a1, b0, b1;
};

__device__ __forceinline__ void load_frag(const float* __restrict__ Rk,
                                          const float* __restrict__ Bk,
                                          int ty, int tx, Frag& f) {
  f.a0 = *reinterpret_cast<const float4*>(Rk + ty * 4);
  f.a1 = *reinterpret_cast<const float4*>(Rk + BM / 2 + ty * 4);
  f.b0 = *reinterpret_cast<const float4*>(Bk + tx * 4);
  f.b1 = *reinterpret_cast<const float4*>(Bk + BN / 2 + tx * 4);
}

// acc[i][j] += r[row_i][k] * Ct[k][code_j]; HALF: codes j < 4 only
template <bool HALF>
__device__ __forceinline__ void fma_frag(const Frag& f, float (&acc)[8][8]) {
  const float a[8] = {f.a0.x, f.a0.y, f.a0.z, f.a0.w,
                      f.a1.x, f.a1.y, f.a1.z, f.a1.w};
  const float b[8] = {f.b0.x, f.b0.y, f.b0.z, f.b0.w,
                      f.b1.x, f.b1.y, f.b1.z, f.b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < (HALF ? 4 : 8); ++j)
      acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// The products of one staged tile, kmax dims deep, with the fragments
// double-buffered in registers: f[0] holds k = 0 on entry.  At the last
// k, if more follows in this layer, turn() waits for the next stage and
// passes the barrier, and its k = 0 (Rn, Bn) is loaded into f[0] while
// this stage's last products run, so no stage starts cold.
template <bool HALF, class Turn>
__device__ __forceinline__ void run_stage(
    const float* __restrict__ R, const float* __restrict__ Bs, int kmax,
    bool more, const float* __restrict__ Rn, const float* __restrict__ Bn,
    int ty, int tx, Frag (&f)[2], float (&acc)[8][8], Turn&& turn) {
  if (kmax == BK) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      if (k + 1 < BK) {
        load_frag(R + (k + 1) * BM, Bs + (k + 1) * BN, ty, tx, f[(k + 1) & 1]);
      } else if (more) {
        turn();
        load_frag(Rn, Bn, ty, tx, f[0]);
      }
      fma_frag<HALF>(f[k & 1], acc);
    }
  } else {  // the last, partial stage of a tile: kmax is a multiple of 4
    for (int k = 0; k < kmax; k += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k + u + 1 < kmax) {
          load_frag(R + (k + u + 1) * BM, Bs + (k + u + 1) * BN, ty, tx,
                    f[(u + 1) & 1]);
        } else if (more) {
          turn();
          load_frag(Rn, Bn, ty, tx, f[0]);
        }
        fma_frag<HALF>(f[u & 1], acc);
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
rq_assign_kernel(const float* __restrict__ x,
                 const __grid_constant__ Books books, int L,
                 long long B, int d, int* __restrict__ codes,
                 float* __restrict__ recon) {
  extern __shared__ __align__(16) float smem[];
  float* R = smem;                          // d x BM residuals, k-major
  float* ring = R + (size_t)d * BM;         // STAGES x BK x BN code tiles
  float* rr = ring + STAGES * BK * BN;      // BM row norms ||r||^2
  int* kk = (int*)(rr + BM);                // BM x MAX_L chosen codes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = warp * 2 + (lane >> 4);   // 0..BM/8-1: rows
  const int tx = lane & 15;                // 0..15: codes
  const long long row0 = (long long)blockIdx.x * BM;
  const int d4 = d >> 2;

  // start the ring, then load the block's rows (transposed) beside it
  Cursor p = {0, 0, 0};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (p.l < L) {
      copy_stage(books, p, d, ring + s * BK * BN, tid);
      advance(books, p, d);
    }
    cp_commit();
  }
  for (int q = tid; q < BM * d4; q += NT) {
    const int r = q % BM, k = (q / BM) * 4;
    const long long g = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < B) v = *reinterpret_cast<const float4*>(x + g * d + k);
    R[(k + 0) * BM + r] = v.x;
    R[(k + 1) * BM + r] = v.y;
    R[(k + 2) * BM + r] = v.z;
    R[(k + 3) * BM + r] = v.w;
  }

  int s = 0;  // stages consumed
  for (int l = 0; l < L; ++l) {
    __syncthreads();                          // residuals final
    if (tid < BM) {                           // ||r||^2 in k order
      float t = 0.f;
      for (int k = 0; k < d; ++k) {
        const float v = R[k * BM + tid];
        t = fmaf(v, v, t);
      }
      rr[tid] = t;
    }
    __syncthreads();
    float rrow[8], best[8];
    int bidx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rrow[i] = rr[(i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3)];
      best[i] = INFINITY;
      bidx[i] = 0;
    }
    const int n = pick(books.n, l);
    const float* __restrict__ cn = pick(books.nrm, l);
    // entering stage s: it has landed and stage s-1 is consumed, so its
    // buffer takes stage s + STAGES - 1
    auto turn = [&]() {
      cp_wait_ring();
      __syncthreads();
      if (p.l < L) {
        copy_stage(books, p, d, ring + ((s + STAGES - 1) % STAGES) * BK * BN, tid);
        advance(books, p, d);
      }
      cp_commit();
    };
    Frag f[2];
    turn();
    load_frag(R, ring + (s % STAGES) * BK * BN, ty, tx, f[0]);

    for (int c0 = 0; c0 < n; c0 += BN) {
      const bool half = c0 + BN / 2 >= n;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < d; k0 += BK) {
        const bool last = k0 + BK >= d;         // of this code tile
        const bool more = !last || c0 + BN < n;  // in this layer
        const float* Bs = ring + (s % STAGES) * BK * BN;
        const float* Rn = last ? R : R + (k0 + BK) * BM;
        const float* Bn = ring + ((s + 1) % STAGES) * BK * BN;
        const int kmax = min(BK, d - k0);
        auto next = [&]() { ++s; turn(); };
        if (half)
          run_stage<true>(R + k0 * BM, Bs, kmax, more, Rn, Bn, ty, tx, f, acc, next);
        else
          run_stage<false>(R + k0 * BM, Bs, kmax, more, Rn, Bn, ty, tx, f, acc, next);
        if (!more) ++s;
      }
      // d2 in the reference's form; this thread's codes in increasing order
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + (j < 4 ? 0 : BN / 2) + tx * 4 + (j & 3);
        if (c < n) {
          const float cc = cn[c];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d2 = (rrow[i] - 2.f * acc[i][j]) + cc;
            if (d2 < best[i]) { best[i] = d2; bidx[i] = c; }
          }
        }
      }
    }
    // merge the 16 pairs of each row: the 16 lanes of a half-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = best[i];
      int ix = bidx[i];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        if (ov < v || (ov == v && oi < ix)) { v = ov; ix = oi; }
      }
      if (tx == 0) kk[((i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3)) * MAX_L + l] = ix;
    }
    if (l + 1 == L) break;
    __syncthreads();
    const float* __restrict__ C = pick(books.c, l);
    for (int q = tid; q < BM * d4; q += NT) {   // resid -= C[k]
      const int r = q % BM, k = (q / BM) * 4;
      const float4 c = *reinterpret_cast<const float4*>(
          C + (long long)kk[r * MAX_L + l] * d + k);
      R[(k + 0) * BM + r] -= c.x;
      R[(k + 1) * BM + r] -= c.y;
      R[(k + 2) * BM + r] -= c.z;
      R[(k + 3) * BM + r] -= c.w;
    }
  }
  __syncthreads();

  for (int q = tid; q < BM * L; q += NT) {
    const int r = q / L, l = q % L;
    const long long g = row0 + r;
    if (g < B) codes[g * L + l] = kk[r * MAX_L + l];
  }
  for (int q = tid; q < BM * d4; q += NT) {   // recon = 0 + C_0[k_0] + ...
    const int r = q / d4, k = (q % d4) * 4;
    const long long g = row0 + r;
    if (g >= B) continue;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int l = 0; l < L; ++l) {
      const float4 c = *reinterpret_cast<const float4*>(
          pick(books.c, l) + (long long)kk[r * MAX_L + l] * d + k);
      t.x += c.x; t.y += c.y; t.z += c.z; t.w += c.w;
    }
    *reinterpret_cast<float4*>(recon + g * d + k) = t;
  }
}

static size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)d * BM + STAGES * BK * BN + BM)
         + sizeof(int) * BM * MAX_L;
}

extern "C" const char* rq_assign_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// the wrapper's smem_bytes must agree (chip_smoke.py Phase 0 checks)
extern "C" size_t rq_assign_smem(int d) { return smem_bytes(d); }

// x (B, d) f32; books[l] (sizes[l], d) f32 device pointers (host array);
// scratch: sum_l (d + 1) * npad_l f32, npad_l = sizes[l] rounded up to
// BN (each layer's Ct, then each layer's norms); codes (B, L) i32;
// recon (B, d) f32.  Requires 1 <= L <= MAX_L, d % 4 == 0,
// smem_bytes(d) <= 227 KB and 16-byte aligned x, books, scratch and
// recon (the wrapper checks).
extern "C" int rq_assign_launch(const void* x, const void* books,
                                const void* sizes, int L, void* scratch,
                                long long B, int d, void* codes,
                                void* recon, void* stream, int device) {
  static bool attr_set[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const float* const* bk = (const float* const*)books;
  const int* nz = (const int*)sizes;
  Books p = {};
  float* w = (float*)scratch;
  int tiles = 0;
  for (int l = 0; l < L; ++l) {
    p.c[l] = bk[l];
    p.n[l] = nz[l];
    p.npad[l] = (nz[l] + BN - 1) / BN * BN;
    p.ct[l] = w;
    w += (size_t)d * p.npad[l];
    tiles += p.npad[l] / 32;
  }
  for (int l = 0; l < L; ++l) {
    p.nrm[l] = w;
    w += p.npad[l];
  }
  const size_t sm = smem_bytes(d);
  if (!attr_set[device]) {   // sized for the largest d the plan takes
    e = cudaFuncSetAttribute(rq_assign_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return (int)e;
    attr_set[device] = true;
  }
  prep_kernel<<<tiles, PREP_NT, 0, s>>>(p, L, d);
  if (B > 0) {
    const long long grid = (B + BM - 1) / BM;
    rq_assign_kernel<<<(unsigned)grid, NT, sm, s>>>(
        (const float*)x, p, L, B, d, (int*)codes, (float*)recon);
  }
  return (int)cudaGetLastError();
}
