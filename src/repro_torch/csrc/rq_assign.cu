// Fused residual-quantization code assignment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rq_assign/rq_assign.py
// (_kernel, launched by _run / rq_assign).  For each row of x (B, d):
// L sequential nearest-code searches, d2 = ||r||^2 - 2 r.C^T + ||C||^2,
// argmin with the lowest index winning ties (jnp.argmin), subtract the
// chosen code from the residual.  Emits codes (B, L) int32 and
// recon (B, d) f32 = sum_l C_l[k_l], added in layer order.
//
// Bound on this card: 2*B*d*sum(n_l) FP32 operations against about
// (B*d*2 + sum(n_l)*d + B*L) * 4 bytes, so it is compute-bound on the
// FP32 pipes.  Exact FP32 on purpose: no TF32 tensor cores, because a
// flipped argmin changes a published cluster id.
//
// Design.  The TPU kernel kept the whole codebook in VMEM; the
// production 5000x256 f32 codebook (5.1 MB) does not fit the 227 KB of
// shared memory a block has.  So a block owns 64 rows and keeps their
// residuals resident in shared memory across all L layers (the
// residual never goes back to device memory between layers), streams
// each codebook through shared memory in 64-code x 32-dim tiles, and
// computes each 64x64 tile of cross terms with a 4x4 register tile per
// thread (256 threads).  Each thread keeps a running (min d2, argmin)
// for its 4 rows over its codes, visited in increasing index order with
// a strict '<', and the 16 threads that share a row merge their pairs
// with warp shuffles (smaller d2, then smaller index).  Every block
// reads every codebook once, from L2.  ||C||^2 comes from a small
// per-code kernel launched first; ||r||^2 is recomputed per layer.
#include <cuda_runtime.h>
#include <math.h>

#define BM 64      // rows per block
#define BN 64      // codes per tile
#define BK 32      // dims per staged tile
#define NT 256     // threads per block
#define MAX_L 8    // codebook layers

struct Books {
  const float* c[MAX_L];    // (n_l, d) codebooks
  const float* nrm[MAX_L];  // (n_l,) squared norms
  int n[MAX_L];
};

// ||C_c||^2 for every code: one warp per code.
__global__ void code_norms_kernel(const float* __restrict__ C, int n, int d,
                                  float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const float* row = C + (long long)warp * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s = fmaf(row[k], row[k], s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

__global__ void __launch_bounds__(NT)
rq_assign_kernel(const float* __restrict__ x, Books books, int L,
                 long long B, int d, int* __restrict__ codes,
                 float* __restrict__ recon) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;                 // padded row stride: no bank clash
  float* R = smem;                      // BM x ld residuals
  float* Ct = R + BM * ld;              // BK x (BN + 1) code tile, transposed
  float* rr = Ct + BK * (BN + 1);       // BM row norms ||r||^2
  int* kk = (int*)(rr + BM);            // BM x MAX_L chosen codes

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * BM;
  const int d4 = d >> 2;

  for (int q = tid; q < BM * d4; q += NT) {
    const int r = q / d4, k = (q % d4) * 4;
    const long long g = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < B) v = *reinterpret_cast<const float4*>(x + g * d + k);
    *reinterpret_cast<float4*>(R + r * ld + k) = v;
  }

  for (int l = 0; l < L; ++l) {
    __syncthreads();
    {  // ||r||^2: 4 threads per row
      const int r = tid >> 2, part = tid & 3;
      float s = 0.f;
      for (int k = part; k < d; k += 4) {
        const float v = R[r * ld + k];
        s = fmaf(v, v, s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) rr[r] = s;
    }
    const float* __restrict__ C = books.c[l];
    const float* __restrict__ cn = books.nrm[l];
    const int n = books.n[l];
    float best[4];
    int bidx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { best[i] = INFINITY; bidx[i] = 0; }

    for (int c0 = 0; c0 < n; c0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < d; k0 += BK) {
        __syncthreads();                 // previous tile fully consumed
        for (int q = tid; q < BN * (BK / 4); q += NT) {
          const int c = q / (BK / 4), kq = (q % (BK / 4)) * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c0 + c < n && k0 + kq < d)
            v = *reinterpret_cast<const float4*>(
                C + (long long)(c0 + c) * d + k0 + kq);
          Ct[(kq + 0) * (BN + 1) + c] = v.x;
          Ct[(kq + 1) * (BN + 1) + c] = v.y;
          Ct[(kq + 2) * (BN + 1) + c] = v.z;
          Ct[(kq + 3) * (BN + 1) + c] = v.w;
        }
        __syncthreads();
        const int kmax = min(BK, d - k0);
        for (int k = 0; k < kmax; k += 4) {
          float4 a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(
                R + (ty + 16 * i) * ld + k0 + k);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Ct[(k + s) * (BN + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float av = s == 0 ? a[i].x : s == 1 ? a[i].y
                             : s == 2 ? a[i].z : a[i].w;
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
            }
          }
        }
      }
      // d2 in the reference's form; codes visited in increasing order
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < n) {
          const float cc = cn[c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d2 = (rr[ty + 16 * i] - 2.f * acc[i][j]) + cc;
            if (d2 < best[i]) { best[i] = d2; bidx[i] = c; }
          }
        }
      }
    }
    // merge the 16 partial (d2, index) pairs of each row: lanes of one
    // row are a 16-lane half of the warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = best[i];
      int ix = bidx[i];
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        if (ov < v || (ov == v && oi < ix)) { v = ov; ix = oi; }
      }
      if (tx == 0) kk[(ty + 16 * i) * MAX_L + l] = ix;
    }
    __syncthreads();
    for (int q = tid; q < BM * d4; q += NT) {   // resid -= C[k]
      const int r = q / d4, k = (q % d4) * 4;
      const float4 c = *reinterpret_cast<const float4*>(
          C + (long long)kk[r * MAX_L + l] * d + k);
      float4* p = reinterpret_cast<float4*>(R + r * ld + k);
      float4 v = *p;
      v.x -= c.x; v.y -= c.y; v.z -= c.z; v.w -= c.w;
      *p = v;
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
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int l = 0; l < L; ++l) {
      const float4 c = *reinterpret_cast<const float4*>(
          books.c[l] + (long long)kk[r * MAX_L + l] * d + k);
      s.x += c.x; s.y += c.y; s.z += c.z; s.w += c.w;
    }
    *reinterpret_cast<float4*>(recon + g * d + k) = s;
  }
}

static size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)BM * (d + 4) + BK * (BN + 1) + BM)
         + sizeof(int) * BM * MAX_L;
}

extern "C" const char* rq_assign_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x (B, d) f32; books[l] (sizes[l], d) f32 device pointers (host array);
// norms: sum(sizes) f32 scratch; codes (B, L) i32; recon (B, d) f32.
// Requires 1 <= L <= MAX_L, d % 4 == 0, smem_bytes(d) <= 227 KB and
// 16-byte aligned x, books and recon (the wrapper checks).
extern "C" int rq_assign_launch(const void* x, const void* books,
                                const void* sizes, int L, void* norms,
                                long long B, int d, void* codes,
                                void* recon, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const float* const* bk = (const float* const*)books;
  const int* nz = (const int*)sizes;
  Books p;
  float* nrm = (float*)norms;
  for (int l = 0; l < L; ++l) {
    p.c[l] = bk[l];
    p.nrm[l] = nrm;
    p.n[l] = nz[l];
    code_norms_kernel<<<(nz[l] + 7) / 8, 256, 0, s>>>(bk[l], nz[l], d, nrm);
    nrm += nz[l];
  }
  const size_t sm = smem_bytes(d);
  e = cudaFuncSetAttribute(rq_assign_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm);
  if (e != cudaSuccess) return (int)e;
  if (B > 0) {
    const long long grid = (B + BM - 1) / BM;
    rq_assign_kernel<<<(unsigned)grid, NT, sm, s>>>(
        (const float*)x, p, L, B, d, (int*)codes, (float*)recon);
  }
  return (int)cudaGetLastError();
}
