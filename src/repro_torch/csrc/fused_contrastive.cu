// Fused margin + InfoNCE contrastive losses, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// repro/kernels/fused_contrastive/fused_contrastive.py: _fwd_kernel
// (launched by _run_fwd) and _bwd_kernel (launched by _run_bwd), the
// two halves of its custom VJP.  Per row b of a batch of positive pairs
// with N negatives each:
//   s_pos = src.dst,  s_neg[n] = src.negs[n]
//   marg  = sum_n relu(s_neg[n] - s_pos + margin)
//   m     = max(max_n s_neg[n], s_pos) / tau
//   lse   = m + log(sum_n exp(s_neg[n]/tau - m) + exp(s_pos/tau - m))
//   info  = lse - s_pos / tau
// The forward emits marg, info, s_pos and lse (f32).  The backward takes
// the cotangents gm, gi of marg and info plus the saved s_pos and lse,
// recomputes s_neg and writes
//   a[n]  = gm * 1{s_neg[n] - s_pos + margin > 0} + gi * exp(s_neg[n]/tau - lse)/tau
//   c     = -gm * sum_n 1{active} + gi * (exp(s_pos/tau - lse) - 1)/tau
//   d_src = c * dst + sum_n a[n] negs[n],  d_dst = c * src,
//   d_negs[n] = a[n] * src
// in the input type.  Inputs are bf16 or f32; all arithmetic is f32.
//
// Bound on this card: bytes.  negs (B, N, d) is read once by each pass
// and d_negs written once by the backward; a row does 2*N*d operations
// per pass against N*d input elements, far below the card's ratio of
// operations to bytes.  So the kernels read negs exactly once, in
// order, and keep the (B, N) similarities out of device memory (the
// TPU kernels' point, too).  No matrix unit: a batched dot of one row
// against its own N negatives has no reuse to feed one.
//
// Design.  One block of 256 threads (8 warps) per row.  src and dst are
// staged in shared memory as f32.  Forward: warp w forms the dots of
// negatives w, w + 8, ..., its lanes striding over d (coalesced loads),
// reduced with shuffles into a shared s_neg[N]; warp 0 then reduces
// the margin sum, the max and the exponent sum.  Backward: the row's
// negs[b] is staged whole in shared memory (N*d elements of the input
// type, 51 KB in bf16 at N 100, d 256), so it is read from device memory
// once and serves both the dots and sum_n a[n] negs[n].
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define NT 256
#define NWARP (NT / 32)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as astype
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// s_pos into *pos and every s_neg[n] into sneg[]; negs read from `ng`
// (device or shared memory).  Ends with a barrier.
template <typename T>
__device__ void row_sims(const float* s_src, const float* s_dst,
                         const T* ng, int N, int d, float* sneg,
                         float* pos) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s = fmaf(s_src[k], s_dst[k], s);
    s = warp_sum(s);
    if (lane == 0) *pos = s;
  }
  for (int n = warp; n < N; n += NWARP) {
    const T* row = ng + (long long)n * d;
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s = fmaf(s_src[k], to_f(row[k]), s);
    s = warp_sum(s);
    if (lane == 0) sneg[n] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ src, const T* __restrict__ dst,
           const T* __restrict__ negs, int N, int d, float margin,
           float tau, float* __restrict__ marg, float* __restrict__ info,
           float* __restrict__ s_pos, float* __restrict__ lse) {
  extern __shared__ __align__(16) float sm[];
  float* s_src = sm;                 // d
  float* s_dst = s_src + d;          // d
  float* sneg = s_dst + d;           // N
  float* pos = sneg + N;             // 1
  const long long b = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += NT) {
    s_src[k] = to_f(src[b * d + k]);
    s_dst[k] = to_f(dst[b * d + k]);
  }
  __syncthreads();
  row_sims(s_src, s_dst, negs + b * N * (long long)d, N, d, sneg, pos);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float sp = *pos;
    float mg = 0.f, mx = -INFINITY;
    for (int n = lane; n < N; n += 32) {
      mg += fmaxf(sneg[n] - sp + margin, 0.f);
      mx = fmaxf(mx, sneg[n]);
    }
    mg = warp_sum(mg);
    const float m = fmaxf(warp_max(mx), sp) / tau;
    float e = 0.f;
    for (int n = lane; n < N; n += 32) e += expf(sneg[n] / tau - m);
    e = warp_sum(e);
    if (lane == 0) {
      const float l = m + logf(e + expf(sp / tau - m));
      marg[b] = mg;
      info[b] = l - sp / tau;
      s_pos[b] = sp;
      lse[b] = l;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_kernel(const T* __restrict__ src, const T* __restrict__ dst,
           const T* __restrict__ negs, const float* __restrict__ gm,
           const float* __restrict__ gi, const float* __restrict__ s_pos,
           const float* __restrict__ lse, int N, int d, float margin,
           float tau, T* __restrict__ d_src, T* __restrict__ d_dst,
           T* __restrict__ d_negs) {
  extern __shared__ __align__(16) float sm[];
  float* s_src = sm;                 // d
  float* s_dst = s_src + d;          // d
  float* sneg = s_dst + d;           // N: s_neg, then a
  float* scal = sneg + N;            // [pos (unused), c]
  T* s_neg_rows = reinterpret_cast<T*>(scal + 4);   // N * d
  const long long b = blockIdx.x;
  const T* ng = negs + b * N * (long long)d;
  for (int k = threadIdx.x; k < d; k += NT) {
    s_src[k] = to_f(src[b * d + k]);
    s_dst[k] = to_f(dst[b * d + k]);
  }
  const int nd = N * d;               // < 2^31: it fits shared memory
  for (int q = threadIdx.x; q < nd; q += NT) s_neg_rows[q] = ng[q];
  __syncthreads();
  row_sims(s_src, s_dst, (const T*)s_neg_rows, N, d, sneg, scal);
  const float g_m = gm[b], g_i = gi[b], sp = s_pos[b], l = lse[b];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float cnt = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float s = sneg[n];
      const float act = (s - sp + margin > 0.f) ? 1.f : 0.f;
      cnt += act;
      sneg[n] = g_m * act + g_i * (expf(s / tau - l) / tau);   // a[n]
    }
    cnt = warp_sum(cnt);
    if (lane == 0)
      scal[1] = -g_m * cnt + g_i * (expf(sp / tau - l) - 1.f) / tau;
  }
  __syncthreads();
  const float c = scal[1];
  for (int k = threadIdx.x; k < d; k += NT) {
    float acc = c * s_dst[k];
    for (int n = 0; n < N; ++n)
      acc = fmaf(sneg[n], to_f(s_neg_rows[n * d + k]), acc);
    d_src[b * d + k] = from_f<T>(acc);
    d_dst[b * d + k] = from_f<T>(c * s_src[k]);
  }
  T* dn = d_negs + b * N * (long long)d;
  for (int q = threadIdx.x; q < nd; q += NT) {
    const int n = q / d, k = q - n * d;
    dn[q] = from_f<T>(sneg[n] * s_src[k]);
  }
}

static size_t fwd_smem(int N, int d) {
  return sizeof(float) * ((size_t)2 * d + N + 4);
}
static size_t bwd_smem(int N, int d, size_t elem) {
  return sizeof(float) * ((size_t)2 * d + N + 4) + elem * (size_t)N * d;
}

extern "C" const char* fused_contrastive_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// dtype 0 = f32, 1 = bf16.  src/dst (B, d), negs (B, N, d) of that type;
// marg/info/s_pos/lse (B,) f32.
extern "C" int fused_contrastive_fwd_launch(
    int dtype, const void* src, const void* dst, const void* negs,
    long long B, int N, int d, float margin, float tau, void* marg,
    void* info, void* s_pos, void* lse, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t sm = fwd_smem(N, d);
  if (dtype == 0) {
    e = cudaFuncSetAttribute(fwd_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    if (B > 0)
      fwd_kernel<float><<<(unsigned)B, NT, sm, s>>>(
          (const float*)src, (const float*)dst, (const float*)negs, N, d,
          margin, tau, (float*)marg, (float*)info, (float*)s_pos,
          (float*)lse);
  } else {
    e = cudaFuncSetAttribute(fwd_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    if (B > 0)
      fwd_kernel<__nv_bfloat16><<<(unsigned)B, NT, sm, s>>>(
          (const __nv_bfloat16*)src, (const __nv_bfloat16*)dst,
          (const __nv_bfloat16*)negs, N, d, margin, tau, (float*)marg,
          (float*)info, (float*)s_pos, (float*)lse);
  }
  return (int)cudaGetLastError();
}

// As the forward, plus gm/gi/s_pos/lse (B,) f32 in; d_src/d_dst (B, d)
// and d_negs (B, N, d) out, of the input type.  Requires bwd_smem <=
// 227 KB (the wrapper checks).
extern "C" int fused_contrastive_bwd_launch(
    int dtype, const void* src, const void* dst, const void* negs,
    const void* gm, const void* gi, const void* s_pos, const void* lse,
    long long B, int N, int d, float margin, float tau, void* d_src,
    void* d_dst, void* d_negs, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const size_t sm = bwd_smem(N, d, sizeof(float));
    e = cudaFuncSetAttribute(bwd_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    if (B > 0)
      bwd_kernel<float><<<(unsigned)B, NT, sm, s>>>(
          (const float*)src, (const float*)dst, (const float*)negs,
          (const float*)gm, (const float*)gi, (const float*)s_pos,
          (const float*)lse, N, d, margin, tau, (float*)d_src,
          (float*)d_dst, (float*)d_negs);
  } else {
    const size_t sm = bwd_smem(N, d, sizeof(__nv_bfloat16));
    e = cudaFuncSetAttribute(bwd_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    if (B > 0)
      bwd_kernel<__nv_bfloat16><<<(unsigned)B, NT, sm, s>>>(
          (const __nv_bfloat16*)src, (const __nv_bfloat16*)dst,
          (const __nv_bfloat16*)negs, (const float*)gm, (const float*)gi,
          (const float*)s_pos, (const float*)lse, N, d, margin, tau,
          (__nv_bfloat16*)d_src, (__nv_bfloat16*)d_dst,
          (__nv_bfloat16*)d_negs);
  }
  return (int)cudaGetLastError();
}
