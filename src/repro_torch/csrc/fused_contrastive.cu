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
// Design.  Forward: one block of 256 threads (8 warps) per row; src and
// dst are staged in shared memory as f32; warp w forms the dots of
// negatives w, w + 8, ..., its lanes striding over d (coalesced loads),
// reduced with shuffles into a shared s_neg[N]; warp 0 then reduces the
// margin sum, the max and the exponent sum.
//
// Backward: one streaming pass over the negatives, none staged.  a[n]
// needs only negative n's own dot and the saved s_pos and lse; only c
// needs the whole row (through the active count), and c multiplies dst
// and src, which are added at the end.  So each warp of a row's block
// takes groups of G consecutive negatives in turn; its lanes hold their
// slice of src in registers (16-byte units of 8 bf16 or 4 f32; single
// elements where d is not a multiple of that or a row is not 16-byte
// aligned), load the group's G rows at once (read-only path; 64 bytes a
// lane on the vector path: G = 4 at the train step's d 256 in bf16, 2
// in f32), reduce G dots together with shuffles, store d_negs[n] = a[n] *
// src at once and add a[n] * negs[n] into per-lane d_src sums.
// At the end warp 0 adds the other warps' sums in warp order (shared
// memory), then c * dst, and writes d_src and d_dst = c * src.  A row
// wider than the register slices (bf16 d > 1024, f32 d > 512, scalar
// d > 256) takes bwd_wide_kernel: 8 warps on one negative at a time,
// src and the d_src sums in shared memory, the dot reduced through it.
// Both are deterministic: every sum has a fixed order, no atomics.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// Element I/O of the backward: exact widening to f32, and rounding to
// nearest even back to the input type.  S is the type one element moves
// as; a 16-byte unit (uint4) holds 16 / sizeof(T) of them.
template <typename T> struct Io;
template <> struct Io<float> {
  using S = float;
  static __device__ __forceinline__ float get1(float v) { return v; }
  static __device__ __forceinline__ float put1(float v) { return v; }
  static __device__ __forceinline__ void get(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 put(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Io<__nv_bfloat16> {
  using S = unsigned short;
  static __device__ __forceinline__ float get1(unsigned short v) {
    return __uint_as_float((unsigned)v << 16);
  }
  static __device__ __forceinline__ unsigned short put1(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void lohi(unsigned u, float* f) {
    f[0] = __uint_as_float(u << 16);
    f[1] = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ void get(const uint4& r, float* f) {
    lohi(r.x, f);
    lohi(r.y, f + 2);
    lohi(r.z, f + 4);
    lohi(r.w, f + 6);
  }
  static __device__ __forceinline__ uint4 put(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

// What one lane moves a time: a 16-byte unit of E elements (VEC), or
// one element.
template <typename T, bool VEC> struct Unit;
template <typename T> struct Unit<T, true> {
  using R = uint4;
  static constexpr int E = 16 / sizeof(T);
  static __device__ __forceinline__ R zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ void get(const R& r, float* f) {
    Io<T>::get(r, f);
  }
  static __device__ __forceinline__ R put(const float* f) {
    return Io<T>::put(f);
  }
};
template <typename T> struct Unit<T, false> {
  using R = typename Io<T>::S;
  static constexpr int E = 1;
  static __device__ __forceinline__ R zero() { return R(0); }
  static __device__ __forceinline__ void get(const R& r, float* f) {
    f[0] = Io<T>::get1(r);
  }
  static __device__ __forceinline__ R put(const float* f) {
    return Io<T>::put1(f[0]);
  }
};

// One block of `warps` warps per row b.  Lane l of every warp holds the
// row's units l, l + 32, ..., (VPL of them; E elements each) of src and
// of its d_src sums.  Warp w takes negatives n0 = G*w, G*(w + warps), ...
// and the G after each.  Dynamic shared memory: (warps - 1) x d partial
// sums, then the warps' active counts.
template <typename T, bool VEC, int VPL>
__global__ void __launch_bounds__(NT)
bwd_kernel(const T* __restrict__ src, const T* __restrict__ dst,
           const T* __restrict__ negs, const float* __restrict__ gm,
           const float* __restrict__ gi, const float* __restrict__ s_pos,
           const float* __restrict__ lse, int N, int d, float margin,
           float tau, T* __restrict__ d_src, T* __restrict__ d_dst,
           T* __restrict__ d_negs) {
  using U = Unit<T, VEC>;
  using R = typename U::R;
  constexpr int E = U::E, K = VPL * E;
  constexpr int G = VEC ? 4 / VPL : 4;     // 64 bytes a lane (vector)
  extern __shared__ __align__(16) float part[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long b = blockIdx.x;
  const int nu = d / E;                    // units a row
  const R* srow = reinterpret_cast<const R*>(src + b * d);
  float s[K], acc[K];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int u = lane + 32 * j;
    U::get(u < nu ? __ldg(srow + u) : U::zero(), s + j * E);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const float g_m = gm[b], g_i = gi[b], sp = s_pos[b], l = lse[b];
  float cnt = 0.f;
  const R* ng = reinterpret_cast<const R*>(negs + b * N * (long long)d);
  R* dn = reinterpret_cast<R*>(d_negs + b * N * (long long)d);
  for (int n0 = G * w; n0 < N; n0 += G * warps) {
    R x[G][VPL];
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int u = lane + 32 * j;
        x[q][j] = (n0 + q < N && u < nu)
                      ? __ldg(ng + (long long)(n0 + q) * nu + u)
                      : U::zero();
      }
    float dot[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float f[E];
        U::get(x[q][j], f);
#pragma unroll
        for (int e = 0; e < E; ++e) t = fmaf(s[j * E + e], f[e], t);
      }
      dot[q] = t;
    }
    // xor butterflies: every lane ends with the same bits of each dot
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < G; ++q)
        dot[q] += __shfl_xor_sync(0xffffffffu, dot[q], off);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (n0 + q < N) {                    // the same in every lane
        const float sn = dot[q];
        const float act = (sn - sp + margin > 0.f) ? 1.f : 0.f;
        cnt += act;
        const float a = g_m * act + g_i * (expf(sn / tau - l) / tau);
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int u = lane + 32 * j;
          if (u < nu) {
            float f[E], o[E];
            U::get(x[q][j], f);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              o[e] = a * s[j * E + e];
              acc[j * E + e] = fmaf(a, f[e], acc[j * E + e]);
            }
            dn[(long long)(n0 + q) * nu + u] = U::put(o);
          }
        }
      }
    }
  }
  float* cnts = part + (long long)(warps - 1) * d;
  if (w > 0) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int u = lane + 32 * j;
      if (u < nu)
#pragma unroll
        for (int e = 0; e < E; ++e)
          part[(w - 1) * d + u * E + e] = acc[j * E + e];
    }
    if (lane == 0) cnts[w] = cnt;
  }
  if (warps > 1) __syncthreads();
  if (w > 0) return;
  for (int v = 1; v < warps; ++v) {       // warp order: a fixed sum
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int u = lane + 32 * j;
      if (u < nu)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[j * E + e] += part[(v - 1) * d + u * E + e];
    }
    cnt += cnts[v];
  }
  const float c = -g_m * cnt + g_i * (expf(sp / tau - l) - 1.f) / tau;
  const R* drow = reinterpret_cast<const R*>(dst + b * d);
  R* osrc = reinterpret_cast<R*>(d_src + b * d);
  R* odst = reinterpret_cast<R*>(d_dst + b * d);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int u = lane + 32 * j;
    if (u < nu) {
      float f[E], o[E], p[E];
      U::get(__ldg(drow + u), f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o[e] = fmaf(c, f[e], acc[j * E + e]);
        p[e] = c * s[j * E + e];
      }
      osrc[u] = U::put(o);
      odst[u] = U::put(p);
    }
  }
}

// Rows wider than the register slices: 8 warps on one negative at a
// time.  Dynamic shared memory: src and the d_src sums (f32, d each),
// then the dot's per-warp partials, double-buffered so one barrier a
// negative suffices.
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_wide_kernel(const T* __restrict__ src, const T* __restrict__ dst,
                const T* __restrict__ negs, const float* __restrict__ gm,
                const float* __restrict__ gi,
                const float* __restrict__ s_pos,
                const float* __restrict__ lse, int N, int d, float margin,
                float tau, T* __restrict__ d_src, T* __restrict__ d_dst,
                T* __restrict__ d_negs) {
  extern __shared__ __align__(16) float sm[];
  float* s_src = sm;                  // d
  float* acc = s_src + d;             // d
  float* red = acc + d;               // 2 x NWARP
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += NT) {
    s_src[k] = to_f(src[b * d + k]);
    acc[k] = 0.f;
  }
  __syncthreads();
  const float g_m = gm[b], g_i = gi[b], sp = s_pos[b], l = lse[b];
  float cnt = 0.f;
  for (int n = 0; n < N; ++n) {
    const T* row = negs + (b * N + n) * (long long)d;
    float t = 0.f;
    for (int k = threadIdx.x; k < d; k += NT)
      t = fmaf(s_src[k], to_f(row[k]), t);
    t = warp_sum(t);
    float* r = red + (n & 1) * NWARP;
    if (lane == 0) r[w] = t;
    __syncthreads();
    float sn = 0.f;
    for (int v = 0; v < NWARP; ++v) sn += r[v];
    const float act = (sn - sp + margin > 0.f) ? 1.f : 0.f;
    cnt += act;
    const float a = g_m * act + g_i * (expf(sn / tau - l) / tau);
    T* out = d_negs + (b * N + n) * (long long)d;
    for (int k = threadIdx.x; k < d; k += NT) {
      out[k] = from_f<T>(a * s_src[k]);
      acc[k] = fmaf(a, to_f(row[k]), acc[k]);
    }
  }
  const float c = -g_m * cnt + g_i * (expf(sp / tau - l) - 1.f) / tau;
  for (int k = threadIdx.x; k < d; k += NT) {
    d_src[b * d + k] = from_f<T>(fmaf(c, to_f(dst[b * d + k]), acc[k]));
    d_dst[b * d + k] = from_f<T>(c * s_src[k]);
  }
}

static size_t fwd_smem(int N, int d) {
  return sizeof(float) * ((size_t)2 * d + N + 4);
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

// The backward's launch plan (kernels/fused_contrastive/fused_contrastive.py
// ::bwd_plan mirrors it): the vector path where d is a multiple of a
// 16-byte unit and every row is 16-byte aligned, else the scalar path;
// the fewest units a lane (VPL) that cover d, else the wide kernel; the
// fewest warps, at most 8, that keep each warp's group count at its
// least.
struct BwdPlan {
  int path;        // 0 vector, 1 scalar, 2 wide
  int vpl, warps;
  size_t smem;     // dynamic shared memory bytes
};

static BwdPlan bwd_plan(int N, int d, size_t elem, bool aligned) {
  const int e = (int)(16 / elem);
  const bool vec = aligned && d % e == 0;
  const int units = vec ? d / e : d, max_vpl = vec ? 4 : 8;
  for (int vpl = 1; vpl <= max_vpl; vpl *= 2) {
    if (32 * vpl < units) continue;
    const int G = vec ? 4 / vpl : 4;
    const int groups = (N + G - 1) / G;
    const int per = (groups + NWARP - 1) / NWARP;
    const int warps = (groups + per - 1) / per;
    return {vec ? 0 : 1, vpl, warps,
            sizeof(float) * ((size_t)(warps - 1) * d + warps)};
  }
  return {2, 0, NWARP, sizeof(float) * ((size_t)2 * d + 2 * NWARP)};
}

// Dynamic shared memory of the backward's block for a row of N negatives
// of width d, 16-byte aligned (dtype 0 = f32, 1 = bf16).
extern "C" size_t fused_contrastive_bwd_smem(int N, int d, int dtype) {
  return bwd_plan(N, d, dtype == 0 ? 4 : 2, true).smem;
}

template <typename T>
using BwdFn = void (*)(const T*, const T*, const T*, const float*,
                       const float*, const float*, const float*, int, int,
                       float, float, T*, T*, T*);

template <typename T> static BwdFn<T> bwd_fn(const BwdPlan& p) {
  if (p.path == 0) {
    if (p.vpl == 1) return bwd_kernel<T, true, 1>;
    if (p.vpl == 2) return bwd_kernel<T, true, 2>;
    return bwd_kernel<T, true, 4>;
  }
  if (p.path == 1) {
    if (p.vpl == 1) return bwd_kernel<T, false, 1>;
    if (p.vpl == 2) return bwd_kernel<T, false, 2>;
    if (p.vpl == 4) return bwd_kernel<T, false, 4>;
    return bwd_kernel<T, false, 8>;
  }
  return bwd_wide_kernel<T>;
}

// The register path stays under the default 48 KB of dynamic shared
// memory (at most 7 x 1024 + 8 floats); the wide kernel may take up to
// 232,448 bytes, allowed once per device and type.
template <typename T>
static cudaError_t bwd_launch(const T* src, const T* dst, const T* negs,
                              const float* gm, const float* gi,
                              const float* s_pos, const float* lse,
                              long long B, int N, int d, float margin,
                              float tau, T* d_src, T* d_dst, T* d_negs,
                              cudaStream_t s, int device) {
  const bool aligned =
      ((uintptr_t)src | (uintptr_t)dst | (uintptr_t)negs | (uintptr_t)d_src |
       (uintptr_t)d_dst | (uintptr_t)d_negs) % 16 == 0;
  const BwdPlan p = bwd_plan(N, d, sizeof(T), aligned);
  const BwdFn<T> fn = bwd_fn<T>(p);
  if (p.path == 2) {
    static bool wide_ready[64];
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!wide_ready[device]) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
      if (e != cudaSuccess) return e;
      wide_ready[device] = true;
    }
  }
  if (B > 0)
    fn<<<(unsigned)B, 32 * p.warps, p.smem, s>>>(
        src, dst, negs, gm, gi, s_pos, lse, N, d, margin, tau, d_src, d_dst,
        d_negs);
  return cudaGetLastError();
}

// As the forward, plus gm/gi/s_pos/lse (B,) f32 in; d_src/d_dst (B, d)
// and d_negs (B, N, d) out, of the input type.  Requires 8 * d + 64 <=
// 232,448 bytes, for the wide kernel (the wrapper checks).
extern "C" int fused_contrastive_bwd_launch(
    int dtype, const void* src, const void* dst, const void* negs,
    const void* gm, const void* gi, const void* s_pos, const void* lse,
    long long B, int N, int d, float margin, float tau, void* d_src,
    void* d_dst, void* d_negs, void* stream, int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const float *g_m = (const float*)gm, *g_i = (const float*)gi;
  const float *sp = (const float*)s_pos, *l = (const float*)lse;
  if (dtype == 0)
    e = bwd_launch<float>((const float*)src, (const float*)dst,
                          (const float*)negs, g_m, g_i, sp, l, B, N, d,
                          margin, tau, (float*)d_src, (float*)d_dst,
                          (float*)d_negs, s, device);
  else
    e = bwd_launch<__nv_bfloat16>(
        (const __nv_bfloat16*)src, (const __nv_bfloat16*)dst,
        (const __nv_bfloat16*)negs, g_m, g_i, sp, l, B, N, d, margin, tau,
        (__nv_bfloat16*)d_src, (__nv_bfloat16*)d_dst,
        (__nv_bfloat16*)d_negs, s, device);
  return (int)e;
}
