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
// with q, k and v upcast to f32 before both products, the max m, the
// normaliser and the accumulator kept in f32 and updated online tile by
// tile (flash_attention.py:51-77), and o cast to q's type once.  Key j is
// masked for row i when j >= kv_len[b] (the ragged kv / decode length)
// or, under `causal`, when j > q_offset + s(i): q_offset is the absolute
// position of query row 0, so the Pallas kernel's decode offset
// (valid_k - valid_q, flash_attention.py:36) is q_offset = T - S and
// repro/models/lm/model.py::_chunked_attention's contract is taken as is.
// GQA: query head h reads KV head h / (Hq / Hkv) in place; nothing is
// repeated (flash_attention.py:124-126 and model.py:165-167 repeat).
//
// Layout.  q is (B, S, Hq, D) and k/v (B, T, Hkv, D), as the LM model
// holds them and its KV cache stores them; the kernel takes element
// strides for the batch, sequence and head axes (the last axis is
// contiguous), so a permuted view of the (B, H, S, D) layout, or a cache
// longer than kv_len, is read in place with no copy.  The output has its
// own strides.
//
// Bound on this card.  Prefill (S = T, causal) does 4*S*T*D/2 operations
// per head on (S + 2T)*D elements: about 6.6 TFLOP a layer at llama's
// 32k, operations-bound (6.7 ms at the bf16 tensor rate, 98 ms at the
// FP32 rate).  Decode (S = 1) reads the whole cache for one row per head:
// bytes-bound (1.07 GB a layer at B 8 x 32k, 0.32 ms at 3.35 TB/s).
//
// Design.  A block of 256 threads takes one (b, KV head) pair and BQ
// rows of its flattened (position, head-in-group) query rows, so the
// group's heads share every K/V tile it loads: BQ = 64 rows (RPT = 4 per
// thread) for prefill, 16 (RPT = 1) when the group has at most 16 rows,
// as at decode.  It loops over 64-key tiles: K and V are loaded once,
// converted to f32 into shared memory (rows padded so the 16-byte reads
// of the score loop do not collide in banks), scores are computed on the
// FP32 pipes (no TF32; thread (ty, tx) holds rows ty*RPT.. and keys
// tx + 16c), the row max and sum are reduced over the 16 lanes that
// share a row, P goes through shared memory, and P.V accumulates in f32
// registers (thread (ty, tx) holds columns tx + 16c of its rows).  Tiles
// wholly past the causal frontier of the block's last row or past
// kv_len are never loaded; keys at or past kv_len are never read.  The
// first kernel is simple: no tensor cores, no TMA, no double buffering
// (those are for later work), and the score loop runs at the FP32 rate.
//
// Split-KV.  On a GPU the Pallas kernel's in-order kv axis becomes a loop
// inside the block.  When the (b, KV head, q-tile) blocks alone cannot
// fill the card (decode: 8 blocks at long_500k, each over 524,288 keys),
// the wrapper splits the kv tiles over `splits` blocks; each writes its
// partial (m, l, acc) in f32 to a workspace the wrapper allocates, and a
// second launch (flash_attention_merge) combines them:
//   M = max_s m_s,  L = sum_s l_s e^(m_s - M),  o = sum_s acc_s e^(m_s - M) / max(L, 1e-30).
// Every valid row sees key 0, so the first split's max is a real score
// and a split whose keys are all masked for a row weighs e^(-1e30 - M) = 0.
//
// Head dims 32, 64, 128, 256 (template); f32 or bf16 inputs, q, k and v
// of one type.  Shared memory is dynamic: 216 KB at D 256 with BQ 64.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define NT 256                  // threads per block: 16 x 16
#define BK 64                   // keys per tile
#define NEG_INF (-1e30f)

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);     // round to nearest even, as astype
}

// 16 bytes of a row (4 f32 or 8 bf16 values) from device memory, as f32
// into shared memory at dst (16-byte aligned).
__device__ __forceinline__ void load16(const float* __restrict__ src,
                                       float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ src,
                                       float* dst) {
  // a bf16 is the top half of its f32; the lower address is the low half
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
      __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
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
};

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
}

// One block of D threads per (b, KV head, row): thread d combines column d
// of the splits' partials.
template <typename T>
__global__ void fa_merge(Args a, int D) {
  const int rep = a.Hq / a.Hkv, rows = a.S * rep;
  const int r = blockIdx.x % rows;
  const int bk = blockIdx.x / rows;       // b * Hkv + kvh
  const int b = bk / a.Hkv, kvh = bk % a.Hkv;
  const int d = threadIdx.x;
  const long long stride = (long long)a.B * a.Hkv * rows;
  const long long w0 = (long long)bk * rows + r;
  float M = NEG_INF;
  for (int s = 0; s < a.splits; ++s) M = fmaxf(M, a.ws_m[w0 + s * stride]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const long long w = w0 + s * stride;
    const float e = expf(a.ws_m[w] - M);
    L += a.ws_l[w] * e;
    A += a.ws_acc[w * D + d] * e;
  }
  const int s_ = r / rep, h = kvh * rep + r % rep;
  T* o = static_cast<T*>(a.o) + b * a.osb + s_ * a.oss + h * a.osh;
  put(o + d, A / fmaxf(L, 1e-30f));
}

template <typename T, int D, int RPT>
static cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D, RPT>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd<T, D, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  const int rows = a.S * (a.Hq / a.Hkv);
  dim3 grid((rows + 16 * RPT - 1) / (16 * RPT), a.B * a.Hkv, a.splits);
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
    case 128: return launch_rpt<T, 128>(a, rpt, st);
    case 256: return launch_rpt<T, 256>(a, rpt, st);
    default: return cudaErrorInvalidValue;
  }
}

static Args make_args(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Hq, int Hkv,
                      const long long* st, int causal, int q_offset,
                      const int* kv_len, int kv_max, float scale, int splits,
                      float* ws_m, float* ws_l, float* ws_acc) {
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
  return a;
}

extern "C" {

// dtype: 0 f32, 1 bf16.  strides: 12 element strides (q b/s/h, k b/t/h,
// v b/t/h, o b/s/h), in host memory.  rpt: 1 or 4.  With splits > 1 the
// outputs are the f32 partials in ws_*; flash_attention_merge then writes o.
int flash_attention_launch(int dtype, int D, const void* q, const void* k,
                           const void* v, void* o, int B, int S, int Hq,
                           int Hkv, const long long* strides,
                           int causal, int q_offset, const int* kv_len,
                           int kv_max, float scale, int rpt, int splits,
                           float* ws_m, float* ws_l, float* ws_acc,
                           void* stream) {
  if ((rpt != 1 && rpt != 4) || splits < 1 || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  Args a = make_args(q, k, v, o, B, S, Hq, Hkv, strides, causal, q_offset,
                     kv_len, kv_max, scale, splits, ws_m, ws_l, ws_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, D, rpt, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, D, rpt, st);
  return cudaErrorInvalidValue;
}

int flash_attention_merge_launch(int dtype, int D, void* o, int B, int S,
                                 int Hq, int Hkv, long long osb,
                                 long long oss, long long osh, int splits,
                                 const float* ws_m, const float* ws_l,
                                 const float* ws_acc, void* stream) {
  if (Hkv < 1 || Hq % Hkv || D < 1 || D > 1024) return cudaErrorInvalidValue;
  long long st[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, osb, oss, osh};
  Args a = make_args(nullptr, nullptr, nullptr, o, B, S, Hq, Hkv, st, 0, 0,
                     nullptr, 0, 0.f, splits, const_cast<float*>(ws_m),
                     const_cast<float*>(ws_l), const_cast<float*>(ws_acc));
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const int blocks = B * Hkv * S * (Hq / Hkv);
  if (dtype == 0) fa_merge<float><<<blocks, D, 0, stm>>>(a, D);
  else if (dtype == 1) fa_merge<__nv_bfloat16><<<blocks, D, 0, stm>>>(a, D);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
