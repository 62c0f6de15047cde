// Fused cluster-queue gather + U2I2I round-robin union for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/queue_gather/queue_gather.py:134 (_kernel, launched
// by _run / queue_gather).  Per request b with cluster c = clusters[b]:
//   1. U2U2I seeds: read the ring row of c newest-first (age 0 = slot
//      (total-1) mod Q, floor-mod), keep entries with age < min(total, Q),
//      time >= cutoff (f32 compare) and item >= 0, drop any item already
//      kept at a smaller age, take the first R.
//   2. U2I2I union: rank-major round-robin over the seeds' I2I rows
//      (rank 0 of every seed, then rank 1, ...); a seed >= N gathers
//      nothing; skip -1, any seed, and any earlier candidate; take the
//      first k.
// Outputs seeds (B, R) and union (B, k) int32, -1-padded.  A cluster id
// outside [0, C) gets empty rows.  Ids are plain integers: no 2^24 cap.
//
// Bound on this card: bytes in principle, the warp's chain of dependent
// steps in practice.  A request moves the ring entries up to its R-th
// seed (8 bytes each), its seeds' I2I rows and (R + k) * 4 output bytes;
// the I2I table (16.8 MB at the serving shape) mostly stays in the 50 MB
// L2, the 512 MB of rings do not.  But each request is a chain: cluster
// id, then cursor, then ring chunk, selection, I2I rows, dedup, stores;
// shared-memory steps and warp votes follow one another, and a warp of
// 32 registers leaves no room to hold a second request's loads.  At the
// serving bulk batch the time moved with the work taken out of that
// chain and with the blocks launched, not with the bytes: rings held in
// L2 and a cache-resident I2I table changed nothing; tiles of 32
// requests a warp, a three-stage software pipeline, two requests
// interleaved in a warp, eight lanes a request, one thread a request, a
// persistent grid, 64 candidates a copy test and larger or smaller hashes
// were each no faster (PERF.md section 6).  So the design keeps a
// request's chain short and its instructions few:
//   * one warp per request, 4 a block; at large batches a warp takes
//     `rpw` consecutive requests (the wrapper's launch plan), so that
//     fewer blocks are launched;
//   * the seed scan takes 32 ages a step (one load of items and times a
//     lane) and stops at R seeds; a scan that needs the whole ring costs
//     one O(1) lookup an entry;
//   * the union loads 64 round-robin candidates a trip, every load issued
//     before any is used (at R 8, K 16 one trip nearly always ends the
//     union), and takes them in columns of 32 consecutive priorities
//     r * ns + s;
//   * dedup is one pass, with no __match_any_sync (several times as slow
//     as a shared load on this card): a lane's entry is a copy if the
//     request's hash in shared memory holds it (seeds, earlier steps or
//     columns); the others place their keys with plain stores (a lane
//     whose slot another key took probes on), so that copies inside a
//     column meet on one slot, where atomicMin of the lane keeps the
//     lowest.  Kept lanes take ballot prefix positions; a seed past the
//     R-th leaves a tombstone.  What is kept depends only on which keys
//     the hash holds, never on thread order;
//   * the ring head's modulo uses a multiplier computed on the host, and
//     the lane's (rank, seed) split a float reciprocal, not a division.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;                 // warps (requests) per block
constexpr int kCols = 2;                  // union columns a load trip
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kEmpty = -1;                // a free slot (keys are >= 0)
constexpr int kTomb = -2;                 // a seed past the R-th: no key
constexpr int kNoLane = 0x7FFFFFFF;

// log2 of a request's hash slots: the smallest power of two >= 2 (R + k +
// 64).  The seed steps place at most R - 1 keys before their last step
// and 32 in it, the union columns at most k - 1 before their last column
// and 32 in it: the table stays at most half full.
__host__ __device__ inline int hash_bits(int R, int k) {
  int b = 1;
  while ((1 << b) < 2 * (R + k + 2 * kLanes)) ++b;
  return b;
}

// Words a request keeps in shared memory: its hash keys, the lowest lane
// of each slot, then its R staged seeds, padded to 16 bytes.
__host__ __device__ inline int request_words(int R, int k) {
  return 2 * (1 << hash_bits(R, k)) + ((R + 3) & ~3);
}

__host__ __device__ inline size_t smem_bytes(int R, int k) {
  return (size_t)kWarps * request_words(R, k) * 4;
}

__device__ __forceinline__ unsigned slot_of(int key, int hbits) {
  return ((unsigned)key * 0x9E3779B1u) >> (32 - hbits);
}

// floor(x / d) for 0 <= x < 64 and 1 <= d <= 32: the product with a
// rounded reciprocal is within 1e-5 of x / d, whose fraction is 0 or at
// least 1/32.
__device__ __forceinline__ int small_div(int x, int d) {
  return __float2int_rz(__fmaf_rn((float)x, __frcp_rn((float)d), 1e-4f));
}

// Whether `key` is held; `h` ends on its slot, or on the free slot where
// a probe for it stops.
__device__ __forceinline__ bool lookup(const int* keys, int key, int hbits,
                                       unsigned& h) {
  const unsigned mask = (1u << hbits) - 1;
  for (h = slot_of(key, hbits);; h = (h + 1) & mask) {
    const int v = keys[h];
    if (v == key) return true;
    if (v == kEmpty) return false;
  }
}

// Place the keys of the lanes with `put` (none held yet), each starting
// at the free slot its lookup ended on; `h` ends on the key's slot.  Two
// lanes may write one slot; the one whose key is not read back probes on
// to the next free slot and writes again.  Lanes of one key start on one
// slot and move together, so they end on one slot.  Which lane writes a
// slot last may vary; which keys the table holds, and where, does not.
__device__ __forceinline__ void place(int* keys, int key, bool put,
                                      unsigned& h, int hbits) {
  const unsigned mask = (1u << hbits) - 1;
  while (__any_sync(kFull, put)) {
    if (put) keys[h] = key;
    __syncwarp();
    if (put && keys[h] == key) put = false;
    else if (put)
      do h = (h + 1) & mask; while (keys[h] != kEmpty);
    __syncwarp();
  }
}

// One column, its 32 lanes in priority order.  A lane is kept if valid,
// not held by the hash (looked up only if `held` may be true) and the
// lowest lane of its key: every valid lane not held places its key, then
// atomicMin of the lane on the key's slot picks the lowest.  Kept lanes
// take positions n, n + 1, ...; those below `cap` are written to `out`,
// and with `trim` the others leave a tombstone, so that the hash holds
// exactly the keys taken.  Returns the number kept.
__device__ __forceinline__ int take_column(int* keys, int* own, int hbits,
                                           int x, bool valid, bool held,
                                           int n, int cap, int* out,
                                           bool trim) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned h = slot_of(x, hbits);
  if (valid && held) valid = !lookup(keys, x, hbits, h);
  place(keys, x, valid, h, hbits);
  if (valid) own[h] = kNoLane;
  __syncwarp();
  if (valid) atomicMin(own + h, lane);
  __syncwarp();
  const bool keep = valid && own[h] == lane;
  const unsigned kept = __ballot_sync(kFull, keep);
  const int pos = n + __popc(kept & below);
  if (keep && pos < cap) out[pos] = x;
  if (trim && keep && pos >= cap) keys[h] = kTomb;
  return __popc(kept);
}

// One request b, served by the calling warp with its hash `keys`, slot
// owners `own` and seed stage.
__device__ __forceinline__ void serve_request(
    long long b, const int* __restrict__ items,
    const float* __restrict__ times, const int* __restrict__ cursor, int C,
    int Q, unsigned q_mul, int q_shift, const int* __restrict__ clusters,
    const int* __restrict__ i2i, long long N, int K, float cutoff, int R,
    int k, int* __restrict__ seeds_out, int* __restrict__ union_out,
    int* keys, int* own, int* stage, int hbits) {
  const int lane = threadIdx.x & 31, H = 1 << hbits;
  const int c = clusters[b];
  const int total = c >= 0 && c < C ? cursor[c] : 0;
  const int fill = min(total, Q);
  int head = 0;                                 // slot of age 0
  if (fill > 0 && Q > 1) {
    const unsigned t1 = (unsigned)(total - 1);  // < 2^31
    head = (int)(t1 - (unsigned)Q * (__umulhi(t1, q_mul) >> q_shift));
  }
  for (int i = lane; i < H / 4; i += kLanes)
    reinterpret_cast<int4*>(keys)[i] = make_int4(kEmpty, kEmpty, kEmpty,
                                                 kEmpty);
  __syncwarp();

  // ---- seeds: 32 ages a step, newest first, until R are kept ----------
  int ns = 0;
  const long long row = (long long)c * Q;
  for (int a0 = 0; a0 < fill && ns < R; a0 += kLanes) {
    const int a = a0 + lane;
    int it = -1;
    bool valid = false;
    if (a < fill) {
      int s = head - a;                         // 0 <= a < Q: one wrap
      if (s < 0) s += Q;
      it = __ldg(items + row + s);
      valid = it >= 0 && __ldg(times + row + s) >= cutoff;
    }
    ns = min(R, ns + take_column(keys, own, hbits, it, valid, ns > 0, ns,
                                 R, stage, true));
  }
  __syncwarp();
  const int sd = lane < ns ? stage[lane] : -1;
  if (lane < R) seeds_out[b * R + lane] = sd;

  // ---- union: 32 consecutive priorities a column, 2 columns a trip ----
  int nu = 0;
  int* urow = union_out + b * k;
  if (ns > 0) {
    const int dr = small_div(kLanes, ns), ds = kLanes - dr * ns;
    int r = small_div(lane, ns), s = lane - r * ns;   // priority p0 + lane
    for (int p0 = 0; p0 < ns * K && nu < k; p0 += kCols * kLanes) {
      int cd[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {         // every load, then any use
        const int seed = __shfl_sync(kFull, sd, s);
        cd[i] = -1;
        if (r < K && seed < N) cd[i] = __ldg(i2i + (long long)seed * K + r);
        r += dr;
        s += ds;
        if (s >= ns) {
          s -= ns;
          ++r;
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (nu < k)
          nu = min(k, nu + take_column(keys, own, hbits, cd[i], cd[i] >= 0,
                                       true, nu, k, urow, false));
    }
  }
  for (int u = nu + lane; u < k; u += kLanes) urow[u] = -1;
}

__global__ void __launch_bounds__(kWarps * kLanes)
queue_gather_kernel(const int* __restrict__ items,
                    const float* __restrict__ times,
                    const int* __restrict__ cursor, int C, int Q,
                    unsigned q_mul, int q_shift,
                    const int* __restrict__ clusters, long long B,
                    const int* __restrict__ i2i, long long N, int K,
                    float cutoff, int R, int k, int rpw,
                    int* __restrict__ seeds_out,
                    int* __restrict__ union_out) {
  extern __shared__ int smem[];
  const int w = threadIdx.x >> 5;
  const int hbits = hash_bits(R, k), H = 1 << hbits;
  int* keys = smem + (size_t)w * request_words(R, k);
  int* own = keys + H;
  int* stage = own + H;
  const long long b0 = ((long long)blockIdx.x * kWarps + w) * rpw;
  for (long long b = b0; b < b0 + rpw && b < B; ++b) {
    serve_request(b, items, times, cursor, C, Q, q_mul, q_shift, clusters,
                  i2i, N, K, cutoff, R, k, seeds_out, union_out, keys, own,
                  stage, hbits);
    __syncwarp();                               // the hash is reused
  }
}

}  // namespace

extern "C" const char* queue_gather_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Dynamic shared memory of one block at (R, k).
extern "C" size_t queue_gather_smem(int R, int k) { return smem_bytes(R, k); }

// items/times (C, Q) int32/f32, cursor (C,) int32 total writes,
// clusters (B,) int32, i2i (N, K) int32; seeds (B, R), uni (B, k) int32.
// (q_mul, q_shift): x / Q == umulhi(x, q_mul) >> q_shift for 0 <= x <
// 2^31.  A warp takes rpw >= 1 consecutive requests.  Requires 1 <= R <=
// 32, 1 <= k <= 256 and R * K < 2^31 (the wrapper checks all of these).
extern "C" int queue_gather_launch(const void* items, const void* times,
                                   const void* cursor, int C, int Q,
                                   unsigned q_mul, int q_shift,
                                   const void* clusters, long long B,
                                   const void* i2i, long long N, int K,
                                   float cutoff, int R, int k, int rpw,
                                   void* seeds, void* uni, void* stream,
                                   int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B > 0) {
    const long long per_block = (long long)kWarps * rpw;
    const long long grid = (B + per_block - 1) / per_block;
    queue_gather_kernel<<<(unsigned)grid, kWarps * kLanes, smem_bytes(R, k),
                          (cudaStream_t)stream>>>(
        (const int*)items, (const float*)times, (const int*)cursor, C, Q,
        q_mul, q_shift, (const int*)clusters, B, (const int*)i2i, N, K,
        cutoff, R, k, rpw, (int*)seeds, (int*)uni);
  }
  return (int)cudaGetLastError();
}
