// Fused cluster-queue gather + U2I2I round-robin union for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/queue_gather/queue_gather.py (_kernel, launched by
// _run / queue_gather).  Per request b with cluster c = clusters[b]:
//   1. U2U2I seeds: read the ring row of c newest-first (age 0 = slot
//      (total-1) mod Q, floor-mod), keep entries with age < min(total, Q),
//      time >= cutoff (f32 compare) and item >= 0, drop any item already
//      seen at a smaller age, take the first R.
//   2. U2I2I union: rank-major round-robin over the seeds' I2I rows
//      (rank 0 of every seed, then rank 1, ...); a seed >= N gathers
//      nothing; skip -1, any seed, and any earlier candidate; take the
//      first k.
// Outputs seeds (B, R) and union (B, k) int32, -1-padded.  A cluster id
// outside [0, C) gets empty rows.
//
// Bound on this card: memory.  Each request moves at most Q*8 ring
// bytes, R*K*4 I2I bytes and (R+k)*4 output bytes and does a few
// integer compares per byte, far below the point where the integer
// pipes would limit it.
//
// Design: one warp per request, 8 requests per 256-thread block.  The
// TPU kernel ranked the whole (1, Q) row with one-hot matmuls on the
// MXU and kept the I2I table in VMEM behind a one-hot f32 gather (hence
// its 2^24 id cap).  Here the warp walks the ring 32 ages at a time
// with coalesced loads straight from device memory and stops as soon as
// it has R seeds, so a full ring is mostly not read at all; dedup is
// __match_any_sync within the 32 lanes plus a compare against the
// seeds already taken (shared memory), and __ballot_sync + __popc give
// each kept lane its output position.  The union walks the R*K
// candidates the same way, 32 at a time, with plain integer loads from
// the I2I table (no id cap), and stops at k.
#include <cuda_runtime.h>

#define WARPS 8
#define MAX_R 32
#define MAX_K 256

__global__ void __launch_bounds__(WARPS * 32)
queue_gather_kernel(const int* __restrict__ items,
                    const float* __restrict__ times,
                    const int* __restrict__ cursor, int C, int Q,
                    const int* __restrict__ clusters, long long B,
                    const int* __restrict__ i2i, long long N, int K,
                    float cutoff, int R, int k, int* __restrict__ seeds_out,
                    int* __restrict__ union_out) {
  __shared__ int s_seeds[WARPS][MAX_R];
  __shared__ int s_union[WARPS][MAX_K];
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;     // lanes before this one
  const long long b = (long long)blockIdx.x * WARPS + w;
  if (b >= B) return;                           // whole warp leaves
  int* seeds = s_seeds[w];
  int* uni = s_union[w];

  // ---- U2U2I seeds: newest-first, recency-filtered, deduped ----------
  int ns = 0;
  const int c = clusters[b];
  if (c >= 0 && c < C) {
    const int total = cursor[c];
    const int fill = min(total, Q);
    const int* irow = items + (long long)c * Q;
    const float* trow = times + (long long)c * Q;
    for (int a0 = 0; a0 < fill && ns < R; a0 += 32) {
      const int a = a0 + lane;
      int it = -1;
      bool valid = false;
      if (a < fill) {
        int slot = (total - 1 - a) % Q;
        if (slot < 0) slot += Q;                // floor-mod, as jnp.mod
        it = irow[slot];
        valid = (trow[slot] >= cutoff) && (it >= 0);
      }
      for (int s = 0; s < ns && valid; ++s) valid = seeds[s] != it;
      // invalid lanes get keys no item can equal
      const unsigned peers = __match_any_sync(FULL, valid ? it : -2 - lane);
      const bool keep = valid && !(peers & below);
      const unsigned kept = __ballot_sync(FULL, keep);
      const int pos = ns + __popc(kept & below);
      if (keep && pos < R) seeds[pos] = it;
      ns = min(R, ns + __popc(kept));
      __syncwarp();
    }
  }
  for (int s = lane; s < R; s += 32)
    seeds_out[b * R + s] = s < ns ? seeds[s] : -1;

  // ---- U2I2I union: rank-major round-robin over the seeds' rows ------
  int nu = 0;
  const int M = ns * K;
  for (int p0 = 0; p0 < M && nu < k; p0 += 32) {
    const int p = p0 + lane;
    int cand = -1;
    bool valid = false;
    if (p < M) {
      const int sd = seeds[p % ns];             // rank p / ns
      if (sd < N) {
        cand = i2i[(long long)sd * K + p / ns];
        valid = cand >= 0;
      }
    }
    for (int s = 0; s < ns && valid; ++s) valid = seeds[s] != cand;
    for (int u = 0; u < nu && valid; ++u) valid = uni[u] != cand;
    const unsigned peers = __match_any_sync(FULL, valid ? cand : -2 - lane);
    const bool keep = valid && !(peers & below);
    const unsigned kept = __ballot_sync(FULL, keep);
    const int pos = nu + __popc(kept & below);
    if (keep && pos < k) uni[pos] = cand;
    nu = min(k, nu + __popc(kept));
    __syncwarp();
  }
  for (int u = lane; u < k; u += 32)
    union_out[b * k + u] = u < nu ? uni[u] : -1;
}

extern "C" const char* queue_gather_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// items/times (C, Q) int32/f32, cursor (C,) int32 total writes,
// clusters (B,) int32, i2i (N, K) int32; seeds (B, R), uni (B, k) int32.
// Requires 1 <= R <= MAX_R and 1 <= k <= MAX_K (the wrapper checks).
extern "C" int queue_gather_launch(const void* items, const void* times,
                                   const void* cursor, int C, int Q,
                                   const void* clusters, long long B,
                                   const void* i2i, long long N, int K,
                                   float cutoff, int R, int k, void* seeds,
                                   void* uni, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B > 0) {
    const long long grid = (B + WARPS - 1) / WARPS;
    queue_gather_kernel<<<(unsigned)grid, WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
        (const int*)items, (const float*)times, (const int*)cursor, C, Q,
        (const int*)clusters, B, (const int*)i2i, N, K, cutoff, R, k,
        (int*)seeds, (int*)uni);
  }
  return (int)cudaGetLastError();
}
