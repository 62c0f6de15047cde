// Fused PPR Monte-Carlo walk + first-occurrence visit counts, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ppr_walk/ppr_walk.py
// (_kernel, launched by _run / ppr_walk).  For each start node: n_walks
// restart walks of walk_len steps over a padded adjacency (nbrs / cum,
// (N, D2)), driven by host-made uniforms (column 2t: the step draw,
// 2t+1: the restart draw).  Emits the walker-major trace visited (n, S)
// and counts (n, S): each node's multiplicity in the row at its first
// occurrence, 0 elsewhere (S = n_walks * walk_len).
//
// Step semantics (the plain version, kernels/ppr_walk/ref.py): the next
// column is the count of cum entries below the draw, clamped to the
// row's last column with positive mass (last[], passed in); a walker on
// a dangling row or a -1 entry stays; a restart draw < restart (f32)
// sends it home.
//
// Bound on this card: bytes.  A walker step needs one cum value and one
// id of its row, and the uniforms and outputs are read and written
// once; there is almost no arithmetic.  The TPU kernel kept the whole
// adjacency in VMEM and gathered rows with one-hot f32 matmuls (ids
// below 2^24).  Here the adjacency stays in device memory: each step
// binary-searches the walker's non-decreasing f32 cum row (6 loads at
// D2 = 64; the lower bound equals the count of entries < u exactly) and
// loads the chosen id as an integer, so ids reach 2^31 - 1 and row
// offsets are 64-bit.
//
// Design.  One block per start, one thread per walker.  The trace goes
// to shared memory; after a barrier the block counts first occurrences
// with an O(S^2) pass over shared memory (every thread reads the same
// element at once: a broadcast, no bank conflict), S / n_walks
// positions per thread.
#include <cuda_runtime.h>

__global__ void ppr_walk_kernel(const int* __restrict__ nbrs,
                                const float* __restrict__ cum,
                                const int* __restrict__ last,
                                const int* __restrict__ starts,
                                const float* __restrict__ u, int D2,
                                int walk_len, float restart,
                                int* __restrict__ visited,
                                int* __restrict__ counts) {
  extern __shared__ int trace[];             // S ids of this start
  const int W = blockDim.x, w = threadIdx.x;
  const int S = W * walk_len;
  const long long s = blockIdx.x;
  const int home = starts[s];
  const float* uw = u + (s * W + w) * 2LL * walk_len;
  int pos = home;
  for (int t = 0; t < walk_len; ++t) {
    const float us = uw[2 * t], ur = uw[2 * t + 1];
    const long long base = (long long)pos * D2;
    const float* row = cum + base;
    int lo = 0, hi = D2;                     // first column with cum >= us
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < us) lo = mid + 1; else hi = mid;
    }
    const int col = min(lo, last[pos]);
    int nxt = nbrs[base + col];
    if (nxt < 0 || row[D2 - 1] <= 0.f) nxt = pos;   // dangling: stay
    if (ur < restart) nxt = home;
    pos = nxt;
    trace[w * walk_len + t] = pos;
  }
  __syncthreads();
  for (int j = w; j < S; j += W) {
    const int v = trace[j];
    int cnt = 0;
    bool first = true;
    for (int i = 0; i < S; ++i) {
      if (trace[i] == v) {
        ++cnt;
        if (i < j) first = false;
      }
    }
    visited[s * S + j] = v;
    counts[s * S + j] = first ? cnt : 0;
  }
}

extern "C" const char* ppr_walk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// nbrs (N, D2) i32, cum (N, D2) f32, last (N,) i32, starts (n,) i32 in
// [0, N), u (n, n_walks, 2 * walk_len) f32; visited / counts (n, S) i32.
// Requires 1 <= n_walks <= 1024 (the wrapper checks).
extern "C" int ppr_walk_launch(const void* nbrs, const void* cum,
                               const void* last, const void* starts,
                               const void* u, long long n, int D2,
                               int n_walks, int walk_len, float restart,
                               void* visited, void* counts, void* stream,
                               int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const size_t sm = sizeof(int) * (size_t)n_walks * walk_len;
    ppr_walk_kernel<<<(unsigned)n, n_walks, sm, (cudaStream_t)stream>>>(
        (const int*)nbrs, (const float*)cum, (const int*)last,
        (const int*)starts, (const float*)u, D2, walk_len, restart,
        (int*)visited, (int*)counts);
  }
  return (int)cudaGetLastError();
}
