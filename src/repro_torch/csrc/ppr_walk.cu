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
// row's last column with positive mass; a walker on a dangling row or a
// -1 entry stays; a restart draw < restart (f32) sends it home.
//
// Bound on this card: bytes, and in practice the rate of random reads.
// A walker step needs one cum value and one id of its row; a random
// 4-byte read moves at least a 32-byte sector, and every step's reads
// depend on the step before.  The TPU kernel kept the whole adjacency in
// VMEM and gathered rows with one-hot f32 matmuls (ids below 2^24).  Here
// the adjacency stays in device memory, ids reach 2^31 - 1 and row
// offsets are 64-bit.
//
// Design.  The kernel reads a layout built once per adjacency
// (kernels/ppr_walk/ppr_walk.py::walk_layout), never nbrs / cum:
//   summ (N, Gp) f32   the largest cum value of each 8-column block
//                      (G = ceil(D2 / 8) of them, +inf up to Gp, a
//                      multiple of 8): 32 bytes a row at D2 <= 64;
//   pack (N, G + 1, 16) one 64-byte line per block: its 8 cum values
//                      (+inf pad) then its 8 ids (-1 pad; all -1 on a
//                      dangling row).  Block G is the overflow block:
//                      cum all +inf, id 0 = the id at the row's last
//                      positive column.
// A cum row is non-decreasing (a cumulative sum of non-negative
// masses), so the count of entries below the draw is 8 * nb + k, with
// nb the blocks whose largest value is below it and k the entries of
// block nb below it; a count of D2 (nb = G) is the plain version's clamp
// to the last positive column, which block G answers.  So a step costs
// two dependent reads, one summary sector and one 64-byte block, and
// needs no branch: the select of id k out of the block's 8, and a -1 id
// (pad, dangling row, or a dangling overflow) keeps the walker.  A step
// whose restart draw fires reads nothing.
//
// One block per start, one thread per walker.  The count is linear and
// runs inside the walk: at each step the warp's walkers on one node
// (__match_any_sync; often home, after a restart) elect their lowest
// lane, which inserts the node into a shared-memory open-addressing hash
// (H > S slots, a power of two) and atomicMin's the slot's first trace
// index; every walker keeps the slot index of its trace position.  After
// a barrier each warp adds its positions to their slots' counts, one
// atomicAdd per distinct slot; after another each position writes its id
// and, at the slot's first index, the count.  Integer atomics commute,
// so both outputs are bitwise independent of the order the threads ran
// in.  Without the election, the walkers that restart together queue on
// one slot's atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 8;                 // columns per packed block
constexpr unsigned kEmpty = 0xFFFFFFFFu;  // a free hash slot (id -1)
constexpr unsigned kNoFirst = 0xFFFFu;    // no trace index yet (S < 2^16)

// log2 of the hash size: the smallest power of two above S.
__host__ __device__ inline int hash_bits(int S) {
  int b = 1;
  while ((1 << b) <= S) ++b;
  return b;
}

// keys (H) and first / count words (H), then one slot index a position.
__host__ __device__ inline size_t smem_bytes(int S) {
  const size_t H = size_t(1) << hash_bits(S);
  return 8 * H + ((2 * (size_t)S + 3) & ~size_t(3));
}

__device__ __forceinline__ int below(float4 v, float u) {
  return (v.x < u) + (v.y < u) + (v.z < u) + (v.w < u);
}

__device__ __forceinline__ int below(int4 v, float u) {
  return below(make_float4(__int_as_float(v.x), __int_as_float(v.y),
                           __int_as_float(v.z), __int_as_float(v.w)), u);
}

__device__ __forceinline__ int pick(int4 a, int4 b, int k) {
  const int4 v = k < 4 ? a : b;
  const int m = k & 3;
  return m < 2 ? (m == 0 ? v.x : v.y) : (m == 2 ? v.z : v.w);
}

__global__ void __launch_bounds__(1024) ppr_walk_kernel(
    const float* __restrict__ summ, const int* __restrict__ pack,
    const int* __restrict__ starts, const float* __restrict__ u, int Gp,
    int G1, int walk_len, float restart, int hbits,
    int* __restrict__ visited, int* __restrict__ counts) {
  extern __shared__ unsigned smem[];
  const int W = blockDim.x, w = threadIdx.x, L = walk_len;
  const int S = W * L, H = 1 << hbits, lane = w & 31;
  // this warp's threads (the last warp of a block may be partial)
  const unsigned lanes =
      W - (w & ~31) >= 32 ? 0xFFFFFFFFu : (1u << (W - (w & ~31))) - 1;
  unsigned* keys = smem;                    // node id of each slot
  unsigned* word = smem + H;                // count << 16 | first index
  unsigned short* slot = reinterpret_cast<unsigned short*>(smem + 2 * H);
  for (int i = w; i < H; i += W) {
    keys[i] = kEmpty;
    word[i] = kNoFirst;
  }
  const long long s = blockIdx.x;
  const int home = starts[s];
  const float2* uw =
      reinterpret_cast<const float2*>(u + (s * W + w) * 2LL * L);
  __syncthreads();
  int pos = home;
  for (int t = 0; t < L; ++t) {
    const float2 d = __ldg(uw + t);          // x: step draw, y: restart
    if (d.y < restart) {
      pos = home;
    } else {
      const float4* sp =
          reinterpret_cast<const float4*>(summ + (long long)pos * Gp);
      int nb = 0;
      for (int c = 0; c < Gp / 4; c += 2) {  // one sector at a time
        const float4 a = __ldg(sp + c), b = __ldg(sp + c + 1);
        nb += below(a, d.x) + below(b, d.x);
      }
      const int4* bp = reinterpret_cast<const int4*>(
          pack + ((long long)pos * G1 + nb) * (2 * kBlock));
      const int4 c0 = __ldg(bp), c1 = __ldg(bp + 1);
      const int4 i0 = __ldg(bp + 2), i1 = __ldg(bp + 3);
      const int id = pick(i0, i1, below(c0, d.x) + below(c1, d.x));
      if (id >= 0) pos = id;
    }
    // the warp's walkers on one node insert it once, by the lowest lane:
    // the lowest walker, so the earliest trace index of this step
    const int j = w * L + t;
    const unsigned peers = __match_any_sync(lanes, pos);
    const int leader = __ffs(peers) - 1;
    unsigned h = 0;
    if (lane == leader) {
      h = ((unsigned)pos * 0x9E3779B1u) >> (32 - hbits);
      for (;;) {
        const unsigned old = atomicCAS(&keys[h], kEmpty, (unsigned)pos);
        if (old == kEmpty || old == (unsigned)pos) break;
        h = (h + 1) & (H - 1);
      }
      atomicMin(&word[h], (unsigned)j);
    }
    slot[j] = (unsigned short)__shfl_sync(lanes, h, leader);
  }
  __syncthreads();
  for (int j = w; j < S; j += W) {          // L rounds for every thread
    const unsigned h = slot[j];
    const unsigned peers = __match_any_sync(lanes, h);
    if (lane == __ffs(peers) - 1)
      atomicAdd(&word[h], (unsigned)__popc(peers) << 16);
  }
  __syncthreads();
  int* vis = visited + s * S;
  int* cnt = counts + s * S;
  for (int j = w; j < S; j += W) {
    const unsigned h = slot[j], wd = word[h];
    vis[j] = (int)keys[h];
    cnt[j] = (wd & 0xFFFFu) == (unsigned)j ? (int)(wd >> 16) : 0;
  }
}

}  // namespace

extern "C" const char* ppr_walk_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Dynamic shared memory of one block for a trace of S ids.
extern "C" size_t ppr_walk_smem(int S) { return smem_bytes(S); }

// summ (N, Gp) f32 and pack (N, G1, 16) i32 from walk_layout, starts
// (n,) i32 in [0, N), u (n, n_walks, 2 * walk_len) f32; visited / counts
// (n, S) i32.  Requires 1 <= n_walks <= 1024 and S <= 12288 (the wrapper
// checks); above 48 KB of shared memory the attribute is raised.
extern "C" int ppr_walk_launch(const void* summ, const void* pack,
                               const void* starts, const void* u,
                               long long n, int Gp, int G1, int n_walks,
                               int walk_len, float restart, void* visited,
                               void* counts, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const int S = n_walks * walk_len;
    const size_t sm = smem_bytes(S);
    if (sm > 48 * 1024) {
      e = cudaFuncSetAttribute(ppr_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm);
      if (e != cudaSuccess) return (int)e;
    }
    ppr_walk_kernel<<<(unsigned)n, n_walks, sm, (cudaStream_t)stream>>>(
        (const float*)summ, (const int*)pack, (const int*)starts,
        (const float*)u, Gp, G1, walk_len, restart, hash_bits(S),
        (int*)visited, (int*)counts);
  }
  return (int)cudaGetLastError();
}
