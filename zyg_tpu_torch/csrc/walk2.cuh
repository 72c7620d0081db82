// The binary threaded BVH walk shared by the point and curve kernels
// (points.cu, curves.cu): node rows [M, 12] of min(3) max(3) hit link,
// miss link, leaf group (-1 inner), count, pad(2), as the JAX package's
// zyg_tpu/scene/points.py and curves.py lay them out, read as three
// 16-byte loads. One skeleton, walk2_lanes, runs both walks; a primitive
// policy (points.cu PointsPrim, curves.cu CurvesPrim) gives it a lane's
// inputs and outputs and the test of one leaf slot.
//
// Design (what bounds the walks and what it does about it: points.cu):
// - persistent warps that refill finished threads: the grid is the card's
//   resident blocks, capped at a whole number of blocks an SM that gives
//   each thread about kClaims lanes, and each warp claims 32 lanes at a
//   time from a lane counter in device memory (one atomicAdd by its thread
//   0). At a claim thread t reads lane base + t's root: a lane that does
//   not walk (root -1) has its outputs written there; a walking one has its
//   words (o, 1/d, tmax and the primitive's ray words) computed and copied
//   into column t of the warp's stage buffer in shared memory. Idle threads
//   take the walking lanes in rank order from there, so a refill waits on
//   shared memory, not on device memory, and does no division. The warp
//   leaves when the counter has passed n and none of its threads holds a
//   lane.
// - each warp-step every thread that holds a lane visits one node row; a
//   __ballot_sync gives the lanes that stand at a hit leaf, and the warp
//   tests their (lane, slot) pairs together, 32 a pass (8 lanes x 4
//   slots): thread t takes slot t % 4 of the pass's lane t / 4, reads that
//   lane's ray from the warp's ray buffer in shared memory and its bound at
//   entry and leaf group by shuffles, and loads only its own primitive's
//   row; each lane reads its four results back from the warp's result
//   buffer (one 16-byte load a word) and replays them in slot order, as the
//   plain walks do. A lane alone at a leaf is served the same way: testing
//   its own four slots measured slower, also once the counter is dry
//   (PERF.md §6, PR 21).
// - the next node row's address is known once the current box is tested,
//   so it is read before the leaf tests, which change only the bound (5-7 %
//   off the curve walk, whose 260 KB of rows do not stay in L1).
// Every loop and collective is warp-uniform on the full mask. Each lane
// keeps its own step order and its own arithmetic, so the outputs do not
// depend on the mapping.
#pragma once
#include "launch.cuh"
#include "prop_hit.cuh"

#define WALK2_THREADS 128

namespace walk2 {

constexpr unsigned kFull = 0xFFFFFFFFu;
// the lanes a thread of the grid takes on average: it caps the grid below
// the resident blocks, fewer and fuller warps (1 and 3-4 measured slower)
constexpr int kClaims = 2;
constexpr int kSlots = 4;  // primitives a leaf row
constexpr int kPassLanes = 32 / kSlots;  // lanes a shared pass serves
// a staged lane's words (word-major, 32 lanes a word): its root, o(3),
// 1/d(3), tmax, then the primitive's kExtra ray words that its slot tests
// read with o (the ray buffer: o(3) and those)
constexpr int kRoot = 0, kO = 1, kInv = 4, kTmax = 7, kExtraAt = 8;
constexpr int kExtra = 4;
constexpr int kStageWords = kExtraAt + kExtra;
constexpr int kRayWords = 3 + kExtra;
constexpr int kWarps = WALK2_THREADS / 32;

// a node row as read: the links, group and count stay float32 (exact
// integers) and are converted where they are used
struct Node2 {
  float lo[3], hi[3];
  float hit, miss, group, cnt;
};

__device__ __forceinline__ Node2 load_node2(const float4* rows, int ptr) {
  const float4* r = rows + 3 * (int64_t)ptr;
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  return Node2{{a.x, a.y, a.z}, {a.w, b.x, b.y}, b.z, b.w, c.x, c.y};
}

__device__ __forceinline__ float inv_dir2(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

// min and max that return NaN when either operand is NaN, in one
// instruction each (torch.minimum/maximum's NaN rule; a NaN's payload and
// the sign of a zero may differ from zmin/zmax's, which no comparison of
// slab2 can see)
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the node's box entered within [tmin, tb] (torch.minimum/maximum: NaN wins)
__device__ __forceinline__ bool slab2(const Node2& n, const float* o, const float* inv,
                                      float tmin, float tb) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (n.lo[k] - o[k]) * inv[k];
    const float t1 = (n.hi[k] - o[k]) * inv[k];
    const float lo = nmin(t0, t1), hi = nmax(t0, t1);
    tn = k == 0 ? lo : nmax(tn, lo);
    tf = k == 0 ? hi : nmin(tf, hi);
  }
  return (tn <= tf) & (tf >= tmin) & (tn <= tb);
}

// one walking lane in its thread
struct Lane {
  int64_t id;  // -1: the thread holds no lane
  float o[3], inv[3];
  float tb;  // the best t so far (tmax at the start)
  int pb;  // group * 4 + slot of the best hit, -1
  int ptr;  // the next node row
  float sb, dl;  // curves: the hit's axial parameter, the direction's length
};

// a block's buffers in shared memory, a row a warp: the result buffer
// (kHitWords words of 32 lanes, 16-byte aligned), the stage buffer, the
// ray buffer and the list of 32 lanes
template <int kHitWords>
struct Buffers {
  float4 res[kWarps][kHitWords * 8];
  float stage[kWarps][kStageWords * 32];
  float ray[kWarps][kRayWords * 32];
  int list[kWarps][32];
};

// What the skeleton needs of a primitive policy P:
//   P::kHitWords     the floats of one slot's result (its t first, NaN on a miss)
//   P::Hit           { float v[kHitWords]; }
//   skip(i)          write the outputs of lane i, which does not walk
//   load(i, col)     lane i's staged words after its root (o, 1/d, tmax and
//                    the kExtra ray words) into a stage column (stride 32)
//   start(r, ray)    the primitive's own registers of a lane just taken
//   bound(r)         the bound a slot test of r's leaf takes (the best t at entry)
//   test(ray, group, slot, bound, h)  one slot against the ray words into h
//   take(r, h, group, slot, cnt)      replay one slot's result in slot order
//   finish(r)        write r's outputs
// Each warp of the block runs this loop over the lanes.
template <bool kAnyHit, class P>
__device__ __forceinline__ void walk2_lanes(const P& p, const float4* rows, const int32_t* root,
                                            float tmin, int64_t n, unsigned long long* next,
                                            Buffers<P::kHitWords>& buf) {
  constexpr int kHitWords = P::kHitWords;
  const int w = threadIdx.x / 32;
  const int lane = (int)(threadIdx.x & 31u);
  const unsigned lower = (1u << lane) - 1u;
  float* const stage = buf.stage[w];
  float* const ray = buf.ray[w];
  int* const list = buf.list[w];
  float* const res = reinterpret_cast<float*>(buf.res[w]);
  int64_t base = 0;
  unsigned avail = 0;  // the claimed lanes that walk and wait for a thread
  bool dry = false;
  Lane r;
  r.id = -1;
  r.ptr = -1;
  Node2 cur;  // the row at r.ptr, read ahead of the step that tests it
  cur.group = -1.0f;
  while (true) {
    // ---- idle threads take the claimed lanes in rank order
    unsigned idle = __ballot_sync(kFull, r.id < 0);
    while (idle != 0 && !dry) {
      if (avail == 0) {
        unsigned long long b = 0;
        if (lane == 0) b = atomicAdd(next, 32ull);
        base = (int64_t)__shfl_sync(kFull, b, 0);
        if (base >= n) {
          dry = true;
          break;
        }
        __syncwarp();  // the stage buffer's last reads before its new lanes
        const int64_t i = base + lane;
        bool walks = false;
        if (i < n) {
          const int rt = __ldg(root + i);
          walks = rt >= 0;
          if (walks) {
            stage[32 * kRoot + lane] = __int_as_float(rt);
            p.load(i, stage + lane);
          } else {
            p.skip(i);
          }
        }
        avail = __ballot_sync(kFull, walks);
        continue;
      }
      const int take = __popc(idle) < __popc(avail) ? __popc(idle) : __popc(avail);
      const bool mine = (avail >> lane) & 1u;
      const int col_rank = __popc(avail & lower);
      __syncwarp();  // the list's last reads before its new entries
      if (mine && col_rank < take) list[col_rank] = lane;
      __syncwarp();
      const int rank = __popc(idle & lower);
      if (((idle >> lane) & 1u) && rank < take) {
        const int c = list[rank];
        const float* col = stage + c;
        r.id = base + c;
        r.ptr = __float_as_int(col[32 * kRoot]);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          r.o[k] = col[32 * (kO + k)];
          r.inv[k] = col[32 * (kInv + k)];
          ray[32 * k + lane] = r.o[k];
        }
#pragma unroll
        for (int e = 0; e < kExtra; ++e) ray[32 * (3 + e) + lane] = col[32 * (kExtraAt + e)];
        r.tb = col[32 * kTmax];
        r.pb = -1;
        p.start(r, ray + lane);
        cur = load_node2(rows, r.ptr);
      }
      avail = __ballot_sync(kFull, mine && col_rank >= take);
      idle = __ballot_sync(kFull, r.id < 0);
    }
    if (idle == kFull) break;  // only once dry: an idle warp that is not dry refills
    // ---- one node row of each walking lane; the next row's address is
    // known once its box is tested, so that row is read before the leaf
    // tests, which change only the bound
    const Node2 nd = cur;
    bool hit = false;
    int nxt = -1;
    if (r.id >= 0) {
      hit = slab2(nd, r.o, r.inv, tmin, r.tb);
      nxt = (int)(hit ? nd.hit : nd.miss);
      if (nxt >= 0) cur = load_node2(rows, nxt);
    }
    const bool at_leaf = hit & (nd.group >= 0.0f);
    const unsigned leaves = __ballot_sync(kFull, at_leaf);
    if (leaves != 0) {
      // the (lane, slot) pairs of the lanes at a leaf, 32 a pass
      const int n_leaf = __popc(leaves);
      const int group = at_leaf ? (int)nd.group : 0;
      const int cnt = at_leaf ? (int)nd.cnt : 0;
      const int my_rank = __popc(leaves & lower);
      __syncwarp();  // the list's last reads before its new entries
      if (at_leaf) list[my_rank] = lane;
      __syncwarp();
      const float bnd = p.bound(r);
      const int slot = lane & (kSlots - 1);
      for (int pass = 0; pass * kPassLanes < n_leaf; ++pass) {
        const int k = pass * kPassLanes + lane / kSlots;
        const bool tests = k < n_leaf;
        const int owner = tests ? list[k] : lane;
        const float b = __shfl_sync(kFull, bnd, owner);
        const int g = __shfl_sync(kFull, group, owner);
        typename P::Hit mine;
        mine.v[0] = __int_as_float(0x7FC00000);  // NaN: no hit
        if (tests) p.test(ray + owner, g, slot, b, mine);
        __syncwarp();  // the result buffer's last reads
#pragma unroll
        for (int v = 0; v < kHitWords; ++v) res[32 * v + lane] = mine.v[v];
        __syncwarp();
        if (at_leaf && my_rank / kPassLanes == pass) {
          const int at = kSlots * (my_rank % kPassLanes);
          typename P::Hit h[kSlots];
#pragma unroll
          for (int v = 0; v < kHitWords; ++v) {
            const float4 q = *reinterpret_cast<const float4*>(res + 32 * v + at);
            h[0].v[v] = q.x;
            h[1].v[v] = q.y;
            h[2].v[v] = q.z;
            h[3].v[v] = q.w;
          }
#pragma unroll
          for (int j = 0; j < kSlots; ++j) p.take(r, h[j], group, j, cnt);
        }
      }
    }
    if (r.id >= 0) {
      r.ptr = nxt;
      if (r.ptr < 0 || (kAnyHit && r.pb >= 0)) {
        p.finish(r);
        r.id = -1;
      }
    }
  }
}

// blocks of a launch over n lanes: the card's resident blocks of the
// kernel, capped at a whole number of blocks an SM that gives each thread
// about kClaims lanes (and at the blocks n lanes fill); and the lane
// counter zeroed on the stream
inline cudaError_t prepare(const void* kernel, int64_t n, unsigned long long* next,
                           cudaStream_t st, unsigned* blocks) {
  int resident = 0, dev = 0, sms = 0;
  cudaError_t err = resident_blocks(kernel, WALK2_THREADS, &resident);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t per_thread = (int64_t)sms * WALK2_THREADS * kClaims;
  const int64_t per_sm = (n + per_thread - 1) / per_thread;
  const int64_t needed = (n + WALK2_THREADS - 1) / WALK2_THREADS;
  const int64_t want = per_sm * sms < needed ? per_sm * sms : needed;
  *blocks = (unsigned)(want < resident ? want : resident);
  return cudaMemsetAsync(next, 0, sizeof(unsigned long long), st);
}

}  // namespace walk2
