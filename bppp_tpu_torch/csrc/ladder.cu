// K6, K7 — lane-wise scalar multiplication [k]P, and the sum of L points per
// lane.
//
// K6 replaces bppp_tpu/ops/pallas_msm.py::_ladder_kernel (scalar_mul_flat).
// What bounds it: the series of dependent modular multiplies a lane's
// thread runs. The mirror verifier launches it on 4,096-32,768 lanes, the
// WNLA commitment on 33,792-132,096: a few warps per scheduler, each
// waiting on its own series, so the time is about (multiplies in series) x
// (latency of one) until the card is full, and the work per lane past that.
// A plain 4-bit ladder walks all 64 windows of k with complete adds: 256
// doubles and 78 adds, about 3,300 multiplies in one series. This design
// halves the doubles with the GLV endomorphism, inside the kernel:
//
//   the split: k = k1 + k2 lambda (mod n), computed per lane as
//   ops/glv.py::decompose does (glv_walk.cuh, glv_decompose: two 512-bit
//   products for the rounding, three F_n multiplies), halves below 2^132 in
//   magnitude, each with a sign;
//
//   then the walks of glv_walk.cuh at D = 1, the code K8 runs: two threads
//   per lane (glv_split), one half each over 33 windows of 4 doubles and at
//   most one incomplete add, the table [1..15] P in shared memory built by
//   the k1 thread; phi (X -> beta X) maps the k2 thread's partial, -Y a
//   negative half's, once each; the two partials join with one complete add
//   (join.cuh). About 1,700 multiplies in series. Or one thread per lane
//   (glv_lane): 33 windows of 4 doubles shared by both halves and one
//   incomplete add per half, the table in the thread's own array; about
//   2,200 multiplies in series, but a third less work per lane than the
//   split, which wins once the card is full.
//   `cuda_ladder.scalar_mul_plan` chooses from the batch, by the sweep of
//   both launches on the card in PERF.md (`tools/compare_designs.py`).
//
// Why incomplete adds are safe for any point P (of prime order n, or the
// identity) and any k, although the mirror verifier hands this kernel points
// and scalars it did not choose. A table add [j] P + P, 2 <= j <= 14, never
// meets +-P. A split thread adds [d] P, 1 <= d <= 15, to [16 p] P with
// 0 <= p < 2^132: 16 p -+ d is a nonzero integer far below n. In the lane
// walk the accumulator before an add is [a + b lambda] P, the entry
// [e1 + e2 lambda] P, and they collide only if (a -+ e1, b -+ e2) lies in
// the lattice {(x, y): x + y lambda = 0 mod n}. That vector is within 31 of
// (k1, k2) / 16^w for the window w, which lies in the box
// {t1 v1 + t2 v2 : |t_i| <= 1/2 + 2^-129} of the lattice's reduced basis
// v1, v2 that the rounding leaves (k1, k2) in. The box holds one lattice
// point, 0, and every other lies about 2^126 away; 0 itself would need a
// multiple of 16 to equal a digit 1..15. Only the join of [k1] P and
// [k2 lambda] P can meet a collision (k = 0 or k1 = +-k2 lambda), and the
// join is complete. A zero digit adds nothing; k = 0 and P = identity give
// the identity. The kernel agrees with the plain version (that 64-window
// ladder with complete adds) as a point — compressed bytes — not in
// (X, Y, Z).
//
// K7 replaces bppp_tpu/ops/pallas_msm.py::_tree_kernel (tree_sum_flat and the
// layout shuffle of tree_sum): the sum of the L points of each lane. Points
// arrive as the port's int64 limb tensors, read where they lie: limb i of
// point l of lane b of coordinate c at in[c][i * limb + l * point + b *
// lane]; the sums are written as (16, B) int64. One launch per call.
//
// One thread walking a lane's L - 1 adds in order is a series of L - 1
// dependent adds (16 at the u64 mirror's L = 17, 128 at WNLA-64's
// commitment), on B / 128 blocks. So n threads ("slots") share a lane:
// slot s sums the contiguous points [s L / n, (s + 1) L / n) in order with
// INCOMPLETE adds (pt_add_inc; an empty slot holds the identity), and the n
// partials join in shared memory by join.cuh's fixed tree of COMPLETE adds;
// slot 0 stores the lane's sum. The series falls to about L / n + log2 n
// adds. A block holds lpb lanes x n slots, slot-major (thread t = s * lpb +
// l), so the threads of a warp read the same point of adjacent lanes.
// cuda_ladder.tree_sum_plan gives (n, lpb) from the sweep on the card.
//
// Why the incomplete adds are safe. Inside a slot an add goes wrong only
// where the running sum of the slot's points equals the next point (a
// doubling: Z3 = 0 where 2P was due; the inverse case gives Z3 = 0, the
// identity, which is the sum). That is a relation sum_{lo <= i < j} P_i =
// P_j among the points the caller summed. The sequential order met one
// only in the same way (a prefix sum equal to the next point), and for the
// callers' points, multiples of distinct generators under Fiat-Shamir or
// secret scalars, any such relation is a discrete-log relation (the
// comment above pt_add_inc in field.cuh). Identity operands are handled; a
// slot whose points sum to the identity holds an identity encoding (Z = 0)
// that later adds and the join read as the identity. Partial sums that
// collide with each other — two slots holding the same point, or one the
// other's negative — meet only the join's complete adds, which handle the
// doubling and the inverse. The kernel and the plain sequential chain
// (cuda_ladder.tree_sum_plain) add in another order, so they agree as
// points (compressed bytes); cuda_ladder.tree_sum_slots_plain runs the
// kernel's order in eager PyTorch and agrees with it limb for limb.
//
// Bounds on an H100: K6 operations — per live lane 1 double and 13 adds for
// the table, 4 doubles per window below the top nonzero one of the larger
// half, one add per nonzero digit of either half, beta's multiply and the
// join, against 7 * 64 bytes moved; K7 bytes — (3 L + 3) * 128 bytes of
// int64 limbs per lane against (L - 1) adds of 16 multiplies.
#include "glv_walk.cuh"

namespace {

using namespace bppp;

constexpr int TREE_MAX_THREADS = 256;  // K7's block at most

// the split: 2 slots per lane, slot j walks GLV half j of [k] P
__global__ void __launch_bounds__(MAX_THREADS)
    scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz, const uint32_t* __restrict__ k,
                      uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                      uint32_t* __restrict__ oz, int B, int lpb) {
  extern __shared__ uint32_t sh[];
  const slot_of s(2, lpb, B);
  glv_halves h = {};
  if (s.live) h = glv_decompose(fe_load(k, B, s.lane));
  pt acc = glv_split<1>(
      sh, s, lpb, [&](int) { return pt_load(px, py, pz, B, s.lane); },
      [&](int j, fe* m, bool* neg) {
        *m = fe_select(j != 0, h.m[1], h.m[0]);
        *neg = j != 0 ? h.neg[1] : h.neg[0];
      });
  if (s.slot == 0 && s.live) pt_store(ox, oy, oz, B, s.lane, acc);
}

// one thread per lane: both halves with one accumulator
__global__ void scalar_mul_lane_kernel(const uint32_t* __restrict__ px,
                                       const uint32_t* __restrict__ py,
                                       const uint32_t* __restrict__ pz,
                                       const uint32_t* __restrict__ k, uint32_t* __restrict__ ox,
                                       uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                                       int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  const glv_halves h = glv_decompose(fe_load(k, B, lane));
  pt acc = glv_lane<1>([&](int) { return pt_load(px, py, pz, B, lane); },
                       [&](int j, fe* m, bool* neg) {
                         *m = h.m[j];
                         *neg = h.neg[j];
                       });
  pt_store(ox, oy, oz, B, lane, acc);
}

// K7's operands: three int64 coordinates with their strides, in elements
struct sum_io {
  const int64_t* in[3];                   // x, y, z of (16, L, B) points
  long long limb[3], point[3], lane[3];   // limb i of point l of lane b at i * limb + l * point + b * lane
  int64_t* out[3];                        // (16, B) contiguous
};

__device__ __forceinline__ pt load_sum_point(const sum_io& io, int l, long long lane) {
  pt r;
  fe* c[3] = {&r.x, &r.y, &r.z};
#pragma unroll
  for (int k = 0; k < 3; k++)
    *c[k] = fe_load64(io.in[k], io.limb[k], l * io.point[k] + lane * io.lane[k]);
  return r;
}

// n slots per lane, lpb lanes per block, slot-major: thread t = s * lpb + l.
// Threads past n * lpb (the block is whole warps) take slot n, which the
// join skips; every thread reaches the join's barriers.
__global__ void __launch_bounds__(TREE_MAX_THREADS)
    tree_sum_kernel(sum_io io, int L, int B, int n, int lpb) {
  extern __shared__ uint32_t sh[];
  const int t = threadIdx.x;
  const bool in_block = t < n * lpb;
  const int slot = in_block ? t / lpb : n;
  const int l = in_block ? t - slot * lpb : 0;
  const long long lane = (long long)blockIdx.x * lpb + l;
  const bool live = in_block && lane < B;
  pt acc = pt_identity();
  if (live) {
    const int lo = (int)((long long)slot * L / n), hi = (int)((long long)(slot + 1) * L / n);
    if (lo < hi) acc = load_sum_point(io, lo, lane);
#pragma unroll 1
    for (int p = lo + 1; p < hi; p++) {
      pt q = load_sum_point(io, p, lane);
      pt_add_inc(&acc, &acc, &q);
    }
  }
  join_slots(sh, &acc, slot, n, l, lpb);
  if (live && slot == 0) {
    fe_store64(io.out[0], B, lane, acc.x);
    fe_store64(io.out[1], B, lane, acc.y);
    fe_store64(io.out[2], B, lane, acc.z);
  }
}

}  // namespace

#ifdef __CUDACC__
// px, py, pz, k and the outputs: (16, B) limb words; nthr threads per lane,
// 2 (the split) or 1 (the lane walk); lpb lanes per block,
// nthr * lpb <= 128. Returns cudaGetLastError().
extern "C" int bppp_scalar_mul(const void* px, const void* py, const void* pz, const void* k,
                               void* ox, void* oy, void* oz, int B, int nthr, int lpb,
                               void* stream) {
  if (B <= 0) return 0;
  if ((nthr != 1 && nthr != 2) || lpb < 1 || nthr * lpb > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const uint32_t *x = (const uint32_t*)px, *y = (const uint32_t*)py, *z = (const uint32_t*)pz;
  const uint32_t* kk = (const uint32_t*)k;
  uint32_t *o1 = (uint32_t*)ox, *o2 = (uint32_t*)oy, *o3 = (uint32_t*)oz;
  cudaStream_t st = (cudaStream_t)stream;
  if (nthr == 1) {
    scalar_mul_lane_kernel<<<(B + lpb - 1) / lpb, lpb, 0, st>>>(x, y, z, kk, o1, o2, o3, B);
    return (int)cudaGetLastError();
  }
  return launch_split(scalar_mul_kernel, glv_split_words(1, lpb), B, nthr, lpb, st, x, y, z, kk,
                      o1, o2, o3);
}
#endif

#ifdef __CUDACC__
// ins: x, y, z int64 limbs; strides: (limb, point, lane) stride of each, in
// elements; outs: three (16, B) contiguous int64. n slots per lane (past
// L they hold the identity), lpb lanes per block, n * lpb <=
// TREE_MAX_THREADS. Returns cudaGetLastError().
extern "C" int bppp_tree_sum(const void* const* ins, const long long* strides, void* const* outs,
                             int L, int B, int n, int lpb, void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || n < 1 || lpb < 1 || n * lpb > TREE_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  sum_io io;
  for (int k = 0; k < 3; k++) {
    io.in[k] = (const int64_t*)ins[k];
    io.limb[k] = strides[3 * k];
    io.point[k] = strides[3 * k + 1];
    io.lane[k] = strides[3 * k + 2];
    io.out[k] = (int64_t*)outs[k];
  }
  const size_t smem = (size_t)join_words(n, lpb) * sizeof(uint32_t);
  tree_sum_kernel<<<(B + lpb - 1) / lpb, (n * lpb + 31) / 32 * 32, smem, (cudaStream_t)stream>>>(
      io, L, B, n, lpb);
  return (int)cudaGetLastError();
}
#endif
