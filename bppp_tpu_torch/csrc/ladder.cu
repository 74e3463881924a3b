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
// layout shuffle of tree_sum). Points arrive as (16, L, B): limb i of point l
// of lane b at ptr[(i * L + l) * B + b]. One thread owns one lane, reads its
// L points straight from that layout (adjacent threads read adjacent lanes,
// so every load coalesces) and accumulates them in order with L - 1
// INCOMPLETE adds: identity operands are handled, a collision P == +-Q
// degrades to the identity encoding. The plain version chains the same
// incomplete add in the same order, so the limbs agree.
//
// Bounds on an H100: K6 operations — per live lane 1 double and 13 adds for
// the table, 4 doubles per window below the top nonzero one of the larger
// half, one add per nonzero digit of either half, beta's multiply and the
// join, against 7 * 64 bytes moved; K7 bytes for short sums —
// (3 L + 3) * 64 bytes per lane against (L - 1) * 16 multiplies.
#include "glv_walk.cuh"

namespace {

using namespace bppp;

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

__global__ void tree_sum_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                                uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int L, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  const size_t stride = (size_t)L * B;
  pt acc = pt_load(px, py, pz, stride, lane);
#pragma unroll 1
  for (int l = 1; l < L; l++) {
    size_t off = (size_t)l * B;
    pt q = pt_load(px + off, py + off, pz + off, stride, lane);
    pt_add_inc(&acc, &acc, &q);
  }
  pt_store(ox, oy, oz, B, lane, acc);
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
// px, py, pz: (16, L, B) limb words, L >= 1; outputs (16, B). Returns
// cudaGetLastError().
extern "C" int bppp_tree_sum(const void* px, const void* py, const void* pz, void* ox, void* oy,
                             void* oz, int L, int B, void* stream) {
  if (B <= 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  tree_sum_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, L, B);
  return (int)cudaGetLastError();
}
#endif
