// K9, K8 — shared-window MSMs over D per-proof points with UNSIGNED 4-bit
// digits: the plain 64-window walk, and its GLV variant over 33 windows.
//
// K9 replaces bppp_tpu/ops/pallas_msm.py::_msm_small_kernel (msm_small_flat),
// the small MSM under BPPP_GLV=0. Inputs: D Jacobian points per lane,
// coordinates (D, 16, B); D scalars per lane, canonical F_n limbs (D, 16, B).
// K8 replaces bppp_tpu/ops/pallas_msm.py::_msm_small_glv_kernel
// (msm_small_glv_flat), the small MSM under BPPP_WNAF=0 with GLV on. Inputs:
// the same points; 2D GLV magnitude halves (2D, 16, B), index j = 2i + half
// (the halves of point i interleaved, k1 then k2), each below 2^132; and 2D
// negate masks (2D, B), nonzero where half j is negative.
//
// What bounds them: at the paths' 1024 lanes, the series of dependent modular
// multiplies one thread runs (about 1 us each with one warp per scheduler),
// not the card's integer rate: one thread per lane left 116 of 132 SMs idle
// and ran 5,500 (K9) or 4,700 (K8) multiplies in series at D = 3. So a lane
// gets several threads ("slots"), each walking one independent part of the
// lane's sum, joined at the end with complete adds in shared memory
// (join.cuh):
//
//   K8, 2D slots: slot j walks half j of point j / 2 over the 33 windows
//   (the low nibble of word 4, then words 3..0), 4 doubles and at most one
//   incomplete add per window, over the plain table of its point. phi and
//   the sign are homomorphisms, so they apply once to the slot's partial
//   instead of once per entry: an odd slot multiplies its X by beta
//   (phi(X:Y:Z) = (beta X : Y : Z) = [lambda] (X:Y:Z)), a slot whose half is
//   negative negates its Y. About 1,700 multiplies in series at any D.
//
//   K9, D slots: slot i walks the 64 windows of point i's full scalar, 4
//   doubles and at most one incomplete add each. About 3,000 multiplies in
//   series: the 252 doubles of a full scalar are a chain no split removes
//   (K9 is the no-GLV path by definition), so K9 gains less than K8.
//
// A walk of one slot cannot collide: its accumulator is [16 p] P with
// 0 <= p < 2^132 (K8) or < 2^252 (K9), against an entry [d] P, 1 <= d <= 15,
// and p = 0 leaves the identity, which the add passes through. The tables
// are built in the reference's order: entry 2 a true double (kept as the
// point on identity lanes), 3..15 incomplete adds [d-1]P + P (2 <= d-1 <= 14
// cannot collide on a prime-order curve); a zero digit adds nothing. K8's
// tables [1..15] P_i live in shared memory, one per point and lane, built by
// slot 2i and read by both halves' slots. K9's slot i alone reads point i's
// table, so it keeps [0..15] P_i in its own array (local memory, cached):
// against a shared-memory table it measured 2-5 % faster at 1024 lanes
// (PERF.md), and its block needs shared memory only for the join. A block is
// `lpb` lanes x nthr slots, thread t owning lane t / nthr, slot t mod nthr;
// padding threads carry a slot the join skips, so every thread meets every
// barrier.
//
// Where the batch fills the card K8's split loses: its 2D x 128 doubles
// per lane, where one thread per lane does 128, cost more than its shorter
// series saves, and 1,440 bytes of shared table per point and lane cap the
// lanes an SM holds. Above `cuda_msm.K8_SPLIT_THREADS` threads per launch
// the wrapper asks for one thread per lane (nthr = 1) and
// msm_small_glv_lane_kernel runs: one thread walks all 2D halves of its lane
// with one accumulator, its tables [0..15] P_i in its own array, phi and the
// sign applied per entry. K9's split, with no shared table, beat one thread
// per lane at every batch swept (up to 16384 lanes), so it has no other
// launch. `cuda_msm.msm_small_glv_plan` / `msm_small_plan` choose; PERF.md
// has the sweep behind them (`tools/compare_designs.py`). The table builds,
// the walk and the bodies of K8's two launches (glv_split, glv_lane) live in
// glv_walk.cuh, which K6 (ladder.cu) shares at D = 1.
//
// D is a template parameter, 1..3, as in the reference (pallas_msm.py
// FT_DMAX): a lane's 16-entry tables take 1,440 bytes of shared memory per
// point in K8 (K4's 8-entry tables 768), so three points of 21 lanes and
// their join fill 97 KB of a block, and 1,536 bytes of local memory per K9
// thread; the caller chunks larger MSMs and joins the chunks with a complete
// add.
//
// Bound on an H100: operations. Per lane K9 does 252 doubles (7 modular
// multiplies each), one add (16) per nonzero digit of its 64 D, and 14 D
// table operations (one double and 13 adds per point); K8 128 doubles, one
// add per nonzero digit of its 66 D, the same table operations and one beta
// multiply per odd half. Bytes moved per lane: K9 (4 D + 3) * 64, K8
// (5 D + 3) * 64 + 8 D.
#include "glv_walk.cuh"

namespace {

using namespace bppp;

// K9 split: D slots per lane, slot i walks point i over its own table.
template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
    msm_small_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                     const uint32_t* __restrict__ pz, const uint32_t* __restrict__ k,
                     uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                     uint32_t* __restrict__ oz, int B, int lpb) {
  extern __shared__ uint32_t sh[];
  const slot_of s(D, lpb, B);
  pt acc = pt_identity();
  if (s.live) {
    const size_t off = (size_t)s.slot * 16 * B;
    pt tab[TAB];
    build_table(tab, pt_load(px + off, py + off, pz + off, B, s.lane));
    acc = walk<8, false>(fe_load(k + off, B, s.lane), [&](uint32_t d) { return tab[d]; });
  }
  join_slots(sh, &acc, s.slot, D, s.l, lpb);
  if (s.slot == 0 && s.live) pt_store(ox, oy, oz, B, s.lane, acc);
}

// K8 split: 2D slots per lane, slot j walks GLV half j of point j / 2.
template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
    msm_small_glv_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                         const uint32_t* __restrict__ pz, const uint32_t* __restrict__ mags,
                         const uint32_t* __restrict__ signs, uint32_t* __restrict__ ox,
                         uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int B, int lpb) {
  extern __shared__ uint32_t sh[];
  const slot_of s(2 * D, lpb, B);
  pt acc = glv_split<D>(
      sh, s, lpb,
      [&](int i) {
        const size_t off = (size_t)i * 16 * B;
        return pt_load(px + off, py + off, pz + off, B, s.lane);
      },
      [&](int j, fe* m, bool* neg) {
        *m = fe_load(mags + (size_t)j * 16 * B, B, s.lane);
        *neg = signs[(size_t)j * B + s.lane] != 0u;
      });
  if (s.slot == 0 && s.live) pt_store(ox, oy, oz, B, s.lane, acc);
}

// K8, one thread per lane: all 2D halves with one accumulator.
template <int D>
__global__ void msm_small_glv_lane_kernel(const uint32_t* __restrict__ px,
                                          const uint32_t* __restrict__ py,
                                          const uint32_t* __restrict__ pz,
                                          const uint32_t* __restrict__ mags,
                                          const uint32_t* __restrict__ signs,
                                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                          uint32_t* __restrict__ oz, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  pt acc = glv_lane<D>(
      [&](int i) {
        const size_t off = (size_t)i * 16 * B;
        return pt_load(px + off, py + off, pz + off, B, lane);
      },
      [&](int j, fe* m, bool* neg) {
        *m = fe_load(mags + (size_t)j * 16 * B, B, lane);
        *neg = signs[(size_t)j * B + lane] != 0u;
      });
  pt_store(ox, oy, oz, B, lane, acc);
}

}  // namespace

#ifdef __CUDACC__
namespace {

// K9: nthr = D threads per lane, lpb lanes per block, D * lpb <= MAX_THREADS.
template <int D>
int launch_plain(const void* px, const void* py, const void* pz, const void* k, void* ox,
                 void* oy, void* oz, int B, int nthr, int lpb, cudaStream_t st) {
  if (nthr != D || lpb < 1 || D * lpb > MAX_THREADS) return (int)cudaErrorInvalidValue;
  return launch_split(msm_small_kernel<D>, join_words(D, lpb), B, nthr, lpb, st,
                      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz,
                      (const uint32_t*)k, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
}

// K8: nthr threads per lane, 2D (the split) or 1 (the lane walk); lpb lanes
// per block, nthr * lpb <= MAX_THREADS.
template <int D>
int launch_glv(const void* px, const void* py, const void* pz, const void* mags,
               const void* signs, void* ox, void* oy, void* oz, int B, int nthr, int lpb,
               cudaStream_t st) {
  if ((nthr != 1 && nthr != 2 * D) || lpb < 1 || nthr * lpb > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const uint32_t *x = (const uint32_t*)px, *y = (const uint32_t*)py, *z = (const uint32_t*)pz;
  const uint32_t *m = (const uint32_t*)mags, *sg = (const uint32_t*)signs;
  uint32_t *o1 = (uint32_t*)ox, *o2 = (uint32_t*)oy, *o3 = (uint32_t*)oz;
  if (nthr == 1) {
    msm_small_glv_lane_kernel<D><<<(B + lpb - 1) / lpb, lpb, 0, st>>>(x, y, z, m, sg, o1, o2, o3,
                                                                      B);
    return (int)cudaGetLastError();
  }
  return launch_split(msm_small_glv_kernel<D>, glv_split_words(D, lpb), B, nthr, lpb, st, x, y, z,
                      m, sg, o1, o2, o3);
}

}  // namespace

// K9. px, py, pz, k: (D, 16, B) limb words; outputs (16, B). D in [1, 3];
// nthr = D threads per lane (one point each); lpb lanes per block,
// nthr * lpb <= 128. Returns cudaGetLastError().
extern "C" int bppp_msm_small(const void* px, const void* py, const void* pz, const void* k,
                              void* ox, void* oy, void* oz, int D, int B, int nthr, int lpb,
                              void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 1: return launch_plain<1>(px, py, pz, k, ox, oy, oz, B, nthr, lpb, st);
    case 2: return launch_plain<2>(px, py, pz, k, ox, oy, oz, B, nthr, lpb, st);
    case 3: return launch_plain<3>(px, py, pz, k, ox, oy, oz, B, nthr, lpb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8. px, py, pz: (D, 16, B) limb words; mags: (2D, 16, B) limb words;
// signs: (2D, B) words; outputs (16, B). D in [1, 3]; nthr threads per lane,
// 2D (one GLV half each) or 1 (the lane walk); lpb lanes per block,
// nthr * lpb <= 128. Returns cudaGetLastError().
extern "C" int bppp_msm_small_glv(const void* px, const void* py, const void* pz, const void* mags,
                                  const void* signs, void* ox, void* oy, void* oz, int D, int B,
                                  int nthr, int lpb, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 1: return launch_glv<1>(px, py, pz, mags, signs, ox, oy, oz, B, nthr, lpb, st);
    case 2: return launch_glv<2>(px, py, pz, mags, signs, ox, oy, oz, B, nthr, lpb, st);
    case 3: return launch_glv<3>(px, py, pz, mags, signs, ox, oy, oz, B, nthr, lpb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
