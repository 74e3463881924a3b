// K4 — GLV + signed-window shared-walk MSM over D per-proof points.
//
// Replaces bppp_tpu/ops/pallas_msm.py::_msm_small_wnaf_kernel
// (msm_small_wnaf_flat). Inputs: D Jacobian points per lane, coordinates
// (D, 16, B); 2D GLV half-scalars per lane as packed signed 4-bit digit
// planes (33 * 2D, B), plane index w * 2D + j with window 0 the least
// significant and the halves interleaved k1, k2 per point; a plane packs
// |digit| (0..8) in its low 4 bits and the final negate bit in bit 4.
//
// The 2D halves of a lane are independent walks over the same 33 windows, so
// a lane has 2D threads ("slots"), slot j walking half j: per window 4
// doubles and at most one incomplete add. An odd j multiplies the selected x
// by beta (phi(P) = (beta x, y) = [lambda] P), a set negate bit negates y,
// magnitude 0 selects nothing. A walk of one half cannot meet a collision:
// its accumulator is [16 p] P with 0 < |p| < 2^132 against an entry [d] P
// with |d| <= 8. The 2D slots of a lane are then joined with complete adds
// in shared memory (join.cuh). A thread does 132 doubles and 33 adds where
// one thread per lane did 132 doubles and 66 D adds: the series shrinks from
// about 6,800 modular multiplies to about 1,500 at D = 5, paid for with
// doubles on SMs that one thread per lane left idle.
//
// The tables [1..8] P_i (entry 2 a true double, 3..8 incomplete adds: [k]P +
// P with 2 <= k <= 7 cannot collide on a prime-order curve) live in shared
// memory, one per point and lane, built by slot i for point i and read by
// both halves' slots. A block is `lpb` lanes x 2D slots, thread t owning
// lane t / 2D, slot t mod 2D, padded to whole warps.
//
// Where the batch fills the card the split loses: its extra doubles cost more
// than its shorter series saves, and 768 bytes of shared table per point and
// lane cap the lanes an SM holds. Above `cuda_msm.K4_LANE_WALK_ABOVE` lanes
// the wrapper asks for one thread per lane (nthr = 1) and
// msm_small_wnaf_lane_kernel runs: one thread walks all 2D halves of
// its lane with its tables in its own array (local memory, cached), the
// accumulator in registers, no join. `cuda_msm.msm_small_wnaf_plan` chooses;
// PERF.md has the sweep behind it (`tools/compare_designs.py`).
// Bound on an H100: operations. Per lane 132 doubles (7 multiplies each),
// 66 D adds (16 each) and 7 D table adds, against (3 D + 3) * 64 + 66 D * 4
// bytes moved.
#include "join.cuh"

namespace {

using namespace bppp;

constexpr int GLV_WINDOWS = 33;
constexpr int MAX_THREADS = 128;

// words of shared memory for the tables and the join of one block
__host__ __device__ constexpr int smem_words(int D, int lpb) {
  return D * 8 * 24 * lpb + join_words(2 * D, lpb);
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
    msm_small_wnaf_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                          const uint32_t* __restrict__ pz, const uint32_t* __restrict__ dig,
                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                          uint32_t* __restrict__ oz, int B, int lpb) {
  constexpr int NTHR = 2 * D;
  extern __shared__ uint32_t sh[];
  const int t = threadIdx.x;
  const bool in_block = t < NTHR * lpb;
  const int l = in_block ? t / NTHR : 0;
  const int slot = in_block ? t - l * NTHR : NTHR;  // padding: a slot the join skips
  const size_t lane = (size_t)blockIdx.x * lpb + l;
  const bool live = in_block && lane < (size_t)B;
  // word k of entry e of point i of lane l at sh[((i * 8 + e) * 24 + k) * lpb + l]
  if (live && slot < D) {
    size_t off = (size_t)slot * 16 * B;
    pt P = pt_load(px + off, py + off, pz + off, B, lane);
    uint32_t* ent = sh + slot * 8 * 24 * lpb + l;
    sh_store_pt(ent, lpb, P);
    pt e;
    pt_dbl(&e, &P);
    e = pt_select(fe_is_zero(P.z), P, e);
    sh_store_pt(ent + 24 * lpb, lpb, e);
#pragma unroll 1
    for (int k = 2; k < 8; k++) {
      pt_add_inc(&e, &e, &P);
      sh_store_pt(ent + k * 24 * lpb, lpb, e);
    }
  }
  __syncthreads();
  const fe beta = fe_const(BETA_WORDS);
  pt acc = pt_identity();
  if (live) {
    const uint32_t* ent = sh + (slot >> 1) * 8 * 24 * lpb + l;
#pragma unroll 1
    for (int w = GLV_WINDOWS - 1; w >= 0; w--) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) pt_dbl(&acc, &acc);
      uint32_t plane = dig[((size_t)w * NTHR + slot) * B + lane];
      uint32_t mag = plane & 15u;
      if (mag > 8u) mag = 8u;
      if (mag == 0) continue;
      pt q = sh_load_pt(ent + ((int)mag - 1) * 24 * lpb, lpb);
      if (slot & 1) q.x = mul_p(q.x, beta);
      if ((plane >> 4) != 0) q.y = fe_neg<true>(q.y);
      pt_add_inc(&acc, &acc, &q);
    }
  }
  join_slots(sh + D * 8 * 24 * lpb, &acc, slot, NTHR, l, lpb);
  if (slot == 0 && live) pt_store(ox, oy, oz, B, lane, acc);
}

// One thread per lane: its own tables, all 2D halves in one walk.
template <int D>
__global__ void msm_small_wnaf_lane_kernel(const uint32_t* __restrict__ px,
                                           const uint32_t* __restrict__ py,
                                           const uint32_t* __restrict__ pz,
                                           const uint32_t* __restrict__ dig,
                                           uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                           uint32_t* __restrict__ oz, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  pt tab[D * 8];
#pragma unroll 1
  for (int i = 0; i < D; i++) {
    size_t off = (size_t)i * 16 * B;
    pt P = pt_load(px + off, py + off, pz + off, B, lane);
    tab[i * 8] = P;
    pt d;
    pt_dbl(&d, &P);
    tab[i * 8 + 1] = pt_select(fe_is_zero(P.z), P, d);
#pragma unroll 1
    for (int e = 2; e < 8; e++) pt_add_inc(&tab[i * 8 + e], &tab[i * 8 + e - 1], &P);
  }
  const fe beta = fe_const(BETA_WORDS);
  pt acc = pt_identity();
#pragma unroll 1
  for (int w = GLV_WINDOWS - 1; w >= 0; w--) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) pt_dbl(&acc, &acc);
#pragma unroll 1
    for (int j = 0; j < 2 * D; j++) {
      uint32_t plane = dig[((size_t)w * 2 * D + j) * B + lane];
      uint32_t mag = plane & 15u;
      if (mag > 8u) mag = 8u;
      bool neg = (plane >> 4) != 0;
      pt q;
      if (mag == 0) {
        q.x = fe_zero();
        q.y = fe_zero();
        q.z = fe_zero();
      } else {
        q = tab[(j >> 1) * 8 + (int)mag - 1];
      }
      if (j & 1) q.x = mul_p(q.x, beta);
      if (neg) q.y = fe_neg<true>(q.y);
      pt_add_inc(&acc, &acc, &q);
    }
  }
  pt_store(ox, oy, oz, B, lane, acc);
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <int D>
int launch(const void* px, const void* py, const void* pz, const void* dig, void* ox, void* oy,
           void* oz, int B, int nthr, int lpb, cudaStream_t st) {
  if ((nthr != 1 && nthr != 2 * D) || lpb < 1 || nthr * lpb > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int threads = (nthr * lpb + 31) / 32 * 32;
  const int blocks = (B + lpb - 1) / lpb;
  if (nthr == 1) {
    msm_small_wnaf_lane_kernel<D><<<blocks, threads, 0, st>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)dig,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, B);
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)smem_words(D, lpb) * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(msm_small_wnaf_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  msm_small_wnaf_kernel<D><<<blocks, threads, bytes, st>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)dig,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, B, lpb);
  return (int)cudaGetLastError();
}

}  // namespace

// px, py, pz: (D, 16, B) limb words; dig: (33 * 2D, B) packed planes;
// outputs (16, B). D in [1, 5]; nthr threads per lane, 2D (one GLV half
// each) or 1 (the lane walk); lpb lanes per block, nthr * lpb <= 128.
// Returns cudaGetLastError().
extern "C" int bppp_msm_small_wnaf(const void* px, const void* py, const void* pz, const void* dig,
                                   void* ox, void* oy, void* oz, int D, int B, int nthr, int lpb,
                                   void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 1: return launch<1>(px, py, pz, dig, ox, oy, oz, B, nthr, lpb, st);
    case 2: return launch<2>(px, py, pz, dig, ox, oy, oz, B, nthr, lpb, st);
    case 3: return launch<3>(px, py, pz, dig, ox, oy, oz, B, nthr, lpb, st);
    case 4: return launch<4>(px, py, pz, dig, ox, oy, oz, B, nthr, lpb, st);
    case 5: return launch<5>(px, py, pz, dig, ox, oy, oz, B, nthr, lpb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
