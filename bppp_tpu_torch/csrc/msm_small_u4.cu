// K9, K8 — shared-window MSMs over D per-proof points with UNSIGNED 4-bit
// digits: the plain 64-window walk, and its GLV variant over 33 windows.
//
// K9 replaces bppp_tpu/ops/pallas_msm.py::_msm_small_kernel (msm_small_flat),
// the small MSM under BPPP_GLV=0. Inputs: D Jacobian points per lane,
// coordinates (D, 16, B); D scalars per lane, canonical F_n limbs (D, 16, B).
// One thread owns one lane. Per point it builds the table [0..15] P_i in
// local memory in the reference's order: entry 0 the identity, 1 the point,
// 2 a true double (kept as the point on identity lanes), 3..15 incomplete
// adds [d-1]P + P (2 <= d-1 <= 14 cannot collide on a prime-order curve).
// Then it walks the 64 windows MSB-first: 4 doubles, and per point one
// INCOMPLETE add of the entry its digit selects; digit 0 selects the
// identity, which the add leaves inert. The digits are peeled from the
// scalars' words in registers as in K6: the loop over the eight words is
// unrolled, the loop over a word's nibbles is not.
//
// K8 replaces bppp_tpu/ops/pallas_msm.py::_msm_small_glv_kernel
// (msm_small_glv_flat), the small MSM under BPPP_WNAF=0 with GLV on. Inputs:
// the same points; 2D GLV magnitude halves (2D, 16, B), index j = 2i + half
// (the halves of point i interleaved, k1 then k2), each below 2^132; and 2D
// negate masks (2D, B), nonzero where half j is negative. The tables are the
// same 16-entry tables, one per point. The walk takes 33 windows MSB-first:
// 4 doubles, then per half j the entry tab_{j/2}[digit], with x times beta
// for the odd (endomorphism) halves, phi(P) = (beta x, y) = [lambda] P, and y
// negated where the lane's mask for j is set; then an incomplete add.
//
// The digits of one window for all points (K9: D, K8: 2D <= 6) ride packed in
// one 32-bit word, four bits each, and the negate masks in another, so the
// per-window body takes no array and indexes no register dynamically.
//
// D is a template parameter, 1..3: a 16-entry table is 16 * 96 = 1.5 KB of
// local memory per point, 4.6 KB per thread at D = 3 (K4's 8-entry tables
// allow D = 5 in 3.8 KB). The reference caps its full-tile calls of both
// kernels at 3 points too (pallas_msm.py FT_DMAX); the caller chunks larger
// MSMs and joins the chunks with a complete add.
//
// Bounds on an H100: operations. Per lane K9 does 256 doubles (7 modular
// multiplies each), 64 D adds (16 each) and 14 D table operations (one double
// and 13 adds per point); K8 132 doubles, 66 D adds, the same 14 D table
// operations and one beta multiply per live odd-half digit. Zero digits add
// nothing in the bound's count. Bytes moved per lane: K9 (4 D + 3) * 64,
// K8 (5 D + 3) * 64 + 8 D.
#include "field.cuh"

namespace {

using namespace bppp;

constexpr int GLV_WINDOWS = 33;
constexpr int TAB = 16;

// tab[0..15] = [d] P, the reference's build order
__device__ __forceinline__ void build_table(pt* tab, const pt& P) {
  tab[0] = pt_identity();
  tab[1] = P;
  pt d;
  pt_dbl(&d, &P);
  tab[2] = pt_select(fe_is_zero(P.z), P, d);
#pragma unroll 1
  for (int e = 3; e < TAB; e++) pt_add_inc(&tab[e], &tab[e - 1], &P);
}

// One window of K9: 4 doubles, then per point the entry of its digit
// (digit of point i in bits 4i..4i+3 of digs).
template <int D>
__device__ __noinline__ void window_plain(pt* acc, const pt* tab, uint32_t digs) {
#pragma unroll 1
  for (int s = 0; s < 4; s++) pt_dbl(acc, acc);
#pragma unroll
  for (int i = 0; i < D; i++) pt_add_inc(acc, acc, &tab[i * TAB + ((digs >> (4 * i)) & 15u)]);
}

// One window of K8: 4 doubles, then per half j the entry of point j / 2 at
// its digit (bits 4j..4j+3 of digs), beta x for odd j, -y where bit j of neg
// is set.
template <int D>
__device__ __noinline__ void window_glv(pt* acc, const pt* tab, uint32_t digs, uint32_t neg) {
#pragma unroll 1
  for (int s = 0; s < 4; s++) pt_dbl(acc, acc);
  const fe beta = fe_const(BETA_WORDS);
#pragma unroll
  for (int j = 0; j < 2 * D; j++) {
    pt q = tab[(j >> 1) * TAB + ((digs >> (4 * j)) & 15u)];
    if (j & 1) q.x = mul_p(q.x, beta);
    if ((neg >> j) & 1u) q.y = fe_neg<true>(q.y);
    pt_add_inc(acc, acc, &q);
  }
}

template <int D>
__global__ void msm_small_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                 const uint32_t* __restrict__ pz, const uint32_t* __restrict__ k,
                                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                 uint32_t* __restrict__ oz, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  pt tab[D * TAB];
  fe kk[D];
#pragma unroll
  for (int i = 0; i < D; i++) {
    size_t off = (size_t)i * 16 * B;
    build_table(&tab[i * TAB], pt_load(px + off, py + off, pz + off, B, lane));
    kk[i] = fe_load(k + off, B, lane);
  }
  pt acc = pt_identity();
#pragma unroll
  for (int word = 7; word >= 0; word--) {
    uint32_t bits[D];
#pragma unroll
    for (int i = 0; i < D; i++) bits[i] = kk[i].v[word];
#pragma unroll 1
    for (int nib = 0; nib < 8; nib++) {
      uint32_t digs = 0;
#pragma unroll
      for (int i = 0; i < D; i++) {
        digs |= (bits[i] >> 28) << (4 * i);
        bits[i] <<= 4;
      }
      window_plain<D>(&acc, tab, digs);
    }
  }
  pt_store(ox, oy, oz, B, lane, acc);
}

template <int D>
__global__ void msm_small_glv_kernel(const uint32_t* __restrict__ px,
                                     const uint32_t* __restrict__ py,
                                     const uint32_t* __restrict__ pz,
                                     const uint32_t* __restrict__ mags,
                                     const uint32_t* __restrict__ signs, uint32_t* __restrict__ ox,
                                     uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  pt tab[D * TAB];
#pragma unroll
  for (int i = 0; i < D; i++) {
    size_t off = (size_t)i * 16 * B;
    build_table(&tab[i * TAB], pt_load(px + off, py + off, pz + off, B, lane));
  }
  // the 33 windows cover bits 0..131 of each half: words 0..3 and the low
  // nibble of word 4
  fe m[2 * D];
  uint32_t neg = 0;
#pragma unroll
  for (int j = 0; j < 2 * D; j++) {
    m[j] = fe_load(mags + (size_t)j * 16 * B, B, lane);
    neg |= (signs[(size_t)j * B + lane] != 0u ? 1u : 0u) << j;
  }
  pt acc = pt_identity();
  uint32_t digs = 0;
#pragma unroll
  for (int j = 0; j < 2 * D; j++) digs |= (m[j].v[4] & 15u) << (4 * j);
  window_glv<D>(&acc, tab, digs, neg);  // window 32
#pragma unroll
  for (int word = 3; word >= 0; word--) {
    uint32_t bits[2 * D];
#pragma unroll
    for (int j = 0; j < 2 * D; j++) bits[j] = m[j].v[word];
#pragma unroll 1
    for (int nib = 0; nib < 8; nib++) {
      digs = 0;
#pragma unroll
      for (int j = 0; j < 2 * D; j++) {
        digs |= (bits[j] >> 28) << (4 * j);
        bits[j] <<= 4;
      }
      window_glv<D>(&acc, tab, digs, neg);
    }
  }
  pt_store(ox, oy, oz, B, lane, acc);
}

static_assert(GLV_WINDOWS == 1 + 4 * 8, "K8 walks the low nibble of word 4, then words 3..0");

}  // namespace

#ifdef __CUDACC__
#define BPPP_LAUNCH_PLAIN(DD)                                                                  \
  case DD:                                                                                     \
    msm_small_kernel<DD><<<grid, block, 0, (cudaStream_t)stream>>>(                            \
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)k,     \
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, B);                                       \
    break;

// px, py, pz, k: (D, 16, B) limb words; outputs (16, B). D in [1, 3].
// Returns cudaGetLastError().
extern "C" int bppp_msm_small(const void* px, const void* py, const void* pz, const void* k,
                              void* ox, void* oy, void* oz, int D, int B, void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + 63) / 64), block(64);
  switch (D) {
    BPPP_LAUNCH_PLAIN(1)
    BPPP_LAUNCH_PLAIN(2)
    BPPP_LAUNCH_PLAIN(3)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#define BPPP_LAUNCH_GLV(DD)                                                                    \
  case DD:                                                                                     \
    msm_small_glv_kernel<DD><<<grid, block, 0, (cudaStream_t)stream>>>(                        \
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)mags,  \
        (const uint32_t*)signs, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, B);               \
    break;

// px, py, pz: (D, 16, B) limb words; mags: (2D, 16, B) limb words; signs:
// (2D, B) words; outputs (16, B). D in [1, 3]. Returns cudaGetLastError().
extern "C" int bppp_msm_small_glv(const void* px, const void* py, const void* pz, const void* mags,
                                  const void* signs, void* ox, void* oy, void* oz, int D, int B,
                                  void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + 63) / 64), block(64);
  switch (D) {
    BPPP_LAUNCH_GLV(1)
    BPPP_LAUNCH_GLV(2)
    BPPP_LAUNCH_GLV(3)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif
