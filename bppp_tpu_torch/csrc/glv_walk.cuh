// The GLV walks shared by K8 (csrc/msm_small_u4.cu) and K6 (csrc/ladder.cu),
// and the in-kernel GLV split of a scalar that K6 feeds them.
//
// A GLV half is an unsigned magnitude below 2^132 and a sign; half 2i + 1
// stands for the scalar of phi(P_i) = (beta x, y) = [lambda] P_i. Both
// kernels walk the halves over the plain tables [d] P_i in 33 four-bit
// windows, MSB first: the low nibble of word 4, then words 3..0. Two
// launches:
//
//   glv_split, 2D slots per lane: slot j walks half j of point j / 2 alone,
//   4 doubles and at most one incomplete add per window, over the table
//   [1..15] P_i in shared memory that slot 2i builds; phi (X -> beta X) for
//   an odd slot and -Y for a negative half are homomorphisms, so they map
//   the slot's partial once; the 2D partials join with complete adds
//   (join.cuh).
//
//   glv_lane, one thread per lane: one accumulator, 4 doubles per window
//   shared by all 2D halves, then one incomplete add per half of the entry
//   at its digit, beta and the sign applied to the entry; the tables
//   [0..15] P_i in the thread's own array.
//
// The tables are built in the reference's order: entry 2 a true double
// (kept as the point on identity lanes), 3..15 incomplete adds [d-1]P + P,
// which cannot collide for 2 <= d-1 <= 14 on a curve of prime order n.
// In a split slot the accumulator is [16 p] P with 0 <= p < 2^132 against an
// entry [d] P, 1 <= d <= 15: never equal or opposite. p = 0 leaves the
// identity, which the add passes through.
#pragma once

#include "join.cuh"

namespace bppp {

constexpr int GLV_WINDOWS = 33;
constexpr int TAB = 16;  // tables [0..15] P_i in a thread's own array
constexpr int ENT = 15;  // shared tables [1..15] P_i
constexpr int MAX_THREADS = 128;

static_assert(GLV_WINDOWS == 1 + 4 * 8, "the walk reads the low nibble of word 4, then words 3..0");

// words of shared memory of one block of a GLV split over D points: the
// lanes' tables and the join of 2D slots
__host__ __device__ constexpr int glv_split_words(int D, int lpb) {
  return D * ENT * 24 * lpb + join_words(2 * D, lpb);
}

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

// [1..15] P into shared memory, word k of entry e at ent[((e - 1) * 24 + k) * lpb]
__device__ __forceinline__ void build_table_sh(uint32_t* ent, int lpb, const pt& P) {
  sh_store_pt(ent, lpb, P);
  pt e;
  pt_dbl(&e, &P);
  e = pt_select(fe_is_zero(P.z), P, e);
  sh_store_pt(ent + 24 * lpb, lpb, e);
#pragma unroll 1
  for (int d = 3; d <= ENT; d++) {
    pt_add_inc(&e, &e, &P);
    sh_store_pt(ent + (d - 1) * 24 * lpb, lpb, e);
  }
}

// [k] P by the 4-bit windows of k, MSB first: the low nibble of word NW if
// LEAD, then words NW - 1 .. 0; 4 doubles per window (none before the
// first), then entry(d) = [d] P added for a nonzero digit d.
template <int NW, bool LEAD, typename Entry>
__device__ __forceinline__ pt walk(const fe& k, Entry entry) {
  pt acc = pt_identity();
  auto add = [&](uint32_t d) {
    if (d == 0) return;
    pt q = entry(d);
    pt_add_inc(&acc, &acc, &q);
  };
  if (LEAD) add(k.v[NW] & 15u);
#pragma unroll
  for (int word = NW - 1; word >= 0; word--) {
    uint32_t bits = k.v[word];
#pragma unroll 1
    for (int nib = 0; nib < 8; nib++) {
      if (LEAD || word != NW - 1 || nib != 0) {
#pragma unroll 1
        for (int s = 0; s < 4; s++) pt_dbl(&acc, &acc);
      }
      add(bits >> 28);
      bits <<= 4;
    }
  }
  return acc;
}

// The lane and slot of thread t of a block of lpb lanes x nthr slots;
// padding threads get slot nthr, which the join skips.
struct slot_of {
  int l, slot;
  size_t lane;
  bool live;
  __device__ slot_of(int nthr, int lpb, int B) {
    const int t = threadIdx.x;
    const bool in_block = t < nthr * lpb;
    l = in_block ? t / nthr : 0;
    slot = in_block ? t - l * nthr : nthr;
    lane = (size_t)blockIdx.x * lpb + l;
    live = in_block && lane < (size_t)B;
  }
};

// The split's sum for thread s of a block: point(i) loads point i of the
// thread's lane, half(j, &m, &neg) gives GLV half j. Every thread of the
// block must call it (it synchronises the block); afterwards slot 0 holds
// the lane's sum. sh: glv_split_words(D, lpb) words.
template <int D, typename Point, typename Half>
__device__ __forceinline__ pt glv_split(uint32_t* sh, const slot_of& s, int lpb, Point point,
                                        Half half) {
  const int i = s.slot >> 1;
  // entry e of point i of lane l at sh + (i * ENT + e - 1) * 24 * lpb + l
  uint32_t* ent = sh + i * ENT * 24 * lpb + s.l;
  if (s.live && (s.slot & 1) == 0) build_table_sh(ent, lpb, point(i));
  __syncthreads();
  pt acc = pt_identity();
  if (s.live) {
    fe m;
    bool neg;
    half(s.slot, &m, &neg);
    acc = walk<4, true>(m, [&](uint32_t d) {
      return sh_load_pt(ent + ((int)d - 1) * 24 * lpb, lpb);
    });
    if (s.slot & 1) acc.x = mul_p(acc.x, fe_const(BETA_WORDS));
    if (neg) acc.y = fe_neg<true>(acc.y);
  }
  join_slots(sh + D * ENT * 24 * lpb, &acc, s.slot, 2 * D, s.l, lpb);
  return acc;
}

// One window of the lane walk: 4 doubles, then per half j the entry of
// point j / 2 at its digit (bits 4j..4j+3 of digs), beta x for odd j, -y
// where bit j of neg is set.
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

// The lane walk's sum of one lane, point(i) and half(j, &m, &neg) as for
// glv_split.
template <int D, typename Point, typename Half>
__device__ __forceinline__ pt glv_lane(Point point, Half half) {
  pt tab[D * TAB];
#pragma unroll
  for (int i = 0; i < D; i++) build_table(&tab[i * TAB], point(i));
  fe m[2 * D];
  uint32_t neg = 0;
#pragma unroll
  for (int j = 0; j < 2 * D; j++) {
    bool ng;
    half(j, &m[j], &ng);
    neg |= (ng ? 1u : 0u) << j;
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
  return acc;
}

// -- the GLV split of a scalar, as ops/glv.py::decompose computes it --------

struct glv_halves {
  fe m[2];      // |k1|, |k2|, each below 2^132
  bool neg[2];  // k1, k2 negative
};

// floor((k * g + 2^383) / 2^384), below 2^128 for k, g < 2^256
__device__ __forceinline__ fe glv_round(const fe& k, const uint32_t* g) {
  uint32_t w[16];
  mul_wide(w, k, fe_const(g));
  uint64_t c = ((uint64_t)w[11] + 0x80000000u) >> 32;  // + 2^383: bit 31 of word 11
  fe r = fe_zero();
#pragma unroll
  for (int i = 12; i < 16; i++) {
    c += w[i];
    r.v[i - 12] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// a > floor(n / 2) for canonical a
__device__ __forceinline__ bool gt_half_n(const fe& a) {
  uint32_t bw = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)HALF_N_WORDS[i] - a.v[i] - bw;
    bw = (uint32_t)(t >> 32) & 1u;
  }
  return bw != 0;
}

// k = k1 + k2 lambda (mod n): c_i = round(k b_i / n) by the 2^384 fixed
// point, k2 = c1 |b1| - c2 b2, k1 = k - k2 lambda; a half above floor(n / 2)
// is negative and its magnitude n - k_i. k below 2^256 < 2n is reduced
// first, so a non-canonical scalar gives [k mod n] P.
__device__ __forceinline__ glv_halves glv_decompose(const fe& kin) {
  const fe k = cond_sub<false>(kin, 0);
  const fe c1 = glv_round(k, G1_WORDS), c2 = glv_round(k, G2_WORDS);
  const fe k2 = fe_sub<false>(fe_mul<false>(c1, fe_const(B1ABS_WORDS)),
                              fe_mul<false>(c2, fe_const(B2_WORDS)));
  const fe k1 = fe_sub<false>(k, fe_mul<false>(k2, fe_const(LAMBDA_WORDS)));
  glv_halves h;
  h.neg[0] = gt_half_n(k1);
  h.neg[1] = gt_half_n(k2);
  h.m[0] = fe_select(h.neg[0], fe_neg<false>(k1), k1);
  h.m[1] = fe_select(h.neg[1], fe_neg<false>(k2), k2);
  return h;
}

#ifdef __CUDACC__
// A split launch of lpb lanes per block, nthr threads each, `words` of
// shared memory per block (above 48 KB by opt-in, at most what the card
// grants).
template <typename Kernel, typename... Args>
int launch_split(Kernel kernel, int words, int B, int nthr, int lpb, cudaStream_t st,
                 Args... args) {
  const size_t bytes = (size_t)words * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + lpb - 1) / lpb, (nthr * lpb + 31) / 32 * 32, bytes, st>>>(args..., B, lpb);
  return (int)cudaGetLastError();
}
#endif

}  // namespace bppp
