// secp256k1 field and point arithmetic for the CUDA kernels of this package.
//
// Counterpart of bppp_tpu/ops/pallas_field.py: not a kernel, but every kernel
// body is made of it. The interchange layout at a kernel's edge is 16 limbs of
// 16 bits per element, limb-major with the batch axis last and contiguous
// (element i of lane b at ptr[i * stride + b]), stored as 32-bit words. Inside,
// an element is 8 x 32-bit limbs in registers: Hopper multiplies 32 x 32 -> 64
// in one IMAD.WIDE, so the 16-bit limbs the TPU needed are only a storage
// format here. One thread owns one lane; loads and stores are coalesced over
// the batch axis.
//
// Reduction is fold-based and every result is canonical (fully reduced):
//   F_p: 2^256 = 2^32 + 977 (mod p)          two folds + conditional subtract
//   F_n: 2^256 = C_N = 2^256 - n (129 bits)   three folds + conditional subtract
// so results equal the plain PyTorch versions limb for limb.
//
// fe_load64 / fe_store64 read and write the port's int64 limb tensors as they
// stand (a limb stride and a lane stride, 0 for a broadcast operand), so a
// wrapper needs no narrowing or widening pass around its launch.
//
// A square has its own product, sqr_wide: the 28 products a[i] * a[j] with
// i < j, doubled by a shift, plus the 8 diagonal squares — 36 word products
// where mul_wide's schoolbook takes 64. Its 512-bit result is the same
// number, so sqr_p(a) equals mul_p(a, a) limb for limb, and sqr_n(a)
// equals fe_mul<false>(a, a). The point formulas square through it: 5 of a
// double's 7 multiplies, 4 of an add's 16; the exponentiation (K2) squares
// through fe_sqr. In a kernel that runs one lane's series of dependent
// multiplies (every walk here is latency-bound at the paths' batches) fewer
// products per square shorten the series.
#pragma once

#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace bppp {

// Little-endian 32-bit words. A unit test parses these arrays and holds them
// equal to the Python constants of the package.
static __constant__ uint32_t P_WORDS[8] = {
    0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
static __constant__ uint32_t N_WORDS[8] = {
    0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
    0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
// C_N = 2^256 - n
static __constant__ uint32_t CN_WORDS[5] = {
    0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u, 0x00000001u};
// beta: cube root of unity in F_p, phi(x, y) = (beta x, y) = [lambda](x, y)
static __constant__ uint32_t BETA_WORDS[8] = {
    0x719501EEu, 0xC1396C28u, 0x12F58995u, 0x9CF04975u,
    0xAC3434E9u, 0x6E64479Eu, 0x657C0710u, 0x7AE96A2Bu};
// The GLV split of a scalar k = k1 + k2 lambda (mod n), libsecp256k1's
// constants as in ops/glv.py: lambda, the lattice vectors' b1 = -B1ABS and
// b2, G_i = round(2^384 * b_i / n) for the rounding, and floor(n / 2), above
// which a half is negative.
static __constant__ uint32_t LAMBDA_WORDS[8] = {
    0x1B23BD72u, 0xDF02967Cu, 0x20816678u, 0x122E22EAu,
    0x8812645Au, 0xA5261C02u, 0xC05C30E0u, 0x5363AD4Cu};
static __constant__ uint32_t B1ABS_WORDS[8] = {
    0x0ABFE4C3u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
static __constant__ uint32_t B2_WORDS[8] = {
    0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
static __constant__ uint32_t G1_WORDS[8] = {
    0x45DBB031u, 0xE893209Au, 0x71E8CA7Fu, 0x3DAA8A14u,
    0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u};
static __constant__ uint32_t G2_WORDS[8] = {
    0x8AC47F71u, 0x1571B4AEu, 0x9DF506C6u, 0x221208ACu,
    0x0ABFE4C4u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u};
static __constant__ uint32_t HALF_N_WORDS[8] = {
    0x681B20A0u, 0xDFE92F46u, 0x57A4501Du, 0x5D576E73u,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};

struct fe {
  uint32_t v[8];
};

struct pt {
  fe x, y, z;  // Jacobian; z == 0 is the identity
};

// -- load / store in the interchange layout ---------------------------------

__device__ __forceinline__ fe fe_load(const uint32_t* p, size_t stride, size_t lane) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t lo = p[(size_t)(2 * k) * stride + lane];
    uint32_t hi = p[(size_t)(2 * k + 1) * stride + lane];
    r.v[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(uint32_t* p, size_t stride, size_t lane, const fe& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p[(size_t)(2 * k) * stride + lane] = a.v[k] & 0xFFFFu;
    p[(size_t)(2 * k + 1) * stride + lane] = a.v[k] >> 16;
  }
}

// The same layout held as the port's int64 limb tensors, read and written
// in place: element i of lane b at p[i * limb_stride + b * lane_stride]
// (lane_stride 0 broadcasts one lane over the batch). Only the low 16 bits
// of each limb are read, as fe_load reads them.
__device__ __forceinline__ fe fe_load64(const int64_t* p, long long limb_stride, long long off) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t lo = (uint32_t)p[(2 * k) * limb_stride + off];
    uint32_t hi = (uint32_t)p[(2 * k + 1) * limb_stride + off];
    r.v[k] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store64(int64_t* p, long long limb_stride, long long off,
                                           const fe& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p[(2 * k) * limb_stride + off] = a.v[k] & 0xFFFFu;
    p[(2 * k + 1) * limb_stride + off] = a.v[k] >> 16;
  }
}

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = 0;
  return r;
}

__device__ __forceinline__ fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

__device__ __forceinline__ fe fe_const(const uint32_t* words) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = words[k];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) acc |= a.v[k];
  return acc == 0;
}

__device__ __forceinline__ fe fe_select(bool m, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = m ? a.v[k] : b.v[k];
  return r;
}

// -- add / sub ----------------------------------------------------------------

template <bool IS_P>
__device__ __forceinline__ uint32_t mod_word(int k) {
  return IS_P ? P_WORDS[k] : N_WORDS[k];
}

// r = a + b, returns the carry out
__device__ __forceinline__ uint32_t add8(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    c += (uint64_t)a[k] + b[k];
    r[k] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - m, returns the borrow out (1 when a < m)
template <bool IS_P>
__device__ __forceinline__ uint32_t sub_mod8(uint32_t* r, const uint32_t* a) {
  uint32_t bw = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t t = (uint64_t)a[k] - mod_word<IS_P>(k) - bw;
    r[k] = (uint32_t)t;
    bw = (uint32_t)(t >> 32) & 1u;
  }
  return bw;
}

// a < 2^256 (+ carry * 2^256, the whole below 2m) -> canonical
template <bool IS_P>
__device__ __forceinline__ fe cond_sub(const fe& a, uint32_t carry) {
  fe d;
  uint32_t bw = sub_mod8<IS_P>(d.v, a.v);
  return fe_select(carry != 0 || bw == 0, d, a);
}

template <bool IS_P>
__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe s;
  uint32_t c = add8(s.v, a.v, b.v);
  return cond_sub<IS_P>(s, c);
}

template <bool IS_P>
__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe d;
  uint32_t bw = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t t = (uint64_t)a.v[k] - b.v[k] - bw;
    d.v[k] = (uint32_t)t;
    bw = (uint32_t)(t >> 32) & 1u;
  }
  // a < b: add the modulus back (the wrap cancels the borrow)
  fe e;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    c += (uint64_t)d.v[k] + mod_word<IS_P>(k);
    e.v[k] = (uint32_t)c;
    c >>= 32;
  }
  return fe_select(bw != 0, e, d);
}

template <bool IS_P>
__device__ __forceinline__ fe fe_neg(const fe& a) {
  return fe_sub<IS_P>(fe_zero(), a);
}

// -- multiply -----------------------------------------------------------------

// 8 x 8 schoolbook, operand scanning: a[i]*b[j] + w[i+j] + carry < 2^64 exactly
__device__ __forceinline__ void mul_wide(uint32_t* w, const fe& a, const fe& b) {
#pragma unroll
  for (int k = 0; k < 16; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t t = (uint64_t)a.v[i] * b.v[j] + w[i + j] + c;
      w[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    w[i + 8] = (uint32_t)c;
  }
}

// a * a, 16 words: the off-diagonal products once, doubled, then the
// diagonal squares. The off-diagonal sum is below 2^511, so the shift loses
// nothing, and the total a^2 < 2^512 leaves no carry.
__device__ __forceinline__ void sqr_wide(uint32_t* w, const fe& a) {
#pragma unroll
  for (int k = 0; k < 16; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      uint64_t t = (uint64_t)a.v[i] * a.v[j] + w[i + j] + c;
      w[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    w[i + 8] = (uint32_t)c;
  }
#pragma unroll
  for (int k = 15; k > 0; k--) w[k] = (w[k] << 1) | (w[k - 1] >> 31);
  w[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t sq = (uint64_t)a.v[i] * a.v[i];
    uint64_t t = (uint64_t)w[2 * i] + (uint32_t)sq + c;
    w[2 * i] = (uint32_t)t;
    c = t >> 32;
    t = (uint64_t)w[2 * i + 1] + (sq >> 32) + c;
    w[2 * i + 1] = (uint32_t)t;
    c = t >> 32;
  }
}

// 16 words -> canonical mod p. x = L + H * (2^32 + 977), folded until no
// carry is left, then one conditional subtract.
__device__ __forceinline__ fe fold_p(const uint32_t* w) {
  // m = H * 977: 9 words, m[8] < 977
  uint32_t m[9];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t t = (uint64_t)w[8 + j] * 977u + c;
    m[j] = (uint32_t)t;
    c = t >> 32;
  }
  m[8] = (uint32_t)c;
  // s = L + m + (H << 32): 10 words, s[9] in {0, 1}
  uint32_t s[10];
  c = 0;
#pragma unroll
  for (int k = 0; k < 10; k++) {
    uint64_t t = c;
    if (k < 8) t += w[k];
    if (k < 9) t += m[k];
    if (k >= 1 && k <= 8) t += w[8 + k - 1];
    s[k] = (uint32_t)t;
    c = t >> 32;
  }
  // second fold: h2 = s[8] + s[9] * 2^32 < 2^34; h2 * 977 < 2^44
  uint64_t h2 = (uint64_t)s[8] | ((uint64_t)s[9] << 32);
  uint64_t p977 = h2 * 977ull;
  fe r;
  uint64_t t = (uint64_t)s[0] + (uint32_t)p977;
  r.v[0] = (uint32_t)t;
  c = t >> 32;
  t = (uint64_t)s[1] + (p977 >> 32) + s[8] + c;
  r.v[1] = (uint32_t)t;
  c = t >> 32;
  t = (uint64_t)s[2] + s[9] + c;
  r.v[2] = (uint32_t)t;
  c = t >> 32;
#pragma unroll
  for (int k = 3; k < 8; k++) {
    t = (uint64_t)s[k] + c;
    r.v[k] = (uint32_t)t;
    c = t >> 32;
  }
  // third fold: a carry here means the sum wrapped to a value < 2^68, so
  // adding 2^32 + 977 once cannot carry again
  uint32_t c3 = (uint32_t)c;
  t = (uint64_t)r.v[0] + 977u * c3;
  r.v[0] = (uint32_t)t;
  c = t >> 32;
  t = (uint64_t)r.v[1] + c3 + c;
  r.v[1] = (uint32_t)t;
  c = t >> 32;
#pragma unroll
  for (int k = 2; k < 8; k++) {
    t = (uint64_t)r.v[k] + c;
    r.v[k] = (uint32_t)t;
    c = t >> 32;
  }
  return cond_sub<true>(r, 0);
}

// t[0..NT) += h[0..NH) * C_N; the caller guarantees the sum fits NT words
template <int NH, int NT>
__device__ __forceinline__ void madd_cn(uint32_t* t, const uint32_t* h) {
#pragma unroll
  for (int i = 0; i < NH; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 5; j++) {
      uint64_t x = (uint64_t)h[i] * CN_WORDS[j] + t[i + j] + c;
      t[i + j] = (uint32_t)x;
      c = x >> 32;
    }
#pragma unroll
    for (int k = i + 5; k < NT; k++) {
      uint64_t x = (uint64_t)t[k] + c;
      t[k] = (uint32_t)x;
      c = x >> 32;
    }
  }
}

// 16 words -> canonical mod n. Each fold replaces H * 2^256 by H * C_N:
//   w  < 2^512 -> t1 < 2^386 -> t2 < 2^260 -> t3 < 2^256 + 2^133 -> r < 2^256
__device__ __forceinline__ fe fold_n(const uint32_t* w) {
  uint32_t t1[13];
#pragma unroll
  for (int k = 0; k < 13; k++) t1[k] = k < 8 ? w[k] : 0;
  madd_cn<8, 13>(t1, w + 8);
  uint32_t t2[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t2[k] = k < 8 ? t1[k] : 0;
  madd_cn<5, 10>(t2, t1 + 8);
  uint32_t t3[9];
#pragma unroll
  for (int k = 0; k < 9; k++) t3[k] = k < 8 ? t2[k] : 0;
  madd_cn<1, 9>(t3, t2 + 8);  // t2[8] < 16, t2[9] == 0
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = t3[k];
  uint32_t c = t3[8];  // 0 or 1; when 1 the low part is < 2^133
  madd_cn<1, 8>(r.v, &c);
  return cond_sub<false>(r, 0);
}

template <bool IS_P>
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint32_t w[16];
  mul_wide(w, a, b);
  return IS_P ? fold_p(w) : fold_n(w);
}

__device__ __forceinline__ fe mul_p(const fe& a, const fe& b) { return fe_mul<true>(a, b); }
__device__ __forceinline__ fe sqr_p(const fe& a) {
  uint32_t w[16];
  sqr_wide(w, a);
  return fold_p(w);
}
__device__ __forceinline__ fe sqr_n(const fe& a) {
  uint32_t w[16];
  sqr_wide(w, a);
  return fold_n(w);
}
// a * a by the dedicated square, limb-equal to fe_mul<IS_P>(a, a)
template <bool IS_P>
__device__ __forceinline__ fe fe_sqr(const fe& a) {
  return IS_P ? sqr_p(a) : sqr_n(a);
}
__device__ __forceinline__ fe add_p(const fe& a, const fe& b) { return fe_add<true>(a, b); }
__device__ __forceinline__ fe sub_p(const fe& a, const fe& b) { return fe_sub<true>(a, b); }

// -- points -------------------------------------------------------------------

__device__ __forceinline__ pt pt_identity() {
  pt r;
  r.x = fe_zero();
  r.y = fe_one();
  r.z = fe_zero();
  return r;
}

__device__ __forceinline__ pt pt_select(bool m, const pt& a, const pt& b) {
  pt r;
  r.x = fe_select(m, a.x, b.x);
  r.y = fe_select(m, a.y, b.y);
  r.z = fe_select(m, a.z, b.z);
  return r;
}

// dbl-2009-l (a = 0). Complete for the identity: Z3 = 2YZ vanishes with Z.
__device__ __noinline__ void pt_dbl(pt* out, const pt* in) {
  const fe X = in->x, Y = in->y, Z = in->z;
  fe A = sqr_p(X);
  fe Bb = sqr_p(Y);
  fe C = sqr_p(Bb);
  fe t = add_p(X, Bb);
  fe D = sub_p(sub_p(sqr_p(t), A), C);
  D = add_p(D, D);
  fe E = add_p(add_p(A, A), A);
  fe F = sqr_p(E);
  fe X3 = sub_p(F, add_p(D, D));
  fe C8 = add_p(C, C);
  C8 = add_p(C8, C8);
  C8 = add_p(C8, C8);
  out->y = sub_p(mul_p(E, sub_p(D, X3)), C8);
  out->z = mul_p(add_p(Y, Y), Z);
  out->x = X3;
}

// Shared body of the Jacobian adds (add-2007-bl shape). Returns H and r too.
struct add_core {
  pt sum;
  fe H, r;
};

__device__ __forceinline__ void jac_add_core(add_core* o, const pt& p, const pt& q) {
  fe Z1Z1 = sqr_p(p.z);
  fe Z2Z2 = sqr_p(q.z);
  fe U1 = mul_p(p.x, Z2Z2);
  fe U2 = mul_p(q.x, Z1Z1);
  fe S1 = mul_p(p.y, mul_p(q.z, Z2Z2));
  fe S2 = mul_p(q.y, mul_p(p.z, Z1Z1));
  fe H = sub_p(U2, U1);
  fe r = sub_p(S2, S1);
  fe HH = sqr_p(H);
  fe HHH = mul_p(H, HH);
  fe V = mul_p(U1, HH);
  fe rr = sqr_p(r);
  fe X3 = sub_p(sub_p(rr, HHH), add_p(V, V));
  o->sum.y = sub_p(mul_p(r, sub_p(V, X3)), mul_p(S1, HHH));
  o->sum.z = mul_p(mul_p(p.z, q.z), H);
  o->sum.x = X3;
  o->H = H;
  o->r = r;
}

// Complete masked Jacobian add: identity operands, the doubling collision
// (H == 0, r == 0) and the inverse collision (H == 0, r != 0) are handled.
__device__ __noinline__ void pt_add(pt* out, const pt* pp, const pt* qq) {
  const pt p = *pp, q = *qq;
  add_core c;
  jac_add_core(&c, p, q);
  bool h_zero = fe_is_zero(c.H), r_zero = fe_is_zero(c.r);
  bool p_id = fe_is_zero(p.z), q_id = fe_is_zero(q.z);
  bool neither = !(p_id || q_id);
  pt res = c.sum;
  if (neither && h_zero && r_zero) {
    pt d;
    pt_dbl(&d, &p);
    res = d;
  }
  res = pt_select(neither && h_zero && !r_zero, pt_identity(), res);
  res = pt_select(q_id, p, res);
  res = pt_select(p_id, q, res);
  *out = res;
}

// INCOMPLETE masked Jacobian add: the identity cases are handled, but NOT the
// collisions p == +-q: those lanes degrade to the identity encoding (H = 0
// gives Z3 = 0). Safe whenever a collision implies a nontrivial discrete-log
// relation between the operands — true for every verifier MSM whose scalars
// are Fiat-Shamir challenges, and for table chains [k]P + P with 2 <= k < 15
// on a prime-order curve. Saves the doubling body and the collision masks.
__device__ __noinline__ void pt_add_inc(pt* out, const pt* pp, const pt* qq) {
  const pt p = *pp, q = *qq;
  add_core c;
  jac_add_core(&c, p, q);
  bool p_id = fe_is_zero(p.z), q_id = fe_is_zero(q.z);
  pt res = pt_select(q_id, p, c.sum);
  *out = pt_select(p_id, q, res);
}

// INCOMPLETE masked mixed add: p Jacobian + q affine (z = 1 implied; all-zero
// coordinates are the identity). madd-2007-bl shape, which saves the
// Z2Z2 / S1 scalings. Collisions degrade to the identity as in pt_add_inc,
// under the same safety argument.
__device__ __noinline__ void pt_add_mixed_inc(pt* out, const pt* pp, const fe* qxp, const fe* qyp) {
  const pt p = *pp;
  const fe qx = *qxp, qy = *qyp;
  fe Z1Z1 = sqr_p(p.z);
  fe U2 = mul_p(qx, Z1Z1);
  fe S2 = mul_p(qy, mul_p(p.z, Z1Z1));
  fe H = sub_p(U2, p.x);
  fe r = sub_p(S2, p.y);
  fe HH = sqr_p(H);
  fe HHH = mul_p(H, HH);
  fe V = mul_p(p.x, HH);
  fe rr = sqr_p(r);
  pt s;
  s.x = sub_p(sub_p(rr, HHH), add_p(V, V));
  s.y = sub_p(mul_p(r, sub_p(V, s.x)), mul_p(p.y, HHH));
  s.z = mul_p(p.z, H);
  bool p_id = fe_is_zero(p.z);
  bool q_id = fe_is_zero(qx) && fe_is_zero(qy);
  pt lift;
  lift.x = qx;
  lift.y = qy;
  lift.z = fe_one();
  s = pt_select(p_id, lift, s);
  *out = pt_select(q_id, p, s);
}

__device__ __forceinline__ pt pt_load(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                      size_t stride, size_t lane) {
  pt r;
  r.x = fe_load(x, stride, lane);
  r.y = fe_load(y, stride, lane);
  r.z = fe_load(z, stride, lane);
  return r;
}

__device__ __forceinline__ void pt_store(uint32_t* x, uint32_t* y, uint32_t* z, size_t stride,
                                         size_t lane, const pt& a) {
  fe_store(x, stride, lane, a.x);
  fe_store(y, stride, lane, a.y);
  fe_store(z, stride, lane, a.z);
}

}  // namespace bppp
