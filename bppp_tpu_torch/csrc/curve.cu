// K5a, K5b — lane-wise complete Jacobian point add, and chains of point
// doubles; and the table build's affine step.
//
// Replace bppp_tpu/ops/pallas_curve.py::_pt_add_kernel (pt_add_flat) and
// ::_pt_double_kernel (pt_double_flat). The add is complete: identity
// operands, the doubling collision and the inverse collision are all
// handled, with the same select order as the plain version, so the
// (X, Y, Z) limbs agree exactly and not only the points. The double is
// dbl-2009-l with a = 0.
//
// K5a's callers on the paths add a few points per proof (1,024 lanes), where
// one thread per lane runs the formula's 16 products in a row on a card that
// holds a warp or so per SM. The formula (add-2007-bl) is only 5 products
// deep, so T threads of a warp share a lane (pt_add_plan: 4 up to 8,192
// lanes, 2 beyond; one thread per lane was slower at every batch swept, up
// to the table build's 200,704 lanes, so there is no such launch): each
// dependency level's products are spread over them and the results passed
// round by __shfl_sync, 8 words per element; a doubling collision runs
// dbl-2009-l the same way (3 deep) on every warp where a lane meets it. The
// kernel reads the six operands' int64 limbs where they lie — a limb stride
// and a lane stride each, 0 for an operand broadcast over the batch — and
// writes int64, so a call is one launch with no conversion around it.
//
// K5b's one caller on the paths is the fixed-base table build, which needs
// [2^t] G_i for t = 1..255 (more for window widths that do not divide 256)
// of each of its 33-129 generators: one double per launch meant 255
// launches in a row, each a host round trip for seven modular multiplies.
// So the kernel runs a chain: its thread doubles the lane's point n times
// in registers and writes every one of the n doubles, (16, n, B) — limb i
// of double t of lane b at (i * n + t - 1) * B + b, so the stores coalesce
// over lanes — in one launch. The TPU kernel's function, one double per
// lane, is the chain at n = 1. The chain cannot be split across threads
// ([2^(t+1)] G needs [2^t] G), and a table build runs it on at most 129
// lanes, five warps: its time is n doubles of latency in one series, about
// 7 n dependent multiplies (five of them squares, sqr_p), far above what the
// card's rates would allow; the bound of PERF.md says about 0 and this
// kernel cannot approach it.
//
// Bound on an H100: bytes for the add and for a short chain. The add moves
// 9 * 128 bytes per lane (int64 limbs) for 16 modular multiplies (23 on a
// doubling collision), the chain (3 + 3 n) * 64 bytes for 7 n; at the
// card's peak rates the traffic takes longer than the arithmetic.
//
// affine_rows — the same table build's affine step: the (x, y) of M rows of
// NE Jacobian points each (NW * F rows of 2^W window entries), by
// Montgomery's trick along each row. It takes the place of the reference's
// one inversion per entry there (to_affine -> fp_inv, K2: pallas_msm.py's
// pow_const_flat, over all NW * F * 2^W entries). One thread owns one row:
// it writes the prefix products of the row's Z into the x output as
// scratch, inverts the last one by Fermat (a 4-bit window over p - 2, one
// inversion per row), and walks the row back down, each entry's Z^-1 the
// running inverse times the prefix before it, then x = X Z^-2, y = Y Z^-3.
// An identity entry (Z = 0) counts as Z = 1 and gives (0, 0). About 7
// modular multiplies per entry and 330 per row, all in registers, where the
// eager product tree ran about 3 limb multiplies per entry through device
// memory and K2 about 330 per entry. Affine values are canonical and
// unique, so the result equals the plain version's (a product tree, one
// inversion per row) limb for limb, whatever the order of the multiplies.
// Its floor on the build's 1,056-4,128 rows is latency: about 7 NE + 330
// dependent multiplies in one thread.
#include "field.cuh"

namespace {

using namespace bppp;

struct add_io {
  const int64_t* in[6];         // px, py, pz, qx, qy, qz
  long long limb[6], lane[6];   // element i of lane b at in[k][i * limb[k] + b * lane[k]]
  int64_t* out[3];              // (16, B) contiguous
};

template <int T>
__device__ __forceinline__ fe shfl_fe(const fe& a, int src) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = __shfl_sync(0xffffffffu, a.v[k], src, T);
  return r;
}

// The N products a[k] * b[k] of one dependency level of a formula, spread
// over the T threads of a lane (thread j computes products j, j + T, ...;
// a thread with none left repeats the round's first, so the warp does not
// diverge), every result then handed to all T threads. A square is
// mul_p(a, a): limb-equal to sqr_p, and one shape of work for the warp.
template <int T, int N>
__device__ __forceinline__ void products(fe (&r)[N], const fe (&a)[N], const fe (&b)[N], int j) {
#pragma unroll
  for (int base = 0; base < N; base += T) {
    fe x = a[base], y = b[base];
#pragma unroll
    for (int k = 1; k < T; k++) {
      if (base + k < N) {
        x = fe_select(j == k, a[base + k], x);
        y = fe_select(j == k, b[base + k], y);
      }
    }
    const fe m = mul_p(x, y);
    if (base + 1 == N) {
      r[base] = m;  // one product in the round: every thread has it
    } else {
#pragma unroll
      for (int k = 0; k < T; k++)
        if (base + k < N) r[base + k] = shfl_fe<T>(m, k);
    }
  }
}

// pt_dbl's formula (dbl-2009-l) by levels: (A, B, 2Y Z) -> (C, (X + B)^2,
// F) -> E (D - X3); 7 products, 3 deep.
template <int T>
__device__ __forceinline__ pt pt_dbl_split(const pt& in, int j) {
  const fe X = in.x, Y = in.y, Z = in.z;
  fe l1[3];  // A, B, Z3
  {
    const fe a[3] = {X, Y, add_p(Y, Y)}, b[3] = {X, Y, Z};
    products<T, 3>(l1, a, b, j);
  }
  const fe A = l1[0], Bb = l1[1];
  const fe t = add_p(X, Bb);
  const fe E = add_p(add_p(A, A), A);
  fe l2[3];  // C, t^2, F
  {
    const fe a[3] = {Bb, t, E}, b[3] = {Bb, t, E};
    products<T, 3>(l2, a, b, j);
  }
  const fe C = l2[0];
  fe D = sub_p(sub_p(l2[1], A), C);
  D = add_p(D, D);
  const fe X3 = sub_p(l2[2], add_p(D, D));
  fe C8 = add_p(C, C);
  C8 = add_p(C8, C8);
  C8 = add_p(C8, C8);
  fe l3[1];
  {
    const fe a[1] = {E}, b[1] = {sub_p(D, X3)};
    products<T, 1>(l3, a, b, j);
  }
  pt o;
  o.x = X3;
  o.y = sub_p(l3[0], C8);
  o.z = l1[2];
  return o;
}

// pt_add on T threads per lane: jac_add_core's 16 products by dependency
// levels, (Z1Z1, Z2Z2, Z1 Z2) -> (U1, U2, Z2 Z2Z2, Z1 Z1Z1) -> (S1, S2, HH,
// Z3) -> (HHH, V, rr) -> (r (V - X3), S1 HHH): 5 products deep where one
// thread runs 16 in a row. The same values and the same select order as
// pt_add, so the limbs agree. Every thread of the warp must arrive here.
template <int T>
__device__ __forceinline__ pt pt_add_split(const pt& p, const pt& q, int j) {
  fe l1[3];
  {
    const fe a[3] = {p.z, q.z, p.z}, b[3] = {p.z, q.z, q.z};
    products<T, 3>(l1, a, b, j);
  }
  fe l2[4];
  {
    const fe a[4] = {p.x, q.x, q.z, p.z}, b[4] = {l1[1], l1[0], l1[1], l1[0]};
    products<T, 4>(l2, a, b, j);
  }
  const fe U1 = l2[0];
  const fe H = sub_p(l2[1], U1);
  fe l3[4];
  {
    const fe a[4] = {p.y, q.y, H, l1[2]}, b[4] = {l2[2], l2[3], H, H};
    products<T, 4>(l3, a, b, j);
  }
  const fe S1 = l3[0];
  const fe r = sub_p(l3[1], S1);
  fe l4[3];
  {
    const fe a[3] = {H, U1, r}, b[3] = {l3[2], l3[2], r};
    products<T, 3>(l4, a, b, j);
  }
  const fe V = l4[1];
  const fe X3 = sub_p(sub_p(l4[2], l4[0]), add_p(V, V));
  fe l5[2];
  {
    const fe a[2] = {r, S1}, b[2] = {sub_p(V, X3), l4[0]};
    products<T, 2>(l5, a, b, j);
  }
  pt res;
  res.x = X3;
  res.y = sub_p(l5[0], l5[1]);
  res.z = l3[3];
  const bool h_zero = fe_is_zero(H), r_zero = fe_is_zero(r);
  const bool p_id = fe_is_zero(p.z), q_id = fe_is_zero(q.z);
  const bool neither = !(p_id || q_id);
  const bool dbl = neither && h_zero && r_zero;
  // the doubling collision: on every thread of a warp where any lane has it
  if (__any_sync(0xffffffffu, dbl)) res = pt_select(dbl, pt_dbl_split<T>(p, j), res);
  res = pt_select(neither && h_zero && !r_zero, pt_identity(), res);
  res = pt_select(q_id, p, res);
  return pt_select(p_id, q, res);
}

__device__ __forceinline__ fe load_in(const add_io& io, int k, long long lane) {
  return fe_load64(io.in[k], io.limb[k], lane * io.lane[k]);
}

// T threads per lane (2 or 4), in blocks of a multiple of 32 threads, so
// that a lane's threads share a warp and every warp is whole.
template <int T>
__global__ void pt_add_kernel(add_io io, int B) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long idx = t / T;
  const bool live = idx < B;
  const long long lane = live ? idx : B - 1;  // threads past the end run along
  pt p, q;
  p.x = load_in(io, 0, lane);
  p.y = load_in(io, 1, lane);
  p.z = load_in(io, 2, lane);
  q.x = load_in(io, 3, lane);
  q.y = load_in(io, 4, lane);
  q.z = load_in(io, 5, lane);
  const pt r = pt_add_split<T>(p, q, (int)(threadIdx.x % T));
  if (!live) return;
  const int j = (int)(t % T);
  const fe* c[3] = {&r.x, &r.y, &r.z};
#pragma unroll
  for (int k = 0; k < 3; k++)
    if (k % T == j) fe_store64(io.out[k], B, lane, *c[k]);
}

// n successive doubles of each lane's point, every one stored
__global__ void pt_double_chain_kernel(const uint32_t* __restrict__ px,
                                       const uint32_t* __restrict__ py,
                                       const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                                       uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int n,
                                       int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  const size_t stride = (size_t)n * B;
  pt p = pt_load(px, py, pz, B, lane);
#pragma unroll 1
  for (int t = 0; t < n; t++) {
    pt_dbl(&p, &p);
    const size_t off = (size_t)t * B;
    pt_store(ox + off, oy + off, oz + off, stride, lane, p);
  }
}

// a^(p-2) = a^-1 in F_p (0 for a = 0): a 4-bit window over the exponent,
// MSB first, its table a^0..a^15 in the thread's own array
__device__ __noinline__ fe inv_p(const fe& a) {
  fe tab[16];
  tab[0] = fe_one();
  tab[1] = a;
#pragma unroll 1
  for (int k = 2; k < 16; k++) tab[k] = mul_p(tab[k - 1], a);
  fe acc = fe_one();
#pragma unroll 1
  for (int i = 63; i >= 0; i--) {
    // word i / 8 of p - 2: P_WORDS with 2 taken from the lowest (no borrow)
    const uint32_t w = P_WORDS[i / 8] - (i / 8 == 0 ? 2u : 0u);
    const int d = (w >> (4 * (i % 8))) & 15;
    if (i != 63) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) acc = sqr_p(acc);
    }
    acc = mul_p(acc, tab[d]);
  }
  return acc;
}

// (x, y) of every entry of each row: coords (16, NE, M), row m's entry e at
// limb-major offset e * M + m, so a warp's loads and stores coalesce over
// rows. The x output holds the row's prefix products on the way up.
__global__ void affine_rows_kernel(const uint32_t* __restrict__ px,
                                   const uint32_t* __restrict__ py,
                                   const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                                   uint32_t* __restrict__ oy, int NE, int M) {
  size_t m = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (size_t)M) return;
  const size_t stride = (size_t)NE * M;
  fe acc = fe_one();
#pragma unroll 1
  for (int e = 0; e < NE; e++) {
    const fe z = fe_load(pz + (size_t)e * M, stride, m);
    if (!fe_is_zero(z)) acc = mul_p(acc, z);
    fe_store(ox + (size_t)e * M, stride, m, acc);
  }
  fe inv = inv_p(acc);  // (Z_0 ... Z_{NE-1})^-1
#pragma unroll 1
  for (int e = NE - 1; e >= 0; e--) {
    const fe z = fe_load(pz + (size_t)e * M, stride, m);
    const bool id = fe_is_zero(z);
    const fe pre = e > 0 ? fe_load(ox + (size_t)(e - 1) * M, stride, m) : fe_one();
    const fe zi = mul_p(inv, pre);  // Z_e^-1
    if (!id) inv = mul_p(inv, z);   // (Z_0 ... Z_{e-1})^-1
    const fe zi2 = sqr_p(zi);
    fe x = mul_p(fe_load(px + (size_t)e * M, stride, m), zi2);
    fe y = mul_p(fe_load(py + (size_t)e * M, stride, m), mul_p(zi2, zi));
    fe_store(ox + (size_t)e * M, stride, m, fe_select(id, fe_zero(), x));
    fe_store(oy + (size_t)e * M, stride, m, fe_select(id, fe_zero(), y));
  }
}

}  // namespace

#ifdef __CUDACC__
// ins: the six operands' int64 limbs; strides: (limb stride, lane stride)
// of each, in elements (a lane stride of 0 broadcasts one lane); outs: three
// (16, B) contiguous int64. nthr: threads per lane (2 or 4), lpb: lanes
// per block. Returns cudaGetLastError().
extern "C" int bppp_pt_add(const void* const* ins, const long long* strides, void* const* outs,
                           int B, int nthr, int lpb, void* stream) {
  if (B <= 0) return 0;
  const int threads = nthr * lpb;
  if ((nthr != 2 && nthr != 4) || lpb < 1 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  add_io io;
  for (int k = 0; k < 6; k++) {
    io.in[k] = (const int64_t*)ins[k];
    io.limb[k] = strides[2 * k];
    io.lane[k] = strides[2 * k + 1];
  }
  for (int k = 0; k < 3; k++) io.out[k] = (int64_t*)outs[k];
  const int grid = (B + lpb - 1) / lpb;
  cudaStream_t st = (cudaStream_t)stream;
  if (nthr == 2) pt_add_kernel<2><<<grid, threads, 0, st>>>(io, B);
  else pt_add_kernel<4><<<grid, threads, 0, st>>>(io, B);
  return (int)cudaGetLastError();
}
#endif

#ifdef __CUDACC__
// px, py, pz: (16, B) limb words; outputs (16, n, B), n >= 1. Returns
// cudaGetLastError().
extern "C" int bppp_pt_double_chain(const void* px, const void* py, const void* pz, void* ox,
                                    void* oy, void* oz, int n, int B, void* stream) {
  if (B <= 0) return 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  pt_double_chain_kernel<<<(B + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n, B);
  return (int)cudaGetLastError();
}
#endif

#ifdef __CUDACC__
// px, py, pz: (16, NE, M) limb words; ox, oy: (16, NE, M). Returns
// cudaGetLastError().
extern "C" int bppp_affine_rows(const void* px, const void* py, const void* pz, void* ox, void* oy,
                                int NE, int M, void* stream) {
  if (M <= 0 || NE <= 0) return 0;
  affine_rows_kernel<<<(M + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)ox, (uint32_t*)oy,
      NE, M);
  return (int)cudaGetLastError();
}
#endif
