// K5a, K5b — lane-wise complete Jacobian point add, and chains of point
// doubles; and the table build's affine step.
//
// Replace bppp_tpu/ops/pallas_curve.py::_pt_add_kernel (pt_add_flat) and
// ::_pt_double_kernel (pt_double_flat). One thread owns one lane and calls
// the library's formula. The add is complete: identity operands, the
// doubling collision and the inverse collision are all handled, with the
// same select order as the plain version, so the (X, Y, Z) limbs agree
// exactly and not only the points. The double is dbl-2009-l with a = 0.
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
// 9 * 64 bytes per lane for 16 modular multiplies (24 on a doubling
// collision), the chain (3 + 3 n) * 64 bytes for 7 n; at the card's peak
// rates the traffic takes about twice as long as the arithmetic.
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

__global__ void pt_add_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                              const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                              const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                              uint32_t* __restrict__ oz, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  pt p = pt_load(px, py, pz, B, lane);
  pt q = pt_load(qx, qy, qz, B, lane);
  pt r;
  pt_add(&r, &p, &q);
  pt_store(ox, oy, oz, B, lane, r);
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
// all nine: (16, B) limb words. Returns cudaGetLastError().
extern "C" int bppp_pt_add(const void* px, const void* py, const void* pz, const void* qx,
                           const void* qy, const void* qz, void* ox, void* oy, void* oz, int B,
                           void* stream) {
  if (B <= 0) return 0;
  pt_add_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
      (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, B);
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
