// K6, K7 — lane-wise scalar multiplication [k]P, and the sum of L points per
// lane.
//
// K6 replaces bppp_tpu/ops/pallas_msm.py::_ladder_kernel (scalar_mul_flat).
// One thread owns one lane. It builds the table [0..15]P in local memory (16
// Jacobian points of 96 bytes, indexed directly by the digit) with 14
// complete adds, then walks the 64 four-bit windows of k from the most
// significant down: 4 doubles and one complete add of the table entry. The
// adds are complete because a window digit can meet acc == +-entry for small
// or structured scalars, and callers hand this kernel points and scalars that
// a verifier did not choose. The digits are peeled from the eight 32-bit
// words of k, which stay in registers: the loop over the words is unrolled,
// the loop over a word's eight nibbles is not. k = 0 and P = identity give
// the identity. The formulas and their select order are those of the plain
// PyTorch version, so the two agree in (X, Y, Z) limb for limb.
//
// K7 replaces bppp_tpu/ops/pallas_msm.py::_tree_kernel (tree_sum_flat and the
// layout shuffle of tree_sum). Points arrive as (16, L, B): limb i of point l
// of lane b at ptr[(i * L + l) * B + b]. One thread owns one lane, reads its
// L points straight from that layout (adjacent threads read adjacent lanes,
// so every load coalesces) and accumulates them in order with L - 1
// INCOMPLETE adds: identity operands are handled, a collision P == +-Q
// degrades to the identity encoding. The plain version chains the same
// incomplete add in the same order, so again the limbs agree.
//
// Bounds on an H100: K6 operations — 78 complete adds of 16 modular
// multiplies and 256 doubles of 7 per lane against 7 * 64 bytes moved; K7
// bytes for short sums — (3 L + 3) * 64 bytes per lane against (L - 1) * 16
// multiplies.
#include "field.cuh"

namespace {

using namespace bppp;

__global__ void scalar_mul_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                  const uint32_t* __restrict__ pz, const uint32_t* __restrict__ k,
                                  uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                  uint32_t* __restrict__ oz, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  pt tab[16];
  pt P = pt_load(px, py, pz, B, lane);
  tab[0] = pt_identity();
  tab[1] = P;
#pragma unroll 1
  for (int e = 2; e < 16; e++) pt_add(&tab[e], &tab[e - 1], &P);
  const fe kk = fe_load(k, B, lane);
  pt acc = pt_identity();
#pragma unroll
  for (int word = 7; word >= 0; word--) {
    uint32_t bits = kk.v[word];
#pragma unroll 1
    for (int nib = 0; nib < 8; nib++) {
#pragma unroll 1
      for (int s = 0; s < 4; s++) pt_dbl(&acc, &acc);
      uint32_t d = bits >> 28;
      bits <<= 4;
      pt_add(&acc, &acc, &tab[d]);
    }
  }
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
// px, py, pz, k and the outputs: (16, B) limb words. Returns cudaGetLastError().
extern "C" int bppp_scalar_mul(const void* px, const void* py, const void* pz, const void* k,
                               void* ox, void* oy, void* oz, int B, void* stream) {
  if (B <= 0) return 0;
  scalar_mul_kernel<<<(B + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)k,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, B);
  return (int)cudaGetLastError();
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
