// K2 — x^e mod p or mod n for a host-static exponent e.
//
// Replaces bppp_tpu/ops/pallas_msm.py::_pow_kernel (pow_const_flat): the
// whole fixed-window ladder behind fp_inv (e = p - 2), fp_sqrt (e = (p+1)/4)
// and fn_inv (e = n - 2) in one launch. One thread owns one lane: it builds
// the table x^0..x^15 in local memory, indexed directly (the TPU kernel
// selected by masked adds), and walks e's 4-bit digits MSB-first with four
// squarings and one table multiply per digit. The digits are passed by
// value; the modulus is a template parameter, chosen once per launch and
// not per multiply. 0 maps to 0.
//
// Bound on an H100: operations. Per lane 14 + 5 * 64 modular multiplies of
// about 64 + 30 32-bit multiply-adds each, against 128 bytes moved.
#include "field.cuh"

namespace {

using namespace bppp;

struct pow_digits {
  uint8_t d[64];  // MSB-first 4-bit digits of the exponent
  int n;
};

template <bool IS_P>
__global__ void pow_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int B,
                           pow_digits dg) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  fe xv = fe_load(x, B, lane);
  fe tab[16];
  tab[0] = fe_one();
  tab[1] = xv;
#pragma unroll 1
  for (int k = 2; k < 16; k++) tab[k] = fe_mul<IS_P>(tab[k - 1], xv);
  fe acc = tab[dg.d[0]];
#pragma unroll 1
  for (int i = 1; i < dg.n; i++) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) acc = fe_mul<IS_P>(acc, acc);
    acc = fe_mul<IS_P>(acc, tab[dg.d[i]]);
  }
  fe_store(out, B, lane, acc);
}

}  // namespace

#ifdef __CUDACC__
// x, out: (16, B) limb words. digits: ndig MSB-first 4-bit digits (host
// memory, ndig <= 64). is_p: 1 for the base field, 0 for the scalar field.
extern "C" int bppp_pow_const(const void* x, void* out, int B, const uint8_t* digits, int ndig,
                              int is_p, void* stream) {
  if (B <= 0) return 0;
  if (ndig < 1 || ndig > 64) return (int)cudaErrorInvalidValue;
  pow_digits dg;
  for (int i = 0; i < 64; i++) dg.d[i] = i < ndig ? (digits[i] & 15) : 0;
  dg.n = ndig;
  dim3 grid((B + 127) / 128), block(128);
  if (is_p)
    pow_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, B, dg);
  else
    pow_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, B, dg);
  return (int)cudaGetLastError();
}
#endif
