// K5a, K5b — lane-wise complete Jacobian point add, and point double.
//
// Replace bppp_tpu/ops/pallas_curve.py::_pt_add_kernel (pt_add_flat) and
// ::_pt_double_kernel (pt_double_flat). One thread owns one lane and calls
// the library's formula. The add is complete: identity operands, the
// doubling collision and the inverse collision are all handled, with the
// same select order as the plain version, so the (X, Y, Z) limbs agree
// exactly and not only the points. The double is dbl-2009-l with a = 0.
//
// Bound on an H100: bytes. The add moves 9 * 64 bytes per lane for 16 modular
// multiplies (24 on a doubling collision), the double 6 * 64 bytes for 7; at
// the card's peak rates the traffic takes about twice as long as the
// arithmetic.
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

__global__ void pt_double_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                 const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  pt p = pt_load(px, py, pz, B, lane);
  pt r;
  pt_dbl(&r, &p);
  pt_store(ox, oy, oz, B, lane, r);
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
// all six: (16, B) limb words. Returns cudaGetLastError().
extern "C" int bppp_pt_double(const void* px, const void* py, const void* pz, void* ox, void* oy,
                              void* oz, int B, void* stream) {
  if (B <= 0) return 0;
  pt_double_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, B);
  return (int)cudaGetLastError();
}
#endif
