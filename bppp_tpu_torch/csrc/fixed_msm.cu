// K3 — fixed-base windowed MSM: sum_i [s_i] G_i per lane over F fixed
// generators, from precomputed affine window tables.
//
// Replaces bppp_tpu/ops/pallas_fixed_base.py::_fixed_msm_kernel
// (fixed_msm_sum_flat). The table is one array of 32-bit words, laid out
// [window][generator][entry][x words 0..7 | y words 0..7] (64 bytes an
// entry), entry d of window w of generator i holding the affine point
// [d * 2^(w*W)] G_i, entry 0 all-zero (the identity sentinel). One thread
// owns one lane: for every generator it loads its scalar, peels W-bit digits
// off the low end, loads the entry by index (the TPU kernel selected it with
// a one-hot matrix product over byte-split rows) and folds it in with one
// incomplete mixed add. No doubles at all. The accumulator stays in
// registers across the generator loop, so the kernel emits the finished sum.
//
// Bound on an H100: operations. F * ceil(256 / W) mixed adds of 11 modular
// multiplies per lane; the table (26 MB at W = 8, F = 49) is shared by all
// lanes and fits the L2 cache, each lane reads F * ceil(256 / W) * 64 bytes
// of it.
#include "field.cuh"

namespace {

using namespace bppp;

__global__ void fixed_msm_kernel(const uint32_t* __restrict__ tab, const uint32_t* __restrict__ sc,
                                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                 uint32_t* __restrict__ oz, int F, int B, int W, int NW) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  const uint32_t mask = (1u << W) - 1u;
  pt acc = pt_identity();
#pragma unroll 1
  for (int f = 0; f < F; f++) {
    // scalars are (16, F, B): limb i of generator f at sc[(i * F + f) * B + lane]
    fe k = fe_load(sc + (size_t)f * B, (size_t)F * B, lane);
#pragma unroll 1
    for (int w = 0; w < NW; w++) {
      uint32_t d = k.v[0] & mask;
#pragma unroll
      for (int j = 0; j < 7; j++) k.v[j] = (k.v[j] >> W) | (k.v[j + 1] << (32 - W));
      k.v[7] >>= W;
      const uint4* e =
          (const uint4*)(tab + ((((size_t)w * F + f) << W) + d) * 16);
      uint4 e0 = __ldg(e), e1 = __ldg(e + 1), e2 = __ldg(e + 2), e3 = __ldg(e + 3);
      fe qx, qy;
      qx.v[0] = e0.x; qx.v[1] = e0.y; qx.v[2] = e0.z; qx.v[3] = e0.w;
      qx.v[4] = e1.x; qx.v[5] = e1.y; qx.v[6] = e1.z; qx.v[7] = e1.w;
      qy.v[0] = e2.x; qy.v[1] = e2.y; qy.v[2] = e2.z; qy.v[3] = e2.w;
      qy.v[4] = e3.x; qy.v[5] = e3.y; qy.v[6] = e3.z; qy.v[7] = e3.w;
      pt_add_mixed_inc(&acc, &acc, &qx, &qy);
    }
  }
  pt_store(ox, oy, oz, B, lane, acc);
}

}  // namespace

#ifdef __CUDACC__
// tab: (NW, F, 2^W, 16) words; sc: (16, F, B) limb words; outputs (16, B).
// W in [1, 16]; NW = ceil(256 / W). Returns cudaGetLastError().
extern "C" int bppp_fixed_msm(const void* tab, const void* sc, void* ox, void* oy, void* oz, int F,
                              int B, int W, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 16 || F < 1) return (int)cudaErrorInvalidValue;
  int NW = (256 + W - 1) / W;
  fixed_msm_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tab, (const uint32_t*)sc, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, F, B,
      W, NW);
  return (int)cudaGetLastError();
}
#endif
