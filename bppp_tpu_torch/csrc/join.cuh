// Joining the partial sums of the threads that share a lane, in shared memory.
//
// K3, K4, K8 and K9 give one lane several threads ("slots"), each summing
// its own part of the lane's terms. A block holds `lpb` lanes x `n` slots;
// thread (slot s, lane l) calls join_slots with its partial sum, and
// afterwards slot 0 holds the lane's total. The join is a fixed tree of
// complete adds: while m > 1 slots are left, h = ceil(m / 2) and slot
// s < m - h adds slot s + h to its own; the CPU tests of the four kernels
// mirror this order. Every
// thread of the block must call it, lanes past the batch's end too: it
// synchronises the block.
//
// Shared layout: (n / 2) partials per lane, word-major — word k of the
// partial in place i of lane l at sh[(k * (n / 2) + i) * lpb + l] — so the
// lanes of a warp hit consecutive banks.
#pragma once

#include "field.cuh"

namespace bppp {

// 32-bit words of shared memory join_slots needs for n slots of lpb lanes
__host__ __device__ constexpr int join_words(int n, int lpb) { return 24 * (n / 2) * lpb; }

__device__ __forceinline__ void sh_store_pt(uint32_t* p, int stride, const pt& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p[k * stride] = a.x.v[k];
    p[(8 + k) * stride] = a.y.v[k];
    p[(16 + k) * stride] = a.z.v[k];
  }
}

__device__ __forceinline__ pt sh_load_pt(const uint32_t* p, int stride) {
  pt a;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    a.x.v[k] = p[k * stride];
    a.y.v[k] = p[(8 + k) * stride];
    a.z.v[k] = p[(16 + k) * stride];
  }
  return a;
}

__device__ __forceinline__ void join_slots(uint32_t* sh, pt* acc, int slot, int n, int lane,
                                           int lpb) {
  const int stride = (n / 2) * lpb;
#pragma unroll 1
  for (int m = n; m > 1; m = (m + 1) >> 1) {
    const int h = (m + 1) >> 1;  // slots [h, m) fold into [0, m - h)
    if (slot >= h && slot < m) sh_store_pt(sh + (slot - h) * lpb + lane, stride, *acc);
    __syncthreads();
    if (slot < m - h) {
      pt o = sh_load_pt(sh + slot * lpb + lane, stride);
      pt_add(acc, acc, &o);
    }
    __syncthreads();
  }
}

}  // namespace bppp
