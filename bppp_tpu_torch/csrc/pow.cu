// K2 — x^e mod p or mod n for a host-static exponent e.
//
// Replaces bppp_tpu/ops/pallas_msm.py::_pow_kernel (pow_const_flat): the
// whole exponentiation behind fp_inv (e = p - 2), fp_sqrt (e = (p+1)/4) and
// fn_inv (e = n - 2) in one launch. The host turns e into a step list once
// (ops/field.py::pow_chain): libsecp256k1's addition chains for p - 2 and
// (p+1)/4 (255 squares + 15 multiplies, 253 + 13), a chain over n's 127
// leading ones and a 4-bit sliding window below them for n - 2 (256 + 41),
// a sliding window of width 4 for any other e. Step s sets
// slot[dst] = slot[src]^(2^nsqr) * slot[mul] (no multiply for mul = 0xFF);
// slot 0 holds x. The list is passed by value, so every thread reads the
// same step at the same time. One thread owns one lane: its slots (at most
// POW_MAX_SLOTS elements) sit in its local memory, indexed
// by the step; the squares in between stay in registers and go through the
// dedicated square (fe_sqr: 36 word products where a multiply takes 64).
// The modulus is a template parameter, chosen once per launch. 0 maps to 0.
//
// The kernel reads the port's int64 limbs where they lie (a limb stride and
// a lane stride) and writes int64 limbs, so a call is this one launch.
//
// Bound on an H100: operations, 253-256 squares and 13-41 multiplies per
// lane for the named exponents against 256 bytes moved. At the paths'
// 1,024-14,336 lanes the card holds a few warps per SM and one lane's
// series of about 270 dependent modular products is the time.
#include "field.cuh"

namespace {

using namespace bppp;

constexpr int POW_MAX_STEPS = 80;
constexpr int POW_MAX_SLOTS = 10;

struct pow_prog {
  uint32_t step[POW_MAX_STEPS];  // dst | src << 8 | mul << 16 | nsqr << 24
  int n;                         // steps
  int result;                    // slot of x^e after the last step
};

template <bool IS_P>
__global__ void pow_kernel(const int64_t* __restrict__ x, long long x_limb, long long x_lane,
                           int64_t* __restrict__ out, int B, pow_prog prog) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fe slot[POW_MAX_SLOTS];
  slot[0] = fe_load64(x, x_limb, lane * x_lane);
#pragma unroll 1
  for (int s = 0; s < prog.n; s++) {
    const uint32_t w = prog.step[s];
    const int mul = (w >> 16) & 0xFF;
    const int nsqr = w >> 24;
    fe acc = slot[(w >> 8) & 0xFF];
#pragma unroll 1
    for (int k = 0; k < nsqr; k++) acc = fe_sqr<IS_P>(acc);
    if (mul != 0xFF) acc = fe_mul<IS_P>(acc, slot[mul]);
    slot[w & 0xFF] = acc;
  }
  fe_store64(out, B, lane, slot[prog.result]);
}

}  // namespace

#ifdef __CUDACC__
// x: int64 limbs, element i of lane b at x[i * x_limb + b * x_lane]; out:
// (16, B) contiguous int64. steps: nsteps packed steps (host memory); result:
// the slot of x^e; nslot: the slots the list uses (at most POW_MAX_SLOTS);
// is_p: 1 for the base field, 0 for the scalar field. Returns
// cudaGetLastError().
extern "C" int bppp_pow_const(const void* x, long long x_limb, long long x_lane, void* out, int B,
                              const uint32_t* steps, int nsteps, int result, int nslot, int is_p,
                              void* stream) {
  if (B <= 0) return 0;
  if (nsteps < 0 || nsteps > POW_MAX_STEPS || nslot < 1 || nslot > POW_MAX_SLOTS ||
      result < 0 || result >= nslot)
    return (int)cudaErrorInvalidValue;
  pow_prog prog;
  for (int i = 0; i < POW_MAX_STEPS; i++) {
    prog.step[i] = i < nsteps ? steps[i] : 0;
    if (i < nsteps) {
      const uint32_t w = steps[i], mul = (w >> 16) & 0xFF;
      if ((int)(w & 0xFF) >= nslot || (int)((w >> 8) & 0xFF) >= nslot ||
          (mul != 0xFF && (int)mul >= nslot))
        return (int)cudaErrorInvalidValue;
    }
  }
  prog.n = nsteps;
  prog.result = result;
  const int64_t* xi = (const int64_t*)x;
  int64_t* o = (int64_t*)out;
  const int grid = (B + 127) / 128;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_p) pow_kernel<true><<<grid, 128, 0, st>>>(xi, x_limb, x_lane, o, B, prog);
  else pow_kernel<false><<<grid, 128, 0, st>>>(xi, x_limb, x_lane, o, B, prog);
  return (int)cudaGetLastError();
}
#endif
