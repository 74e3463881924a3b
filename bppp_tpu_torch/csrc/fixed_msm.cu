// K3 — fixed-base windowed MSM: sum_f [s_f] G_f per lane over F fixed
// generators, from precomputed affine window tables.
//
// Replaces bppp_tpu/ops/pallas_fixed_base.py::_fixed_msm_kernel
// (fixed_msm_sum_flat). The table is one array of 32-bit words, laid out
// [window][generator][entry][x words 0..7 | y words 0..7] (64 bytes an
// entry) over Ftab generators, entry d of window w of generator g holding the
// affine point [d * 2^(w*W)] G_g, entry 0 all-zero (the identity sentinel).
// The call walks F of those generators: rows[f] names the table row of
// scalar f, or, with no row index, f itself. So a caller that sums over a
// subset of the generators reads the one table by index and copies nothing.
//
// A lane's sum is F * NW independent terms T[w][f][digit]: no doubles at all,
// one incomplete mixed add each (the TPU kernel selected the entries with a
// one-hot matrix product over byte-split rows; here they are loaded by index).
// Work is split so that 1024 lanes fill the card: a lane has S threads
// ("slices"), slice s walking the terms t = f * NW + w in [s*T/S, (s+1)*T/S),
// T = F * NW. A block is 32 lanes x n slices (n = min(S, 4)): a warp is 32
// consecutive lanes on the same term, so the scalar limb loads coalesce over
// the batch axis and the 32 entry loads fall in one 16 KB window row. Each
// slice leaves its partial sum in a scratch buffer, and a second launch joins
// the S partials of a lane with complete adds: slot s of n2 = min(S, 8) sums
// the partials s, s + n2, ... in order, then the slots join in shared memory
// (join.cuh). The join is a kernel of its own because the complete add needs
// more registers than the walk: inside the walk it cut the walk to half the
// resident warps. The wrapper chooses S from B and F
// (`cuda_fixed_base.slice_count`) and the kernels take it as an argument;
// S = 1 writes the sum straight out.
//
// Bound on an H100: operations. F * NW mixed adds of 11 modular multiplies
// per lane (those of the nonzero digits); the table (26 MB at W = 8, F = 49)
// is shared by all lanes and fits the L2 cache. One thread per lane walked
// all F * NW adds in series on 8 of the 132 SMs at B = 1024; S = 32 slices
// cut the series to 49 adds plus a join of 7 and spread it over the whole
// card (S = 64 halves the walk's series but, the card being full, not its
// time, and lengthens the join: measured slower).
#include "join.cuh"

namespace {

using namespace bppp;

constexpr int LANES = 32;       // lanes per block: one warp's worth
constexpr int WALK_SLICES = 4;  // slices per block of the walk
constexpr int JOIN_SLOTS = 8;   // slots per lane of the join

__device__ __forceinline__ void pt_store_part(uint32_t* part, long long s, int B, size_t lane,
                                              const pt& a) {
  uint32_t* p = part + (size_t)s * 48 * B;
  pt_store(p, p + (size_t)16 * B, p + (size_t)32 * B, B, lane, a);
}

// four blocks of 128 threads per SM: at most 128 registers, 16 resident warps
__global__ void __launch_bounds__(LANES * WALK_SLICES, 4)
    fixed_msm_kernel(const uint32_t* __restrict__ tab, const int* __restrict__ rows,
                     const uint32_t* __restrict__ sc, uint32_t* __restrict__ ox,
                     uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                     uint32_t* __restrict__ part, int F, int Ftab, int B, int W, int NW, int S) {
  const size_t lane = (size_t)blockIdx.x * LANES + threadIdx.x;
  if (lane >= (size_t)B) return;
  const long long T = (long long)F * NW;
  const long long s = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  const long long lo = s * T / S, hi = (s + 1) * T / S;
  const uint32_t mask = (1u << W) - 1u;
  const size_t limb = (size_t)F * B;  // scalars are (16, F, B)
  pt acc = pt_identity();
#pragma unroll 1
  for (long long t = lo; t < hi; t++) {
    const int f = (int)(t / NW), w = (int)(t - (long long)f * NW);
    // digit w: bits [w * W, w * W + W) of scalar f, across at most two limbs
    const int bit = w * W, li = bit >> 4, off = bit & 15;
    const uint32_t* col = sc + (size_t)f * B + lane;
    uint32_t v = col[li * limb] >> off;
    if (off + W > 16 && li + 1 < 16) v |= col[(li + 1) * limb] << (16 - off);
    const uint32_t d = v & mask;
    if (d == 0) continue;
    const int row = rows ? __ldg(rows + f) : f;
    const uint4* e = (const uint4*)(tab + ((((size_t)w * Ftab + row) << W) + d) * 16);
    uint4 e0 = __ldg(e), e1 = __ldg(e + 1), e2 = __ldg(e + 2), e3 = __ldg(e + 3);
    fe qx, qy;
    qx.v[0] = e0.x; qx.v[1] = e0.y; qx.v[2] = e0.z; qx.v[3] = e0.w;
    qx.v[4] = e1.x; qx.v[5] = e1.y; qx.v[6] = e1.z; qx.v[7] = e1.w;
    qy.v[0] = e2.x; qy.v[1] = e2.y; qy.v[2] = e2.z; qy.v[3] = e2.w;
    qy.v[4] = e3.x; qy.v[5] = e3.y; qy.v[6] = e3.z; qy.v[7] = e3.w;
    pt_add_mixed_inc(&acc, &acc, &qx, &qy);
  }
  if (S == 1)
    pt_store(ox, oy, oz, B, lane, acc);
  else
    pt_store_part(part, s, B, lane, acc);
}

// The join of the S partials of each lane: slot t of a lane sums the partials
// t, t + n, t + 2n, ... in order, then the block joins its n slots.
__global__ void __launch_bounds__(LANES * JOIN_SLOTS)
    fixed_msm_join_kernel(const uint32_t* __restrict__ part, uint32_t* __restrict__ ox,
                          uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int S, int B) {
  extern __shared__ uint32_t sh[];
  const int l = threadIdx.x, slot = threadIdx.y, n = blockDim.y;
  const size_t lane = (size_t)blockIdx.x * LANES + l;
  const bool live = lane < (size_t)B;
  pt acc = pt_identity();
  if (live) {
#pragma unroll 1
    for (int g = slot; g < S; g += n) {
      const uint32_t* p = part + (size_t)g * 48 * B;
      pt q = pt_load(p, p + (size_t)16 * B, p + (size_t)32 * B, B, lane);
      pt_add(&acc, &acc, &q);
    }
  }
  join_slots(sh, &acc, slot, n, l, LANES);
  if (slot == 0 && live) pt_store(ox, oy, oz, B, lane, acc);
}

}  // namespace

#ifdef __CUDACC__
// tab: (NW, Ftab, 2^W, 16) words; rows: F int32 table rows, or null for rows
// 0..F-1; sc: (16, F, B) limb words; outputs (16, B); part: scratch of
// S * 48 * B words when S > 1, else unused. W in [1, 16]; NW = ceil(256 / W);
// S, the slices per lane, a power of two. Returns cudaGetLastError().
extern "C" int bppp_fixed_msm(const void* tab, const void* rows, const void* sc, void* ox,
                              void* oy, void* oz, void* part, int F, int Ftab, int B, int W, int S,
                              void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > 16 || F < 1 || Ftab < 1 || S < 1 || (S & (S - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (S > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const int NW = (256 + W - 1) / W;
  const int n = S < WALK_SLICES ? S : WALK_SLICES, n2 = S < JOIN_SLOTS ? S : JOIN_SLOTS;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((B + LANES - 1) / LANES, S / n);
  fixed_msm_kernel<<<grid, dim3(LANES, n), 0, st>>>(
      (const uint32_t*)tab, (const int*)rows, (const uint32_t*)sc, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, (uint32_t*)part, F, Ftab, B, W, NW, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  fixed_msm_join_kernel<<<grid.x, dim3(LANES, n2), join_words(n2, LANES) * sizeof(uint32_t), st>>>(
      (const uint32_t*)part, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, S, B);
  return (int)cudaGetLastError();
}
#endif
