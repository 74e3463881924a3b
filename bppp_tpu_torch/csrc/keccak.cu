// K1 — Keccak-f[1600] on a byte-per-element sponge state: 25 threads per
// sponge, or one where the batch fills the card.
//
// Replaces bppp_tpu/ops/pallas_keccak.py::_f1600_kernel (f1600_flat). The
// state arrives as the port's int64 tensor (200, *batch), one byte per
// element, read where it lies: byte i of lane b at in[i * byte_stride +
// b * lane_stride]. The result is written as a contiguous (200, B) int64
// tensor. So a call is one launch, with no narrowing or widening pass.
//
// Bound on an H100: bytes. A lane moves 2 * 200 * 8 B (int64 bytes in and
// out) and does about 24 * 216 64-bit logic operations; at the card's
// rates the traffic costs more. What holds a sponge back at the paths'
// 1,024 lanes is the series of 24 rounds: one thread per sponge runs about
// 3,600 dependent operations in a row on a few SMs.
//
// So f1600_kernel shares a sponge among 25 threads, one 64-bit word each
// (the TPU kernel split each word into u32 halves; Hopper has 64-bit
// integer registers). A block holds lpb sponges, word-major: thread t =
// w * lpb + s owns word w of sponge s, so the threads of a warp hold one
// word (or a few) of consecutive sponges, and their loads, stores and
// shared accesses fall on consecutive lanes. One round, per thread:
//
//   theta  the word goes to shared memory (A); after a barrier the five
//          threads of row 0 xor the columns into shared memory (C), and
//          after a second one every thread reads the two parities it needs
//          (W_THETA_L, W_THETA_R) and xors D into its word;
//   rho    one rotation by the thread's own constant (ROTATIONS);
//   pi     a store to the permuted slot of a second buffer (B, W_PI);
//   chi    after a third barrier, its own slot and the two neighbours of
//          the row (W_CHI1, W_CHI2) read back from B;
//   iota   on word 0.
//
// Three block barriers per round, 5 shared loads and 2 stores per thread
// (the five threads of row 0 5 loads and a store more). A and B alternate,
// so a thread writes A only after the barrier that ends every read of A.
// Once the card is full the shared traffic is what bounds the 25 threads
// (about 1.6 KB a sponge a round); reading both columns in every thread
// for theta, 10 loads behind two barriers, measured slower from 4,096
// lanes up, and one warp a sponge exchanging words by shuffle slower at
// every path's batch (PERF.md). Above cuda_keccak.K1_LANE_ABOVE lanes f1600_lane_kernel runs
// instead: one thread a sponge, its 25 words in registers, no shared
// memory, which the sweep measured faster there.
//
// Which thread handles which word: the per-thread constants below are
// written by ops/cuda_keccak.py::thread_constants from oracle/keccak.py's
// tables, and a unit test parses them back and runs the same schedule in
// numpy against the oracle.
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

// Copied from oracle/keccak.py; a unit test parses both arrays and holds
// them equal to the Python ones.
__constant__ uint64_t ROUND_CONSTANTS[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

// The thread of word w = x + 5 y: rho's rotation of the word (the oracle's
// ROTATIONS, indexed by lane), the slot pi moves it to, the two columns
// theta reads (x - 1 and x + 1), and the two row neighbours chi reads
// (x + 1 and x + 2 of row y).
__constant__ uint32_t ROTATIONS[25] = {
    0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
__constant__ uint32_t W_PI[25] = {
    0, 10, 20, 5, 15, 16, 1, 11, 21, 6, 7, 17, 2, 12, 22, 23, 8, 18, 3, 13, 14, 24, 9, 19, 4};
__constant__ uint32_t W_THETA_L[25] = {
    4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3};
__constant__ uint32_t W_THETA_R[25] = {
    1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0};
__constant__ uint32_t W_CHI1[25] = {
    1, 2, 3, 4, 0, 6, 7, 8, 9, 5, 11, 12, 13, 14, 10, 16, 17, 18, 19, 15, 21, 22, 23, 24, 20};
__constant__ uint32_t W_CHI2[25] = {
    2, 3, 4, 0, 1, 7, 8, 9, 5, 6, 12, 13, 14, 10, 11, 17, 18, 19, 15, 16, 22, 23, 24, 20, 21};

constexpr int WORDS = 25;
constexpr int MAX_LPB = 32;  // 800 threads a block

__device__ __forceinline__ uint64_t rotl64(uint64_t v, uint32_t n) {
  return (v << n) | (v >> ((64u - n) & 63u));
}

// The xor of column x of A: words x, x + 5, ..., x + 20 of sponge s.
__device__ __forceinline__ uint64_t column(const uint64_t* a, uint32_t x, int lpb, int s) {
  return a[x * lpb + s] ^ a[(x + 5) * lpb + s] ^ a[(x + 10) * lpb + s] ^ a[(x + 15) * lpb + s] ^
         a[(x + 20) * lpb + s];
}

__device__ __forceinline__ uint64_t load_word(const int64_t* in, long long byte_stride,
                                              long long lane_stride, int w, long long lane) {
  const int64_t* p = in + (long long)(8 * w) * byte_stride + lane * lane_stride;
  uint64_t a = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) a |= (uint64_t)(p[k * byte_stride] & 0xFF) << (8 * k);
  return a;
}

__device__ __forceinline__ void store_word(int64_t* out, int B, int w, long long idx, uint64_t a) {
  int64_t* p = out + (long long)(8 * w) * B + idx;
#pragma unroll
  for (int k = 0; k < 8; k++) p[(long long)k * B] = (int64_t)((a >> (8 * k)) & 0xFF);
}

// Threads past 25 * lpb (the block is whole warps) and sponges past the
// batch's end run along on the last lane, so that every thread reaches
// each barrier; they store nothing.
__global__ void __launch_bounds__(WORDS * MAX_LPB)
    f1600_kernel(const int64_t* __restrict__ in, long long byte_stride, long long lane_stride,
                 int64_t* __restrict__ out, int B, int lpb) {
  extern __shared__ uint64_t sh[];
  uint64_t* sa = sh;                    // word w of sponge s at sa[w * lpb + s]
  uint64_t* sb = sh + WORDS * lpb;      // the same after rho and pi
  uint64_t* sc = sh + 2 * WORDS * lpb;  // column x's parity at sc[x * lpb + s]
  const int t = threadIdx.x;
  const bool in_block = t < WORDS * lpb;
  const int w = in_block ? t / lpb : 0;
  const int s = in_block ? t - w * lpb : 0;
  const long long idx = (long long)blockIdx.x * lpb + s;
  const bool live = in_block && idx < B;
  const long long lane = idx < B ? idx : B - 1;

  uint64_t a = load_word(in, byte_stride, lane_stride, w, lane);
  const uint32_t rot = ROTATIONS[w], pi = W_PI[w], tl = W_THETA_L[w], tr = W_THETA_R[w];
  const uint32_t c1 = W_CHI1[w], c2 = W_CHI2[w];
#pragma unroll 1
  for (int rnd = 0; rnd < 24; rnd++) {
    if (in_block) sa[t] = a;
    __syncthreads();
    if (in_block && w < 5) sc[t] = column(sa, w, lpb, s);
    __syncthreads();
    if (in_block) {
      a ^= sc[tl * lpb + s] ^ rotl64(sc[tr * lpb + s], 1);
      sb[pi * lpb + s] = rotl64(a, rot);
    }
    __syncthreads();
    if (in_block) {
      a = sb[t] ^ (~sb[c1 * lpb + s] & sb[c2 * lpb + s]);
      if (w == 0) a ^= ROUND_CONSTANTS[rnd];
    }
  }
  if (live) store_word(out, B, w, idx, a);
}

// One thread per sponge, its 25 words in registers for all 24 rounds.
__global__ void f1600_lane_kernel(const int64_t* __restrict__ in, long long byte_stride,
                                  long long lane_stride, int64_t* __restrict__ out, int B) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B) return;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = load_word(in, byte_stride, lane_stride, i, idx);
#pragma unroll 1
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
    }
    uint64_t b[25];
#pragma unroll
    for (int x = 0; x < 5; x++)
#pragma unroll
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], ROTATIONS[x + 5 * y]);
#pragma unroll
    for (int y = 0; y < 5; y++)
#pragma unroll
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= ROUND_CONSTANTS[rnd];
  }
#pragma unroll
  for (int i = 0; i < 25; i++) store_word(out, B, i, idx, a[i]);
}

}  // namespace

#ifdef __CUDACC__
// in: int64 bytes, byte i of lane b at in[i * byte_stride + b * lane_stride];
// out: (200, B) contiguous int64. nthr threads per sponge: 25 (lpb sponges
// a block, 1 <= lpb <= 32, in blocks of whole warps) or 1 (lpb threads a
// block). Returns cudaGetLastError().
extern "C" int bppp_f1600(const void* in, long long byte_stride, long long lane_stride, void* out,
                          int B, int nthr, int lpb, void* stream) {
  if (B <= 0) return 0;
  const int64_t* x = (const int64_t*)in;
  int64_t* o = (int64_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = (B + lpb - 1) / lpb;
  if (nthr == WORDS && lpb >= 1 && lpb <= MAX_LPB) {
    f1600_kernel<<<grid, (WORDS * lpb + 31) / 32 * 32, (2 * WORDS + 5) * lpb * sizeof(uint64_t),
                   st>>>(x, byte_stride, lane_stride, o, B, lpb);
  } else if (nthr == 1 && lpb >= 1 && lpb <= 1024) {
    f1600_lane_kernel<<<grid, lpb, 0, st>>>(x, byte_stride, lane_stride, o, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif
