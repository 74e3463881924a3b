// K1 — Keccak-f[1600] on a byte-per-element sponge state.
//
// Replaces bppp_tpu/ops/pallas_keccak.py::_f1600_kernel (f1600_flat). The
// state arrives as (200, B) 32-bit words holding one byte each, batch axis
// last. One thread owns one lane: it packs its 200 bytes into 25 uint64_t
// lanes held in registers (the TPU kernel had to split each lane into two
// u32 halves; Hopper has 64-bit integer registers), runs the 24 rounds, and
// unpacks. Loads and stores are coalesced over the batch axis.
//
// Bound on an H100: bytes. The call moves 2 * 200 * 4 B per lane and does
// about 24 * 25 * 6 64-bit logic operations per lane; at the card's memory
// rate the traffic costs more than the arithmetic, and most of it is the
// byte-per-word storage format, which the transcript layer fixes.
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

// rho rotation offsets indexed by lane (x + 5*y)
__constant__ uint32_t ROTATIONS[25] = {
    0,  1,  62, 28, 27,
    36, 44, 6,  55, 20,
    3,  10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2,  61, 56, 14};

__device__ __forceinline__ uint64_t rotl64(uint64_t v, uint32_t n) {
  n &= 63u;
  return n ? (v << n) | (v >> (64u - n)) : v;
}

__global__ void f1600_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int B) {
  size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)B) return;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) {
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; k++)
      v |= (uint64_t)(in[(size_t)(8 * i + k) * B + lane] & 0xFFu) << (8 * k);
    a[i] = v;
  }
#pragma unroll 1
  for (int rnd = 0; rnd < 24; rnd++) {
    // theta
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
    }
    // rho + pi: B[y, 2x + 3y] = rot(A[x, y], r[x, y])
    uint64_t b[25];
#pragma unroll
    for (int x = 0; x < 5; x++)
#pragma unroll
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], ROTATIONS[x + 5 * y]);
    // chi
#pragma unroll
    for (int y = 0; y < 5; y++)
#pragma unroll
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    // iota
    a[0] ^= ROUND_CONSTANTS[rnd];
  }
#pragma unroll
  for (int i = 0; i < 25; i++)
#pragma unroll
    for (int k = 0; k < 8; k++)
      out[(size_t)(8 * i + k) * B + lane] = (uint32_t)(a[i] >> (8 * k)) & 0xFFu;
}

}  // namespace

#ifdef __CUDACC__
// in, out: (200, B) 32-bit words, contiguous. Returns cudaGetLastError().
extern "C" int bppp_f1600(const void* in, void* out, int B, void* stream) {
  if (B <= 0) return 0;
  f1600_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, B);
  return (int)cudaGetLastError();
}
#endif
