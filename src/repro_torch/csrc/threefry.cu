// The threefry PRNG on Hopper (sm_90a): one threefry PRNG.bits call of K
// keys in one launch.
//
//   split:  new_key = threefry(key, (0, 0)),  sub = threefry(key, (0, 1))
//   words:  out[k, i] = (b1 ^ b2) >> shift,  (b1, b2) = threefry(sub, (i >> 32, i & M32))
//
// (without split, sub is the key itself and the key is copied to new_key).
// Replaces the threefry branch of repro/core/prng.py:PRNG.bits (jax.random
// split and bits, which XLA compiles on the TPU; no Pallas kernel) and the
// jax.random.bernoulli draws of repro/core/dtm.py:DTMEngine.program, which
// the port ran as torch elementwise passes (about 130 of them a call).
// Threefry-2x32 has 20 rounds: rotations 13 15 26 6 on even groups of four
// and 17 29 16 24 on odd ones, ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), ks[(g+1)%3]
// into x0 and ks[(g+2)%3] + g + 1 into x1 after group g.  Keys and words
// are int64 tensors holding uint32 values; the words' layout is [K, size],
// as the plain version lays them out.
//
// Bound: 74 32-bit integer instructions a word (20 rounds of an add, a
// funnel-shift rotate and an xor, six two-add key injections, the output xor
// and the shift) against 8 bytes a word written.  The adds, rotates and xors
// spread over more than one pipe, so the SM's issue rate (4 warp
// instructions a clock, 33.4 T/s) is their limit: 2.2 ns per thousand words,
// below the bytes' 2.4 ns, so the words' bytes bound it.  Design:
// one thread per word, a grid-stride loop over a grid capped at 8 blocks of
// 256 an SM (about a dozen words a thread at the program draw, one at a flat
// step's selection draw); each thread forms the subkey itself in registers
// (one threefry evaluation, no barrier), and each program's thread 0 of block
// 0 also forms and stores the new key.  The new keys go to their own tensor:
// an in-place write would race the threads that still read the key.
// Neighbouring threads store neighbouring words (coalesced 8-byte stores).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSms = 132;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    threefry_words(const int64_t* __restrict__ keys, int64_t* __restrict__ new_keys,
                   int64_t* __restrict__ out, long long size, int shift) {
  const int k = blockIdx.y;
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * k]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * k + 1]);
  uint32_t s0 = k0, s1 = k1;
  if (kSplit) {
    s0 = 0u;
    s1 = 1u;
    threefry2x32(k0, k1, s0, s1);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    uint32_t n0 = k0, n1 = k1;
    if (kSplit) {
      n0 = 0u;
      n1 = 0u;
      threefry2x32(k0, k1, n0, n1);
    }
    new_keys[2 * k] = static_cast<int64_t>(n0);
    new_keys[2 * k + 1] = static_cast<int64_t>(n1);
  }
  int64_t* dst = out + static_cast<long long>(k) * size;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < size;
       i += stride) {
    uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32);
    uint32_t x1 = static_cast<uint32_t>(i);
    threefry2x32(s0, s1, x0, x1);
    dst[i] = static_cast<int64_t>((x0 ^ x1) >> shift);
  }
}

}  // namespace

extern "C" int dtm_threefry_bits(const void* keys, void* new_keys, void* out, int K,
                                 long long size, int shift, int split, void* stream) {
  if (K < 1 || K > 65535 || size < 0 || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (size + kThreads - 1) / kThreads;
  if (blocks > kSms * kBlocksPerSm) blocks = kSms * kBlocksPerSm;
  if (blocks < 1) blocks = 1;  // the new keys are written at any size
  const dim3 grid(static_cast<unsigned>(blocks), K);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* k64 = static_cast<const int64_t*>(keys);
  auto* n64 = static_cast<int64_t*>(new_keys);
  auto* o64 = static_cast<int64_t*>(out);
  if (split)
    threefry_words<true><<<grid, kThreads, 0, st>>>(k64, n64, o64, size, shift);
  else
    threefry_words<false><<<grid, kThreads, 0, st>>>(k64, n64, o64, size, shift);
  return static_cast<int>(cudaGetLastError());
}
