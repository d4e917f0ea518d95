// The paper's lfsr PRNG cluster on Hopper (sm_90a): every cycle of one
// PRNG.bits call in one launch.
//
//   for c in [0, steps):  lanes <- galois(lanes); cycles += 1;
//                         if seed_refresh and cycles >= 2^L - 1:
//                             master <- xorshift32(master)
//                             lanes[i] <- splitmix32(master ^ i) & mask (0 -> 1)
//                             cycles <- 0
//                         out[k, c·n + i] = word(lanes[i])   (for c·n + i < size)
//
// Replaces the lfsr branch of repro/core/prng.py:PRNG.bits (a lax.scan over
// cluster_next that XLA compiles on the TPU; no Pallas kernel), which the
// port ran as a Python loop of about 15 torch operations a cycle.  k is the
// program axis of a bank (blockIdx.y).  The state is int64 tensors holding
// uint32 values (lanes [K, n], master [K], cycles [K]); the words are int64
// holding rand_bits-wide values, cycle-major, as the plain loop lays them
// out.  uint32_t arithmetic wraps as the plain version's int64 arithmetic
// masked to 32 bits does; cycles stay 64-bit, as in the plain version.
//
// Bound: a lane is a serial chain, one Galois step a cycle, so the least
// time is the larger of the words' bytes (8 a word) over the memory rate and
// `steps` dependent steps of one lane (dtm_lfsr_chain_probe measures the
// clocks of one step).  Design: one thread per (program, lane), the cycles
// in a register loop, 64 threads a block so that 8192 lanes spread over 128
// SMs; each cycle's store is coalesced (neighbouring lanes, neighbouring
// words).  The inner loop is a Galois step and an unguarded store:
//  * The refresh is uniform per program (block) and due at a cycle count
//    known in advance, so the inner loop runs up to it and the refresh
//    runs outside (a count test inside the loop made it 2.4x slower); a
//    call with no refresh due, as every call at 24 bits, runs the inner
//    loop alone.  Every thread advances its own copy of the master
//    register, so no thread waits on another; thread 0 of each program
//    writes master and cycles back.
//  * Only the call's last cycle can pass size, so it is peeled off.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  uint32_t z = (x ^ (x >> 16)) * 0x21F0AAADu;
  z = (z ^ (z >> 15)) * 0x735A2D97u;
  return z ^ (z >> 15);
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  return x ^ (x << 5);
}

__device__ __forceinline__ uint32_t galois(uint32_t x, uint32_t taps) {
  const uint32_t s = x >> 1;
  return (x & 1u) ? (s ^ taps) : s;
}

// A lane's fresh seed after a refresh: splitmix32(master ^ lane), masked
// to the width, 0 mapped to 1.
__device__ __forceinline__ uint32_t reseed(uint32_t m, int i, uint32_t lane_mask) {
  const uint32_t f = splitmix32(m ^ static_cast<uint32_t>(i)) & lane_mask;
  return f ? f : 1u;
}

// `run` plain Galois steps of a lane, each cycle's word stored at idx
// (advanced by n a cycle).  No bounds test: only the call's last cycle can
// pass size, and the kernel peels it off (a guarded store compiled to a
// branch and a convergence barrier per store, and 1.5x the time).
__device__ __forceinline__ uint32_t plain_cycles(uint32_t lane, uint32_t taps, int run,
                                                 long long& idx, int n, int64_t* dst,
                                                 int up, int down, uint32_t word_mask) {
  for (int j = 0; j < run; ++j, idx += n) {
    lane = galois(lane, taps);
    dst[idx] = static_cast<int64_t>(((lane << up) >> down) & word_mask);
  }
  return lane;
}

template <bool kRefresh>
__global__ void __launch_bounds__(kThreads)
    lfsr_cycles(const int64_t* __restrict__ lanes, const int64_t* __restrict__ master,
                const int64_t* __restrict__ cycles, int64_t* __restrict__ out,
                int64_t* __restrict__ lanes_out, int64_t* __restrict__ master_out,
                int64_t* __restrict__ cycles_out, int n, long long size, int steps,
                uint32_t taps, int width, int rand_bits) {
  const int k = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t lane = static_cast<uint32_t>(lanes[static_cast<long long>(k) * n + i]);
  uint32_t m = static_cast<uint32_t>(master[k]);
  long long cyc = cycles[k];
  // width 32: a 32-bit shift by 32 is undefined, so the masks are spelled out
  const long long period = (1LL << width) - 1;
  const uint32_t lane_mask = width >= 32 ? 0xffffffffu : (1u << width) - 1u;
  const uint32_t word_mask = rand_bits >= 32 ? 0xffffffffu : (1u << rand_bits) - 1u;
  const int up = rand_bits > width ? rand_bits - width : 0;    // zero-extend
  const int down = width > rand_bits ? width - rand_bits : 0;  // truncate
  int64_t* dst = out + static_cast<long long>(k) * size;
  long long idx = i;
  // the cycles before the last, whose words all lie below size
  const int full = steps - 1;
  int c = 0;
  if (!kRefresh || period - cyc > steps) {
    // no refresh falls within the call (always so at 24 bits and above)
    lane = plain_cycles(lane, taps, full, idx, n, dst, up, down, word_mask);
    c = full;
    cyc += full;
  }
  while (c < full) {
    // cycle c + j counts cyc + j + 1: the refresh fires at the first j
    // where that reaches the period; the cycles before it are plain steps
    const long long plain = period - cyc > 1 ? period - cyc - 1 : 0;
    const int run = static_cast<int>(plain < full - c ? plain : full - c);
    lane = plain_cycles(lane, taps, run, idx, n, dst, up, down, word_mask);
    c += run;
    cyc += run;
    if (c < full) {  // the refreshing cycle: its Galois step is overwritten
      m = xorshift32(m);
      lane = reseed(m, i, lane_mask);
      cyc = 0;
      dst[idx] = static_cast<int64_t>(((lane << up) >> down) & word_mask);
      ++c;
      idx += n;
    }
  }
  // the last cycle, its word stored only below size
  if (kRefresh && cyc + 1 >= period) {
    m = xorshift32(m);
    lane = reseed(m, i, lane_mask);
    cyc = 0;
  } else {
    lane = galois(lane, taps);
    ++cyc;
  }
  if (idx < size) dst[idx] = static_cast<int64_t>(((lane << up) >> down) & word_mask);
  lanes_out[static_cast<long long>(k) * n + i] = static_cast<int64_t>(lane);
  if (i == 0) {
    master_out[k] = static_cast<int64_t>(m);
    cycles_out[k] = cyc;
  }
}

// One warp runs `iters` dependent Galois steps per lane between two clock64
// reads; clocks[0] gets the clocks lane 0 saw.  sink keeps the chain live.
__global__ void lfsr_chain_probe(uint32_t taps, int iters, long long* clocks,
                                 uint32_t* sink) {
  uint32_t lane = threadIdx.x + 1u;
  const long long t0 = clock64();
#pragma unroll 4
  for (int c = 0; c < iters; ++c) lane = galois(lane, taps);
  const long long t1 = clock64();
  sink[threadIdx.x] = lane;
  if (threadIdx.x == 0) clocks[0] = t1 - t0;
}

}  // namespace

extern "C" int dtm_lfsr_bits(const void* lanes, const void* master, const void* cycles,
                             void* out, void* lanes_out, void* master_out,
                             void* cycles_out, int K, int n, long long size, int steps,
                             unsigned taps, int width, int rand_bits, int refresh,
                             void* stream) {
  if (K < 1 || K > 65535 || n < 1 || steps < 1 || width < 1 || width > 32 ||
      rand_bits < 1 || rand_bits > 32 || static_cast<long long>(steps) * n < size ||
      static_cast<long long>(steps - 1) * n >= size)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, K);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l64 = static_cast<const int64_t*>(lanes);
  const auto* m64 = static_cast<const int64_t*>(master);
  const auto* c64 = static_cast<const int64_t*>(cycles);
  auto* o64 = static_cast<int64_t*>(out);
  auto* lo = static_cast<int64_t*>(lanes_out);
  auto* mo = static_cast<int64_t*>(master_out);
  auto* co = static_cast<int64_t*>(cycles_out);
  if (refresh)
    lfsr_cycles<true><<<grid, kThreads, 0, st>>>(l64, m64, c64, o64, lo, mo, co, n, size,
                                                 steps, taps, width, rand_bits);
  else
    lfsr_cycles<false><<<grid, kThreads, 0, st>>>(l64, m64, c64, o64, lo, mo, co, n, size,
                                                  steps, taps, width, rand_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtm_lfsr_chain_probe(unsigned taps, int iters, void* clocks, void* sink,
                                    void* stream) {
  if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  lfsr_chain_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      taps, iters, static_cast<long long*>(clocks), static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
