// Batched TA update (the paper's Alg 5) on Hopper (sm_90a): three entry
// points, one tile body.
//
//   new_ta[k, r, c] = clip(ta + l_mask[c] · Σ_b delta_b(r, c), 0, n_states − 1)
//   delta_b = t1[b, r] · (cl∧lit ? +1 unless (!boost and rand < p_ta)
//                                : −1 if rand < p_ta)
//           + t2[b, r] · (cl ∧ ¬lit ∧ ¬include ? +1 : 0)
//   cl = clause[b, r], lit = literal c of batch row b, include = ta >= n_states/2
//   (of the state before the update).
//   new_inc[k, r, w] = the packed include bitplane of the updated rows.
//
// dtm_ta_update replaces repro/kernels/ta_update.py: ta_update (dense grid,
// new output tensors); dtm_ta_update_sparse replaces ta_update.py:
// ta_update_sparse (the Alg-6 compacted grid over the active 128-row
// clause groups listed in tile_idx), and updates those groups of ta and
// inc in place, so the groups left alone cost no traffic.  A slot at or
// past the program's count exits, so the host never reads the count; a
// slot that repeats an earlier slot's group exits too, so no group is
// updated twice.  dtm_ta_update_streamed replaces ta_update.py:
// ta_update_streamed, the streamed baseline of the in-kernel generator:
// the dense update, each TA's random word read from a pre-made
// rands[k, b, r, c] tensor (the same numbers), only where a Type I delta
// needs it; it is bound by the bytes of rands.  The other two make their
// random numbers in the kernel, one stream
// per TA keyed on key = (row0 + row) · stride + col (uint32), stride = L
// rounded up to 256: the JAX package's keying, so the states are bit
// for bit the reference's.  One stream step per batch row, whether or not
// that row gives the clause feedback.
//   counter: s = splitmix32(seed ^ key), then s = xorshift32(s), rand = s >> (32 − rand_bits)
//   lfsr:    lane = splitmix32(seed ^ key) & (2^L − 1) (nonzero); a Galois
//            shift per row; every 2^L − 1 rows (seed_refresh) the master
//            xorshifts and the lane reseeds from (master, key).
//
// Bound: integer operations.  Per TA of a clause row that gets feedback:
// a seed (key and splitmix32, 11 operations; lfsr 13), then per batch row
// a stream step (counter: xorshift32 and the shift out, 7; lfsr: the
// Galois shift, 4, the shift out, 1, and the refresh count, 2) and, where
// that row gives the clause feedback, the Alg-5 delta (6).  At the main
// path's shapes (R=2048, L=1664, 2B=64) the stream steps alone are ~1.5 G
// operations if every clause row gets feedback, against ~7.3 MB of
// states, literals and feedback.
// Design: one thread per TA, one warp per clause row and 32 columns, so
// each warp's new include word is one __ballot_sync.  The block (8 rows ×
// 32 columns) stages its literal word and its rows' feedback bits for all
// 2B batch rows in shared memory.  A clause row that gets no feedback from
// any batch row has a zero delta: its warp skips the stream entirely (the
// result is the same), so the work is what the data needs.  TA states are
// read and written in their own dtype (uint8, or int32 above 8 bits); a
// thread reads its state before it writes it, so in and out may be one
// buffer.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;    // one warp per clause row
constexpr int kThreads = kRowsPerBlock * 32;
constexpr int kGroup = 128;         // rows per compaction group
constexpr int kTilesPerGroup = kGroup / kRowsPerBlock;
constexpr int kKeyTile = 256;       // the stream-key stride granularity

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  uint32_t z = (x ^ (x >> 16)) * 0x21F0AAADu;
  z = (z ^ (z >> 15)) * 0x735A2D97u;
  return z ^ (z >> 15);
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

__device__ __forceinline__ uint32_t lfsr_seed(uint32_t master, uint32_t key, uint32_t mask) {
  const uint32_t s = splitmix32(master ^ key) & mask;
  return s == 0u ? 1u : s;
}

struct Params {   // per program: [seed, p_ta, boost, n_states, row0]
  uint32_t seed, p_ta, row0;
  int32_t n_states;
  bool boost;
};

struct Stream {   // static stream configuration
  int lfsr;       // 0 = counter, 1 = lfsr
  int lfsr_bits, seed_refresh, rand_bits;
  uint32_t taps;
};

// The random words of TA (r, c), made in the kernel: the stream is seeded
// from (seed, key) and advances one step per batch row.
struct InKernel {
  Stream s;

  struct Gen {
    Stream s;
    uint32_t st, master, cycles, key, lmask, rmask, rnd;

    __device__ __forceinline__ void step() {   // every batch row
      if (s.lfsr) {
        st = (st & 1u) ? ((st >> 1) ^ s.taps) : (st >> 1);
        if (s.seed_refresh && ++cycles >= lmask) {   // lmask = 2^L − 1, the period
          master = xorshift32(master);
          st = lfsr_seed(master, key, lmask);
          cycles = 0u;
        }
        uint32_t o = st;
        if (s.lfsr_bits < s.rand_bits) o <<= (s.rand_bits - s.lfsr_bits);
        else if (s.lfsr_bits > s.rand_bits) o >>= (s.lfsr_bits - s.rand_bits);
        rnd = o & rmask;
      } else {
        st = xorshift32(st);
        rnd = st >> (32 - s.rand_bits);
      }
    }

    __device__ __forceinline__ uint32_t word() const { return rnd; }
  };

  __device__ __forceinline__ Gen start(int, int r, int c, int L, const Params& p) const {
    const uint32_t stride = static_cast<uint32_t>((L + kKeyTile - 1) / kKeyTile * kKeyTile);
    Gen g;
    g.s = s;
    g.key = (p.row0 + static_cast<uint32_t>(r)) * stride + static_cast<uint32_t>(c);
    g.lmask = (s.lfsr_bits >= 32) ? 0xffffffffu : ((1u << s.lfsr_bits) - 1u);
    g.rmask = (s.rand_bits >= 32) ? 0xffffffffu : ((1u << s.rand_bits) - 1u);
    g.st = s.lfsr ? lfsr_seed(p.seed, g.key, g.lmask) : splitmix32(p.seed ^ g.key);
    g.master = p.seed;
    g.cycles = 0u;
    return g;
  }
};

// The random words of TA (r, c) of program k, read from a pre-made
// rands[k, b, r, c] (uint32 bit patterns; the streamed baseline).
struct Streamed {
  const uint32_t* rands;
  int B2, C;

  struct Gen {
    const uint32_t* base;   // rands[k, 0, r, c]
    long long stride, off;  // C·L; the offset of the current batch row

    __device__ __forceinline__ void step() { off += stride; }
    // read only where a Type I delta needs it
    __device__ __forceinline__ uint32_t word() const { return __ldg(base + off); }
  };

  __device__ __forceinline__ Gen start(int k, int r, int c, int L, const Params&) const {
    const long long row = static_cast<long long>(k) * B2 * C + r;
    const long long stride = static_cast<long long>(C) * L;
    return Gen{rands + row * L + c, stride, -stride};
  }
};

// Update TA (r, c) of program k; every lane of the warp calls this with
// the same r, and the lanes of columns >= L still take part in the ballot.
// Src supplies each batch row's random word (InKernel or Streamed): step()
// once per batch row, word() where a Type I delta reads it.
template <typename TA, typename Src>
__device__ void update_row(const TA* ta, TA* out, uint32_t* inc_out, int k, int r, int c, int L,
                           int W, long long row_off, long long inc_off, int B2,
                           const uint32_t* s_lit, const uint8_t* s_fb, bool active,
                           const int32_t* __restrict__ l_mask, const Params& p,
                           const Src& src) {
  const bool col_ok = c < L;
  const int32_t old = col_ok ? static_cast<int32_t>(ta[row_off + c]) : 0;
  const bool include = old >= (p.n_states >> 1);
  int32_t delta = 0;
  if (active && col_ok) {
    auto gen = src.start(k, r, c, L, p);
    const int bit = c & 31;
    for (int b = 0; b < B2; ++b) {
      gen.step();
      const uint8_t fb = s_fb[b];          // bit 0 clause, 1 type I, 2 type II
      if (fb & 6u) {
        const bool lit_on = (s_lit[b] >> bit) & 1u;
        const bool cl_and_lit = (fb & 1u) && lit_on;
        if (fb & 2u) {
          const bool low = gen.word() < p.p_ta;
          delta += cl_and_lit ? ((p.boost || !low) ? 1 : 0) : (low ? -1 : 0);
        }
        if ((fb & 4u) && (fb & 1u) && !lit_on && !include) delta += 1;
      }
    }
    delta *= __ldg(l_mask + c);
  }
  const int32_t v = min(max(old + delta, 0), p.n_states - 1);
  if (col_ok) out[row_off + c] = static_cast<TA>(v);
  const uint32_t word = __ballot_sync(0xffffffffu, col_ok && v >= (p.n_states >> 1));
  if ((threadIdx.x & 31) == 0 && (c >> 5) < W) inc_out[inc_off + (c >> 5)] = word;
}

// One block: kRowsPerBlock clause rows (from row0_blk) × 32 columns
// (word blockIdx.x) of program k.
template <typename TA, typename Src>
__device__ void tile(const TA* ta, const uint32_t* __restrict__ lit,
                     const int8_t* __restrict__ cl, const int8_t* __restrict__ t1,
                     const int8_t* __restrict__ t2, const int32_t* __restrict__ l_mask,
                     const int32_t* __restrict__ params, TA* out, uint32_t* inc_out,
                     int k, int row0_blk, int C, int L,
                     int W, int B2, const Src& src) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_lit = smem;                                           // [B2]
  uint8_t* s_fb = reinterpret_cast<uint8_t*>(smem + B2);            // [rows][B2]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wd = blockIdx.x;
  const int r = row0_blk + warp;
  const long long kB2 = static_cast<long long>(k) * B2;
  for (int b = threadIdx.x; b < B2; b += kThreads)
    s_lit[b] = lit[(kB2 + b) * W + wd];
  bool any = false;
  if (r < C) {
    for (int b = lane; b < B2; b += 32) {
      const long long i = (kB2 + b) * C + r;
      const uint8_t f = static_cast<uint8_t>((cl[i] > 0 ? 1 : 0) | (t1[i] > 0 ? 2 : 0) |
                                             (t2[i] > 0 ? 4 : 0));
      s_fb[warp * B2 + b] = f;
      any |= (f & 6u) != 0;
    }
  }
  const bool active = __any_sync(0xffffffffu, any);
  __syncthreads();
  if (r >= C) return;   // warp-uniform

  const int32_t* pk = params + 5 * k;
  Params p;
  p.seed = static_cast<uint32_t>(pk[0]);
  p.p_ta = static_cast<uint32_t>(pk[1]);
  p.boost = pk[2] != 0;
  p.n_states = pk[3];
  p.row0 = static_cast<uint32_t>(pk[4]);
  const long long row_off = (static_cast<long long>(k) * C + r) * L;
  const long long inc_off = (static_cast<long long>(k) * C + r) * W;
  update_row<TA, Src>(ta, out, inc_out, k, r, wd * 32 + lane, L, W, row_off, inc_off, B2, s_lit,
                      s_fb + warp * B2, active, l_mask + static_cast<long long>(k) * L, p, src);
}

template <typename TA>
__global__ void __launch_bounds__(kThreads)
ta_update_dense(const TA* __restrict__ ta, const uint32_t* __restrict__ lit,
                const int8_t* __restrict__ cl, const int8_t* __restrict__ t1,
                const int8_t* __restrict__ t2, const int32_t* __restrict__ l_mask,
                const int32_t* __restrict__ params, TA* __restrict__ out,
                uint32_t* __restrict__ inc_out, int C, int L, int W, int B2, Stream s) {
  tile<TA>(ta, lit, cl, t1, t2, l_mask, params, out, inc_out, blockIdx.z,
           blockIdx.y * kRowsPerBlock, C, L, W, B2, InKernel{s});
}

template <typename TA>
__global__ void __launch_bounds__(kThreads)
ta_update_streamed(const TA* __restrict__ ta, const uint32_t* __restrict__ lit,
                   const int8_t* __restrict__ cl, const int8_t* __restrict__ t1,
                   const int8_t* __restrict__ t2, const int32_t* __restrict__ l_mask,
                   const int32_t* __restrict__ params, const uint32_t* __restrict__ rands,
                   TA* __restrict__ out, uint32_t* __restrict__ inc_out, int C, int L, int W,
                   int B2) {
  tile<TA>(ta, lit, cl, t1, t2, l_mask, params, out, inc_out, blockIdx.z,
           blockIdx.y * kRowsPerBlock, C, L, W, B2, Streamed{rands, B2, C});
}

template <typename TA>
__global__ void __launch_bounds__(kThreads)
ta_update_sparse(TA* ta, const uint32_t* __restrict__ lit, const int8_t* __restrict__ cl,
                 const int8_t* __restrict__ t1, const int8_t* __restrict__ t2,
                 const int32_t* __restrict__ l_mask, const int32_t* __restrict__ params,
                 const int32_t* __restrict__ tile_idx, const int32_t* __restrict__ count,
                 uint32_t* inc, int C, int L, int W, int B2, int S, Stream s) {
  const int k = blockIdx.z;
  const int slot = blockIdx.y / kTilesPerGroup;
  if (slot >= __ldg(count + k)) return;   // block-uniform
  const int32_t* idx_k = tile_idx + static_cast<long long>(k) * S;
  const int g = __ldg(idx_k + slot);
  if (g < 0 || static_cast<long long>(g) * kGroup >= C) return;
  for (int j = 0; j < slot; ++j)          // an earlier slot owns this group
    if (__ldg(idx_k + j) == g) return;
  tile<TA>(ta, lit, cl, t1, t2, l_mask, params, ta, inc, k,
           g * kGroup + (blockIdx.y % kTilesPerGroup) * kRowsPerBlock, C, L, W, B2,
           InKernel{s});
}

Stream make_stream(int lfsr, int lfsr_bits, int seed_refresh, int rand_bits,
                   unsigned int taps) {
  return Stream{lfsr, lfsr_bits, seed_refresh, rand_bits, taps};
}

}  // namespace

extern "C" size_t dtm_ta_update_smem(int B2) {
  return sizeof(uint32_t) * B2 + sizeof(uint8_t) * kRowsPerBlock * B2;
}

// ta_bytes: 1 (uint8 states) or 4 (int32).  dtm_ta_update writes new
// buffers (out, inc_out); dtm_ta_update_sparse updates ta and inc in place.
extern "C" int dtm_ta_update(const void* ta, const void* lit, const void* cl,
                             const void* t1, const void* t2, const void* l_mask,
                             const void* params, void* out, void* inc_out, int K, int C,
                             int L, int W, int B2, int ta_bytes, int lfsr, int lfsr_bits,
                             int seed_refresh, int rand_bits, unsigned int taps,
                             void* stream) {
  const dim3 grid(W, (C + kRowsPerBlock - 1) / kRowsPerBlock, K);
  const size_t smem = dtm_ta_update_smem(B2);
  const Stream s = make_stream(lfsr, lfsr_bits, seed_refresh, rand_bits, taps);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const uint32_t*>(lit);
  const auto* c8 = static_cast<const int8_t*>(cl);
  const auto* a8 = static_cast<const int8_t*>(t1);
  const auto* b8 = static_cast<const int8_t*>(t2);
  const auto* lm = static_cast<const int32_t*>(l_mask);
  const auto* pr = static_cast<const int32_t*>(params);
  auto* io = static_cast<uint32_t*>(inc_out);
  if (ta_bytes == 1)
    ta_update_dense<uint8_t><<<grid, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(ta), lp, c8, a8, b8, lm, pr,
        static_cast<uint8_t*>(out), io, C, L, W, B2, s);
  else
    ta_update_dense<int32_t><<<grid, kThreads, smem, st>>>(
        static_cast<const int32_t*>(ta), lp, c8, a8, b8, lm, pr,
        static_cast<int32_t*>(out), io, C, L, W, B2, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtm_ta_update_sparse(void* ta, const void* lit, const void* cl,
                                    const void* t1, const void* t2, const void* l_mask,
                                    const void* params, const void* tile_idx,
                                    const void* count, void* inc, int K,
                                    int C, int L, int W, int B2, int S, int ta_bytes,
                                    int lfsr, int lfsr_bits, int seed_refresh,
                                    int rand_bits, unsigned int taps, void* stream) {
  const dim3 grid(W, S * kTilesPerGroup, K);
  const size_t smem = dtm_ta_update_smem(B2);
  const Stream s = make_stream(lfsr, lfsr_bits, seed_refresh, rand_bits, taps);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const uint32_t*>(lit);
  const auto* c8 = static_cast<const int8_t*>(cl);
  const auto* a8 = static_cast<const int8_t*>(t1);
  const auto* b8 = static_cast<const int8_t*>(t2);
  const auto* lm = static_cast<const int32_t*>(l_mask);
  const auto* pr = static_cast<const int32_t*>(params);
  const auto* ix = static_cast<const int32_t*>(tile_idx);
  const auto* cn = static_cast<const int32_t*>(count);
  auto* io = static_cast<uint32_t*>(inc);
  if (ta_bytes == 1)
    ta_update_sparse<uint8_t><<<grid, kThreads, smem, st>>>(
        static_cast<uint8_t*>(ta), lp, c8, a8, b8, lm, pr, ix, cn, io, C, L, W, B2, S, s);
  else
    ta_update_sparse<int32_t><<<grid, kThreads, smem, st>>>(
        static_cast<int32_t*>(ta), lp, c8, a8, b8, lm, pr, ix, cn, io, C, L, W, B2, S, s);
  return static_cast<int>(cudaGetLastError());
}

// dtm_ta_update with the random words read from rands [K, B2, C, L]
// (uint32 bit patterns) instead of the in-kernel streams; params' seed and
// row0 are unused.
extern "C" int dtm_ta_update_streamed(const void* ta, const void* lit, const void* cl,
                                      const void* t1, const void* t2, const void* l_mask,
                                      const void* params, const void* rands, void* out,
                                      void* inc_out, int K, int C, int L, int W, int B2,
                                      int ta_bytes, void* stream) {
  const dim3 grid(W, (C + kRowsPerBlock - 1) / kRowsPerBlock, K);
  const size_t smem = dtm_ta_update_smem(B2);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const uint32_t*>(lit);
  const auto* c8 = static_cast<const int8_t*>(cl);
  const auto* a8 = static_cast<const int8_t*>(t1);
  const auto* b8 = static_cast<const int8_t*>(t2);
  const auto* lm = static_cast<const int32_t*>(l_mask);
  const auto* pr = static_cast<const int32_t*>(params);
  const auto* rd = static_cast<const uint32_t*>(rands);
  auto* io = static_cast<uint32_t*>(inc_out);
  if (ta_bytes == 1)
    ta_update_streamed<uint8_t><<<grid, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(ta), lp, c8, a8, b8, lm, pr, rd,
        static_cast<uint8_t*>(out), io, C, L, W, B2);
  else
    ta_update_streamed<int32_t><<<grid, kThreads, smem, st>>>(
        static_cast<const int32_t*>(ta), lp, c8, a8, b8, lm, pr, rd,
        static_cast<int32_t*>(out), io, C, L, W, B2);
  return static_cast<int>(cudaGetLastError());
}
