// Batched TA update (the paper's Alg 5) on Hopper (sm_90a): three entry
// points: the dense and streamed kernels share one tile body, the sparse one
// has its own.
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
// inc in place, so the groups left alone cost no traffic.
// dtm_ta_update_streamed replaces ta_update.py: ta_update_streamed, the
// streamed baseline of the in-kernel generator: the dense update, each
// TA's random word read from a pre-made rands[k, b, r, c] tensor (the same
// numbers), only where a Type I delta needs it; it is bound by the bytes
// of rands.  The other two make their random numbers in the kernel, one
// stream per TA keyed on key = (row0 + row) · stride + col (uint32),
// stride = L rounded up to 256: the JAX package's keying, so the states
// are bit for bit the reference's.  One stream step per batch row,
// whether or not that row gives the clause feedback.
//   counter: s = splitmix32(seed ^ key), then s = xorshift32(s), rand = s >> (32 − rand_bits)
//   lfsr:    lane = splitmix32(seed ^ key) & (2^L − 1) (nonzero); a Galois
//            shift per row; every 2^L − 1 rows (seed_refresh) the master
//            xorshifts and the lane reseeds from (master, key).
//
// Bound: integer operations.  Per TA of a clause row that gets Type I
// feedback (Type II reads no random word): a seed (key and splitmix32, 11
// operations; lfsr 13), then per batch row a stream step (counter:
// xorshift32, 6; lfsr: the Galois shift, 4; the refresh count, 2, only
// where a refresh can fire within the call; the output shift folds into
// the compare's threshold); per TA and batch row that gives the clause
// feedback the Alg-5 delta (6).  At the main path's shapes (R=2048,
// L=1664, 2B=64) the lfsr stream steps alone are ~0.9 G operations if
// every clause row gets Type I feedback, against ~7.3 MB of states,
// literals and feedback.
//
// Dense and streamed (the first design, kept): one thread per TA, one warp
// per clause row and 32 columns, so each warp's new include word is one
// __ballot_sync.  The block (8 rows × 32 columns) stages its literal word
// and its rows' feedback bits for all 2B batch rows in shared memory.  A
// clause row that gets no feedback from any batch row has a zero delta:
// its warp skips the stream entirely (the result is the same).
//
// Sparse (sp:: below), built for this card:
//  * The grid is a few blocks per SM (the wrapper sizes it from the SM
//    count and the slot count), not a block per slot and tile: each block
//    reads tile_idx[k, :count[k]] once into shared memory, where the first
//    slot that lists a group owns it (an atomicMin per slot, then a ballot
//    compaction), and walks the listed groups' items.  count stays on the
//    device.
//  * A block item is 4 clause rows (a quad) of a listed group and 4 word
//    chunks of 2 literal words, one a warp.  Three warps turn the quad's
//    feedback over the 2B batch rows into three bitmasks (clause, Type I,
//    Type II) by ballots, in chunks of 64 rows, once for the block: a lane
//    reads the 4 rows of its batch row with one 16-byte load of the
//    engine's int32 feedback.  A lane owns one literal column for the 4
//    rows: its literal bits over a chunk come from a 32 × 32 butterfly
//    transpose of the packed literal words, and its 4 streams are
//    independent chains (ILP).
//  * The stream family and whether a refresh can fire within the call
//    (2B ≥ 2^L − 1, chosen on the host) are template parameters; the
//    output shift folds into the comparison threshold (low <=> state <
//    p_ta shifted to the state's width), so a step is the stream update
//    and two instructions (sub.cc, addc) that shift the compare into the
//    row's low-word mask.
//  * The Alg-5 delta is then popcounts of the masks per 64 rows:
//    Type I +popc(t1 ∧ cl ∧ lit) − popc(t1 ∧ ¬(cl ∧ lit) ∧ low)
//    (− popc(t1 ∧ cl ∧ lit ∧ low) without boost), Type II
//    +popc(t2 ∧ cl ∧ ¬lit) unless included.  A row without Type I feedback
//    runs no stream at all (Type II reads no random word).
// TA states are read and written in their own dtype (uint8, or int32
// above 8 bits); a thread reads its state before it writes it, so in and
// out may be one buffer.
#include "common.cuh"

#include <cstring>

namespace {

constexpr int kRowsPerBlock = 8;    // one warp per clause row
constexpr int kThreads = kRowsPerBlock * 32;
constexpr int kGroup = 128;         // rows per compaction group
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

// ---- dtm_ta_update_sparse: the compacted update built for this card -------

namespace sp {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;           // clause rows per warp item: 4 stream chains a lane
constexpr int kChunkB = 64;        // batch rows per feedback bitmask
constexpr int kWordsPerItem = 2;   // literal words (32 columns each) per warp item
constexpr int kQuads = kGroup / kRows;
constexpr int kNone = 0x7fffffff;

struct Scalar {      // one per-program scalar: a tensor element or a value
  const void* ptr;   // null: use value
  long long value;
  int bytes;         // element bytes: 1 (bool), 4 (int32) or 8 (int64)
  int stride;        // elements from one program to the next (0: shared)
};
struct Scalars {     // seed, p_ta, boost, n_states, row0
  Scalar s[5];
};

// The scalar of program k, truncated to 32 bits: the uint32 value the JAX
// kernel's SMEM row holds.
__device__ __forceinline__ uint32_t read_u32(const Scalar& a, int k) {
  if (a.ptr == nullptr) return static_cast<uint32_t>(a.value);
  const long long i = static_cast<long long>(k) * a.stride;
  switch (a.bytes) {
    case 1: return static_cast<const uint8_t*>(a.ptr)[i];
    case 4: return static_cast<const uint32_t*>(a.ptr)[i];
    default: return static_cast<uint32_t>(static_cast<const unsigned long long*>(a.ptr)[i]);
  }
}

// int32 feedback of batch row b for clause rows r0 … r0 + kRows − 1 (n of
// them real), one vector load when the rows are aligned
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ p, long long i, int n,
                                          bool vec, int32_t (&v)[kRows]) {
  static_assert(kRows == 4, "one 4-element vector load a row quad");
  if (vec && n == kRows) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p + i));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    return;
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) v[rr] = rr < n ? p[i + rr] : 0;
}

// TA state i of a uint8 (ta_bytes = 1) or int32 state tensor
__device__ __forceinline__ int32_t load_ta(const void* ta, int ta_bytes, long long i) {
  return ta_bytes == 1 ? static_cast<int32_t>(static_cast<const uint8_t*>(ta)[i])
                       : static_cast<const int32_t*>(ta)[i];
}

__device__ __forceinline__ void store_ta(void* ta, int ta_bytes, long long i, int32_t v) {
  if (ta_bytes == 1) static_cast<uint8_t*>(ta)[i] = static_cast<uint8_t>(v);
  else static_cast<int32_t*>(ta)[i] = v;
}

// The comparator word is below p_ta iff the raw stream state is below this
// threshold: counter words are state >> (32 − rand_bits); LFSR words are the
// L-bit state shifted right (L > rand_bits) or left (L < rand_bits).  So a
// step costs no output shift.
__device__ __forceinline__ unsigned long long low_threshold(uint32_t p, bool lfsr, int lfsr_bits,
                                                            int rand_bits) {
  const unsigned long long p64 = p;
  if (!lfsr) return p64 << (32 - rand_bits);
  if (lfsr_bits > rand_bits) return p64 << (lfsr_bits - rand_bits);
  if (lfsr_bits < rand_bits) {
    const int d = rand_bits - lfsr_bits;
    return (p64 + (1ull << d) - 1ull) >> d;
  }
  return p64;
}

// 32 × 32 bit transpose across a warp: lane i holds row i on entry and
// column i on exit (bit j = row j's bit i); five butterfly levels.
__device__ __forceinline__ uint32_t warp_transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const uint32_t m = s == 16 ? 0x0000ffffu : s == 8 ? 0x00ff00ffu : s == 4 ? 0x0f0f0f0fu
                     : s == 2 ? 0x33333333u : 0x55555555u;   // columns with bit s clear
    const uint32_t o = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? ((x & ~m) | ((o & ~m) >> s)) : ((x & m) | ((o & m) << s));
  }
  return x;
}

// This lane's literal column (32w + lane) over batch rows [64ch, 64ch + 64):
// bit b = literal of batch row 64ch + b.
__device__ __forceinline__ unsigned long long lit_column(const uint32_t* __restrict__ lit_k,
                                                        int B2, int W, int w, int ch, int lane) {
  unsigned long long col = 0ull;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = ch * kChunkB + 32 * h + lane;
    const uint32_t x = b < B2 ? __ldg(lit_k + static_cast<long long>(b) * W + w) : 0u;
    col |= static_cast<unsigned long long>(warp_transpose32(x, lane)) << (32 * h);
  }
  return col;
}

// One stream step's compare, shifted into hm (hm = 2·hm + (state >= thr)):
// sub.cc sets the carry flag when state − thr does not borrow, and addc
// adds it.  Two instructions; after n steps bit n − 1 − j of hm is the
// complement of step j's low bit.
__device__ __forceinline__ uint32_t shift_in_high(uint32_t hm, uint32_t st, uint32_t thr) {
  uint32_t out;
  asm("{\n\t.reg .u32 t;\n\tsub.cc.u32 t, %1, %2;\n\taddc.u32 %0, %3, %3;\n\t}"
      : "=r"(out)
      : "r"(st), "r"(thr), "r"(hm));
  return out;
}

template <bool kLfsr>
__device__ __forceinline__ uint32_t advance(uint32_t s, uint32_t taps) {
  if (kLfsr) return (s >> 1) ^ ((0u - (s & 1u)) & taps);
  return xorshift32(s);
}

// Grid (blocks, K).  Every block reads tile_idx[k, :count[k]] once into
// shared memory (the first slot that lists a group owns it; negative and
// past-C entries drop out), then its warps walk the items of the listed
// groups: (group, row quad, 4 word chunks), strided by the grid.
template <bool kLfsr, bool kRefresh>
__global__ void __launch_bounds__(kThreads)
ta_update_sparse(void* ta, int ta_bytes, const uint32_t* __restrict__ lit,
                 const int32_t* __restrict__ cl, const int32_t* __restrict__ t1,
                 const int32_t* __restrict__ t2, const int32_t* __restrict__ l_mask, Scalars sc,
                 const int32_t* __restrict__ tile_idx, const int32_t* __restrict__ count,
                 uint32_t* inc, int C, int L, int W, int B2, int S, int lfsr_bits,
                 int rand_bits, uint32_t taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = (C + kGroup - 1) / kGroup;
  const int nch = (B2 + kChunkB - 1) / kChunkB;
  auto* s_mask = reinterpret_cast<unsigned long long*>(smem);   // [nch][kRows][3]
  int* s_owner = reinterpret_cast<int*>(s_mask + nch * kRows * 3);            // [G]
  int* s_list = s_owner + G;                                                  // [G]
  __shared__ int s_groups;
  const int k = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int n_slots = min(max(__ldg(count + k), 0), S);
  const int32_t* idx_k = tile_idx + static_cast<long long>(k) * S;
  for (int g = threadIdx.x; g < G; g += kThreads) s_owner[g] = kNone;
  __syncthreads();
  for (int j = threadIdx.x; j < n_slots; j += kThreads) {
    const int g = __ldg(idx_k + j);
    if (g >= 0 && g < G) atomicMin(s_owner + g, j);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const bool listed = g < G && s_owner[g] != kNone;
      const uint32_t m = __ballot_sync(0xffffffffu, listed);
      if (listed) s_list[n + __popc(m & ((1u << lane) - 1u))] = g;
      n += __popc(m);
    }
    if (lane == 0) s_groups = n;
  }
  __syncthreads();
  const int ncc = (W + kWordsPerItem - 1) / kWordsPerItem;   // word chunks a row quad
  const int ncb = (ncc + kWarps - 1) / kWarps;                // ... kWarps at a time
  const long long items = static_cast<long long>(s_groups) * kQuads * ncb;

  const uint32_t seed = read_u32(sc.s[0], k);
  const bool boost = read_u32(sc.s[2], k) != 0u;
  const int32_t n_states = static_cast<int32_t>(read_u32(sc.s[3], k));
  const uint32_t row0 = read_u32(sc.s[4], k);
  const int32_t half = n_states >> 1;
  const uint32_t lmask = lfsr_bits >= 32 ? 0xffffffffu : ((1u << lfsr_bits) - 1u);
  const unsigned long long thr = low_threshold(read_u32(sc.s[1], k), kLfsr, lfsr_bits, rand_bits);
  const bool low_all = thr > 0xffffffffull;   // every word is below p_ta
  const uint32_t thr32 = static_cast<uint32_t>(thr);   // else: low <=> state < thr32
  const uint32_t stride = static_cast<uint32_t>((L + kKeyTile - 1) / kKeyTile * kKeyTile);
  const uint32_t* lit_k = lit + static_cast<long long>(k) * B2 * W;
  const int32_t* fb_src = warp == 0 ? cl : warp == 1 ? t1 : t2;
  const bool fb_vec = C % kRows == 0 && reinterpret_cast<uintptr_t>(fb_src) % 16 == 0;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {   // block-uniform
    const int q = static_cast<int>((it / ncb) % kQuads);
    const int r0 = s_list[it / (static_cast<long long>(ncb) * kQuads)] * kGroup + q * kRows;
    if (r0 >= C) continue;
    const int wc = static_cast<int>(it % ncb) * kWarps + warp;   // this warp's word chunk

    // the quad's feedback over the 2B batch rows as bitmasks per chunk of
    // 64 rows, built once for the block: warp a reads array a (clause,
    // Type I, Type II), 4 rows a lane and load, and ballots them
    __syncthreads();   // the previous item's masks are read
    if (warp < 3) {
      const int nr = min(kRows, C - r0);
      for (int ch = 0; ch < nch; ++ch) {
        unsigned long long m[kRows] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = ch * kChunkB + 32 * h + lane;
          int32_t v[kRows] = {};
          if (b < B2)
            load_rows(fb_src, (static_cast<long long>(k) * B2 + b) * C + r0, nr, fb_vec, v);
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr)
            m[rr] |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, v[rr] > 0))
                     << (32 * h);
        }
        if (lane < kRows) {
          unsigned long long mine = m[0];
#pragma unroll
          for (int rr = 1; rr < kRows; ++rr) mine = lane == rr ? m[rr] : mine;
          s_mask[(ch * kRows + lane) * 3 + warp] = mine;
        }
      }
    }
    __syncthreads();
    if (wc >= ncc) continue;   // warp-uniform: no word chunk left for this warp
    // a row's stream runs only if it gets Type I feedback (Type II reads no
    // random word)
    bool run = false;
    for (int i = 0; i < nch * kRows; ++i) run |= s_mask[i * 3 + 1] != 0ull;

    const int w_end = min(W, (wc + 1) * kWordsPerItem);
    for (int w = wc * kWordsPerItem; w < w_end; ++w) {
      const int c = 32 * w + lane;
      const bool col_ok = c < L;
      int32_t old[kRows], delta[kRows];
      uint32_t st[kRows], key[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = r0 + rr;
        old[rr] = (col_ok && r < C) ? load_ta(ta, ta_bytes, (static_cast<long long>(k) * C + r) * L + c) : 0;
        delta[rr] = 0;
        key[rr] = (row0 + static_cast<uint32_t>(r)) * stride + static_cast<uint32_t>(c);
        st[rr] = !run ? 0u : kLfsr ? lfsr_seed(seed, key[rr], lmask) : splitmix32(seed ^ key[rr]);
      }
      uint32_t master = seed;
      uint32_t cycles = 0u;
      for (int ch = 0; ch < nch; ++ch) {
        const unsigned long long litm = lit_column(lit_k, B2, W, w, ch, lane);
        uint32_t low[kRows][2];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) low[rr][0] = low[rr][1] = 0u;
        if (run) {   // warp-uniform
          const int nb = min(kChunkB, B2 - ch * kChunkB);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nbh = min(32, nb - 32 * h);
            if (nbh <= 0) break;
            uint32_t lm[kRows] = {0u, 0u, 0u, 0u};
            auto one_row = [&]() {   // one batch row: every chain steps once
#pragma unroll
              for (int rr = 0; rr < kRows; ++rr) st[rr] = advance<kLfsr>(st[rr], taps);
              if (kRefresh && ++cycles == lmask) {   // lmask = 2^L − 1, the period
                master = xorshift32(master);
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) st[rr] = lfsr_seed(master, key[rr], lmask);
                cycles = 0u;
              }
#pragma unroll
              for (int rr = 0; rr < kRows; ++rr) lm[rr] = shift_in_high(lm[rr], st[rr], thr32);
            };
            if (nbh == 32) {
#pragma unroll
              for (int b = 0; b < 32; ++b) one_row();
            } else {
              for (int b = 0; b < nbh; ++b) one_row();
            }
            // bit b of the half = step b's low bit
            const uint32_t valid = nbh == 32 ? 0xffffffffu : ((1u << nbh) - 1u);
#pragma unroll
            for (int rr = 0; rr < kRows; ++rr)
              low[rr][h] = low_all ? valid : (__brev(~lm[rr]) >> (32 - nbh));
          }
        }
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const unsigned long long* m = s_mask + (ch * kRows + rr) * 3;
          const unsigned long long mc = m[0], m1 = m[1], m2 = m[2];
          const unsigned long long lw =
              low[rr][0] | (static_cast<unsigned long long>(low[rr][1]) << 32);
          const unsigned long long pos = mc & litm;       // clause ∧ literal
          int32_t d = __popcll(m1 & pos) - __popcll(m1 & ~pos & lw);
          if (!boost) d -= __popcll(m1 & pos & lw);
          if (old[rr] < half) d += __popcll(m2 & mc & ~litm);
          delta[rr] += d;
        }
      }
      const int32_t lmv = col_ok ? __ldg(l_mask + static_cast<long long>(k) * L + c) : 0;
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = r0 + rr;
        if (r >= C) break;   // warp-uniform
        const int32_t v = min(max(old[rr] + delta[rr] * lmv, 0), n_states - 1);
        if (col_ok) store_ta(ta, ta_bytes, (static_cast<long long>(k) * C + r) * L + c, v);
        const uint32_t word = __ballot_sync(0xffffffffu, col_ok && v >= half);
        if (lane == rr) inc[(static_cast<long long>(k) * C + r) * W + w] = word;
      }
    }
  }
}

// dynamic shared memory of a launch: the feedback masks of a row quad,
// then the group owners and the listed groups
size_t smem_bytes(int C, int B2) {
  const int nch = (B2 + kChunkB - 1) / kChunkB;
  const int G = (C + kGroup - 1) / kGroup;
  return sizeof(unsigned long long) * nch * kRows * 3 + 2 * sizeof(int) * G;
}

}  // namespace sp

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

// Updates ta and inc in place.  cl, t1, t2 [K, B2, C] int32; scalars
// points to five host sp::Scalar records (seed, p_ta, boost, n_states,
// row0).  refresh = 1 only for an LFSR with seed_refresh whose period
// 2^L − 1 is at most B2, the one case where a refresh fires within a call.
// blocks: the grid's x size.
extern "C" int dtm_ta_update_sparse(void* ta, const void* lit, const void* cl, const void* t1,
                                    const void* t2, const void* l_mask, const void* scalars,
                                    const void* tile_idx, const void* count, void* inc, int K,
                                    int C, int L, int W, int B2, int S, int ta_bytes, int lfsr,
                                    int lfsr_bits, int refresh, int rand_bits,
                                    unsigned int taps, int blocks, void* stream) {
  sp::Scalars sc;
  memcpy(&sc, scalars, sizeof sc);
  const dim3 grid(blocks, K);
  const size_t smem = sp::smem_bytes(C, B2);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const uint32_t*>(lit);
  const auto* c32 = static_cast<const int32_t*>(cl);
  const auto* a32 = static_cast<const int32_t*>(t1);
  const auto* b32 = static_cast<const int32_t*>(t2);
  const auto* lm = static_cast<const int32_t*>(l_mask);
  const auto* ix = static_cast<const int32_t*>(tile_idx);
  const auto* cn = static_cast<const int32_t*>(count);
  auto* io = static_cast<uint32_t*>(inc);
#define DTM_SPARSE(LFSR, REFRESH)                                                   \
  sp::ta_update_sparse<LFSR, REFRESH><<<grid, sp::kThreads, smem, st>>>(            \
      ta, ta_bytes, lp, c32, a32, b32, lm, sc, ix, cn, io, C, L, W, B2, S, lfsr_bits, \
      rand_bits, taps)
  if (!lfsr) DTM_SPARSE(false, false);
  else if (refresh) DTM_SPARSE(true, true);
  else DTM_SPARSE(true, false);
#undef DTM_SPARSE
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
