// Batched TA update (the paper's Alg 5) on Hopper (sm_90a): one kernel
// body, three entry points.
//
//   new_ta[k, r, c] = clip(ta + l_mask[c] · Σ_b delta_b(r, c), 0, n_states − 1)
//   delta_b = t1[b, r] · (cl∧lit ? +1 unless (!boost and low)
//                                : −1 if low)
//           + t2[b, r] · (cl ∧ ¬lit ∧ ¬include ? +1 : 0)
//   cl = clause[b, r], lit = literal c of batch row b, include = ta >= n_states/2
//   (of the state before the update), low = this TA's random word of batch
//   row b is below p_ta.
//   new_inc[k, r, w] = the packed include bitplane of the updated rows.
//
// dtm_ta_update replaces repro/kernels/ta_update.py: ta_update (every row,
// into new tensors); dtm_ta_update_sparse replaces ta_update.py:
// ta_update_sparse (the Alg-6 compacted grid over the 128-row clause
// groups listed in tile_idx, updated in place in ta and inc, so the groups
// left alone cost no traffic); dtm_ta_update_streamed replaces ta_update.py:
// ta_update_streamed (every row, into new tensors, the random words read
// from a pre-made rands[k, b, r, c] tensor: the streamed baseline).
//
// The random source is the body's template parameter (Source):
//  * in-kernel streams (kCounter, kLfsr, kLfsrRefresh): one stream per TA
//    keyed on key = (row0 + row) · stride + col (uint32), stride = L rounded
//    up to 256: the JAX package's keying, so the states are bit for bit the
//    reference's.  One stream step per batch row, whether or not that row
//    gives the clause feedback.
//      counter: s = splitmix32(seed ^ key), then s = xorshift32(s), word = s >> (32 − rand_bits)
//      lfsr:    lane = splitmix32(seed ^ key) & (2^L − 1) (nonzero); a Galois
//               shift per row; every 2^L − 1 rows (seed_refresh) the master
//               xorshifts and the lane reseeds from (master, key).
//    kLfsrRefresh is the one case where a refresh can fire within a call
//    (2B ≥ 2^L − 1, chosen on the host).  The output shift folds into the
//    compare's threshold (low <=> state < p_ta shifted to the state's
//    width), so a step is the stream update and two instructions (sub.cc,
//    addc) that shift the compare into the row's low-word mask.
//  * streamed words (kStreamed): word = rands[k, b, r, c] (int32 [K, 2B, C,
//    L], already rand_bits wide: no threshold fold), read only at the batch
//    rows of the clause row's Type I mask.  The warp that builds the Type I
//    masks also lists each row's set batch rows in shared memory, so a load
//    costs a shared read, an address and the load (walking the mask's bits
//    in every lane cost more than the loads); a lane issues up to
//    kLoadBatch listed rows of each of the 4 rows, as streaming loads,
//    before it compares any.  A warp's load of one (b, r) is one coalesced
//    128-byte row.
//
// Bound: the in-kernel update by integer operations (per TA of a clause row
// with Type I feedback a seed, ~11–13 operations, and a stream step per
// batch row, 4–6; the Alg-5 delta per TA and batch row with feedback); the
// streamed update by the bytes of the rands words a Type I delta reads.
// At the main path's shapes (R=2048, L=1664, 2B=64) the lfsr stream steps
// are ~0.9 G operations if every clause row gets Type I feedback, against
// ~7.3 MB of states, literals and feedback.  Beside either, each (word, row
// quad) costs a few hundred fixed instructions (two transposes, the
// popcounts, the clip and the include ballots), which set the time where
// few rows get Type I feedback.
//
// Design:
//  * The grid is kBlocksPerSm blocks per SM (the wrapper sizes it from the
//    SM count and the group count), all resident at 64 registers a thread,
//    not a block per tile.  The dense entry points list every 128-row
//    group; the sparse one reads tile_idx[k, :count[k]] once into shared
//    memory, where the first slot that lists a group owns it (an atomicMin
//    per slot, then a ballot compaction).  count stays on the device.  The
//    block's warps walk the listed groups' items.
//  * A block item is 4 clause rows (a quad) of a listed group and 8
//    literal words, warp j taking words j and j + 4.  Three warps turn the
//    quad's feedback over the 2B batch rows into three bitmasks (clause,
//    Type I, Type II) by ballots, in chunks of 64 rows, once for the block:
//    a lane reads the 4 rows of its batch row with one 16-byte load of the
//    engine's int32 feedback.  A lane owns one literal column for the 4
//    rows: its literal bits over a chunk come from a 32 × 32 butterfly
//    transpose of the packed literal words, loaded before the low bits are
//    made and transposed after, and its 4 streams are independent chains
//    (ILP).
//  * The Alg-5 delta is then popcounts of the masks per 64 rows:
//    Type I +popc(t1 ∧ cl ∧ lit) − popc(t1 ∧ ¬(cl ∧ lit) ∧ low)
//    (− popc(t1 ∧ cl ∧ lit ∧ low) without boost), Type II
//    +popc(t2 ∧ cl ∧ ¬lit) unless included.  The low mask is read only
//    under the Type I mask, so a row without Type I feedback runs no stream
//    and reads no word.  A row without any feedback stores its old state,
//    clipped, as the JAX kernels do.
// TA states are read and written in their own dtype (uint8, or int32
// above 8 bits); a thread reads its state before it writes it, so ta and
// ta_out may be one buffer (the sparse update in place).
#include "common.cuh"

#include <cstring>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 8;    // the grid's blocks per SM, all resident (64 registers)
constexpr int kRows = 4;           // clause rows per warp item: 4 stream chains a lane
constexpr int kChunkB = 64;        // batch rows per feedback bitmask
constexpr int kWordsPerItem = 2;   // literal words (32 columns each) per warp item
constexpr int kGroup = 128;        // rows per compaction group
constexpr int kQuads = kGroup / kRows;
constexpr int kKeyTile = 256;      // the stream-key stride granularity
constexpr int kLoadBatch = 4;      // streamed words in flight per row and lane
constexpr int kNone = 0x7fffffff;

enum Source { kCounter, kLfsr, kLfsrRefresh, kStreamed };

struct Scalar {      // one per-program scalar: a tensor element or a value
  const void* ptr;   // null: use value
  long long value;
  int bytes;         // element bytes: 1 (bool), 4 (int32) or 8 (int64)
  int stride;        // elements from one program to the next (0: shared)
};
struct Scalars {     // seed, p_ta, boost, n_states, row0
  Scalar s[5];
};

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

// The packed literal words of word w over batch rows [64ch, 64ch + 64):
// this lane's two rows, 64ch + lane and 64ch + 32 + lane.
__device__ __forceinline__ void lit_words(const uint32_t* __restrict__ lit_k, int B2, int W,
                                          int w, int ch, int lane, uint32_t (&x)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = ch * kChunkB + 32 * h + lane;
    x[h] = b < B2 ? __ldg(lit_k + static_cast<long long>(b) * W + w) : 0u;
  }
}

// This lane's literal column (32w + lane) over those rows, from the
// words: bit b = literal of batch row 64ch + b.
__device__ __forceinline__ unsigned long long lit_column(const uint32_t (&x)[2], int lane) {
  return static_cast<unsigned long long>(warp_transpose32(x[0], lane)) |
         (static_cast<unsigned long long>(warp_transpose32(x[1], lane)) << 32);
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

// The low bits (word < p_ta) of this lane's column for the quad's rows over
// one chunk, from the streamed words at p (rands[k, 64ch, r0, c]; batch row
// b of row rr at p + b·b_stride + rr·L), only at the batch rows of each
// row's Type I mask: bits[64·rr + i], i < nb[rr], listed in shared memory
// when the masks were built.  Up to kLoadBatch rows of each of the 4 rows a
// round, all the round's loads issued before any is compared.
__device__ __forceinline__ void streamed_low(const uint32_t* __restrict__ p, long long b_stride,
                                             int L, uint32_t p_ta, bool col_ok,
                                             const int (&nb)[kRows],
                                             const uint8_t* __restrict__ bits,
                                             unsigned long long (&lw)[kRows]) {
  const int n_max = max(max(nb[0], nb[1]), max(nb[2], nb[3]));
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) lw[rr] = 0ull;
  for (int j0 = 0; j0 < n_max; j0 += kLoadBatch) {   // warp-uniform
    uint32_t word[kRows][kLoadBatch];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int i = j0 + j;
        word[rr][j] = 0xffffffffu;   // never below p_ta
        if (col_ok && i < nb[rr])
          word[rr][j] = __ldcs(p + bits[kChunkB * rr + i] * b_stride + rr * L);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int i = j0 + j;
        if (i < nb[rr] && word[rr][j] < p_ta) lw[rr] |= 1ull << bits[kChunkB * rr + i];
      }
    }
  }
}

// Grid (blocks, K).  tile_idx null: every group (the dense update); else
// every block reads tile_idx[k, :count[k]] once into shared memory (the
// first slot that lists a group owns it; negative and past-C entries drop
// out).  Then the block's warps walk the items of the listed groups:
// (group, row quad, 8 words), strided by the grid.  rands: the streamed
// words (kStreamed only).
template <Source kSrc>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
ta_update(const void* ta, void* ta_out, int ta_bytes, const uint32_t* __restrict__ lit,
          const int32_t* __restrict__ cl, const int32_t* __restrict__ t1,
          const int32_t* __restrict__ t2, const int32_t* __restrict__ l_mask, Scalars sc,
          const int32_t* __restrict__ tile_idx, const int32_t* __restrict__ count,
          const uint32_t* __restrict__ rands, uint32_t* inc, int C, int L, int W, int B2, int S,
          int lfsr_bits, int rand_bits, uint32_t taps) {
  constexpr bool kStream = kSrc == kStreamed;
  constexpr bool kIsLfsr = kSrc == kLfsr || kSrc == kLfsrRefresh;
  constexpr bool kRefresh = kSrc == kLfsrRefresh;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = (C + kGroup - 1) / kGroup;
  const int nch = (B2 + kChunkB - 1) / kChunkB;
  auto* s_mask = reinterpret_cast<unsigned long long*>(smem);   // [nch][kRows][3]
  int* s_owner = reinterpret_cast<int*>(s_mask + nch * kRows * 3);            // [G]
  int* s_list = s_owner + G;                                                  // [G]
  // streamed: each row's Type I batch rows, listed per chunk
  int* s_nb = s_list + G;                                                     // [nch][kRows]
  auto* s_bits = reinterpret_cast<uint8_t*>(s_nb + (kStream ? nch * kRows : 0));  // [nch][kRows][64]
  __shared__ int s_groups;
  const int k = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (tile_idx == nullptr) {   // dense: every group, in order
    for (int g = threadIdx.x; g < G; g += kThreads) s_list[g] = g;
    if (threadIdx.x == 0) s_groups = G;
  } else {
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
  }
  __syncthreads();
  // an item's words: kWarps · kWordsPerItem of them, warp j taking every
  // kWarps-th
  constexpr int span = kWarps * kWordsPerItem;
  const int ncb = (W + span - 1) / span;                      // items a row quad
  const long long items = static_cast<long long>(s_groups) * kQuads * ncb;

  const uint32_t p_ta = read_u32(sc.s[1], k);
  const bool boost = read_u32(sc.s[2], k) != 0u;
  const int32_t n_states = static_cast<int32_t>(read_u32(sc.s[3], k));
  const int32_t half = n_states >> 1;
  // in-kernel streams: seeds, keys and the compare threshold
  const uint32_t seed = kStream ? 0u : read_u32(sc.s[0], k);
  const uint32_t row0 = kStream ? 0u : read_u32(sc.s[4], k);
  const uint32_t lmask = lfsr_bits >= 32 ? 0xffffffffu : ((1u << lfsr_bits) - 1u);
  const unsigned long long thr = kStream ? 0ull : low_threshold(p_ta, kIsLfsr, lfsr_bits, rand_bits);
  const bool low_all = thr > 0xffffffffull;   // every word is below p_ta
  const uint32_t thr32 = static_cast<uint32_t>(thr);   // else: low <=> state < thr32
  const uint32_t stride = static_cast<uint32_t>((L + kKeyTile - 1) / kKeyTile * kKeyTile);
  // streamed words: one batch row of rands is C·L words
  const long long b_stride = static_cast<long long>(C) * L;
  const uint32_t* lit_k = lit + static_cast<long long>(k) * B2 * W;
  const int32_t* fb_src = warp == 0 ? cl : warp == 1 ? t1 : t2;
  const bool fb_vec = C % kRows == 0 && reinterpret_cast<uintptr_t>(fb_src) % 16 == 0;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {   // block-uniform
    const int q = static_cast<int>((it / ncb) % kQuads);
    const int r0 = s_list[it / (static_cast<long long>(ncb) * kQuads)] * kGroup + q * kRows;
    if (r0 >= C) continue;
    const int w0 = static_cast<int>(it % ncb) * span;   // the item's first word

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
        if (kStream && warp == 1) {   // list the Type I batch rows (a ballot compaction)
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            uint8_t* list = s_bits + (ch * kRows + rr) * kChunkB;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int b = 32 * h + lane;
              if ((m[rr] >> b) & 1ull) list[__popcll(m[rr] & ((1ull << b) - 1ull))] = b;
            }
            if (lane == 0) s_nb[ch * kRows + rr] = __popcll(m[rr]);
          }
        }
      }
    }
    __syncthreads();
    if (w0 + warp >= W) continue;   // warp-uniform: no word left for this warp
    // a row's stream runs only if it gets Type I feedback (Type II reads no
    // random word)
    bool run = false;
    if (!kStream)
      for (int i = 0; i < nch * kRows; ++i) run |= s_mask[i * 3 + 1] != 0ull;

    const int w_end = min(W, w0 + span);
    for (int w = w0 + warp; w < w_end; w += kWarps) {
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
        st[rr] = !run ? 0u : kIsLfsr ? lfsr_seed(seed, key[rr], lmask) : splitmix32(seed ^ key[rr]);
      }
      const int32_t lmv = col_ok ? __ldg(l_mask + static_cast<long long>(k) * L + c) : 0;
      uint32_t master = seed;
      uint32_t cycles = 0u;
      for (int ch = 0; ch < nch; ++ch) {
        // the literal words' loads are in flight while the low bits are
        // made (stream steps) or read (the streamed words); the transpose
        // waits for them after
        uint32_t lx[2];
        lit_words(lit_k, B2, W, w, ch, lane, lx);
        unsigned long long lw[kRows];
        if constexpr (kStream) {
          int nb[kRows];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) nb[rr] = s_nb[ch * kRows + rr];
          const uint32_t* p =
              rands + ((static_cast<long long>(k) * B2 + ch * kChunkB) * C + r0) * L + c;
          streamed_low(p, b_stride, L, p_ta, col_ok, nb, s_bits + ch * kRows * kChunkB, lw);
        } else {
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
                for (int rr = 0; rr < kRows; ++rr) st[rr] = advance<kIsLfsr>(st[rr], taps);
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
          for (int rr = 0; rr < kRows; ++rr)
            lw[rr] = low[rr][0] | (static_cast<unsigned long long>(low[rr][1]) << 32);
        }
        const unsigned long long litm = lit_column(lx, lane);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const unsigned long long* m = s_mask + (ch * kRows + rr) * 3;
          const unsigned long long mc = m[0], m1 = m[1], m2 = m[2];
          const unsigned long long pos = mc & litm;       // clause ∧ literal
          int32_t d = __popcll(m1 & pos) - __popcll(m1 & ~pos & lw[rr]);
          if (!boost) d -= __popcll(m1 & pos & lw[rr]);
          if (old[rr] < half) d += __popcll(m2 & mc & ~litm);
          delta[rr] += d;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int r = r0 + rr;
        if (r >= C) break;   // warp-uniform
        const int32_t v = min(max(old[rr] + delta[rr] * lmv, 0), n_states - 1);
        if (col_ok) store_ta(ta_out, ta_bytes, (static_cast<long long>(k) * C + r) * L + c, v);
        const uint32_t word = __ballot_sync(0xffffffffu, col_ok && v >= half);
        if (lane == rr) inc[(static_cast<long long>(k) * C + r) * W + w] = word;
      }
    }
  }
}

// dynamic shared memory of a launch: the feedback masks of a row quad,
// the group owners and the listed groups, and (streamed) each row's list
// of Type I batch rows
size_t smem_bytes(int C, int B2, bool streamed) {
  const int nch = (B2 + kChunkB - 1) / kChunkB;
  const int G = (C + kGroup - 1) / kGroup;
  const size_t lists = streamed ? (sizeof(int) + kChunkB) * nch * kRows : 0;
  return sizeof(unsigned long long) * nch * kRows * 3 + 2 * sizeof(int) * G + lists;
}

// One launch of the body; src: kCounter, kLfsr, kLfsrRefresh or kStreamed.
int launch(Source src, const void* ta, void* ta_out, const void* lit, const void* cl,
           const void* t1, const void* t2, const void* l_mask, const void* scalars,
           const void* tile_idx, const void* count, const void* rands, void* inc, int K, int C,
           int L, int W, int B2, int S, int ta_bytes, int lfsr_bits, int rand_bits,
           unsigned int taps, int blocks, void* stream) {
  Scalars sc;
  memcpy(&sc, scalars, sizeof sc);
  const dim3 grid(blocks, K);
  const size_t smem = smem_bytes(C, B2, src == kStreamed);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* lp = static_cast<const uint32_t*>(lit);
  const auto* c32 = static_cast<const int32_t*>(cl);
  const auto* a32 = static_cast<const int32_t*>(t1);
  const auto* b32 = static_cast<const int32_t*>(t2);
  const auto* lm = static_cast<const int32_t*>(l_mask);
  const auto* ix = static_cast<const int32_t*>(tile_idx);
  const auto* cn = static_cast<const int32_t*>(count);
  const auto* rd = static_cast<const uint32_t*>(rands);
  auto* io = static_cast<uint32_t*>(inc);
#define DTM_TA(SRC)                                                                       \
  ta_update<SRC><<<grid, kThreads, smem, st>>>(ta, ta_out, ta_bytes, lp, c32, a32, b32, lm, \
                                               sc, ix, cn, rd, io, C, L, W, B2, S,          \
                                               lfsr_bits, rand_bits, taps)
  switch (src) {
    case kCounter: DTM_TA(kCounter); break;
    case kLfsr: DTM_TA(kLfsr); break;
    case kLfsrRefresh: DTM_TA(kLfsrRefresh); break;
    default: DTM_TA(kStreamed); break;
  }
#undef DTM_TA
  return static_cast<int>(cudaGetLastError());
}

Source in_kernel(int lfsr, int refresh) {
  return !lfsr ? kCounter : refresh ? kLfsrRefresh : kLfsr;
}

}  // namespace

// The entry points take cl, t1, t2 [K, B2, C] int32; scalars points to
// five host Scalar records (seed, p_ta, boost, n_states, row0); ta_bytes is
// 1 (uint8 states) or 4 (int32); blocks is the grid's x size.  refresh = 1
// only for an LFSR with seed_refresh whose period 2^L − 1 is at most B2,
// the one case where a refresh fires within a call.

// Every row, into new buffers (out, inc_out).
extern "C" int dtm_ta_update(const void* ta, const void* lit, const void* cl, const void* t1,
                             const void* t2, const void* l_mask, const void* scalars, void* out,
                             void* inc_out, int K, int C, int L, int W, int B2, int ta_bytes,
                             int lfsr, int lfsr_bits, int refresh, int rand_bits,
                             unsigned int taps, int blocks, void* stream) {
  return launch(in_kernel(lfsr, refresh), ta, out, lit, cl, t1, t2, l_mask, scalars, nullptr,
                nullptr, nullptr, inc_out, K, C, L, W, B2, 0, ta_bytes, lfsr_bits, rand_bits,
                taps, blocks, stream);
}

// The groups tile_idx[k, :count[k]] (int32 [K, S] and [K]), in place in
// ta and inc.
extern "C" int dtm_ta_update_sparse(void* ta, const void* lit, const void* cl, const void* t1,
                                    const void* t2, const void* l_mask, const void* scalars,
                                    const void* tile_idx, const void* count, void* inc, int K,
                                    int C, int L, int W, int B2, int S, int ta_bytes, int lfsr,
                                    int lfsr_bits, int refresh, int rand_bits,
                                    unsigned int taps, int blocks, void* stream) {
  return launch(in_kernel(lfsr, refresh), ta, ta, lit, cl, t1, t2, l_mask, scalars, tile_idx,
                count, nullptr, inc, K, C, L, W, B2, S, ta_bytes, lfsr_bits, rand_bits, taps,
                blocks, stream);
}

// Every row, into new buffers, the random words read from rands
// [K, B2, C, L] (uint32 bit patterns); the seed and row0 scalars are unused.
extern "C" int dtm_ta_update_streamed(const void* ta, const void* lit, const void* cl,
                                      const void* t1, const void* t2, const void* l_mask,
                                      const void* scalars, const void* rands, void* out,
                                      void* inc_out, int K, int C, int L, int W, int B2,
                                      int ta_bytes, int blocks, void* stream) {
  return launch(kStreamed, ta, out, lit, cl, t1, t2, l_mask, scalars, nullptr, nullptr, rands,
                inc_out, K, C, L, W, B2, 0, ta_bytes, 0, 32, 0u, blocks, stream);
}
