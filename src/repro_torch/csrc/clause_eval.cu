// Dense clause evaluation and fused inference on Hopper (sm_90a): two
// entry points.
//
//   viol[k, b, c]   = Σ_l (1 − lit[k, b, l]) · inc[k, c, l]
//   clause[k, b, c] = viol == 0   (and, in eval mode, row c of inc has an include)
//   sums[k, b, h]   = Σ_c clause[k, b, c] · w[k, h, c]            (tm_infer)
//
// dtm_clause_eval replaces repro/kernels/clause_eval.py: clause_eval (the
// Pallas int8 product on the MXU, violation and include counts carried
// across the literal grid axis).  dtm_tm_infer replaces
// repro/kernels/tm_infer.py: tm_infer, whose clause tile feeds the class
// sums on chip; here too the clause tile never goes to device memory.
// The sums are unpinned, as in the JAX kernel.
//
// Operands: literals int8 [K, B, L] and include int8 [K, C, L], one byte per
// literal (any nonzero byte counts as 1); weights int32 [K, H, C]; all
// contiguous.  k is the program axis of a bank (blockIdx.z).
//
// Bound: device-memory bytes.  The include matrix is K·C·L bytes (54 MB at
// the serving bank, K=4, C=4224, L=3200) against K·B·L literal bytes; the
// work is a violation test per (b, c, l), far below the byte time once
// literals are bits.
//
// dtm_clause_eval, the streaming bit-packed kernel.  A clause fires iff no
// bit of inc & (lit == 0) is set, so no count is needed.
//  * Pack to bits on the way in: 32 literal bytes become one word (bit
//    8j + i = byte j of word i is nonzero, one LOP3/IADD/LOP3 per 4 bytes
//    and a shift-or), the same permutation for both operands, so one LOP3
//    (acc |= inc & neg) covers 32 literals.  The block packs the
//    literals of its 32 batch rows and literal range once (neg = ~bits),
//    into shared memory, [word][row], read as broadcast 16-byte loads.
//  * Keep loads in flight: each warp owns 32 clause rows (lane = clause)
//    and streams their include bytes through its own ring of 4 stages of
//    128 bytes a row (cp.async, 16 bytes a lane, 4 rows a warp
//    instruction, rows padded to 144 bytes so a lane's own-row reads are
//    conflict-free).  Stage i is packed and tested while stages i+1…i+3
//    arrive; a warp waits on its own copies and __syncwarp()s, so the main
//    loop has no block barrier.  Byte loads through registers when L or a
//    pointer is not 16-byte aligned; bytes past L read as zero (a zero
//    include never violates and never makes a clause nonempty).  (TMA bulk
//    copies of each lane's row chunk measured slower here.)
//  * Fill the card at small B·C: a block is 32 batch rows × 128 clauses ×
//    a range of the literal axis; the wrapper (kernels/clause_eval.py
//    clause_split) splits L so that about two blocks run per SM, at most
//    8 splits.  A split packs its literals into shared memory in ranges
//    of at most 64 chunks (8192 literals, 32 KB), so any L works; only
//    L > 65,536 takes more than one range.  The splits of a tile are one
//    thread-block cluster: each block arrives on the cluster barrier
//    (relaxed) once its first copies are in flight and waits on it just
//    before it stores its clauses' violated-row masks and nonempty bits
//    (one 64-bit word per clause) into the shared memory of rank 0
//    (distributed shared memory), so rank 0 has started before it is
//    written; then each arrives again and rank 0 alone waits, ORs the
//    words and writes the int32 outputs.  No scratch, no atomics, no memset; without a split
//    the block writes from registers.
//
// dtm_tm_infer keeps the first version's clause tile (clause_tile below): a
// block owns 32 batch rows × 64 clauses and walks the literal axis in
// 128-byte chunks staged in shared memory as {0, 1} bytes (one LOP3 per 4
// literals, rows of 33 words to keep shared loads conflict-free), then
// turns the tile into one 64-bit fired mask per batch row (warp ballots),
// stages the weights of its 64 clauses, adds the weights of the fired
// clauses per (row, class) and adds each nonzero partial sum into the
// zeroed [K, B, H] output with an integer atomic: exact in any order.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kRows = 32;          // batch rows per block
constexpr int kClauses = 64;       // clauses per block
constexpr int kThreads = 128;
constexpr int kChunk = 128;        // literal bytes per stage
constexpr int kWords = kChunk / 4; // words per staged row
constexpr int kStride = kWords + 1;
constexpr int kClasses = 16;       // classes per pass of the sum stage

struct Ones {    // byte != 0 -> 1
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return __vcmpne4(x, 0u) & 0x01010101u;
  }
};

struct Zeros {   // byte == 0 -> 1
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return __vcmpeq4(x, 0u) & 0x01010101u;
  }
};

// The 4 bytes at l..l+3 of a row of n bytes, bytes past n read as zero.
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int l, int n) {
  uint32_t v = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (l + e < n) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + l + e))) << (8 * e);
  return v;
}

// Stage chunk [l0, l0 + kChunk) of `rows` rows (from row0 of nrows) into
// s[row][kStride], each word passed through f.
template <bool kVec, typename F>
__device__ __forceinline__ void stage(uint32_t* s, const int8_t* base, int row0, int nrows,
                                      int rows, int L, int l0, F f) {
  if (kVec) {
    for (int i = threadIdx.x; i < rows * (kChunk / 16); i += kThreads) {
      const int r = i / (kChunk / 16), q = i % (kChunk / 16);
      const int l = l0 + 16 * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < nrows && l < L)
        v = __ldg(reinterpret_cast<const uint4*>(base + static_cast<long long>(row0 + r) * L + l));
      uint32_t* d = s + r * kStride + 4 * q;
      d[0] = f(v.x);
      d[1] = f(v.y);
      d[2] = f(v.z);
      d[3] = f(v.w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kWords; i += kThreads) {
      const int r = i / kWords, q = i % kWords;
      uint32_t v = 0u;
      if (row0 + r < nrows)
        v = load_word(base + static_cast<long long>(row0 + r) * L, l0 + 4 * q, L);
      s[r * kStride + q] = f(v);
    }
  }
}

struct Tile {
  uint32_t acc[4][4];   // [batch j][clause i]: OR of the violation bytes
  uint32_t nz[4];       // [clause i]: OR of the include bytes
};

// The clause tile of block (blockIdx.x: clause chunk, blockIdx.y: batch
// chunk, blockIdx.z: program).  Thread t holds batch rows bg + 8j and
// clauses cg + 16i of the tile (bg = t / 16, cg = t % 16).
template <bool kVec>
__device__ __forceinline__ void clause_tile(const int8_t* __restrict__ lit,
                                            const int8_t* __restrict__ inc, int B, int C,
                                            int L, Tile& t) {
  __shared__ uint32_t s_neg[kRows * kStride];
  __shared__ uint32_t s_inc[kClauses * kStride];
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * kRows, c0 = blockIdx.x * kClauses;
  const int8_t* lit_k = lit + static_cast<long long>(k) * B * L;
  const int8_t* inc_k = inc + static_cast<long long>(k) * C * L;
  const int cg = threadIdx.x & 15, bg = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) t.acc[j][i] = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) t.nz[i] = 0u;

  for (int l0 = 0; l0 < L; l0 += kChunk) {
    stage<kVec>(s_neg, lit_k, b0, B, kRows, L, l0, Zeros());
    stage<kVec>(s_inc, inc_k, c0, C, kClauses, L, l0, Ones());
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < kWords; ++w) {
      uint32_t iw[4], nw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) iw[i] = s_inc[(cg + 16 * i) * kStride + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) nw[j] = s_neg[(bg + 8 * j) * kStride + w];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) t.acc[j][i] |= iw[i] & nw[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) t.nz[i] |= iw[i];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool fired(const Tile& t, int j, int i, bool eval_mode) {
  return t.acc[j][i] == 0u && (!eval_mode || t.nz[i] != 0u);
}

// ---- dtm_clause_eval: the streaming bit-packed kernel ----------------------

namespace ce {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileB = 32;            // batch rows per block (one word of acc each)
constexpr int kTileC = kWarps * 32;   // clauses per block, one per lane
constexpr int kChunk = 128;           // literal bytes a row per stage
constexpr int kStages = 4;            // ring depth per warp
constexpr int kSegs = kChunk / 16;    // 16-byte segments a row per stage
constexpr int kWordsPerChunk = kChunk / 32;       // packed words a row per stage
constexpr int kRowBytes = kChunk + 16;            // padded staged row
constexpr int kStageBytes = 32 * kRowBytes;       // one warp's stage
constexpr int kRingBytes = kWarps * kStages * kStageBytes;
constexpr int kMaxChunks = 32768 / (kWordsPerChunk * kTileB * 4);   // packed literals <= 32 KB
constexpr int kMaxSplits = 8;         // blocks of a cluster (the portable limit)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bit 7 of each byte: the byte is nonzero
__device__ __forceinline__ uint32_t nonzero7(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// 32 literal bytes (8 words) -> 32 bits: bit 8j + i = byte j of word i is
// nonzero.  Both operands use this one permutation of the 32 literals.
__device__ __forceinline__ uint32_t pack32(const uint32_t* x) {
  uint32_t p = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) p |= nonzero7(x[i]) >> (7 - i);
  return p;
}

// 16 bytes at l of a row of n bytes, bytes past n read as zero.
__device__ __forceinline__ uint4 load16_bytes(const int8_t* row, int l, int n) {
  return make_uint4(load_word(row, l, n), load_word(row, l + 4, n),
                    load_word(row, l + 8, n), load_word(row, l + 12, n));
}

// Stage chunk [l0, l0 + kChunk) of the warp's 32 clause rows (from c0w)
// into dst: lane i of 32 takes 16-byte segments lane + 32t, so kSegs lanes
// cover a row's chunk and one warp instruction 32 / kSegs rows.
template <bool kVec>
__device__ __forceinline__ void load_stage(uint8_t* dst, const int8_t* inc_k, int c0w, int C,
                                           int L, int l0, int lane) {
#pragma unroll
  for (int t = 0; t < kSegs; ++t) {
    const int i = lane + 32 * t, r = i / kSegs, q = i % kSegs;
    const int l = l0 + 16 * q, c = c0w + r;
    uint8_t* d = dst + r * kRowBytes + 16 * q;
    const bool ok = c < C && l < L;
    if (kVec) {
      const int8_t* src = ok ? inc_k + static_cast<long long>(c) * L + l : inc_k;
      cp_async16(d, src, ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(d) =
          ok ? load16_bytes(inc_k + static_cast<long long>(c) * L, l, L) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Block (blockIdx.x = clause tile · splits + split, blockIdx.y = batch
// tile, blockIdx.z = program).  cps: chunks per split, walked in ranges of
// at most kMaxChunks (the packed literals of a range fill s_neg) when
// kRanges, else in one range (cps <= kMaxChunks: no range loop, which
// slows small shapes); splits: the number of splits, the blocks of one
// cluster (launched with that cluster size when it is above 1).
template <bool kVec, bool kRanges>
__global__ void __launch_bounds__(kThreads)
clause_eval_stream(const int8_t* __restrict__ lit, const int8_t* __restrict__ inc,
                   int32_t* __restrict__ out, int B, int C, int L, int cps, int splits,
                   bool eval_mode) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  uint32_t* s_neg = reinterpret_cast<uint32_t*>(smem + kRingBytes);   // [word][32 rows]
  // rank 0 of a cluster: every split's violated rows | nonempty << 32
  __shared__ unsigned long long s_part[kMaxSplits][kTileC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.z, bt = blockIdx.y;
  const int ct = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int b0 = bt * kTileB, c0 = ct * kTileC;
  const int ch0 = sp * cps;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int nst = min(cps, nchunks - ch0);   // this split's chunks
  const int8_t* inc_k = inc + static_cast<long long>(k) * C * L;
  const int8_t* lit_k = lit + static_cast<long long>(k) * B * L;
  uint8_t* wring = ring + warp * kStages * kStageBytes;
  const int c0w = c0 + warp * 32;

  uint32_t acc[kTileB];
#pragma unroll
  for (int b = 0; b < kTileB; ++b) acc[b] = 0u;
  uint32_t nz = 0u;
  for (int r0 = 0; r0 < nst; r0 += kMaxChunks) {   // one range unless L > 64 Ki
    const int nr = kRanges ? min(kMaxChunks, nst - r0) : nst;
    const int l_lo = (ch0 + r0) * kChunk;
    if (r0 > 0) __syncthreads();   // every warp is done with s_neg and its ring

    // neg = (lit == 0) of item i = (word i / 32, batch row i % 32) of this
    // block's rows and range: its two 16-byte halves, and their packing
    const int nwords = kWordsPerChunk * nr;
    auto lit_load = [&](int i, uint4& v0, uint4& v1) {
      const int b = i & 31, l = l_lo + 32 * (i >> 5);
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      v0 = v1 = z;
      if (b0 + b >= B) return;
      const int8_t* r = lit_k + static_cast<long long>(b0 + b) * L;
      if (kVec) {
        if (l < L) v0 = __ldg(reinterpret_cast<const uint4*>(r + l));
        if (l + 16 < L) v1 = __ldg(reinterpret_cast<const uint4*>(r + l + 16));
      } else {
        v0 = load16_bytes(r, l, L);
        v1 = load16_bytes(r, l + 16, L);
      }
    };
    auto lit_store = [&](int i, const uint4& v0, const uint4& v1) {
      const uint32_t x[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      s_neg[i] = b0 + (i & 31) < B ? ~pack32(x) : 0u;   // s_neg[word][row]
    };

    // this thread's first literal loads go out first, then the first
    // kStages − 1 include stages, then the rest of the literals
    uint4 f0, f1;
    if (static_cast<int>(threadIdx.x) < nwords * kTileB) lit_load(threadIdx.x, f0, f1);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nr) load_stage<kVec>(wring + s * kStageBytes, inc_k, c0w, C, L, l_lo + s * kChunk, lane);
      cp_async_commit();
    }
    // Every split says that it has started, once its first copies are in
    // flight (an arrive at entry would stall them), and waits for the
    // others only before it writes rank 0's shared memory: a block's
    // shared memory may be written only once the block runs.
    if (splits > 1 && r0 == 0) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    if (static_cast<int>(threadIdx.x) < nwords * kTileB) lit_store(threadIdx.x, f0, f1);
#pragma unroll 4
    for (int i = threadIdx.x + kThreads; i < nwords * kTileB; i += kThreads) {
      uint4 v0, v1;
      lit_load(i, v0, v1);
      lit_store(i, v0, v1);
    }
    __syncthreads();

    for (int i = 0; i < nr; ++i) {
      cp_async_wait<kStages - 2>();   // this lane's copies of stage i
      __syncwarp();                   // ... and every lane's; slot (i − 1) is free
      const int nxt = i + kStages - 1;
      if (nxt < nr)
        load_stage<kVec>(wring + (nxt % kStages) * kStageBytes, inc_k, c0w, C, L,
                         l_lo + nxt * kChunk, lane);
      cp_async_commit();
      const uint4* row = reinterpret_cast<const uint4*>(wring + (i % kStages) * kStageBytes +
                                                        lane * kRowBytes);
#pragma unroll
      for (int pw = 0; pw < kWordsPerChunk; ++pw) {
        const uint4 v0 = row[2 * pw], v1 = row[2 * pw + 1];
        const uint32_t x[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        const uint32_t p = pack32(x);
        nz |= p;
        const uint4* n = reinterpret_cast<const uint4*>(s_neg + (i * kWordsPerChunk + pw) * 32);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint4 a = n[q];
          acc[4 * q] |= p & a.x;
          acc[4 * q + 1] |= p & a.y;
          acc[4 * q + 2] |= p & a.z;
          acc[4 * q + 3] |= p & a.w;
        }
      }
    }
    cp_async_wait<0>();
    if (!kRanges) break;
  }

  const int c = c0w + lane;
  const int nb = min(kTileB, B - b0);
  int32_t* out_k = out + static_cast<long long>(k) * B * C;
  if (splits == 1) {
    const bool gate = !eval_mode || nz != 0u;
    if (c < C)
#pragma unroll
      for (int b = 0; b < kTileB; ++b)   // unrolled: acc stays in registers
        if (b < nb) out_k[static_cast<long long>(b0 + b) * C + c] = (acc[b] == 0u && gate) ? 1 : 0;
    return;
  }
  // once every split has started, each stores its partial masks into rank
  // 0's shared memory (distributed shared memory) and arrives on the
  // cluster barrier again; rank 0 waits, ORs the splits' words and writes
  // the tile
  uint32_t vm = 0u;
#pragma unroll
  for (int b = 0; b < kTileB; ++b) vm |= (acc[b] != 0u ? 1u : 0u) << b;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  cluster.map_shared_rank(&s_part[0][0], 0)[sp * kTileC + threadIdx.x] =
      vm | (static_cast<unsigned long long>(nz != 0u) << 32);
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (sp != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (c >= C) return;
  unsigned long long all = 0ull;
  for (int r = 0; r < splits; ++r) all |= s_part[r][threadIdx.x];
  const uint32_t viol = static_cast<uint32_t>(all);
  const bool gate = !eval_mode || (all >> 32) != 0ull;
  for (int b = 0; b < nb; ++b)
    out_k[static_cast<long long>(b0 + b) * C + c] = (((viol >> b) & 1u) == 0u && gate) ? 1 : 0;
}

// dynamic shared memory of a launch: the rings and the packed literals of
// a range
size_t smem_bytes(int cps) {
  return static_cast<size_t>(kRingBytes) +
         static_cast<size_t>(min(cps, kMaxChunks)) * kWordsPerChunk * kTileB * 4;
}

}  // namespace ce

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tm_infer_kernel(const int8_t* __restrict__ lit, const int8_t* __restrict__ inc,
                const int32_t* __restrict__ w, int32_t* __restrict__ out, int B, int C,
                int L, int H, bool eval_mode) {
  __shared__ __align__(8) uint16_t s_mask[kRows][4];   // fired clauses per row
  __shared__ int32_t s_w[kClasses * (kClauses + 1)];
  Tile t;
  clause_tile<kVec>(lit, inc, B, C, L, t);
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * kRows, c0 = blockIdx.x * kClauses;
  const int cg = threadIdx.x & 15, bg = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31;

  // lanes 0-15 hold row bg = 2·warp, lanes 16-31 row 2·warp + 1: one ballot
  // per (j, i) gives 16 fired bits of each of the two rows
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool on = fired(t, j, i, eval_mode) && c0 + cg + 16 * i < C;
      const uint32_t m = __ballot_sync(0xffffffffu, on);
      if (lane == 0) {
        const int r = bg + 8 * j;   // lane 0's row; lane 16's is r + 1
        s_mask[r][i] = static_cast<uint16_t>(m & 0xffffu);
        s_mask[r + 1][i] = static_cast<uint16_t>(m >> 16);
      }
    }

  const int32_t* w_k = w + static_cast<long long>(k) * H * C;
  int32_t* out_k = out + static_cast<long long>(k) * B * H;
  for (int h0 = 0; h0 < H; h0 += kClasses) {
    __syncthreads();   // the masks are written; s_w is free
    for (int i = threadIdx.x; i < kClasses * kClauses; i += kThreads) {
      const int h = i / kClauses, c = i % kClauses;
      s_w[h * (kClauses + 1) + c] =
          (h0 + h < H && c0 + c < C) ? __ldg(w_k + static_cast<long long>(h0 + h) * C + c0 + c) : 0;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kRows * kClasses; p += kThreads) {
      const int r = p / kClasses, h = p % kClasses;
      if (b0 + r >= B || h0 + h >= H) continue;
      unsigned long long m = *reinterpret_cast<const unsigned long long*>(s_mask[r]);
      int32_t s = 0;
      while (m) {
        const int c = __ffsll(static_cast<long long>(m)) - 1;
        s += s_w[h * (kClauses + 1) + c];
        m &= m - 1ull;
      }
      if (s != 0) atomicAdd(out_k + static_cast<long long>(b0 + r) * H + h0 + h, s);
    }
  }
}

dim3 grid_of(int K, int B, int C) {
  return dim3((C + kClauses - 1) / kClauses, (B + kRows - 1) / kRows, K);
}

}  // namespace

// vec = 1 when L is a multiple of 16 and both operand pointers are 16-byte
// aligned (cp.async 16-byte copies); else the kernel loads bytes.  The
// literal axis is cut into splits of cps chunks (kernels/clause_eval.py
// clause_split); the splits of a tile form one cluster.
extern "C" int dtm_clause_eval(const void* lit, const void* inc, void* out, int K, int B,
                               int C, int L, int eval_mode, int vec, int cps, void* stream) {
  const int nchunks = (L + ce::kChunk - 1) / ce::kChunk;
  if (cps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = max(1, (nchunks + cps - 1) / cps);
  if (splits > ce::kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ce::smem_bytes(cps);
  const bool ranges = cps > ce::kMaxChunks;
  auto kernel = vec ? (ranges ? ce::clause_eval_stream<true, true> : ce::clause_eval_stream<true, false>)
                    : (ranges ? ce::clause_eval_stream<false, true> : ce::clause_eval_stream<false, false>);
  // static (s_part) and dynamic shared memory above 48 KB only after opting in
  if (smem + sizeof(unsigned long long) * ce::kMaxSplits * ce::kTileC > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((C + ce::kTileC - 1) / ce::kTileC) * splits,
                     (B + ce::kTileB - 1) / ce::kTileB, K);
  cfg.blockDim = dim3(ce::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int8_t*>(lit),
                                           static_cast<const int8_t*>(inc),
                                           static_cast<int32_t*>(out), B, C, L, cps, splits,
                                           eval_mode != 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out must be zeroed: the kernel adds into it.
extern "C" int dtm_tm_infer(const void* lit, const void* inc, const void* w, void* out, int K,
                            int B, int C, int L, int H, int eval_mode, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l8 = static_cast<const int8_t*>(lit);
  const auto* i8 = static_cast<const int8_t*>(inc);
  const auto* w32 = static_cast<const int32_t*>(w);
  auto* o = static_cast<int32_t*>(out);
  if (vec)
    tm_infer_kernel<true><<<grid_of(K, B, C), kThreads, 0, st>>>(l8, i8, w32, o, B, C, L, H,
                                                                 eval_mode != 0);
  else
    tm_infer_kernel<false><<<grid_of(K, B, C), kThreads, 0, st>>>(l8, i8, w32, o, B, C, L, H,
                                                                  eval_mode != 0);
  return static_cast<int>(cudaGetLastError());
}
