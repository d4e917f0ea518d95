// Dense clause evaluation and fused inference on Hopper (sm_90a): one
// clause body, two epilogues.
//
//   viol[k, b, c]   = Σ_l (1 − lit[k, b, l]) · inc[k, c, l]
//   clause[k, b, c] = viol == 0   (and, in eval mode, row c of inc has an include)
//   sums[k, b, h]   = Σ_c clause[k, b, c] · w[k, h, c]            (tm_infer)
//
// dtm_clause_eval replaces repro/kernels/clause_eval.py: clause_eval (the
// Pallas int8 product on the MXU, violation and include counts carried
// across the literal grid axis); its epilogue stores the int32 clauses.
// dtm_tm_infer replaces repro/kernels/tm_infer.py: tm_infer, whose clause
// tile feeds the class sums on chip; its epilogue adds the weights of the
// fired clauses, so the clause tile never goes to device memory.  The sums
// are unpinned, as in the JAX kernel.
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
// The clause body (clause_stream), a streaming bit-packed tile.  A clause
// fires iff no bit of inc & (lit == 0) is set, so no count is needed.
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
//    written; then each arrives again and rank 0 alone waits and ORs the
//    words.  No scratch, no memset between the splits.
//  * The epilogue runs in rank 0 (or in the block, without a split) once
//    each lane knows which of the 32 batch rows its clause fires for, the
//    c < C and eval-mode nonempty gates applied:
//    - Clauses (dtm_clause_eval) writes the int32 outputs;
//    - ClassSums (dtm_tm_infer) has had the weights of the block's 128
//      clauses for the first 16 classes in flight since the first stages
//      (4-byte cp.async copies in the third ring stage's group, issued by
//      the epilogue's block only), turns the lanes' fired masks into one
//      128-bit mask per batch
//      row (32 ballots a warp), adds the weights of the set bits with a
//      thread per (row, class) and adds each nonzero partial into the
//      zeroed [K, B, H] output with an integer atomic: exact in any order.
//      Classes run in passes of 16, so any H works.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

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

// The 4 bytes at l..l+3 of a row of n bytes, bytes past n read as zero.
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int l, int n) {
  uint32_t v = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (l + e < n) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + l + e))) << (8 * e);
  return v;
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
      dtm_cp_async16(d, src, ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(d) =
          ok ? load16_bytes(inc_k + static_cast<long long>(c) * L, l, L) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The tile a block evaluates: program k, batch rows [b0, b0 + nb) of B,
// clauses [c0, c0 + kTileC) of C.
struct TileAt {
  int k, B, C, b0, nb, c0;
};

// An epilogue's finish(smem, tile, c, fired) runs in every thread of the
// block that holds the tile's clauses (rank 0 after a split): the lane's
// clause c, and bit b of fired set iff it fires for batch row b0 + b (the
// c < C and eval-mode nonempty gates applied).  An epilogue with kPerLane
// writes each lane's clause alone: without a split it stores straight
// from the lane's accumulators (from_acc), and lanes past C leave early.

// Epilogue of dtm_clause_eval: the int32 clause outputs.
struct Clauses {
  int32_t* out;
  static constexpr int kSmem = 0;
  static constexpr bool kPerLane = true;
  __device__ void prefetch(uint8_t*, const TileAt&) const {}
  // acc[b] != 0: the clause is violated for batch row b0 + b
  __device__ void from_acc(const TileAt& t, int c, const uint32_t (&acc)[kTileB],
                           bool gate) const {
    int32_t* out_k = out + static_cast<long long>(t.k) * t.B * t.C;
    if (c < t.C)
#pragma unroll
      for (int b = 0; b < kTileB; ++b)   // unrolled: acc stays in registers
        if (b < t.nb) out_k[static_cast<long long>(t.b0 + b) * t.C + c] = (acc[b] == 0u && gate) ? 1 : 0;
  }
  __device__ void finish(uint8_t*, const TileAt& t, int c, uint32_t fired) const {
    if (c >= t.C) return;
    int32_t* out_k = out + static_cast<long long>(t.k) * t.B * t.C;
    for (int b = 0; b < t.nb; ++b)
      out_k[static_cast<long long>(t.b0 + b) * t.C + c] = static_cast<int32_t>((fired >> b) & 1u);
  }
};

// Epilogue of dtm_tm_infer: the class sums of the fired clauses, added into
// the zeroed output.
constexpr int kClasses = 16;          // classes per pass
constexpr int kWStride = kTileC + 1;  // padded weight row: a warp's 16 classes hit 16 banks

struct ClassSums {
  const int32_t* w;
  int32_t* out;
  int H;
  // weights [kClasses][kWStride], then the fired masks [kTileB rows][kWarps]
  static constexpr int kSmem = (kClasses * kWStride + kTileB * kWarps) * 4;
  static constexpr bool kPerLane = false;   // the block's lanes vote together

  // weights of classes [h0, h0 + kClasses) of the tile's clauses, zero past H or C
  __device__ void load_weights(uint8_t* smem, const TileAt& t, int h0) const {
    int32_t* s_w = reinterpret_cast<int32_t*>(smem);
    const int32_t* w_k = w + static_cast<long long>(t.k) * H * t.C;
    for (int i = threadIdx.x; i < kClasses * kTileC; i += kThreads) {
      const int h = i / kTileC, c = i % kTileC;
      const bool ok = h0 + h < H && t.c0 + c < t.C;
      const int32_t* src = ok ? w_k + static_cast<long long>(h0 + h) * t.C + t.c0 + c : w;
      dtm_cp_async4(s_w + h * kWStride + c, src, ok ? 4 : 0);
    }
  }
  __device__ void prefetch(uint8_t* smem, const TileAt& t) const { load_weights(smem, t, 0); }

  __device__ void finish(uint8_t* smem, const TileAt& t, int, uint32_t fired) const {
    const int32_t* s_w = reinterpret_cast<const int32_t*>(smem);
    uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + kClasses * kWStride * 4);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // lane b keeps the warp's 32 clause bits of batch row b
    uint32_t mine = 0u;
#pragma unroll
    for (int b = 0; b < kTileB; ++b) {
      const uint32_t m = __ballot_sync(0xffffffffu, (fired >> b) & 1u);
      if (lane == b) mine = m;
    }
    s_mask[lane * kWarps + warp] = mine;
    dtm_cp_async_wait<0>();
    __syncthreads();
    int32_t* out_k = out + static_cast<long long>(t.k) * t.B * H;
    for (int h0 = 0; h0 < H; h0 += kClasses) {
      if (h0 > 0) {       // the next pass's weights, once every thread is done with these
        __syncthreads();
        load_weights(smem, t, h0);
        dtm_cp_async_commit();
        dtm_cp_async_wait<0>();
        __syncthreads();
      }
      for (int p = threadIdx.x; p < kTileB * kClasses; p += kThreads) {
        const int r = p / kClasses, h = p % kClasses;
        if (r >= t.nb || h0 + h >= H) continue;
        int32_t s = 0;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          uint32_t m = s_mask[r * kWarps + q];
          while (m) {
            s += s_w[h * kWStride + 32 * q + __ffs(m) - 1];
            m &= m - 1u;
          }
        }
        if (s != 0) atomicAdd(out_k + static_cast<long long>(t.b0 + r) * H + h0 + h, s);
      }
    }
  }
};

// Block (blockIdx.x = clause tile · splits + split, blockIdx.y = batch
// tile, blockIdx.z = program).  cps: chunks per split, walked in ranges of
// at most kMaxChunks (the packed literals of a range fill s_neg) when
// kRanges, else in one range (cps <= kMaxChunks: no range loop, which
// slows small shapes); splits: the number of splits, the blocks of one
// cluster (launched with that cluster size when it is above 1).  Dynamic
// shared memory: the rings, the epilogue's Epi::kSmem bytes, then the
// packed literals of a range.
template <bool kVec, bool kRanges, class Epi>
__global__ void __launch_bounds__(kThreads)
clause_stream(const int8_t* __restrict__ lit, const int8_t* __restrict__ inc, Epi epi, int B,
              int C, int L, int cps, int splits, bool eval_mode) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  uint8_t* epi_smem = smem + kRingBytes;
  uint32_t* s_neg = reinterpret_cast<uint32_t*>(epi_smem + Epi::kSmem);   // [word][32 rows]
  // rank 0 of a cluster: every split's violated rows | nonempty << 32
  __shared__ unsigned long long s_part[kMaxSplits][kTileC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = blockIdx.x / splits, sp = blockIdx.x % splits;
  const TileAt tile{static_cast<int>(blockIdx.z), B, C, static_cast<int>(blockIdx.y) * kTileB,
                    min(kTileB, B - static_cast<int>(blockIdx.y) * kTileB), ct * kTileC};
  const int b0 = tile.b0;
  const int ch0 = sp * cps;
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int nst = min(cps, nchunks - ch0);   // this split's chunks
  const int8_t* inc_k = inc + static_cast<long long>(tile.k) * C * L;
  const int8_t* lit_k = lit + static_cast<long long>(tile.k) * B * L;
  uint8_t* wring = ring + warp * kStages * kStageBytes;
  const int c0w = tile.c0 + warp * 32;

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
    // kStages − 1 include stages (the epilogue's prefetch joins the last
    // of them, so the ring waits for nothing more), then the rest of the
    // literals
    uint4 f0, f1;
    if (static_cast<int>(threadIdx.x) < nwords * kTileB) lit_load(threadIdx.x, f0, f1);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nr) load_stage<kVec>(wring + s * kStageBytes, inc_k, c0w, C, L, l_lo + s * kChunk, lane);
      if (s == kStages - 2 && r0 == 0 && sp == 0) epi.prefetch(epi_smem, tile);
      dtm_cp_async_commit();
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
      dtm_cp_async_wait<kStages - 2>();   // this lane's copies of stage i
      __syncwarp();                   // ... and every lane's; slot (i − 1) is free
      const int nxt = i + kStages - 1;
      if (nxt < nr)
        load_stage<kVec>(wring + (nxt % kStages) * kStageBytes, inc_k, c0w, C, L,
                         l_lo + nxt * kChunk, lane);
      dtm_cp_async_commit();
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
    dtm_cp_async_wait<0>();
    if (!kRanges) break;
  }

  const int c = c0w + lane;
  if constexpr (Epi::kPerLane) {
    if (splits == 1) {
      epi.from_acc(tile, c, acc, !eval_mode || nz != 0u);
      return;
    }
  }
  // violated rows of this lane's clause (unrolled: acc stays in registers)
  uint32_t vm = 0u;
#pragma unroll
  for (int b = 0; b < kTileB; ++b) vm |= (acc[b] != 0u ? 1u : 0u) << b;
  if (splits > 1) {
    // once every split has started, each stores its partial masks into
    // rank 0's shared memory (distributed shared memory) and arrives on the
    // cluster barrier again; rank 0 waits and ORs the splits' words
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    cluster.map_shared_rank(&s_part[0][0], 0)[sp * kTileC + threadIdx.x] =
        vm | (static_cast<unsigned long long>(nz != 0u) << 32);
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (sp != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if constexpr (Epi::kPerLane) {
      if (c >= C) return;
    }
    unsigned long long all = 0ull;
    for (int r = 0; r < splits; ++r) all |= s_part[r][threadIdx.x];
    vm = static_cast<uint32_t>(all);
    nz = static_cast<uint32_t>(all >> 32);
  }
  const bool on = c < C && (!eval_mode || nz != 0u);
  epi.finish(epi_smem, tile, c, on ? ~vm : 0u);
}

// dynamic shared memory of a launch: the rings, the epilogue's and the
// packed literals of a range
template <class Epi>
size_t smem_bytes(int cps) {
  return static_cast<size_t>(kRingBytes) + Epi::kSmem +
         static_cast<size_t>(min(cps, kMaxChunks)) * kWordsPerChunk * kTileB * 4;
}

// The literal axis is cut into splits of cps chunks; the splits of a tile
// form one cluster.
template <class Epi>
int launch(const void* lit, const void* inc, Epi epi, int K, int B, int C, int L,
           int eval_mode, int vec, int cps, void* stream) {
  const int nchunks = (L + kChunk - 1) / kChunk;
  if (cps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = max(1, (nchunks + cps - 1) / cps);
  if (splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<Epi>(cps);
  const bool ranges = cps > kMaxChunks;
  auto kernel = vec ? (ranges ? clause_stream<true, true, Epi> : clause_stream<true, false, Epi>)
                    : (ranges ? clause_stream<false, true, Epi> : clause_stream<false, false, Epi>);
  // static (s_part) and dynamic shared memory above 48 KB only after opting in
  if (smem + sizeof(unsigned long long) * kMaxSplits * kTileC > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((C + kTileC - 1) / kTileC) * splits, (B + kTileB - 1) / kTileB, K);
  cfg.blockDim = dim3(kThreads);
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
                                           static_cast<const int8_t*>(inc), epi, B, C, L, cps,
                                           splits, eval_mode != 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec = 1 when L is a multiple of 16 and both operand pointers are 16-byte
// aligned (cp.async 16-byte copies); else the kernel loads bytes.  cps:
// chunks per split (kernels/clause_eval.py clause_split).
extern "C" int dtm_clause_eval(const void* lit, const void* inc, void* out, int K, int B,
                               int C, int L, int eval_mode, int vec, int cps, void* stream) {
  return launch(lit, inc, Clauses{static_cast<int32_t*>(out)}, K, B, C, L, eval_mode, vec, cps,
                stream);
}

// out must be zeroed: the kernel adds into it.
extern "C" int dtm_tm_infer(const void* lit, const void* inc, const void* w, void* out, int K,
                            int B, int C, int L, int H, int eval_mode, int vec, int cps,
                            void* stream) {
  return launch(lit, inc,
                ClassSums{static_cast<const int32_t*>(w), static_cast<int32_t*>(out), H}, K, B,
                C, L, eval_mode, vec, cps, stream);
}
