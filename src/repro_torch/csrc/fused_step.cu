// Fused training-step front half on Hopper (sm_90a), one launch:
//
//   clause[k, b, r] = (OR_w inc[k, r, w] & ~lit[k, b, w] == 0) · cl_mask[k, r]
//   sums[k, b, h]   = Σ_r clause · w[k, h, r], padded classes -> NEG_INF_SUM
//   sel_y[k, b, r]  = rand[k, y, b, r]·2T < (T ∓ clip(sums[b, cls_y], −T, T)) << rand_bits
//                     and cl_mask[k, r] and (w[k, cls_y, r] != 0 unless w_frozen == 0)
//   for the target round (y = 0, cls = labels, minus) and the negated round
//   (y = 1, cls = neg, plus).  Training-mode clause semantics: an empty
//   clause fires.  Include bits at positions >= n_bits never veto a clause.
//
// Replaces repro/kernels/fused_step.py: fused_step (the Pallas kernel with a
// sequential clause grid axis carrying the class sums in VMEM scratch).
// It takes the engine's packed operands (32 literals per word) instead of
// the unpacked int8 [B, L] / [R, L] pair; the outputs are the same.
//
// Bound: at the main path's shapes (K=1, B=32, R=2048, W=52, H=16) about
// 1.9 MB of device memory (random words, weights, include bitplane, three
// [B, R] outputs) against ~9 M integer operations: both ~0.5 µs, so the
// kernel is bound by its chain of latencies.  The selection needs each
// batch row's complete class sums, which depend on all R clauses, and
// blocks run in no order (the TPU carried them along a sequential grid
// axis).  Design (each choice measured on the H100; PERF.md §6):
//  * One thread-block cluster per (program, batch tile of kRows = 4 rows)
//    splits the clause axis: block `rank` of the cluster's cs blocks owns
//    the 256-row clause tiles rank, rank + cs, ... (cs <= 16, so R past 16
//    tiles loops inside the block; 8 at R=2048).  4 rows and 8 warps beat
//    8 rows or 4 warps: the include bitplane is re-read from L2 for each
//    batch tile, but each block's chain of latencies is shorter.
//  * One thread per clause row.  Each warp's 32 include rows are one
//    contiguous span of 32·W words: one TMA bulk copy on an mbarrier
//    (faster than 16-byte cp.async copies in the design runs), or,
//    where W or R is not a multiple of 4, an operand is not 16-byte
//    aligned or the rows do not fit in shared memory, 4-byte cp.async
//    copies of 64 words a pass into rows of an odd stride.  The batch
//    tile's literal words sit in shared memory as [word][row], their bits
//    past n_bits set, read as 16-byte broadcasts; one LOP3 per (word, row).
//  * A second cp.async group stages the tile's weights of 16 classes,
//    cl_mask and (one tile a block) the random words of both rounds while
//    the clauses are evaluated.  Every load is unconditional (clamped
//    indices): a load behind a branch waits for the one before it.
//  * Class votes: one ballot per batch row; lane l sums class (l & 15)'s
//    weights over the fired bits and adds the sum into the block's partial
//    sums [kRows][H] in shared memory.
//  * The partials meet through distributed shared memory behind one
//    cluster barrier.  Between its arrive and its wait a block stores its
//    clause outputs (after the arrive, so its release waits on no global
//    store) and prepares the selection.  Then it reads the cs partials of
//    the class sums its rows compare against, writes its share (pair i
//    goes to rank i % cs) of the sums output, and runs both selection
//    rounds over its own tiles.  A second, relaxed arrive, waited on at
//    exit, keeps each block's partials alive until every block has read
//    them.  No scratch in device memory, no atomics across blocks, no
//    memset: one launch.
// T, w_frozen and h_mask are read per program from device memory, so a
// program swap or a bank never needs the host.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kRows = 4;                  // batch rows per tile
constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kThreads;           // clause rows per tile, one per thread
constexpr int kWStride = kTile + 4;       // s_w rows: 16 classes read at one column hit 8 banks
constexpr int kWChunk = 64;               // include words of a row staged per pass (4-byte copies)
constexpr int kClasses = 16;              // classes per vote pass
constexpr int kMaxCluster = 16;           // blocks of a cluster (non-portable above 8)
constexpr int kPortableCluster = 8;
constexpr int32_t kNegInfSum = -(1 << 24);
// Row stride of the include words staged by 4-byte copies: odd, so a
// lane's own-row word reads are conflict-free.
constexpr int kStrideWord = kWChunk + 1;

struct Params {
  const uint32_t* lit;
  const uint32_t* inc;
  const int32_t* w;
  const int32_t* labels;
  const int32_t* neg;
  const int32_t* rand;
  const int32_t* cl_mask;
  const int32_t* h_mask;
  const int32_t* T;
  const int32_t* frozen;
  int32_t* clause;
  int32_t* sums;
  int32_t* sel_lab;
  int32_t* sel_neg;
  int B, R, W, H, n_bits, rand_bits;
};

// One TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned phase) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(b),
      "r"(phase)
      : "memory");
}

// Shared memory of a launch (dynamic part), in 4-byte words.
// chunk: include words of a row staged per pass; stride: their row
// stride in shared memory (W and W for the bulk copies).
struct Layout {
  int inc, lit, w, rand, clm, hm, part, total;
  __host__ __device__ Layout(int H, int chunk, int stride) {
    inc = 0;                                       // [kTile][stride]
    lit = inc + kTile * stride;                    // [chunk rounded up to 8][kRows]
    w = lit + ((chunk + 7) & ~7) * kRows;          // [kClasses][kWStride]
    rand = w + kClasses * kWStride;                // [2][kRows][kTile]
    clm = rand + 2 * kRows * kTile;                // [kTile]
    hm = clm + kTile;                              // [H]
    part = hm + H;                                 // [kRows][H]
    total = part + kRows * H;
  }
};

// Copy columns [c0, c0 + n) of `rows` int32 rows (row i at src + i ·
// stride) into dst + i · dst_stride with cp.async by `threads` threads; columns at or
// past R read as zero.  kVec: 16-byte copies (R, stride and src 16-byte
// aligned, n a multiple of 4).
template <bool kVec>
__device__ __forceinline__ void stage_rows(int32_t* dst, int dst_stride, const int32_t* src,
                                           long long stride, int rows, int c0, int n, int R,
                                           int tid, int threads) {
  constexpr int kPer = kVec ? 4 : 1;
  const int per_row = n / kPer;
  for (int i = tid; i < rows * per_row; i += threads) {
    const int row = i / per_row, q = kPer * (i % per_row);
    const bool ok = c0 + q < R;
    const int32_t* from = ok ? src + row * stride + c0 + q : src;
    if (kVec)
      dtm_cp_async16(dst + row * dst_stride + q, from, ok ? 16 : 0);
    else
      dtm_cp_async4(dst + row * dst_stride + q, from, ok ? 4 : 0);
  }
}

// Clause outputs of clause row r for the tile's nb batch rows, bit b of
// `bits` = row b fired.
__device__ __forceinline__ void store_clauses(int32_t* out, int r, int R, int nb, uint32_t bits) {
  if (r >= R) return;
#pragma unroll
  for (int b = 0; b < kRows; ++b)
    if (b < nb) out[static_cast<long long>(b) * R + r] = (bits >> b) & 1u;
}

// Block (blockIdx.x = rank in the cluster over R, blockIdx.y = batch tile,
// blockIdx.z = program); the cluster is (gridDim.x, 1, 1).  kBulk: W and R
// are multiples of 4, the operands are 16-byte aligned and each warp's 32
// include rows (all W words, row stride W) come in one bulk copy; else
// 4-byte copies, 64 words a pass.
template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int B = p.B, R = p.R, W = p.W, H = p.H;
  const int chunk = kBulk ? W : kWChunk;
  const int stride = kBulk ? W : kStrideWord;
  const Layout lay(H, chunk, stride);
  uint32_t* s_inc = smem + lay.inc;
  uint32_t* s_lit = smem + lay.lit;
  int32_t* s_w = reinterpret_cast<int32_t*>(smem + lay.w);
  int32_t* s_rand = reinterpret_cast<int32_t*>(smem + lay.rand);
  int32_t* s_clm = reinterpret_cast<int32_t*>(smem + lay.clm);
  int32_t* s_hm = reinterpret_cast<int32_t*>(smem + lay.hm);
  int32_t* s_part = reinterpret_cast<int32_t*>(smem + lay.part);
  __shared__ int32_t s_cls[2][kRows];
  __shared__ int32_t s_rhs[2][kRows];
  __shared__ int32_t s_scalar[2];   // T, w_frozen
  __shared__ __align__(8) uint64_t s_bar[kWarps];   // kBulk: each warp's include rows
  unsigned bar_phase = 0u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int k = blockIdx.z, b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int ntiles = (R + kTile - 1) / kTile;
  const bool single = ntiles <= cs;   // one tile a block: the selection reads what phase 1 staged
  const int hs = min(H, kClasses);    // classes whose weights are staged
  const long long kB = static_cast<long long>(k) * B;
  const uint32_t* lit_k = p.lit + (kB + b0) * W;
  const uint32_t* inc_k = p.inc + static_cast<long long>(k) * R * W;
  const int32_t* w_k = p.w + static_cast<long long>(k) * H * R;
  const int32_t* clm_k = p.cl_mask + static_cast<long long>(k) * R;
  const int32_t* rand_k = p.rand + (static_cast<long long>(k) * 2 * B + b0) * R;   // + y·B·R

  // per-program operands the exchange and the selection read, staged with
  // the first tile's words
  if (tid < 2 * kRows && tid % kRows < nb)
    dtm_cp_async4(&s_cls[tid / kRows][tid % kRows],
                  (tid < kRows ? p.labels : p.neg) + kB + b0 + tid % kRows, 4);
  if (tid == 0) dtm_cp_async4(&s_scalar[0], p.T + k, 4);
  if (tid == 1) dtm_cp_async4(&s_scalar[1], p.frozen + k, 4);
  for (int i = tid; i < H; i += kThreads) dtm_cp_async4(s_hm + i, p.h_mask + static_cast<long long>(k) * H + i, 4);
  for (int i = tid; i < kRows * H; i += kThreads) s_part[i] = 0;
  if (kBulk && lane == 0) {
    const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(&s_bar[warp]));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // ---- phase 1: clause outputs and partial class sums of this block's
  // tiles.  One cp.async group stages what a tile needs: its include
  // words, the weights of 16 classes, cl_mask and (one tile a block) the
  // random words of both rounds; the literal words go through registers,
  // their bits past n_bits set (so include bits there never violate).
  uint32_t first_bits = 0u;
  for (int tile = rank; tile < ntiles; tile += cs) {
    const int c0 = tile * kTile, r = c0 + tid;
    const bool in = r < R;
    uint32_t acc[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[b] = 0u;
    const int rw = c0 + warp * 32;   // this warp's first clause row
    uint32_t* s_own = s_inc + warp * 32 * stride;
    for (int w0 = 0; w0 < W; w0 += chunk) {
      const int nw = min(chunk, W - w0);
      __syncthreads();   // the previous chunk and tile are consumed (and the barriers set up)
      const bool bulk_rows = kBulk && rw < R;   // rows past R are never read back
      if (kBulk) {
        if (bulk_rows && lane == 0) {
          if (tile != rank) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bulk_copy(s_own, inc_k + static_cast<long long>(rw) * W,
                    static_cast<unsigned>(min(32, R - rw) * W * 4), &s_bar[warp]);
        }
      } else {
        for (int row = 0; row < 32; ++row) {
          const bool ok = rw + row < R;
          const uint32_t* src = ok ? inc_k + static_cast<long long>(rw + row) * W + w0 : inc_k;
          for (int q = lane; q < nw; q += 32)
            dtm_cp_async4(s_own + row * stride + q, ok ? src + q : src, ok ? 4 : 0);
        }
      }
      dtm_cp_async_commit();   // group 1: the include words (and the scalars)
      if (w0 == 0) {       // group 2: what the votes and the selection read
        stage_rows<kBulk>(s_w, kWStride, w_k, R, hs, c0, kTile, R, tid, kThreads);
        stage_rows<kBulk>(s_clm, kTile, clm_k, 0, 1, c0, kTile, R, tid, kThreads);
        if (single)
          for (int y = 0; y < 2; ++y)
            stage_rows<kBulk>(s_rand + y * kRows * kTile, kTile, rand_k + static_cast<long long>(y) * B * R,
                             R, nb, c0, kTile, R, tid, kThreads);
        dtm_cp_async_commit();
      }
      // s_lit[word][row], 4 loads a thread in flight before their stores;
      // clamped, so each load is unconditional; padded rows and words read
      // as all ones (never violated)
      const int nlit = ((nw + 7) & ~7) * kRows;
      for (int i0 = 0; i0 < nlit; i0 += 4 * kThreads) {
        uint32_t v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = i0 + t * kThreads + tid, b = i % kRows, q = i / kRows;
          v[t] = __ldg(lit_k + static_cast<long long>(min(b, nb - 1)) * W + w0 + min(q, nw - 1));
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = i0 + t * kThreads + tid, b = i % kRows, q = i / kRows;
          if (i < nlit)
            s_lit[i] = (b < nb && q < nw) ? v[t] | ~dtm_tail_mask(w0 + q, p.n_bits) : 0xffffffffu;
        }
      }
      if (w0 == 0)
        dtm_cp_async_wait<1>();   // group 1; group 2 may still be in flight
      else
        dtm_cp_async_wait<0>();
      if (bulk_rows) bar_wait(&s_bar[warp], bar_phase);
      bar_phase ^= kBulk ? 1u : 0u;
      __syncthreads();
      // 8 words a step: their include and literal words are read from
      // shared memory before the 8 · kRows LOP3s use them
      const uint32_t* mine = s_own + lane * stride;
      for (int q0 = 0; q0 < nw; q0 += 8) {
        uint32_t iw[8];
        if (kBulk) {
          const uint4 a = *reinterpret_cast<const uint4*>(mine + q0);
          const uint4 c = *reinterpret_cast<const uint4*>(mine + q0 + 4);   // past nw: unused words
          iw[0] = a.x; iw[1] = a.y; iw[2] = a.z; iw[3] = a.w;
          iw[4] = c.x; iw[5] = c.y; iw[6] = c.z; iw[7] = c.w;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) iw[j] = mine[q0 + j];
        }
        uint4 lw[8][kRows / 4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int b4 = 0; b4 < kRows / 4; ++b4)
            lw[j][b4] = reinterpret_cast<const uint4*>(s_lit + (q0 + j) * kRows)[b4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t x = q0 + j < nw ? iw[j] : 0u;
#pragma unroll
          for (int b4 = 0; b4 < kRows / 4; ++b4) {
            acc[4 * b4] |= x & ~lw[j][b4].x;
            acc[4 * b4 + 1] |= x & ~lw[j][b4].y;
            acc[4 * b4 + 2] |= x & ~lw[j][b4].z;
            acc[4 * b4 + 3] |= x & ~lw[j][b4].w;
          }
        }
      }
    }
    dtm_cp_async_wait<0>();   // group 2
    __syncthreads();
    const bool real = in && s_clm[tid] != 0;
    bool fired[kRows];
    uint32_t bits = 0u;
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      fired[b] = acc[b] == 0u && real && b < nb;
      bits |= (fired[b] ? 1u : 0u) << b;
    }
    // the first tile's clause outputs are stored after the exchange, so
    // the release of the cluster barrier waits on no global store
    if (tile == rank)
      first_bits = bits;
    else
      store_clauses(p.clause + (kB + b0) * R, r, R, nb, bits);
    // votes: one ballot per batch row gives the warp's fired clauses;
    // lane l then sums class (l & 15)'s weights over the fired bits of
    // rows (l >> 4) + 2i and adds them to the block's partial sums.  The
    // weights past the staged 16 classes are read from device memory,
    // clamped so every load is unconditional (what a clamped load reads
    // is never added).
    uint32_t m[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) m[b] = __ballot_sync(0xffffffffu, fired[b]);
    constexpr int kPer = kRows / 2;   // batch rows a lane sums
    for (int h0 = 0; h0 < H; h0 += kClasses) {
      const int h = h0 + (lane & 15);
      int32_t vs[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) vs[i] = 0;
      int32_t wc[32];
      if (h0 == 0) {
        const int32_t* wrow = s_w + min(lane & 15, hs - 1) * kWStride + warp * 32;
#pragma unroll
        for (int c = 0; c < 32; ++c) wc[c] = wrow[c];
      } else {
        const int32_t* wrow = w_k + static_cast<long long>(min(h, H - 1)) * R;
#pragma unroll
        for (int c = 0; c < 32; ++c) wc[c] = __ldg(wrow + min(rw + c, R - 1));
      }
#pragma unroll
      for (int c = 0; c < 32; ++c)
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          vs[i] += ((m[(lane >> 4) + 2 * i] >> c) & 1u) ? wc[c] : 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int b = (lane >> 4) + 2 * i;
        if (b < nb && h < H && vs[i] != 0) atomicAdd(s_part + b * H + h, vs[i]);
      }
    }
  }

  __syncthreads();

  // ---- the partials meet through distributed shared memory.  Between
  // this block's arrive and its wait on the others it stores its first
  // tile's clause outputs and prepares the selection's operands.
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  store_clauses(p.clause + (kB + b0) * R, rank * kTile + tid, R, nb, first_bits);
  const int32_t T = s_scalar[0];
  const bool frozen = s_scalar[1] > 0;
  const uint32_t two_t = 2u * static_cast<uint32_t>(T);
  const int ty = tid / kRows, tb = tid % kRows;
  const bool rhs_thread = tid < 2 * kRows && tb < nb;
  const int my_cls = rhs_thread ? min(max(s_cls[ty][tb], 0), H - 1) : 0;
  // single: the only tile's rand · 2T (int32 wrap-around, as the reference
  // computes it) and eligibility (cl_mask > 0, and for Vanilla the class
  // weight != 0), per round and batch row
  int32_t lhs[2][kRows];
  uint32_t ok = 0u;
  if (single) {
    const bool real = s_clm[tid] > 0;
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        lhs[y][b] = static_cast<int32_t>(
            static_cast<uint32_t>(s_rand[(y * kRows + b) * kTile + tid]) * two_t);
        const int c = min(max(s_cls[y][b], 0), H - 1);
        const int r = rank * kTile + tid;
        bool elig = real;
        if (frozen && b < nb && r < R)
          elig = elig && (c < kClasses ? s_w[c * kWStride + tid]
                                       : __ldg(w_k + static_cast<long long>(c) * R + r)) != 0;
        ok |= (elig ? 1u : 0u) << (y * kRows + b);
      }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rhs_thread) {   // the class sum round ty of batch row tb compares against
    int32_t part[kMaxCluster];   // all in flight at once
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      part[q] = q < cs ? cluster.map_shared_rank(s_part, q)[tb * H + my_cls] : 0;
    int32_t v = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v += part[q];
    if (s_hm[my_cls] <= 0) v = kNegInfSum;
    const int32_t c = max(min(v, T), -T);
    const uint32_t p_num = ty == 0 ? static_cast<uint32_t>(T) - static_cast<uint32_t>(c)
                                   : static_cast<uint32_t>(T) + static_cast<uint32_t>(c);
    s_rhs[ty][tb] = static_cast<int32_t>(p_num << p.rand_bits);
  }
  int32_t* sums_k = p.sums + (kB + b0) * H;   // [nb][H], as s_part
  for (int i = rank + cs * tid; i < nb * H; i += cs * kThreads) {
    int32_t part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      part[q] = q < cs ? cluster.map_shared_rank(s_part, q)[i] : 0;
    int32_t v = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v += part[q];
    sums_k[i] = s_hm[i % H] > 0 ? v : kNegInfSum;
  }
  // done reading the others' partials (their values are in registers or
  // stored already, so no release is needed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  __syncthreads();   // s_rhs

  // ---- both selection rounds over this block's own tiles (int32
  // wrap-around arithmetic, as the reference computes it)
  if (single) {
    const int r = rank * kTile + tid;
    if (r < R) {
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        int32_t* out = (y == 0 ? p.sel_lab : p.sel_neg) + (kB + b0) * R + r;
#pragma unroll
        for (int b = 0; b < kRows; ++b)
          if (b < nb)
            out[static_cast<long long>(b) * R] =
                (lhs[y][b] < s_rhs[y][b] && ((ok >> (y * kRows + b)) & 1u)) ? 1 : 0;
      }
    }
  }
  for (int tile = rank; !single && tile < ntiles; tile += cs) {
    const int r = tile * kTile + tid;
    if (r >= R) continue;
    const int32_t clm = __ldg(clm_k + r);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      int32_t* out = (y == 0 ? p.sel_lab : p.sel_neg) + (kB + b0) * R + r;
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        if (b >= nb) continue;
        const long long row = static_cast<long long>(y) * B * R + static_cast<long long>(b) * R;
        const int32_t rv = __ldg(rand_k + row + r);
        const int32_t wv =
            frozen ? __ldg(w_k + static_cast<long long>(min(max(s_cls[y][b], 0), H - 1)) * R + r) : 1;
        const int32_t lhs = static_cast<int32_t>(static_cast<uint32_t>(rv) * two_t);
        out[static_cast<long long>(b) * R] = (lhs < s_rhs[y][b] && clm > 0 && wv != 0) ? 1 : 0;
      }
    }
  }
  // every block of the cluster has read this block's partials
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <bool kBulk>
cudaError_t launch(const Params& p, int K, int cs, size_t smem, cudaStream_t stream) {
  auto kernel = fused_step_kernel<kBulk>;
  static bool nonportable = false;
  static size_t smem_set = 48 * 1024;
  if (cs > kPortableCluster && !nonportable) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    nonportable = true;
  }
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (p.B + kRows - 1) / kRows, K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

}  // namespace

// Dynamic shared memory of a launch (bulk: the include rows in bulk
// copies): the include rows, the literal words, a tile's weights, random
// words and cl_mask, h_mask and the partial class sums.
extern "C" size_t dtm_fused_step_smem(int H, int W, int bulk) {
  const int chunk = bulk ? W : kWChunk;
  const int stride = bulk ? W : kStrideWord;
  return sizeof(uint32_t) * static_cast<size_t>(Layout(H, chunk, stride).total);
}

// cs: blocks of a cluster over R (1-16, at most one per 256-row tile);
// bulk = 1 (fused_step_kernel kBulk) only when W and R are multiples of 4
// and inc, w, rand and cl_mask are 16-byte aligned.
extern "C" int dtm_fused_step(const void* lit, const void* inc, const void* w,
                              const void* labels, const void* neg, const void* rand,
                              const void* cl_mask, const void* h_mask,
                              const void* T, const void* w_frozen,
                              void* clause, void* sums, void* sel_lab, void* sel_neg,
                              int K, int B, int R, int W, int H, int n_bits,
                              int rand_bits, int cs, int bulk, void* stream) {
  if (cs < 1 || cs > kMaxCluster || R < 1 || cs > (R + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);   // every block has a tile
  const Params p = {static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(inc),
                    static_cast<const int32_t*>(w), static_cast<const int32_t*>(labels),
                    static_cast<const int32_t*>(neg), static_cast<const int32_t*>(rand),
                    static_cast<const int32_t*>(cl_mask), static_cast<const int32_t*>(h_mask),
                    static_cast<const int32_t*>(T), static_cast<const int32_t*>(w_frozen),
                    static_cast<int32_t*>(clause), static_cast<int32_t*>(sums),
                    static_cast<int32_t*>(sel_lab), static_cast<int32_t*>(sel_neg),
                    B, R, W, H, n_bits, rand_bits};
  const size_t smem = dtm_fused_step_smem(H, W, bulk);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bulk ? launch<true>(p, K, cs, smem, st) : launch<false>(p, K, cs, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
