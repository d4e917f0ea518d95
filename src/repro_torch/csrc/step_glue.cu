// The train step's glue around its front half on Hopper (sm_90a): two
// launches in place of the ~110 small PyTorch kernels of the engine's
// torch glue (kernels/step_glue.py has the contracts and the plain
// versions; core/dtm.py _train_impl calls them).
//
// dtm_step_prologue, after the three draws and before the front half:
//
//   cls_lab[k, b] = regression[k] ? 0 : labels[k, b]
//   neg[k, b]     = rn < cls_lab ? rn : rn + 1,
//                   rn = c_rand[k, b] mod max(Σ_h h_mask[k, h] − 1, 1)
//   ta_seed[k]    = (seed_bits[k, 0] << rand_bits | seed_bits[k, 1]) & M32
//   sel_out       = (int32) sel_rand                     [K, 2, B, R]
//
// One grid-stride pass; the selection words (the bulk: 12 bytes a word)
// move 4 a thread in 16-byte loads and stores when both are aligned.
//
// dtm_step_epilogue, after the front half and before the TA update, per
// program k (Alg 4, the Type I/II split of Alg 5 and the Alg-6 groups):
//
//   votes[b]  = min(max(Σ_r cl[b, r], 0), T),  err[b] = labels[b] − votes[b]
//   classifier: t1 = sel · (w[cls, r] >= 0), t2 = sel · (w[cls, r] < 0) for
//               the target round, the other way round for the negated one
//   regression: sel_reg[b, r] = (rand0[b, r] · 2T < |err[b]| << rand_bits) ·
//               cl_mask[r]; t1 = sel_reg · (err > 0), t2 = sel_reg · (err < 0)
//               for the target round, 0 for the negated one
//   lit2, cl2, t1, t2 [2B, ·]: target rows, then negated rows
//   w'[h, r]  = w_frozen ? w : clip(w + Σ_b [cls_b = h] sel·cl − [neg_b = h] sel·cl)
//   tile_idx, count: the 128-row groups with any t1 or t2, in order, then 0
//   stats [5, K]: selected, active_groups, total_groups (y-row groups),
//                 correct (argmax of the sums = label; 0 for regression),
//                 abs_err
//
// int32 arithmetic with wrap-around, as the reference computes it.  The
// kernel is exact for the engine's operands: cl, the selections and
// cl_mask in {0, 1}, labels in [0, H), H <= kMaxClasses.
//
// Bound: at the main path's shape (K=1, B=32, R=2048, W=52, H=16) about
// 2.6 MB moved (cl, both selections and the weights read; cl2, t1, t2 and
// the weights written), ~0.8 µs at 3.35 TB/s.  The vote counts, the group
// list and the stats cross the clause axis, and a regression program's
// split needs its rows' vote counts before any column, so the kernel is a
// chain of dependent steps, each a global round trip or a cluster barrier
// (~0.6-1 µs each on the H100); the design shortens the chain:
//  * One thread-block cluster per program splits the clause axis into
//    tiles of 128 columns, one compaction group each: block `rank` of the
//    cluster's cs blocks owns tiles rank, rank + cs, ... (cs <= 16, so R
//    past 16 tiles loops inside the block).  A block's 512 threads are
//    128 columns × 4 row groups: thread t takes column t % 128 and, of
//    each 32-row chunk, rows t / 128 + 4j, all 8 loads in flight at once.
//  * The first loads (phase A's clause outputs, the class sums of the
//    correct count) are issued before anything is staged.  Phase A: each
//    warp sums its columns' clause outputs per row (__reduce_add_sync)
//    into the block's partial votes.  A cluster barrier; between its
//    arrive and its wait the block loads its own tile's weights and
//    selections.  Then every block sums the cs partial votes of each row
//    through distributed shared memory, and the errors follow.
//  * Phase B: a thread ORs the signs of its column's weights into a
//    64-bit class mask (the Type I/II split of every row), splits its
//    rows, and ORs the rows whose nudge is nonzero into its column's bit
//    masks over 32 rows; a class's nudge is two popcounts a chunk against
//    the rows of that class (masks made once a block), and the new weight
//    is written where the old one was read: in place when the step is
//    donated.  Group flags go to shared memory by warp vote, stat
//    partials by warp reduction.
//  * Each block adds its flags and partials into rank 0's shared memory
//    (remote stores and atomics) and arrives at a second barrier.  With
//    B <= 32 no global store precedes that arrive (the release would wait
//    for them): the own tile's cl2, t1, t2 and weights (its split again,
//    from registers) and lit2 are stored after it.  Rank 0 then writes the
//    group list (ballot and prefix popcount) and the stats.  No scratch in
//    device memory, no memset.
//  Measured at the fit's shape (PERF.md §6): 12.2 µs against the plain
//  version's 158.  Design runs: one thread a column and 256 a block took
//  23.8 µs; 1,024 threads a block (8 row groups, 64 registers, spills)
//  12.9, 256 (2 row groups) 13.4; 8 blocks 18.1; one block a program 110.
// T, w_frozen, w_clip and regression are read per program from device
// memory, so a bank that mixes classifier and regression programs needs
// no host.
//
// The kernel above holds a program's B rows (5 words each, and its nudge
// and class masks a 32-row chunk) and its columns' class signs (64 bits)
// in shared memory.  A launch with more than kMaxClasses classes, or more
// rows than fit (about 4,150 at H=16 on the H100), takes the wide kernel
// (the wrapper picks it, dtm_step_epilogue_wide): the same cluster and
// thread layout, the rows' vote counts met a segment of kSeg rows at a
// time and their errors kept in device memory (err [K, B]), each row's
// split reading its classes' weights from device memory, and the nudges
// added by integer atomics once every sign of the tile has been read; a
// second pass over the operands gives them.  The same outputs, bit for
// bit, for any B and H.
#include "common.cuh"

#include <climits>
#include <cooperative_groups.h>

namespace {

constexpr int kMaxCluster = 16;           // blocks of a cluster (non-portable above 8)
constexpr int kPortableCluster = 8;
constexpr int kGroup = 128;               // rows of an Alg-6 compaction group (ta_update kGroup)
constexpr int kMaxClasses = 64;           // classes a column's sign mask holds
constexpr int kProThreads = 256;
constexpr int kCols = 128;                // clause columns of an epilogue tile: one compaction group
constexpr int kThreads = 512;             // an epilogue block: kCols columns × 4 row groups
constexpr int kSeg = 1024;                // rows whose partial vote counts a wide block holds

struct ProParams {
  const long long* c_rand;     // [K, B]
  const long long* seed_bits;  // [K, 2]
  const long long* sel_rand;   // [K, 2, B, R]
  const int32_t* labels;       // [K, B]
  const int32_t* h_mask;       // [K, H]
  const uint8_t* reg;          // [K]
  int32_t* cls;
  int32_t* neg;
  long long* ta_seed;
  int32_t* sel_out;
  int K, B, H;
  long long n_sel;
  int rand_bits;
};

__global__ void __launch_bounds__(kProThreads) step_prologue_kernel(const ProParams p) {
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(p.sel_rand) |
                     reinterpret_cast<uintptr_t>(p.sel_out)) & 15u) == 0;
  const long long n4 = vec ? p.n_sel / 4 : 0;
  const longlong2* src = reinterpret_cast<const longlong2*>(p.sel_rand);
  int4* dst = reinterpret_cast<int4*>(p.sel_out);
  for (long long j = i0; j < n4; j += stride) {
    const longlong2 a = src[2 * j], b = src[2 * j + 1];
    dst[j] = make_int4(static_cast<int32_t>(a.x), static_cast<int32_t>(a.y),
                       static_cast<int32_t>(b.x), static_cast<int32_t>(b.y));
  }
  for (long long j = 4 * n4 + i0; j < p.n_sel; j += stride)
    p.sel_out[j] = static_cast<int32_t>(p.sel_rand[j]);
  const long long kb = static_cast<long long>(p.K) * p.B;
  for (long long i = i0; i < kb; i += stride) {
    const int k = static_cast<int>(i / p.B);
    long long n = 0;
#pragma unroll 8
    for (int h = 0; h < p.H; ++h) n += p.h_mask[static_cast<long long>(k) * p.H + h];
    const long long m = n - 1 > 1 ? n - 1 : 1;
    long long rr = p.c_rand[i] % m;
    if (rr < 0) rr += m;                       // the floor remainder, as torch's
    const int32_t rn = static_cast<int32_t>(rr);
    const int32_t cl = p.reg[k] ? 0 : p.labels[i];
    p.cls[i] = cl;
    p.neg[i] = rn < cl ? rn : rn + 1;
  }
  for (long long i = i0; i < p.K; i += stride) {
    const unsigned long long a = static_cast<unsigned long long>(p.seed_bits[2 * i]);
    const unsigned long long b = static_cast<unsigned long long>(p.seed_bits[2 * i + 1]);
    p.ta_seed[i] = static_cast<long long>(((a << p.rand_bits) | b) & 0xffffffffull);
  }
}

struct EpiParams {
  const uint32_t* lit;      // [K, B, W]
  const int32_t* cl;        // [K, B, R]
  const int32_t* sums;      // [K, B, H]
  const int32_t* sel_lab;   // [K, B, R]
  const int32_t* sel_neg;   // [K, B, R]
  const int32_t* rand;      // [K, 2, B, R] (round 0 read)
  const int32_t* labels;    // [K, B]
  const int32_t* cls;       // [K, B]
  const int32_t* neg;       // [K, B]
  const int32_t* w;         // [K, H, R]
  const int32_t* cl_mask;   // [K, R]
  const uint8_t* frozen;    // [K]
  const int32_t* clip;      // [K]
  const int32_t* T;         // [K]
  const uint8_t* reg;       // [K]
  uint32_t* lit2;           // [K, 2B, W]
  int32_t* cl2;             // [K, 2B, R]
  int32_t* t1;
  int32_t* t2;
  int32_t* tile_idx;        // [K, ceil(R / 128)]
  int32_t* count;           // [K]
  int32_t* w_out;           // [K, H, R]; == w in place
  int32_t* stats;           // [5, K]
  int32_t* err;             // [K, B] the wide kernel's row errors
  int K, B, R, W, H, y, rand_bits;
};

// Shared memory of a launch (dynamic), in 4-byte words.
struct EpiLayout {
  int cls, neg, lab, err, vpart, cm, nm, lm, nmk, pos, gc, gs, gm, stat, total;
  __host__ __device__ EpiLayout(int B, int H, int R, int y) {
    const int nch = (B + 31) / 32;
    cls = 0;                       // [B] target classes
    neg = cls + B;                 // [B] negated classes
    lab = neg + B;                 // [B] labels
    err = lab + B;                 // [B] errors of the clipped vote counts
    vpart = err + B;               // [B] this block's partial vote counts
    cm = vpart + B;                // [nch][H] rows whose target class is h
    nm = cm + nch * H;             // [nch][H] rows whose negated class is h
    lm = nm + nch * H;             // [nch][kCols] a column's target nudges
    nmk = lm + nch * kCols;        // [nch][kCols] ... negated nudges
    pos = (nmk + nch * kCols + 1) & ~1;   // [kCols] 64-bit class sign masks
    gc = pos + 2 * kCols;          // [ceil(R / 128)] compaction group flags
    gs = gc + (R + kGroup - 1) / kGroup;   // [R / y] stat group flags
    gm = gs + R / y;               // [R / y] stat group clause-mask maxima
    stat = gm + R / y;             // selected, correct, abs_err
    total = stat + 4;
  }
};

// Shared memory of a wide launch, in 4-byte words.
struct WideLayout {
  int vpart, gc, gs, gm, stat, total;
  __host__ __device__ WideLayout(int R, int y) {
    vpart = 0;                             // [kSeg] a row segment's partial vote counts
    gc = vpart + kSeg;                     // [ceil(R / 128)] compaction group flags
    gs = gc + (R + kGroup - 1) / kGroup;   // [R / y] stat group flags
    gm = gs + R / y;                       // [R / y] stat group clause-mask maxima
    stat = gm + R / y;                     // selected, correct, abs_err
    total = stat + 4;
  }
};

// Rows 32c + rg + kRowGroups·j (j < 32 / kRowGroups: one 32-row chunk)
// of column col of a [B, R] operand, clamped to the last row, so each
// load is unconditional.
template <int kRowGroups>
__device__ __forceinline__ void load_pass(int32_t (&v)[32 / kRowGroups], const int32_t* base,
                                          int col, int c, int rg, int B, int R) {
#pragma unroll
  for (int j = 0; j < 32 / kRowGroups; ++j)
    v[j] = __ldg(base + static_cast<long long>(min(32 * c + rg + j * kRowGroups, B - 1)) * R + col);
}

// One row of one column: the Type I / II feedback of both rounds, and the
// selections that nudge the weights (a regression program's: its own).
struct Split {
  int32_t t1l, t2l, t1n, t2n, sl, sn;
};
__device__ __forceinline__ Split split_row(bool reg, int32_t sl, int32_t sn, int32_t rv, int32_t e,
                                           int32_t clm, uint32_t two_t, int rand_bits,
                                           unsigned long long pos, int cls, int neg) {
  if (reg) {
    const int32_t lhs = static_cast<int32_t>(static_cast<uint32_t>(rv) * two_t);
    const int32_t rhs = static_cast<int32_t>(static_cast<uint32_t>(e < 0 ? -e : e) << rand_bits);
    const int32_t sr = lhs < rhs ? clm : 0;
    return {e > 0 ? sr : 0, e < 0 ? sr : 0, 0, 0, sr, 0};
  }
  const bool pl = (pos >> cls) & 1ull, pn = (pos >> neg) & 1ull;
  return {pl ? sl : 0, pl ? 0 : sl, pn ? 0 : sn, pn ? sn : 0, sl, sn};
}

// A tile's group flags and stat partials: a warp's 32 columns lie in one
// tile, which is one compaction group.  dsel: the thread's selections of
// column r (over its rows), fb: any of them with Type I or II feedback.
__device__ __forceinline__ void tile_flags(int tile, int c0, int col, int lane, int r, int R, int y,
                                           int32_t dsel, bool fb, int32_t clm, int32_t* s_gc,
                                           int32_t* s_gs, int32_t* s_gm, int32_t* s_stat) {
  const bool in = r < R;
  const int wr = c0 + (col & ~31);
  if (__any_sync(0xffffffffu, in && fb) && lane == 0) s_gc[tile] = 1;
  const int32_t ssum = __reduce_add_sync(0xffffffffu, in ? dsel : 0);
  if (lane == 0 && ssum != 0) atomicAdd(s_stat, ssum);
  if (y % 32 == 0) {
    const bool any_s = __any_sync(0xffffffffu, in && dsel > 0);
    const int32_t mx = __reduce_max_sync(0xffffffffu, in ? clm : INT_MIN);
    if (lane == 0 && wr < R) {
      if (any_s) s_gs[wr / y] = 1;
      atomicMax(s_gm + wr / y, mx);
    }
  } else if (in) {
    if (dsel > 0) s_gs[r / y] = 1;
    atomicMax(s_gm + r / y, clm);
  }
}

// A block's group flags and its first nstat stat partials added into rank
// 0's shared memory (before the cluster barrier that rank 0 waits on).
__device__ __forceinline__ void push_partials(cooperative_groups::cluster_group& cluster, int tid,
                                              int Gc, int Gs, int nstat, int32_t* s_gc,
                                              int32_t* s_gs, int32_t* s_gm, int32_t* s_stat) {
  int32_t* gc0 = cluster.map_shared_rank(s_gc, 0);
  int32_t* gs0 = cluster.map_shared_rank(s_gs, 0);
  int32_t* gm0 = cluster.map_shared_rank(s_gm, 0);
  int32_t* st0 = cluster.map_shared_rank(s_stat, 0);
  for (int g = tid; g < Gc; g += kThreads)
    if (s_gc[g]) gc0[g] = 1;
  for (int g = tid; g < Gs; g += kThreads) {
    if (s_gs[g]) gs0[g] = 1;
    if (s_gm[g] != INT_MIN) atomicMax(gm0 + g, s_gm[g]);
  }
  if (tid < nstat && s_stat[tid] != 0) atomicAdd(st0 + tid, s_stat[tid]);
}

// This block's share of lit2: the literals twice, target then negated rows.
__device__ __forceinline__ void copy_lits(const EpiParams& p, long long kB, int rank, int cs, int tid) {
  const long long n = static_cast<long long>(p.B) * p.W;
  const uint32_t* src = p.lit + kB * p.W;
  uint32_t* dst = p.lit2 + 2 * kB * p.W;
  for (long long i = static_cast<long long>(rank) * kThreads + tid; i < n;
       i += static_cast<long long>(cs) * kThreads) {
    const uint32_t v = __ldg(src + i);
    dst[i] = v;
    dst[n + i] = v;
  }
}

// Rank 0, once every block's partials are in: the group list (ballot and
// prefix popcount) and program k's stats.
__device__ __forceinline__ void write_results(const EpiParams& p, int k, int warp, int lane, int Gc,
                                              int Gs, bool reg, const int32_t* s_gc,
                                              const int32_t* s_gs, const int32_t* s_gm,
                                              const int32_t* s_stat) {
  if (warp == 0) {
    int32_t* idx = p.tile_idx + static_cast<long long>(k) * Gc;
    int off = 0;
    for (int g0 = 0; g0 < Gc; g0 += 32) {
      const int g = g0 + lane;
      const bool f = g < Gc && s_gc[g] != 0;
      const uint32_t ball = __ballot_sync(0xffffffffu, f);
      if (f) idx[off + __popc(ball & ((1u << lane) - 1u))] = g;
      off += __popc(ball);
    }
    for (int i = off + lane; i < Gc; i += 32) idx[i] = 0;
    if (lane == 0) p.count[k] = off;
  } else if (warp == 1) {   // the stat groups
    int32_t act = 0, tot = 0;
    for (int g = lane; g < Gs; g += 32) {
      act += s_gs[g] != 0 ? s_gm[g] : 0;
      tot += s_gm[g];
    }
    act = __reduce_add_sync(0xffffffffu, act);
    tot = __reduce_add_sync(0xffffffffu, tot);
    if (lane == 0) {
      p.stats[1 * p.K + k] = act;
      p.stats[2 * p.K + k] = tot;
    }
  } else if (warp == 2 && lane == 0) {
    p.stats[0 * p.K + k] = s_stat[0];
    p.stats[3 * p.K + k] = reg ? 0 : s_stat[1];
    p.stats[4 * p.K + k] = s_stat[2];
  }
}

// Block (blockIdx.x = rank in the cluster over R, blockIdx.z = program);
// thread t takes column t % kCols of the block's tiles and, of each
// 32-row chunk, the rows t / kCols + j · kRowGroups.
template <int kMaxH>
__global__ void __launch_bounds__(kThreads) step_epilogue_kernel(const EpiParams p) {
  constexpr int kRowGroups = kThreads / kCols;
  constexpr int kPass = 32 / kRowGroups;         // rows a thread takes of a chunk
  constexpr int kPairs = kMaxH / kRowGroups;     // classes of its column a thread updates
  extern __shared__ __align__(16) int32_t sm[];
  const int B = p.B, R = p.R, H = p.H, y = p.y;
  const EpiLayout lay(B, H, R, y);
  int32_t* s_cls = sm + lay.cls;
  int32_t* s_neg = sm + lay.neg;
  int32_t* s_lab = sm + lay.lab;
  int32_t* s_err = sm + lay.err;
  int32_t* s_vpart = sm + lay.vpart;
  uint32_t* s_cm = reinterpret_cast<uint32_t*>(sm + lay.cm);
  uint32_t* s_nm = reinterpret_cast<uint32_t*>(sm + lay.nm);
  uint32_t* s_lm = reinterpret_cast<uint32_t*>(sm + lay.lm);
  uint32_t* s_nmk = reinterpret_cast<uint32_t*>(sm + lay.nmk);
  unsigned long long* s_pos = reinterpret_cast<unsigned long long*>(sm + lay.pos);
  int32_t* s_gc = sm + lay.gc;
  int32_t* s_gs = sm + lay.gs;
  int32_t* s_gm = sm + lay.gm;
  int32_t* s_stat = sm + lay.stat;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % kCols, rg = tid / kCols;
  const int cs = gridDim.x, rank = blockIdx.x, k = blockIdx.z;
  const int nch = (B + 31) / 32;
  const int Gc = (R + kGroup - 1) / kGroup, Gs = R / y;
  const int ntiles = (R + kCols - 1) / kCols;
  const long long kB = static_cast<long long>(k) * B;
  const long long kBR = kB * R;
  const int32_t* cl_k = p.cl + kBR;
  const int32_t* lab_k = p.sel_lab + kBR;
  const int32_t* negs_k = p.sel_neg + kBR;
  const int32_t* rand_k = p.rand + 2 * kBR;   // round 0
  const int32_t* w_k = p.w + static_cast<long long>(k) * H * R;
  int32_t* wo_k = p.w_out + static_cast<long long>(k) * H * R;
  const int32_t* clm_k = p.cl_mask + static_cast<long long>(k) * R;
  int32_t* cl2_k = p.cl2 + 2 * kBR;
  int32_t* t1_k = p.t1 + 2 * kBR;
  int32_t* t2_k = p.t2 + 2 * kBR;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();

  // ---- in flight before anything is staged: phase A's first chunk of
  // clause outputs and the row of class sums this warp checks
  const int rc0 = min(rank * kCols + col, R - 1);
  int32_t va[kPass];
  load_pass<kRowGroups>(va, cl_k, rc0, 0, rg, B, R);
  const int brow = rank + cs * warp;   // the row whose argmax this warp checks
  const int32_t* srow = p.sums + (kB + min(brow, B - 1)) * H;
  int32_t v0 = __ldg(srow + min(lane, H - 1)), v1 = __ldg(srow + min(lane + 32, H - 1));
  const int32_t blab = __ldg(p.labels + kB + min(brow, B - 1));
  const int32_t T = p.T[k], clip = p.clip[k];
  const bool frozen = p.frozen[k] != 0, reg = p.reg[k] != 0;
  const bool keep_frozen = frozen && p.w_out == p.w;   // in place: nothing to write
  for (int b = tid; b < B; b += kThreads) {
    s_cls[b] = p.cls[kB + b];
    s_neg[b] = p.neg[kB + b];
    s_lab[b] = p.labels[kB + b];
    s_vpart[b] = 0;
  }
  for (int g = tid; g < Gc; g += kThreads) s_gc[g] = 0;
  for (int g = tid; g < Gs; g += kThreads) {
    s_gs[g] = 0;
    s_gm[g] = INT_MIN;
  }
  if (tid < 4) s_stat[tid] = 0;
  for (int i = tid; i < kCols; i += kThreads) s_pos[i] = 0ull;
  for (int i = tid; i < nch * kCols; i += kThreads) {
    s_lm[i] = 0u;
    s_nmk[i] = 0u;
  }
  __syncthreads();
  // the rows of each class, per 32-row chunk, for both rounds
  for (int i = tid; i < nch * H; i += kThreads) {
    const int c = i / H, h = i % H;
    uint32_t mc = 0u, mn = 0u;
    for (int j = 0; j < 32 && c * 32 + j < B; ++j) {
      mc |= (s_cls[c * 32 + j] == h ? 1u : 0u) << j;
      mn |= (s_neg[c * 32 + j] == h ? 1u : 0u) << j;
    }
    s_cm[i] = mc;
    s_nm[i] = mn;
  }
  // correct: the first class of the row's largest sum against its label
  // (a warp a row; the rows spread over the cluster's blocks)
  for (int b = brow; b < B; b += cs * (kThreads / 32)) {
    if (b != brow) {
      const int32_t* row = p.sums + (kB + b) * H;
      v0 = __ldg(row + min(lane, H - 1));
      v1 = __ldg(row + min(lane + 32, H - 1));
    }
    if (lane >= H) v0 = INT_MIN;
    if (lane + 32 >= H) v1 = INT_MIN;
    const int32_t m = __reduce_max_sync(0xffffffffu, max(v0, v1));
    const uint32_t m0 = __ballot_sync(0xffffffffu, v0 == m);
    const uint32_t m1 = __ballot_sync(0xffffffffu, v1 == m);
    const int arg = m0 ? __ffs(m0) - 1 : 32 + __ffs(m1) - 1;
    if (lane == 0 && arg == (b == brow ? blab : p.labels[kB + b])) atomicAdd(s_stat + 1, 1);
  }

  // ---- phase A: partial vote counts of this block's columns, a warp's
  // 32 columns summed per row
  for (int tile = rank; tile < ntiles; tile += cs) {
    const int r = tile * kCols + col;
    const bool in = r < R;
    for (int c = 0; c < nch; ++c) {
      int32_t v[kPass];
      if (tile == rank && c == 0) {
#pragma unroll
        for (int j = 0; j < kPass; ++j) v[j] = va[j];
      } else {
        load_pass<kRowGroups>(v, cl_k, min(r, R - 1), c, rg, B, R);
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const int b = 32 * c + rg + j * kRowGroups;
        const int32_t s = __reduce_add_sync(0xffffffffu, in && b < B ? v[j] : 0);
        if (lane == 0 && s != 0 && b < B) atomicAdd(s_vpart + b, s);
      }
    }
  }
  __syncthreads();

  // ---- the partial votes meet through distributed shared memory; before
  // the wait, phase B's first tile (the block's own, processed last) is
  // loaded: its weights and its first chunk's selections (the clause
  // outputs are phase A's)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  int32_t pw[kPairs], psl[kPass], psn[kPass], prv[kPass];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int h = rg + j * kRowGroups;   // pair j: class h of this column
    pw[j] = h < H ? w_k[static_cast<long long>(h) * R + rc0] : 0;
  }
  load_pass<kRowGroups>(psl, lab_k, rc0, 0, rg, B, R);
  load_pass<kRowGroups>(psn, negs_k, rc0, 0, rg, B, R);
  if (reg) load_pass<kRowGroups>(prv, rand_k, rc0, 0, rg, B, R);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  for (int b = tid; b < B; b += kThreads) {
    int32_t part[kMaxCluster];   // all in flight at once
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      part[q] = q < cs ? cluster.map_shared_rank(s_vpart, q)[b] : 0;
    int32_t v = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v += part[q];
    v = min(max(v, 0), T);
    const int32_t e = s_lab[b] - v;
    s_err[b] = e;
    if (rank == 0) atomicAdd(s_stat + 2, e < 0 ? -e : e);
  }
  __syncthreads();

  // ---- phase B, the block's tiles from the last to its own: the split,
  // cl2/t1/t2, the nudged weights, group flags.  With one chunk (B <= 32)
  // the own tile's stores wait until after the cluster barrier below, so
  // its release waits on no global store; its operands stay in registers.
  const uint32_t two_t = 2u * static_cast<uint32_t>(T);
  const bool defer = nch == 1;
  const int last = rank < ntiles ? rank + ((ntiles - 1 - rank) / cs) * cs : rank - cs;
  unsigned long long pos = 0ull;
  int32_t clm = 0;
  for (int tile = last; tile >= rank; tile -= cs) {
    const bool own = tile == rank;
    const int c0 = tile * kCols;
    const int r = c0 + col;
    const bool in = r < R;
    const int rc = min(r, R - 1);
    if (tile != last) {   // clear the masks of the tile before
      __syncthreads();
      for (int i = tid; i < kCols; i += kThreads) s_pos[i] = 0ull;
      for (int i = tid; i < nch * kCols; i += kThreads) {
        s_lm[i] = 0u;
        s_nmk[i] = 0u;
      }
      __syncthreads();
    }
    clm = clm_k[rc];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int h = rg + j * kRowGroups;
      const int32_t w = own ? pw[j] : (h < H ? w_k[static_cast<long long>(h) * R + rc] : 0);
      if (h < H && w >= 0) atomicOr(s_pos + col, 1ull << h);
    }
    __syncthreads();
    pos = s_pos[col];
    int32_t dsel = 0;
    bool fb = false;
    for (int c = 0; c < nch; ++c) {
      int32_t clv[kPass], slv[kPass], snv[kPass], rv[kPass];
      if (own && c == 0) {
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          clv[j] = va[j];
          slv[j] = psl[j];
          snv[j] = psn[j];
          rv[j] = prv[j];
        }
      } else {
        load_pass<kRowGroups>(clv, cl_k, rc, c, rg, B, R);
        load_pass<kRowGroups>(slv, lab_k, rc, c, rg, B, R);
        load_pass<kRowGroups>(snv, negs_k, rc, c, rg, B, R);
        if (reg) load_pass<kRowGroups>(rv, rand_k, rc, c, rg, B, R);
      }
      const bool store = in && !(own && defer);
      uint32_t lm = 0u, nm = 0u;
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const int b = 32 * c + rg + j * kRowGroups;
        if (b >= B) break;
        const int32_t cv = clv[j];
        const Split t = split_row(reg, slv[j], snv[j], rv[j], s_err[b], clm, two_t, p.rand_bits,
                                  pos, s_cls[b], s_neg[b]);
        if (store) {
          const long long lo = static_cast<long long>(b) * R + r;
          const long long hi = static_cast<long long>(B + b) * R + r;
          cl2_k[lo] = cv;
          cl2_k[hi] = cv;
          t1_k[lo] = t.t1l;
          t1_k[hi] = t.t1n;
          t2_k[lo] = t.t2l;
          t2_k[hi] = t.t2n;
        }
        lm |= (t.sl * cv != 0 ? 1u : 0u) << (b & 31);
        nm |= (t.sn * cv != 0 ? 1u : 0u) << (b & 31);
        dsel += t.sl + t.sn;
        fb = fb || t.t1l > 0 || t.t2l > 0 || t.t1n > 0 || t.t2n > 0;
      }
      if (lm) atomicOr(s_lm + c * kCols + col, lm);
      if (nm) atomicOr(s_nmk + c * kCols + col, nm);
    }
    tile_flags(tile, c0, col, lane, r, R, y, dsel, fb, clm, s_gc, s_gs, s_gm, s_stat);
    __syncthreads();
    // the new weights of the thread's classes of its column: a class's
    // nudge is two popcounts a 32-row chunk (the own tile's later when
    // its stores wait)
    if (!keep_frozen && in && !(own && defer)) {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int h = rg + j * kRowGroups;
        if (h >= H) continue;
        const long long o = static_cast<long long>(h) * R + r;
        const int32_t w = own ? pw[j] : w_k[o];
        int32_t d = 0;
        for (int q = 0; q < nch; ++q)
          d += __popc(s_lm[q * kCols + col] & s_cm[q * H + h]) -
               __popc(s_nmk[q * kCols + col] & s_nm[q * H + h]);
        wo_k[o] = frozen ? w : min(max(w + d, -clip), clip);
      }
    }
  }

  // ---- each block adds its group flags and stat partials into rank 0's
  // shared memory, then arrives; rank 0 waits for all of them
  if (rank != 0) push_partials(cluster, tid, Gc, Gs, 2, s_gc, s_gs, s_gm, s_stat);
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  // ---- the stores that waited: the own tile's cl2/t1/t2 (the split
  // again, from the operands in registers), its weights, and this block's
  // share of lit2
  if (defer && rank < ntiles) {
    const int r = rank * kCols + col;
    if (r < R) {
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const int b = rg + j * kRowGroups;
        if (b >= B) break;
        const Split t = split_row(reg, psl[j], psn[j], prv[j], s_err[b], clm, two_t, p.rand_bits,
                                  pos, s_cls[b], s_neg[b]);
        const long long lo = static_cast<long long>(b) * R + r;
        const long long hi = static_cast<long long>(B + b) * R + r;
        cl2_k[lo] = va[j];
        cl2_k[hi] = va[j];
        t1_k[lo] = t.t1l;
        t1_k[hi] = t.t1n;
        t2_k[lo] = t.t2l;
        t2_k[hi] = t.t2n;
      }
      if (!keep_frozen) {
        const uint32_t lm = s_lm[col], nm = s_nmk[col];
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int h = rg + j * kRowGroups;
          if (h >= H) continue;
          const int32_t d = __popc(lm & s_cm[h]) - __popc(nm & s_nm[h]);
          wo_k[static_cast<long long>(h) * R + r] =
              frozen ? pw[j] : min(max(pw[j] + d, -clip), clip);
        }
      }
    }
  }
  copy_lits(p, kB, rank, cs, tid);
  // every block has added its partials (and read the others' votes)
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank == 0) write_results(p, k, warp, lane, Gc, Gs, reg, s_gc, s_gs, s_gm, s_stat);
}

// The wide kernel (see the top): any B and H.  Block and thread layout as
// step_epilogue_kernel's.
__global__ void __launch_bounds__(kThreads) step_epilogue_wide_kernel(const EpiParams p) {
  constexpr int kRowGroups = kThreads / kCols;
  extern __shared__ __align__(16) int32_t sm[];
  const int B = p.B, R = p.R, H = p.H, y = p.y;
  const WideLayout lay(R, y);
  int32_t* s_vpart = sm + lay.vpart;
  int32_t* s_gc = sm + lay.gc;
  int32_t* s_gs = sm + lay.gs;
  int32_t* s_gm = sm + lay.gm;
  int32_t* s_stat = sm + lay.stat;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % kCols, rg = tid / kCols;
  const int cs = gridDim.x, rank = blockIdx.x, k = blockIdx.z;
  const int Gc = (R + kGroup - 1) / kGroup, Gs = R / y;
  const int ntiles = (R + kCols - 1) / kCols;
  const long long kB = static_cast<long long>(k) * B;
  const long long kBR = kB * R;
  const int32_t* cl_k = p.cl + kBR;
  const int32_t* lab_k = p.sel_lab + kBR;
  const int32_t* negs_k = p.sel_neg + kBR;
  const int32_t* rand_k = p.rand + 2 * kBR;   // round 0
  const int32_t* w_k = p.w + static_cast<long long>(k) * H * R;
  int32_t* wo_k = p.w_out + static_cast<long long>(k) * H * R;
  const int32_t* clm_k = p.cl_mask + static_cast<long long>(k) * R;
  const int32_t* cls_k = p.cls + kB;
  const int32_t* neg_k = p.neg + kB;
  int32_t* err_k = p.err + kB;
  int32_t* cl2_k = p.cl2 + 2 * kBR;
  int32_t* t1_k = p.t1 + 2 * kBR;
  int32_t* t2_k = p.t2 + 2 * kBR;
  const int32_t T = p.T[k], clip = p.clip[k];
  const bool frozen = p.frozen[k] != 0, reg = p.reg[k] != 0;
  const bool inplace = p.w_out == p.w;
  const uint32_t two_t = 2u * static_cast<uint32_t>(T);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();

  for (int g = tid; g < Gc; g += kThreads) s_gc[g] = 0;
  for (int g = tid; g < Gs; g += kThreads) {
    s_gs[g] = 0;
    s_gm[g] = INT_MIN;
  }
  if (tid < 4) s_stat[tid] = 0;
  __syncthreads();
  // correct: the first class of the row's largest sum against its label,
  // a warp a row, 32 classes at a time
  for (int b = rank + cs * warp; b < B; b += cs * (kThreads / 32)) {
    const int32_t* row = p.sums + (kB + b) * H;
    int32_t best = INT_MIN;
    int arg = 0;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const int32_t v = h0 + lane < H ? __ldg(row + h0 + lane) : INT_MIN;
      const int32_t m = __reduce_max_sync(0xffffffffu, v);
      const uint32_t at = __ballot_sync(0xffffffffu, v == m);
      if (h0 == 0 || m > best) {
        best = m;
        arg = h0 + __ffs(at) - 1;
      }
    }
    if (lane == 0 && arg == p.labels[kB + b]) atomicAdd(s_stat + 1, 1);
  }

  // ---- the vote counts, kSeg rows at a time: each block's columns summed
  // per row (a warp's 32 columns at once), met through distributed shared
  // memory; the rows' errors go to device memory
  for (int s0 = 0; s0 < B; s0 += kSeg) {
    const int n = min(kSeg, B - s0);
    for (int i = tid; i < n; i += kThreads) s_vpart[i] = 0;
    __syncthreads();
    for (int tile = rank; tile < ntiles; tile += cs) {
      const int r = tile * kCols + col;
      const int32_t* c = cl_k + static_cast<long long>(s0) * R + min(r, R - 1);
      for (int i = rg; i < n; i += kRowGroups) {
        const int32_t v = __ldg(c + static_cast<long long>(i) * R);
        const int32_t s = __reduce_add_sync(0xffffffffu, r < R ? v : 0);
        if (lane == 0 && s != 0) atomicAdd(s_vpart + i, s);
      }
    }
    cluster.sync();
    for (int i = rank * kThreads + tid; i < n; i += cs * kThreads) {
      int32_t v = 0;
      for (int q = 0; q < cs; ++q) v += cluster.map_shared_rank(s_vpart, q)[i];
      v = min(max(v, 0), T);
      const int32_t e = p.labels[kB + s0 + i] - v;
      err_k[s0 + i] = e;
      atomicAdd(s_stat + 2, e < 0 ? -e : e);
    }
    cluster.sync();   // the errors written, the partial votes free again
  }

  // ---- the block's tiles: the split and cl2/t1/t2 (the signs of the old
  // weights read from device memory), group flags; then, once every sign of
  // the tile is read, the nudges as atomics on the new weights, and the clip
  for (int tile = rank; tile < ntiles; tile += cs) {
    const int c0 = tile * kCols;
    const int r = c0 + col;
    const bool in = r < R;
    const int rc = min(r, R - 1);
    const int32_t clm = clm_k[rc];
    if (!inplace && in)   // the new weights start as the old ones
      for (int h = rg; h < H; h += kRowGroups)
        wo_k[static_cast<long long>(h) * R + r] = w_k[static_cast<long long>(h) * R + r];
    int32_t dsel = 0;
    bool fb = false;
    for (int b = rg; b < B; b += kRowGroups) {
      const long long o = static_cast<long long>(b) * R + rc;
      const int cls = cls_k[b], ng = neg_k[b];
      const int32_t rv = reg ? __ldg(rand_k + o) : 0;
      const unsigned long long pos =
          reg ? 0ull
              : (w_k[static_cast<long long>(cls) * R + rc] >= 0 ? 1ull : 0ull) |
                    (w_k[static_cast<long long>(ng) * R + rc] >= 0 ? 2ull : 0ull);
      const int32_t cv = __ldg(cl_k + o);
      const Split t = split_row(reg, __ldg(lab_k + o), __ldg(negs_k + o), rv, __ldcg(err_k + b), clm,
                                two_t, p.rand_bits, pos, 0, 1);
      if (in) {
        const long long lo = static_cast<long long>(b) * R + r;
        const long long hi = static_cast<long long>(B + b) * R + r;
        cl2_k[lo] = cv;
        cl2_k[hi] = cv;
        t1_k[lo] = t.t1l;
        t1_k[hi] = t.t1n;
        t2_k[lo] = t.t2l;
        t2_k[hi] = t.t2n;
      }
      dsel += t.sl + t.sn;
      fb = fb || t.t1l > 0 || t.t2l > 0 || t.t1n > 0 || t.t2n > 0;
    }
    tile_flags(tile, c0, col, lane, r, R, y, dsel, fb, clm, s_gc, s_gs, s_gm, s_stat);
    __syncthreads();   // every sign of the tile read (in place)
    if (!frozen && in) {
      for (int b = rg; b < B; b += kRowGroups) {
        const long long o = static_cast<long long>(b) * R + r;
        const int32_t cv = __ldg(cl_k + o);
        if (cv == 0) continue;
        const Split t = split_row(reg, __ldg(lab_k + o), __ldg(negs_k + o),
                                  reg ? __ldg(rand_k + o) : 0, __ldcg(err_k + b), clm, two_t,
                                  p.rand_bits, 0ull, 0, 1);
        if (t.sl != 0) atomicAdd(wo_k + static_cast<long long>(cls_k[b]) * R + r, t.sl * cv);
        if (t.sn != 0) atomicAdd(wo_k + static_cast<long long>(neg_k[b]) * R + r, -(t.sn * cv));
      }
    }
    __syncthreads();   // every nudge of the tile added
    if (!frozen && in)
      for (int h = rg; h < H; h += kRowGroups) {
        int32_t* o = wo_k + static_cast<long long>(h) * R + r;
        *o = min(max(__ldcg(o), -clip), clip);
      }
  }

  if (rank != 0) push_partials(cluster, tid, Gc, Gs, 3, s_gc, s_gs, s_gm, s_stat);
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  copy_lits(p, kB, rank, cs, tid);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank == 0) write_results(p, k, warp, lane, Gc, Gs, reg, s_gc, s_gs, s_gm, s_stat);
}

// A kernel's attributes, set once each (a launch past 8 blocks a cluster,
// or past 48 KB of shared memory).
struct FuncState {
  bool nonportable = false;
  size_t smem_set = 48 * 1024;
};

cudaError_t launch_epilogue(void (*kernel)(EpiParams), FuncState& fs, const EpiParams& p, int cs,
                            size_t smem, cudaStream_t stream) {
  if (cs > kPortableCluster && !fs.nonportable) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    fs.nonportable = true;
  }
  if (smem > fs.smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    fs.smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, p.K);
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

// blocks: the grid (the wrapper's: the words over 4 a thread, at most a
// few blocks an SM).
extern "C" int dtm_step_prologue(const void* c_rand, const void* seed_bits, const void* sel_rand,
                                 const void* labels, const void* h_mask, const void* regression,
                                 void* cls, void* neg, void* ta_seed, void* sel_out, int K, int B,
                                 int H, long long n_sel, int rand_bits, int blocks, void* stream) {
  if (blocks < 1 || K < 1 || B < 0 || H < 0 || rand_bits < 0 || rand_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const ProParams p = {static_cast<const long long*>(c_rand), static_cast<const long long*>(seed_bits),
                       static_cast<const long long*>(sel_rand), static_cast<const int32_t*>(labels),
                       static_cast<const int32_t*>(h_mask), static_cast<const uint8_t*>(regression),
                       static_cast<int32_t*>(cls), static_cast<int32_t*>(neg),
                       static_cast<long long*>(ta_seed), static_cast<int32_t*>(sel_out),
                       K, B, H, n_sel, rand_bits};
  step_prologue_kernel<<<blocks, kProThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of an epilogue launch (wide: of the wide kernel).
extern "C" size_t dtm_step_epilogue_smem(int B, int H, int R, int y, int wide) {
  const int words = wide ? WideLayout(R, y).total : EpiLayout(B, H, R, y).total;
  return sizeof(int32_t) * static_cast<size_t>(words);
}

// The shared memory a block may opt in to on `device` (the wrapper keeps it
// once per device and takes the wide kernel past it); a negative CUDA error.
extern "C" int dtm_smem_optin(int device) {
  int optin = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? optin : -static_cast<int>(e);
}

// cluster: blocks over R (1-16); R a multiple of y; wide: the wide kernel
// (err [K, B] its scratch), else H <= 64.
extern "C" int dtm_step_epilogue(const void* lit, const void* cl, const void* sums,
                                 const void* sel_lab, const void* sel_neg, const void* rand,
                                 const void* labels, const void* cls, const void* neg,
                                 const void* w, const void* cl_mask, const void* frozen,
                                 const void* clip, const void* T, const void* regression,
                                 void* lit2, void* cl2, void* t1, void* t2, void* tile_idx,
                                 void* count, void* w_out, void* stats, void* err, int K, int B,
                                 int R, int W, int H, int y, int rand_bits, int cluster, int wide,
                                 void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || K < 1 || B < 1 || R < 1 || H < 1 ||
      (!wide && H > kMaxClasses) || (wide && err == nullptr) || y < 1 || R % y != 0 ||
      rand_bits < 0 || rand_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const EpiParams p = {static_cast<const uint32_t*>(lit), static_cast<const int32_t*>(cl),
                       static_cast<const int32_t*>(sums), static_cast<const int32_t*>(sel_lab),
                       static_cast<const int32_t*>(sel_neg), static_cast<const int32_t*>(rand),
                       static_cast<const int32_t*>(labels), static_cast<const int32_t*>(cls),
                       static_cast<const int32_t*>(neg), static_cast<const int32_t*>(w),
                       static_cast<const int32_t*>(cl_mask), static_cast<const uint8_t*>(frozen),
                       static_cast<const int32_t*>(clip), static_cast<const int32_t*>(T),
                       static_cast<const uint8_t*>(regression), static_cast<uint32_t*>(lit2),
                       static_cast<int32_t*>(cl2), static_cast<int32_t*>(t1),
                       static_cast<int32_t*>(t2), static_cast<int32_t*>(tile_idx),
                       static_cast<int32_t*>(count), static_cast<int32_t*>(w_out),
                       static_cast<int32_t*>(stats), static_cast<int32_t*>(err),
                       K, B, R, W, H, y, rand_bits};
  const size_t smem = dtm_step_epilogue_smem(B, H, R, y, wide);
  const auto st = static_cast<cudaStream_t>(stream);
  static FuncState fs16, fs64, fs_wide;
  // a thread's class registers: kMaxH / row groups
  const cudaError_t e =
      wide      ? launch_epilogue(step_epilogue_wide_kernel, fs_wide, p, cluster, smem, st)
      : H <= 16 ? launch_epilogue(step_epilogue_kernel<16>, fs16, p, cluster, smem, st)
                : launch_epilogue(step_epilogue_kernel<64>, fs64, p, cluster, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
