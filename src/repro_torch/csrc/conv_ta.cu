// The conv train step's TA stage on Hopper (sm_90a): two launches in place
// of the ~170 PyTorch kernels of the engine's torch chain (kernels/conv_ta.py
// has the contract and the plain version; core/dtm.py _train_conv_impl
// calls it).  Per program k, with the step's draws patch_rand [B, P, Rg] and
// ta_rand [2, B, Rg, L] (int64 words below 2^32) read at rows row0 + r:
//
//   pidx[b, r]  = the first argmax over p of cl_p[b, p, r]·1000 +
//                 patch_rand[b, p, row0 + r] mod 997   (the patch pick)
//   lit[b, r, l] = bit l of plits[b, pidx[b, r]]
//   c = cl[b, r] > 0,  cal = c & lit,  inc2 = c & !lit & !inc[r, l]
//   rounds q = 0, 1: t1/t2 = sel_lab·(w[labels[b], r] >= 0 / < 0),
//                    then sel_neg·(w[neg[b], r] < 0 / >= 0)
//   low = ta_rand[q, b, row0 + r, l] < p_ta
//   d1  = cal ? (boost | !low) : −low            (Alg 5: Type I)
//   Δ[r, l] = Σ_q Σ_b t1_q·d1 + t2_q·inc2         (Type II: t2·inc2)
//   ta'[r, l] = clip(ta + Δ·l_mask[l]·cl_mask[r], 0, n_states − 1)
//   inc'[r, w] bit j = ta'[r, 32w + j] >= n_states >> 1
//
// It replaces no Pallas kernel: the JAX engine's conv TA stage is jnp
// (src/repro/core/dtm.py _train_conv_impl), the one stage its shared-literal
// TA kernel cannot express.  int32 arithmetic with wrap-around, as the plain
// version's.  Exact for the engine's operands: clause outputs cl_p in
// [0, 2^21) with cl their maximum over the patches (_conv_clauses), labels
// and neg in [0, H).
//
// Bound: bytes.  At the conv cell's step (K=1, B=32, P=361, R=2048, L=384)
// the torch chain reads and writes every [B, R, L] intermediate in device
// memory (~25 M elements a pass, tens of passes).  What the algorithm needs
// is the drawn words once (50 M int64 words, 403 MB, 120 µs at 3.35 TB/s),
// the clause outputs once (95 MB) and the picked patches' words, and a few
// MB of TA state.  The design reads less where the algebra allows it, with
// every output bit unchanged:
//  * conv_patch_pick: a block is 32 clause rows (a warp's lanes, 128
//    contiguous bytes of cl_p a patch) × 8 splits of the patch axis; each
//    thread keeps its split's best key, in patch order, and the splits meet
//    in shared memory (the larger key, the lower patch on a tie).  A
//    clause output of 0 gives a key below 1000, so with cl > 0 the argmax
//    lies among the patches where the clause fires: the draw is read there
//    only.  A pair with cl = 0 or no selection in either round is never
//    read by the TA stage, so its pick is skipped (pidx −1).
//  * conv_ta_update: a warp is one clause row × 128 literals (4 a lane, so
//    a lane's words of one round are one 32-byte sector); a block is 4 rows
//    of one 128-literal segment.  The block stages each batch row's
//    per-(b, r) scalars in shared memory (t1 of both rounds, Σt2 gated by
//    c, the segment's 4 words of the picked patch, zero where c = 0), then
//    every lane loops over b and both rounds with its 4 deltas in
//    registers: no atomics, no order.  A round's words are read only where
//    they can count: t1 ≠ 0 (a pair without Type I feedback needs none; a
//    Type II delta does not read them), l_mask ≠ 0 (a padded literal's
//    delta is masked), and not (boost and cal) (d1 is then 1).  Two batch
//    rows' loads are issued before either is used.  The epilogue masks,
//    clips and stores the lane's 4 states (4 bytes or 16) and ORs 8 lanes'
//    nibbles into each include word.
//  The draws stay as PRNG.bits makes them, so every PRNG state is unchanged.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kPickRows = 32;   // clause rows a pick block (a warp's lanes)
constexpr int kPickSplit = 8;   // patch-axis splits a pick block
constexpr int kPickUnroll = 8;  // patches a thread loads before it compares
constexpr int kSeg = 128;       // literals a TA warp: 4 a lane
constexpr int kRows = 4;        // clause rows a TA block, a warp each
constexpr int kChunk = 32;      // batch rows staged at a time (kChunk·kRows entries
                                // for 32·kRows threads: one each)
constexpr int kUnroll = 2;      // batch rows whose loads are in flight together
// blocks an SM must hold at once: registers capped at 64 (pick) and 80
// (update) a thread, for more loads in flight across the SM
constexpr int kPickBlocks = 4;
constexpr int kTaBlocks = 6;

struct PickParams {
  const int32_t* cl_p;           // [K, B, P, R]
  const int32_t* cl;             // [K, B, R]
  const int32_t* sel_lab;        // [K, B, R]
  const int32_t* sel_neg;        // [K, B, R]
  const long long* patch_rand;   // [K, B, P, Rg]
  int32_t* pidx;                 // [K, B, R]
  int B, P, R, Rg, row0;
};

__global__ void __launch_bounds__(kPickRows* kPickSplit, kPickBlocks)
    conv_patch_pick(const PickParams p) {
  __shared__ int s_key[kPickSplit][kPickRows];
  __shared__ int s_idx[kPickSplit][kPickRows];
  const int x = threadIdx.x, y = threadIdx.y;
  const int r = blockIdx.x * kPickRows + x;
  const long long kb = static_cast<long long>(blockIdx.z) * p.B + blockIdx.y;
  bool need = false;
  if (r < p.R) {
    const long long o = kb * p.R + r;
    need = p.cl[o] > 0 && (p.sel_lab[o] != 0 || p.sel_neg[o] != 0);
  }
  int best = INT_MIN, best_p = 0;
  if (need) {
    const int32_t* c = p.cl_p + kb * p.P * p.R + r;
    const long long* n = p.patch_rand + kb * p.P * p.Rg + p.row0 + r;
    for (int q0 = y; q0 < p.P; q0 += kPickSplit * kPickUnroll) {
      int v[kPickUnroll];
      long long m[kPickUnroll];
#pragma unroll
      for (int u = 0; u < kPickUnroll; ++u) {
        const int q = q0 + u * kPickSplit;
        v[u] = q < p.P ? __ldcs(c + static_cast<long long>(q) * p.R) : 0;
      }
#pragma unroll
      for (int u = 0; u < kPickUnroll; ++u) {
        const int q = q0 + u * kPickSplit;
        m[u] = v[u] > 0 ? __ldcs(n + static_cast<long long>(q) * p.Rg) : 0;
      }
#pragma unroll
      for (int u = 0; u < kPickUnroll; ++u) {
        if (v[u] > 0) {
          long long rem = m[u] % 997;          // the floor remainder, as torch's %
          if (rem < 0) rem += 997;
          const int key = v[u] * 1000 + static_cast<int>(rem);
          if (key > best) {                    // strict: the first patch on a tie
            best = key;
            best_p = q0 + u * kPickSplit;
          }
        }
      }
    }
  }
  s_key[y][x] = best;
  s_idx[y][x] = best_p;
  __syncthreads();
  if (y == 0 && r < p.R) {
    for (int j = 1; j < kPickSplit; ++j) {
      const int kj = s_key[j][x], pj = s_idx[j][x];
      if (kj > best || (kj == best && pj < best_p)) {
        best = kj;
        best_p = pj;
      }
    }
    p.pidx[kb * p.R + r] = need ? best_p : -1;
  }
}

struct TaParams {
  const void* ta;                // [K, R, L] uint8 or int32
  const uint32_t* inc;           // [K, R, W]
  const uint32_t* plits;         // [K, B, P, Wl]
  const int32_t* pidx;           // [K, B, R]
  const int32_t* cl;             // [K, B, R]
  const int32_t* sel_lab;        // [K, B, R]
  const int32_t* sel_neg;        // [K, B, R]
  const int32_t* weights;        // [K, H, R]
  const int32_t* labels;         // [K, B]
  const int32_t* neg;            // [K, B]
  const long long* ta_rand;      // [K, 2, B, Rg, L]
  const int32_t* l_mask;         // [K, L]
  const int32_t* cl_mask;        // [K, R]
  const int32_t* p_ta;           // [K], uint32 bits
  const uint8_t* boost;          // [K]
  const int32_t* n_states;       // [K]
  void* ta_out;                  // [K, R, L]
  uint32_t* inc_out;             // [K, R, W]
  int B, P, R, Rg, row0, L, Wl, W, H;
};

// A (batch row, clause row) pair's staged scalars: t1 of both rounds, the
// rounds' t2 summed and gated by c, and the picked patch's words of the
// block's segment (zero where c = 0, so that cal = 0 there).
struct Stage {
  int t1[2];
  int t2;
  uint32_t lw[kSeg / 32];
};

// A lane's 4 words of one round (one 32-byte sector when kVec), each read
// only where its bit of `want` is set.
template <bool kVec>
__device__ __forceinline__ void load_words(long long (&w)[4], const long long* src,
                                           unsigned want) {
  if constexpr (kVec) {
    const longlong2 z = make_longlong2(0, 0);
    const longlong2 a = (want & 3u) ? __ldcs(reinterpret_cast<const longlong2*>(src)) : z;
    const longlong2 b = (want & 12u) ? __ldcs(reinterpret_cast<const longlong2*>(src) + 1) : z;
    w[0] = a.x;
    w[1] = a.y;
    w[2] = b.x;
    w[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = ((want >> i) & 1u) ? __ldcs(src + i) : 0;
  }
}

template <typename TA, bool kVec>
__global__ void __launch_bounds__(32 * kRows, kTaBlocks) conv_ta_update(const TaParams p) {
  __shared__ Stage s[kChunk][kRows];
  const int lane = threadIdx.x & 31, rr = threadIdx.x >> 5;
  const int r = blockIdx.x * kRows + rr;
  const int seg = blockIdx.y, k = blockIdx.z;
  const int l0 = seg * kSeg + 4 * lane;
  const bool row_ok = r < p.R;
  const long long kL = static_cast<long long>(k) * p.L;
  const long long pta = static_cast<long long>(static_cast<uint32_t>(p.p_ta[k]));
  const bool boost = p.boost[k] != 0;

  // this lane's literals: real (l < L), unmasked, and their include bits
  unsigned live = 0;
  int lm[4] = {0, 0, 0, 0};
  uint32_t incn = 0;
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (l0 + i < p.L) {
        lm[i] = p.l_mask[kL + l0 + i];
        live |= (lm[i] != 0 ? 1u : 0u) << i;
      }
    }
    if (l0 < p.L)
      incn = (p.inc[(static_cast<long long>(k) * p.R + r) * p.W + (l0 >> 5)] >> (l0 & 31)) & 0xFu;
  }

  int acc[4] = {0, 0, 0, 0};
  const int sr = threadIdx.x % kRows, sb = threadIdx.x / kRows;   // this thread's entry
  const long long b_stride = static_cast<long long>(p.Rg) * p.L;
  const long long q_stride = static_cast<long long>(p.B) * b_stride;
  for (int b0 = 0; b0 < p.B; b0 += kChunk) {
    {
      Stage e = {{0, 0}, 0, {0u, 0u, 0u, 0u}};
      const int b = b0 + sb, rs = blockIdx.x * kRows + sr;
      if (b < p.B && rs < p.R) {
        const long long kb = static_cast<long long>(k) * p.B + b;
        const long long o = kb * p.R + rs;
        const bool c = p.cl[o] > 0;
        const int sl = p.sel_lab[o], sn = p.sel_neg[o];
        const long long kH = static_cast<long long>(k) * p.H;
        const int wl = p.weights[(kH + p.labels[kb]) * p.R + rs];
        const int wn = p.weights[(kH + p.neg[kb]) * p.R + rs];
        e.t1[0] = wl >= 0 ? sl : 0;
        e.t1[1] = wn < 0 ? sn : 0;
        e.t2 = c ? (wl < 0 ? sl : 0) + (wn >= 0 ? sn : 0) : 0;
        if (c && (e.t1[0] | e.t1[1] | e.t2)) {
          const uint32_t* w = p.plits + (kb * p.P + p.pidx[o]) * p.Wl;
#pragma unroll
          for (int j = 0; j < kSeg / 32; ++j) {
            const int wi = seg * (kSeg / 32) + j;
            e.lw[j] = wi < p.Wl ? w[wi] : 0u;
          }
        }
      }
      s[sb][sr] = e;
    }
    __syncthreads();
    const int nb = min(kChunk, p.B - b0);
    if (row_ok && live) {
      const long long* tr = p.ta_rand + ((static_cast<long long>(k) * 2 * p.B + b0) * p.Rg +
                                         p.row0 + r) * p.L + l0;
      for (int bb = 0; bb < nb; bb += kUnroll) {
        Stage e[kUnroll];
        unsigned lit[kUnroll], want[kUnroll][2];
        long long w[kUnroll][2][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (bb + u < nb) {
            e[u] = s[bb + u][rr];
          } else {
            e[u] = Stage{{0, 0}, 0, {0u, 0u, 0u, 0u}};
          }
          lit[u] = (e[u].lw[lane >> 3] >> ((lane & 7) * 4)) & 0xFu;
          const unsigned need = live & (boost ? ~lit[u] : 0xFu);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            want[u][q] = e[u].t1[q] != 0 ? need : 0u;
            load_words<kVec>(w[u][q], tr + q * q_stride + (bb + u) * b_stride, want[u][q]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int cal = (lit[u] >> i) & 1;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if ((want[u][q] >> i) & 1u) {
                const int low = w[u][q][i] < pta;
                acc[i] += e[u].t1[q] * (cal ? 1 - low : -low);
              } else if (cal) {   // boost (d1 = 1), t1 = 0 or a masked literal
                acc[i] += e[u].t1[q];
              }                   // else t1 = 0 or a masked literal: nothing
            }
            acc[i] += e[u].t2 * ((cal | ((incn >> i) & 1)) ^ 1);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!row_ok) return;                     // a whole warp: rr is the warp
  const long long row = static_cast<long long>(k) * p.R + r;
  const int cm = p.cl_mask[row];
  const int top = p.n_states[k] - 1, half = p.n_states[k] >> 1;
  const TA* ta = static_cast<const TA*>(p.ta) + row * p.L + l0;
  TA* out = static_cast<TA*>(p.ta_out) + row * p.L + l0;
  uint32_t bits = 0;
  if (l0 < p.L) {
    int old[4] = {0, 0, 0, 0};
    if constexpr (kVec && sizeof(TA) == 1) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(ta);
#pragma unroll
      for (int i = 0; i < 4; ++i) old[i] = (v >> (8 * i)) & 0xFFu;
    } else if constexpr (kVec) {
      const int4 v = *reinterpret_cast<const int4*>(ta);
      old[0] = v.x;
      old[1] = v.y;
      old[2] = v.z;
      old[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (l0 + i < p.L) old[i] = static_cast<int>(ta[i]);
    }
    int nv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = old[i] + acc[i] * lm[i] * cm;
      nv[i] = max(min(t, top), 0);
      if (l0 + i < p.L) bits |= static_cast<uint32_t>(nv[i] >= half) << i;
    }
    if constexpr (kVec && sizeof(TA) == 1) {
      *reinterpret_cast<uint32_t*>(out) =
          static_cast<uint32_t>(nv[0] & 0xFF) | (static_cast<uint32_t>(nv[1] & 0xFF) << 8) |
          (static_cast<uint32_t>(nv[2] & 0xFF) << 16) | (static_cast<uint32_t>(nv[3] & 0xFF) << 24);
    } else if constexpr (kVec) {
      *reinterpret_cast<int4*>(out) = make_int4(nv[0], nv[1], nv[2], nv[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (l0 + i < p.L) out[i] = static_cast<TA>(nv[i]);
    }
  }
  // 8 lanes' nibbles make an include word
  bits <<= (lane & 7) * 4;
  bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
  bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
  bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
  const int wi = seg * (kSeg / 32) + (lane >> 3);
  if ((lane & 7) == 0 && wi < p.W) p.inc_out[row * p.W + wi] = bits;
}

}  // namespace

// ta_bytes: 1 (uint8 states) or 4 (int32); vec: L % 4 == 0 and the states'
// pointers 16-byte (int32) or 4-byte (uint8) aligned, the draws' 16-byte.
// pidx [K, B, R] is the pick's output, read by the update.  B = 0 launches
// the update alone (Δ = 0).
extern "C" int dtm_conv_ta(const void* ta, const void* inc, const void* plits, const void* cl_p,
                           const void* cl, const void* sel_lab, const void* sel_neg,
                           const void* weights, const void* labels, const void* neg,
                           const void* patch_rand, const void* ta_rand, const void* l_mask,
                           const void* cl_mask, const void* p_ta, const void* boost,
                           const void* n_states, void* pidx, void* ta_out, void* inc_out, int K,
                           int B, int P, int R, int Rg, int row0, int L, int Wl, int W, int H,
                           int ta_bytes, int vec, void* stream) {
  if (K < 1 || K > 65535 || B < 0 || B > 65535 || P < 1 || R < 1 || L < 1 || row0 < 0 ||
      row0 + R > Rg || Wl * 32 < L || W * 32 < L || H < 1 || (ta_bytes != 1 && ta_bytes != 4) ||
      (vec && L % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const PickParams pp = {static_cast<const int32_t*>(cl_p), static_cast<const int32_t*>(cl),
                           static_cast<const int32_t*>(sel_lab),
                           static_cast<const int32_t*>(sel_neg),
                           static_cast<const long long*>(patch_rand), static_cast<int32_t*>(pidx),
                           B, P, R, Rg, row0};
    const dim3 grid((R + kPickRows - 1) / kPickRows, B, K);
    conv_patch_pick<<<grid, dim3(kPickRows, kPickSplit), 0, st>>>(pp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const TaParams tp = {ta, static_cast<const uint32_t*>(inc), static_cast<const uint32_t*>(plits),
                       static_cast<const int32_t*>(pidx), static_cast<const int32_t*>(cl),
                       static_cast<const int32_t*>(sel_lab), static_cast<const int32_t*>(sel_neg),
                       static_cast<const int32_t*>(weights), static_cast<const int32_t*>(labels),
                       static_cast<const int32_t*>(neg), static_cast<const long long*>(ta_rand),
                       static_cast<const int32_t*>(l_mask), static_cast<const int32_t*>(cl_mask),
                       static_cast<const int32_t*>(p_ta), static_cast<const uint8_t*>(boost),
                       static_cast<const int32_t*>(n_states), ta_out,
                       static_cast<uint32_t*>(inc_out), B, P, R, Rg, row0, L, Wl, W, H};
  const dim3 grid((R + kRows - 1) / kRows, (L + kSeg - 1) / kSeg, K);
  const dim3 block(32 * kRows);
  if (ta_bytes == 1) {
    if (vec)
      conv_ta_update<uint8_t, true><<<grid, block, 0, st>>>(tp);
    else
      conv_ta_update<uint8_t, false><<<grid, block, 0, st>>>(tp);
  } else {
    if (vec)
      conv_ta_update<int32_t, true><<<grid, block, 0, st>>>(tp);
    else
      conv_ta_update<int32_t, false><<<grid, block, 0, st>>>(tp);
  }
  return static_cast<int>(cudaGetLastError());
}
