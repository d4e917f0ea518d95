// Dense clause evaluation and fused inference on Hopper (sm_90a): two
// entry points, one clause tile.
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
// literal, {0, 1} (any nonzero byte counts as 1); weights int32 [K, H, C];
// all contiguous.  k is the program axis of a bank (blockIdx.z).
//
// Bound: device-memory bytes.  The include matrix is K·C·L bytes (54 MB at
// the serving bank, K=4, C=4224, L=3200) against K·B·L literal bytes; the
// work, B·C·L byte pairs per program, is int8-product work that the tensor
// cores would do at 1,979 T/s, far below the byte time.
// Design (a simple first version; wgmma/IMMA is later work): a block owns
// 32 batch rows × 64 clauses of one program, so each include byte is read
// from device memory once per 32 batch rows.  It walks the literal axis in
// chunks of 128 bytes staged in shared memory (16-byte loads when L and
// the pointers allow, byte loads else; the ragged tail reads as zero, and
// a zero include never violates), normalising every byte to {0, 1}.  A
// clause fires iff no byte of inc & (lit == 0) is set, so the violation
// test needs no count: per 4 literals one LOP3, acc |= inc & neg.  Each of
// the 128 threads keeps 4 batch rows × 4 clauses; row strides of 33 words
// keep the shared loads free of bank conflicts.  tm_infer then turns the
// tile into one 64-bit fired mask per batch row (warp ballots), stages the
// weights of its 64 clauses, adds the weights of the fired clauses per
// (row, class) and adds each nonzero partial sum into the zeroed
// [K, B, H] output with an integer atomic: exact in any order.
#include "common.cuh"

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

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
clause_eval_kernel(const int8_t* __restrict__ lit, const int8_t* __restrict__ inc,
                   int32_t* __restrict__ out, int B, int C, int L, bool eval_mode) {
  Tile t;
  clause_tile<kVec>(lit, inc, B, C, L, t);
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * kRows, c0 = blockIdx.x * kClauses;
  const int cg = threadIdx.x & 15, bg = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = b0 + bg + 8 * j;
    if (b >= B) continue;
    int32_t* row = out + (static_cast<long long>(k) * B + b) * C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + cg + 16 * i;
      if (c < C) row[c] = fired(t, j, i, eval_mode) ? 1 : 0;
    }
  }
}

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
// aligned (16-byte loads); else the kernel loads bytes.
extern "C" int dtm_clause_eval(const void* lit, const void* inc, void* out, int K, int B,
                               int C, int L, int eval_mode, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l8 = static_cast<const int8_t*>(lit);
  const auto* i8 = static_cast<const int8_t*>(inc);
  auto* o = static_cast<int32_t*>(out);
  if (vec)
    clause_eval_kernel<true><<<grid_of(K, B, C), kThreads, 0, st>>>(l8, i8, o, B, C, L,
                                                                    eval_mode != 0);
  else
    clause_eval_kernel<false><<<grid_of(K, B, C), kThreads, 0, st>>>(l8, i8, o, B, C, L,
                                                                     eval_mode != 0);
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
