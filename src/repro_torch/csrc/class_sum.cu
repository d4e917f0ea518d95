// Class sums on Hopper (sm_90a):
//
//   csum[k, b, h] = Σ_r clause[k, b, r] · w[k, h, r]       (int32)
//
// Replaces repro/kernels/class_sum.py: class_sum (the Pallas MXU block
// product with an int32 accumulator carried across the clause grid axis).
// k is the program axis of a bank (blockIdx.z, one stride per operand).
// Weights reach ±2047 and R <= 4224 at the paper's models, so int32
// cannot overflow (the sums wrap as the reference's int32 sums do).
// PyTorch has no int32 matmul on the card, and the sums must be exact.
//
// Bound: device-memory bytes.  Each clause value meets at most H weights
// (16 at the paper's models), far below the card's operations-per-byte
// balance.  What limits the kernel is how many blocks are in flight: the
// main path calls it at K=4 B=32 (serving), K=1 B=32 (the dense training
// front) and K=1 B=1 (the edge).  Design:
//  * One thread-block cluster per (program, batch tile of kRows rows)
//    splits the clause axis into `cs` spans (cs <= 16; the wrapper,
//    kernels/class_sum.py class_sum_split, sizes them to put about two
//    blocks on each SM); a block reads its span of the weights once for
//    the whole batch tile.
//  * A thread takes 4 clauses at a time: 16-byte loads of each batch row's
//    clause values and of each class's weights (scalar loads when R or a
//    pointer is not 16-byte aligned), kRows × 16 multiply-add sums in
//    registers.
//  * The warp's kRows × 16 sums meet in one butterfly reduce-scatter
//    (shuffles), after which each lane adds the (row, class) sums it holds
//    into the block's partial [kRows][H] in shared memory.
//  * The partials meet through distributed shared memory behind one
//    cluster barrier: block `rank` sums output pair i over the cluster's
//    partials when i % cs == rank, and writes it.  A second barrier keeps
//    each block's partials alive until all have read them.  No atomics in
//    device memory, no memset, one launch.
// Classes come in passes of 16 (registers) within a block of at most `hc`
// classes exchanged at once (shared memory); only H > hc repeats the
// exchange.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 128;
constexpr int kClasses = 16;          // classes per pass
constexpr int kMaxCluster = 16;       // blocks of a cluster (non-portable above 8)
constexpr int kPortableCluster = 8;

// Sum v[0, N) over the warp's lanes with N·31/32 shuffles (a butterfly
// reduce-scatter; call with O = 16): afterwards lane l holds, in
// v[0, max(N / 32, 1)), the sums of indices l·N/32 + i when N >= 32, or of
// index l >> log2(32 / N) (in lanes l and l ^ 1, ...) when N < 32.
// Independent shuffles at each of the five steps keep the exchange
// pipelined, where N warp reductions (redux.sync) would each wait for the
// last.  N is a power of two.
template <int N, int O>
__device__ __forceinline__ void warp_reduce_scatter(int32_t* v, int lane) {
  if constexpr (N >= 2) {
    constexpr int H = N / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int32_t send = upper ? v[i] : v[i + H];
      const int32_t keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    if constexpr (O > 1) warp_reduce_scatter<H, O / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    if constexpr (O > 1) warp_reduce_scatter<1, O / 2>(v, lane);
  }
}

// Values r..r+3 of a row (r < r_hi); past r_hi they read as zero.  Every
// load is unconditional (clamped): a load behind a branch waits for the
// one before it.
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* row, int r, int r_hi) {
  if (kVec) return __ldg(reinterpret_cast<const int4*>(row + r));
  const int32_t y = __ldg(row + min(r + 1, r_hi - 1)), z = __ldg(row + min(r + 2, r_hi - 1)),
                w = __ldg(row + min(r + 3, r_hi - 1));
  return make_int4(__ldg(row + r), r + 1 < r_hi ? y : 0, r + 2 < r_hi ? z : 0,
                   r + 3 < r_hi ? w : 0);
}

// Block (blockIdx.x = rank in the cluster over R, blockIdx.y = batch tile,
// blockIdx.z = program); the cluster is (gridDim.x, 1, 1).  span: clauses
// per block, a multiple of 4.
template <int kRows, bool kVec>
__global__ void __launch_bounds__(kThreads)
class_sum_kernel(const int32_t* __restrict__ cl, const int32_t* __restrict__ w,
                 int32_t* __restrict__ out, int B, int R, int H, long long cl_sk,
                 long long w_sk, long long out_sk, int span, int hc) {
  extern __shared__ int32_t s_part[];   // [kRows][hc]
  const int tid = threadIdx.x, lane = tid & 31;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int k = blockIdx.z, b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int r_lo = rank * span, r_hi = min(R, r_lo + span);
  const int32_t* cl_k = cl + k * cl_sk + static_cast<long long>(b0) * R;
  const int32_t* w_k = w + k * w_sk;
  int32_t* out_k = out + k * out_sk + static_cast<long long>(b0) * H;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();

  for (int hb = 0; hb < H; hb += hc) {
    const int nh = min(hc, H - hb);
    for (int i = tid; i < kRows * hc; i += kThreads) s_part[i] = 0;
    __syncthreads();
    for (int h0 = 0; h0 < nh; h0 += kClasses) {
      constexpr int kN = kRows * kClasses;
      int32_t acc[kN];   // [row][class]
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] = 0;
      for (int r = r_lo + 4 * tid; r < r_hi; r += 4 * kThreads) {
        // rows past nb and classes past nh are clamped, so every load is
        // unconditional; their sums are never added
        int4 c[kRows];
#pragma unroll
        for (int b = 0; b < kRows; ++b)
          c[b] = load4<kVec>(cl_k + static_cast<long long>(min(b, nb - 1)) * R, r, r_hi);
        int4 v[kClasses];
#pragma unroll
        for (int j = 0; j < kClasses; ++j)
          v[j] = load4<kVec>(w_k + static_cast<long long>(hb + min(h0 + j, nh - 1)) * R, r, r_hi);
#pragma unroll
        for (int j = 0; j < kClasses; ++j)
#pragma unroll
          for (int b = 0; b < kRows; ++b)
            acc[b * kClasses + j] +=
                c[b].x * v[j].x + c[b].y * v[j].y + c[b].z * v[j].z + c[b].w * v[j].w;
      }
      // one reduce-scatter of the kRows × 16 sums over the warp's lanes;
      // lane l then adds the (row, class) pairs it holds
      warp_reduce_scatter<kN, 16>(acc, lane);
      if constexpr (kN >= 32) {
#pragma unroll
        for (int i = 0; i < kN / 32; ++i) {
          const int idx = lane * (kN / 32) + i;
          const int b = idx / kClasses, h = h0 + idx % kClasses;
          if (b < nb && h < nh && acc[i] != 0) atomicAdd(s_part + b * hc + h, acc[i]);
        }
      } else {   // kN = 16: lanes 2j and 2j + 1 hold class j
        const int h = h0 + (lane >> 1);
        if ((lane & 1) == 0 && h < nh && acc[0] != 0) atomicAdd(s_part + h, acc[0]);
      }
    }
    __syncthreads();
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    for (int i = rank + cs * tid; i < nb * nh; i += cs * kThreads) {
      const int b = i / nh, h = i % nh;
      int32_t part[kMaxCluster];   // all in flight at once
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        part[q] = q < cs ? cluster.map_shared_rank(s_part, q)[b * hc + h] : 0;
      int32_t v = 0;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) v += part[q];
      out_k[static_cast<long long>(b) * H + hb + h] = v;
    }
    // every block has read this block's partials before they are
    // cleared or the block exits (the values read are used already: no
    // release, so the arrive does not wait for the stores above)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
}

template <int kRows, bool kVec>
cudaError_t launch(const int32_t* cl, const int32_t* w, int32_t* out, int K, int B, int R,
                   int H, long long cl_sk, long long w_sk, long long out_sk, int cs, int span,
                   int hc, cudaStream_t stream) {
  auto kernel = class_sum_kernel<kRows, kVec>;
  static bool nonportable = false;
  static size_t smem_set = 48 * 1024;
  const size_t smem = sizeof(int32_t) * kRows * hc;
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
  cfg.gridDim = dim3(cs, (B + kRows - 1) / kRows, K);
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
  return cudaLaunchKernelEx(&cfg, kernel, cl, w, out, B, R, H, cl_sk, w_sk, out_sk, span, hc);
}

}  // namespace

// rows: batch rows per tile (1 or 4); cs: blocks of a cluster over R
// (1-16), each taking span clauses (a multiple of 4, cs · span >= R);
// hc: classes exchanged at once (shared memory 4 · rows · hc bytes);
// vec = 1 when R and the program strides are multiples of 4 and both
// pointers are 16-byte aligned.
extern "C" int dtm_class_sum(const void* cl, const void* w, void* out,
                             int K, int B, int R, int H,
                             long long cl_sk, long long w_sk, long long out_sk,
                             int rows, int cs, int span, int hc, int vec, void* stream) {
  if (cs < 1 || cs > kMaxCluster || span < 4 || span % 4 != 0 ||
      static_cast<long long>(cs) * span < R || hc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c32 = static_cast<const int32_t*>(cl);
  const auto* w32 = static_cast<const int32_t*>(w);
  auto* o32 = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rows == 1)
    e = vec ? launch<1, true>(c32, w32, o32, K, B, R, H, cl_sk, w_sk, out_sk, cs, span, hc, st)
            : launch<1, false>(c32, w32, o32, K, B, R, H, cl_sk, w_sk, out_sk, cs, span, hc, st);
  else if (rows == 4)
    e = vec ? launch<4, true>(c32, w32, o32, K, B, R, H, cl_sk, w_sk, out_sk, cs, span, hc, st)
            : launch<4, false>(c32, w32, o32, K, B, R, H, cl_sk, w_sk, out_sk, cs, span, hc, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
