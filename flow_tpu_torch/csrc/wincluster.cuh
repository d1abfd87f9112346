// The thread-block-cluster walk that the window kernels winstiff_p1_3d,
// winstiff_p2_2d and winstiff_p2_3d (winstiff.cu), winmass (winmass.cu),
// winform (winform.cu) and winmom3d (winmom3d.cu) share: a
// window block's local results staged at their scatter-list positions in
// the shared memory of a cluster of blocks (distributed shared memory,
// DSMEM), and each window row summed from it in list order. No device
// scratch, and no read of the lists themselves (ent).
//
// The lists (attic/window.py::build_scatter_lists): for window dof w of
// block b, rowptr[b, w] .. rowptr[b, w + 1] are the positions of the (cell,
// local dof) entries that land on w, in ascending entry order. pos [nb, NL,
// C] is their inverse (window.py::scatter_positions): the position of
// local result (c, i), -1 for a padding cell. Summing a row's positions in
// order is the order of every other window kernel's scatter_window
// (winscatter.cuh), so the result does not depend on the cluster size, the
// block size or the number of passes.
//
// The walk: a grid of `clusters` clusters of CL blocks; cluster k takes the
// window blocks k, k + clusters, ... (the wrapper launches no more clusters
// than the card holds at once, cudaOccupancyMaxActiveClusters, so one wave
// covers the grid). Within a window block, block `rank` of the cluster
// takes a contiguous range of cells, computes each cell's NL local results
// (the kernel's `cell`) and stores result (c, i) at its list position p in
// the shared memory of the block that stages p: block r stages positions
// [r*Q, (r+1)*Q), Q = 1/CL of the positions. After cluster.sync() each
// block sums the rows whose first position it stages, each along its
// contiguous positions, from its own shared memory or (for a row that runs
// past its last position) the next block's. A window block whose entries
// exceed the cluster's CL*cap staged positions runs in passes over whole rows;
// each pass reads every cell again and stores the results that fall in
// it. The row sums are bound by instructions, not bytes (most rows of a
// 3-D window are empty, and a warp waits for its longest row): a thread
// loads the pointers of kRows rows at once and finds a row's holder once.
//
// A position may hold NC values (K3 3-D: the three velocity components of
// a local result), staged as NC planes of Q values in each block's shared
// memory and summed per component; component m of window block b is
// out[(m * nb + b) * W + w]. And the walk may take compressed rows
// (COMPACT): only the rows that some local result lands on (rows [nb, R],
// ascending, padded with W; rowptr [nb, R + 1] their positions), after
// zeros written over the whole window with 16-byte stores (interleaved
// with the cells of the first pass), so that an empty row costs neither a
// pointer load nor a turn of the row loop.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Phase marks for scripts/torch_window_cluster_trace.py. Built with
// -DWINCLUSTER_TRACE, thread 0 of each block writes %globaltimer at mark k
// of the first pass of its first window block to
// wincluster_trace[blockIdx.x * 8 + k], and wincluster_trace_read copies
// the table out; otherwise the marks are empty.
#ifdef WINCLUSTER_TRACE
__device__ unsigned long long wincluster_trace[1 << 16];
extern "C" int wincluster_trace_read(void* dst, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, wincluster_trace, n * sizeof(unsigned long long)));
}
#define WINCLUSTER_MARK(k, on)                                                       \
  do {                                                                               \
    if (threadIdx.x == 0 && (on)) {                                                  \
      unsigned long long t_;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                         \
      wincluster_trace[blockIdx.x * 8 + (k)] = t_;                                   \
    }                                                                                \
  } while (0)
#else
#define WINCLUSTER_MARK(k, on) \
  do {                         \
    (void)(on);                \
  } while (0)
#endif

namespace wincluster {

constexpr int kMaxCluster = 8;  // blocks of a cluster, at most (portable)
constexpr int kRows = 8;  // rows a thread sums per round of row-pointer loads
// First row w in [lo, hi] with rp[w] >= target, or hi (rp ascends), found
// by the whole block: each round probes blockDim.x rows evenly spread over
// the interval left and keeps the gap where rp crosses target, so that two
// or three rounds of parallel loads replace a chain of log2(W) dependent
// ones. Every thread of the block calls it with the same arguments.
__device__ __forceinline__ int row_at(const int* rp, long long target, int lo, int hi) {
  const int T = static_cast<int>(blockDim.x);
  while (lo < hi) {
    const int stride = (hi - lo + T - 1) / T;
    const int probe = lo + static_cast<int>(threadIdx.x) * stride;
    const int below = __syncthreads_count(probe < hi && rp[probe] < target);
    if (below == 0) break;  // rp[lo] >= target
    lo += (below - 1) * stride + 1;
    hi = min(hi, lo - 1 + stride);
  }
  return lo;
}

// The block that stages position q of a pass, Q positions a block: q / Q
// through a float reciprocal, corrected to the exact quotient.
struct Holder {
  int Q;
  float inv_q;
  __device__ __forceinline__ explicit Holder(int q_per_block)
      : Q(q_per_block), inv_q(1.f / static_cast<float>(q_per_block)) {}
  __device__ __forceinline__ int operator()(int q) const {
    int h = __float2int_rz(static_cast<float>(q) * inv_q);
    if ((h + 1) * Q <= q) ++h;
    if (h * Q > q) --h;
    return h;
  }
};

// The walk of the header for a kernel whose cell(b, c) reads what cell c
// of window block b needs and returns result, with result(i) its local
// result i (NC = 1) or result(i, m) component m of it: the walk asks only
// for the results that fall in the pass, so a kernel computes in result
// what it can skip and in cell() what it had better load early. Each
// block stages up to `cap` positions a pass, NC*cap floats of its dynamic
// shared memory. rowptr [nb, R + 1] holds the positions of the rows the
// walk sums: every row (R = W, rows unused) or, COMPACT, the listed rows
// rows [nb, R]. The caller stages its own tables in shared memory first;
// the cluster.sync() here, before any store to another block's shared
// memory, orders them too.
template <int NL, int NC, bool COMPACT, typename Cell>
__device__ __forceinline__ void walk(const int* __restrict__ rowptr,
                                     const int* __restrict__ rows, int R,
                                     const int* __restrict__ pos, float* __restrict__ out,
                                     int nb, int W, int C, int cap, Cell&& cell) {
  namespace coop = cooperative_groups;
  extern __shared__ __align__(16) float stage_s[];
  coop::cluster_group cluster = coop::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int T = static_cast<int>(blockDim.x);
  const int cells = (C + CL - 1) / CL;  // this block's cells [c0, c1)
  const int c0 = min(C, rank * cells);
  const int c1 = min(C, c0 + cells);
  const long long plane = static_cast<long long>(nb) * W;  // component stride of out
  bool tracing = true;  // the first pass of the first window block (marks)
  WINCLUSTER_MARK(0, tracing);
  // every block of the cluster has started (and staged its tables): a
  // block may write another's shared memory only after this
  cluster.sync();

  for (int b = static_cast<int>(blockIdx.x) / CL; b < nb;
       b += static_cast<int>(gridDim.x) / CL) {
    const int* rp = rowptr + static_cast<long long>(b) * (R + 1);
    const int* pos_b = pos + static_cast<long long>(b) * NL * C;
    float* out_b = out + static_cast<long long>(b) * W;
    // COMPACT: the empty rows' zeros, the whole window's NC*W/4 16-byte
    // chunks, this block's share [z, z1) of them. The threads store them
    // interleaved with the first pass's cells (zstep a cell, T apart), so
    // that they drain while the cells compute; the cluster barrier before
    // the row sums orders them first.
    [[maybe_unused]] int z = 0, z1 = 0, zstep = 0;
    if constexpr (COMPACT) {
      const int zn = NC * (W / 4);
      const int zshare = (zn + CL - 1) / CL;
      z = min(zn, rank * zshare) + static_cast<int>(threadIdx.x);
      z1 = min(zn, rank * zshare + zshare);
      const int rounds = max(1, (c1 - c0 + T - 1) / T);
      zstep = (zshare + rounds * T - 1) / (rounds * T);
    }
    auto store_zeros = [&](int count) {
      for (int k = 0; k < count && z < z1; ++k, z += T)
        reinterpret_cast<float4*>(out_b + (z / (W / 4)) * plane)[z % (W / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    };
    // passes over whole rows [r0, r1) whose entries [e0, e1) fit the
    // cluster's CL*cap staged positions
    for (int r0 = 0; r0 < R;) {
      const int e0 = rp[r0];
      const long long room = static_cast<long long>(CL) * cap;
      const int r1 = rp[R] - e0 <= room ? R : row_at(rp, e0 + room + 1, r0, R) - 1;
      if (r1 <= r0) __trap();  // a row longer than the cluster's stage
      const int n = rp[r1] - e0;
      const Holder holder_of((n + CL - 1) / CL);  // positions [r*Q, +Q) on block r
      WINCLUSTER_MARK(1, tracing);
      for (int c = c0 + static_cast<int>(threadIdx.x); c < c1; c += T) {
        if constexpr (COMPACT) store_zeros(zstep);
        auto result = cell(b, c);
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const int q = pos_b[i * C + c] - e0;
          if (q < 0 || q >= n) continue;  // a padding cell, or another pass
          if constexpr (NC == 1) {
            const float value = result(i);
            const int h = holder_of(q);
            *cluster.map_shared_rank(stage_s + (q - h * holder_of.Q), h) = value;
          } else {
            const int h = holder_of(q);
            float* dst = cluster.map_shared_rank(stage_s + (q - h * holder_of.Q), h);
#pragma unroll
            for (int m = 0; m < NC; ++m) dst[m * holder_of.Q] = result(i, m);
          }
        }
      }
      if constexpr (COMPACT) store_zeros(z1);  // what is left of them
#ifdef WINCLUSTER_TRACE
      __syncthreads();
#endif
      WINCLUSTER_MARK(2, tracing);
      cluster.sync();  // every staged value of this pass is written
      WINCLUSTER_MARK(3, tracing);
      const int Q = holder_of.Q;
      // rows: those whose first position this block stages, each summed
      // along its positions in order
      const int ra = rank == 0 ? r0 : row_at(rp, e0 + static_cast<long long>(rank) * Q, r0, r1);
      const int rb = rank == CL - 1
                         ? r1 : row_at(rp, e0 + static_cast<long long>(rank + 1) * Q, r0, r1);
      WINCLUSTER_MARK(4, tracing);
      for (int w0 = ra + static_cast<int>(threadIdx.x); w0 < rb; w0 += kRows * T) {
        // kRows rows a thread, T apart, their row pointers loaded together
        int first[kRows], last[kRows];
        [[maybe_unused]] int row[kRows];  // COMPACT: the window rows of the slots
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int w = min(w0 + k * T, rb);
          first[k] = rp[w] - e0;
          last[k] = rp[min(w + 1, rb)] - e0;
          if constexpr (COMPACT) row[k] = w < rb ? rows[static_cast<long long>(b) * R + w] : W;
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (w0 + k * T >= rb) break;
          float acc[NC];
#pragma unroll
          for (int m = 0; m < NC; ++m) acc[m] = 0.f;
          int q = first[k];
          if (q < last[k]) {
            // the row's positions run through one holder's stage, rarely
            // into the next one's: find the holder once, step at its end
            int h = holder_of(q);
            int next = (h + 1) * Q;
            const float* held = h == rank ? stage_s : cluster.map_shared_rank(stage_s, h);
            int off = h * Q;
            for (; q < last[k]; ++q) {
              if (q == next) {
                ++h;
                next += Q;
                off += Q;
                held = h == rank ? stage_s : cluster.map_shared_rank(stage_s, h);
              }
#pragma unroll
              for (int m = 0; m < NC; ++m) acc[m] += held[m * Q + q - off];
            }
          }
          int w = w0 + k * T;
          if constexpr (COMPACT) {
            w = row[k];
            if (w >= W) continue;  // a padding slot
          }
#pragma unroll
          for (int m = 0; m < NC; ++m) out_b[m * plane + w] = acc[m];
        }
      }
#ifdef WINCLUSTER_TRACE
      __syncthreads();
#endif
      WINCLUSTER_MARK(5, tracing);
      cluster.sync();  // no block overwrites or leaves what another still reads
      WINCLUSTER_MARK(6, tracing);
      tracing = false;
      r0 = r1;
    }
  }
}

// The walk of a scalar kernel (one value a position) over every row.
template <int NL, typename Cell>
__device__ __forceinline__ void stage_and_sum(const int* __restrict__ rowptr,
                                              const int* __restrict__ pos,
                                              float* __restrict__ out, int nb, int W,
                                              int C, int cap, Cell&& cell) {
  walk<NL, 1, false>(rowptr, nullptr, W, pos, out, nb, W, C, cap,
                     static_cast<Cell&&>(cell));
}

// Launches kernel(args...) as `clusters` clusters of `cl` blocks of
// `threads` threads (at most `max_threads`, the kernel's launch bounds),
// each with 4*stage bytes of dynamic shared memory, through
// cudaLaunchKernelEx with a cluster dimension. With `max_clusters` set it
// launches nothing and writes there how many such clusters the card holds
// at once (cudaOccupancyMaxActiveClusters). Returns the cudaError_t.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int clusters, int cl, int threads, int max_threads,
           int stage, void* stream, int* max_clusters, Args... args) {
  if (clusters <= 0 || cl < 1 || cl > kMaxCluster || threads < 32 ||
      threads > max_threads || threads % 32 || stage <= 0 || stage > 227 * 1024 / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * stage;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * cl, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (max_clusters != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &config));
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wincluster
