// Window-blocked scalar stiffness apply on a P1 or P2 space, 2-D (DIM=2,
// NL=3 or 6) or 3-D (DIM=3, NL=4 or 10):
//
//   out[b, w] = sum over the real cells c of block b and local dofs i with
//               lidx[b, i, c] == w of
//               valid[b, c] * sum_{k,l} Cg[b, DIM*k+l, c]
//                             * sum_j Kref[k, l, i, j] * x[b*S + lidx[b, j, c]]
//
// x is the permuted, zero-padded input [nb*S + W]; out holds one window
// [nb, W] per block, which the caller overlap-adds (attic/window.py).
//
// Replaces flow_tpu/attic/winkernel.py::WindowStiffnessOperator._pallas
// (K4b), whose TPU kernel DMAs the window into VMEM and gathers and scatters
// with one-hot MXU contractions. It is the pressure operator of the window
// route (Karman in 2-D, the cavity in 3-D) and the operator of the large
// 2-D multigrid levels.
//
// Bound: memory bandwidth. Per cell it reads NL indices, DIM^2 geometry
// factors, a mask and NL window values and does ~100 (2-D P1), ~370 (3-D
// P1), ~360 (2-D P2) or ~1,900 (3-D P2) flops. The scatter lists, which
// only this design needs, add one index per (cell, local dof) and one row
// pointer per window dof on top of the function's own bytes; the device
// scratch of all but winstiff_p1_3d adds two floats per local result.
//
// Design of winstiff_p1_2d, winstiff_p2_2d and winstiff_p2_3d: one block
// per window block b. The Kref table is staged in shared memory. Threads
// take cells in turn, gather the NL window values (the window of one block
// spans a few thousand contiguous floats, so the gathers hit L1/L2), and
// write the NL local results. Then the block sums them into its window
// along the host-built scatter lists, in a fixed order and with no atomics
// (scatter_window, csrc/winscatter.cuh, as in winmass.cu and winform.cu).
// The local results live in a device scratch [nb, C*NL] that the wrapper
// allocates, so any C fits; __syncthreads() makes the block's global writes
// visible to the block before the sums. A 3-D block has 1,024 threads, a
// 2-D block 256.
//
// Design of winstiff_p1_3d (the cavity's pressure operator: nb = 68, C =
// 23,958, W = 20,480 at N=64): a thread-block cluster of CL blocks per
// window block, launched with cudaLaunchKernelEx, so that 68 window blocks
// spread over the 132 SMs. The cluster's shared memory (distributed shared
// memory, DSMEM) holds what the TPU kernel kept in VMEM: every local result
// of the window block, in the order of the scatter lists, so no device
// scratch is written or read back. Block `rank` takes a contiguous range of
// cells and stores each local result (c, i) at its list position p (the
// host-built inverse of the lists, window.py::scatter_positions) in the
// shared memory of the block that stages p: block r stages positions
// [r*Q, (r+1)*Q), Q = 1/CL of the window's entries. After cluster.sync()
// each block sums the rows whose first position it stages, each along its
// contiguous positions in list order, from its own shared memory (a row
// that runs past its last position reads the rest from the next block's).
// So each row sums in the order of the other entries' scatter_window, with
// no gather of the lists. A layout whose entries exceed the cluster's CL*cap
// staged values runs in passes over whole rows; each pass computes every
// cell again and stores the results that fall in it.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "winscatter.cuh"

namespace {

template <int DIM, int NL, int THREADS>
__global__ void __launch_bounds__(THREADS)
winstiff_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
                const float* __restrict__ valid, const float* __restrict__ cg,
                const float* __restrict__ kref, const int* __restrict__ rowptr,
                const int* __restrict__ ent, float* __restrict__ scratch,
                float* __restrict__ out, int S, int W, int C) {
  constexpr int D2 = DIM * DIM;
  constexpr int KT = D2 * NL * NL;
  // the 3-D P1 table (144 floats) and the P2 tables (144 and 900) are read
  // through a volatile pointer, so that every use reads shared memory:
  // otherwise the compiler hoists them out of the cell loop and spills them
  // to local memory; the 2-D P1 table (36 floats) stays in registers
  using KrefPtr = std::conditional_t<(KT > 64), const volatile float*, const float*>;
  __shared__ float kref_s[KT];  // [D2*NL, NL]

  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < KT; t += blockDim.x) kref_s[t] = kref[t];

  // [C, NL] local results: the block's rows of the scratch
  float* loc_s = scratch + static_cast<long long>(b) * C * NL;
  const float* xw = x + static_cast<long long>(b) * S;
  const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
  const float* valid_b = valid + static_cast<long long>(b) * C;
  const float* cg_b = cg + static_cast<long long>(b) * D2 * C;
  const int* rp = rowptr + static_cast<long long>(b) * (W + 1);
  const int* en = ent + static_cast<long long>(b) * C * NL;
  float* out_b = out + static_cast<long long>(b) * W;
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float u[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
    float g[D2];
#pragma unroll
    for (int kl = 0; kl < D2; ++kl) g[kl] = cg_b[kl * C + c];
    const float v = valid_b[c];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float loc = 0.f;
#pragma unroll
      for (int kl = 0; kl < D2; ++kl) {
        KrefPtr kr = kref_s + (kl * NL + i) * NL;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += kr[j] * u[j];
        loc += g[kl] * s;
      }
      loc_s[c * NL + i] = loc * v;
    }
  }
  __syncthreads();
  scatter_window(loc_s, rp, en, out_b, W);
}

// s = sum_j kr[j] * u[j] in j order, kr a row of NL = 4 values of the Kref
// table in shared memory, read as one 16-byte load. The load is asm
// volatile, so that the compiler keeps the table in shared memory instead
// of hoisting it out of the cell loop into spilled registers, and reads it
// at a quarter of the shared-memory instructions of four volatile floats.
template <int NL>
__device__ __forceinline__ float kref_row_dot(const float* kr, const float (&u)[NL]) {
  static_assert(NL == 4, "kref_row_dot reads rows of four values");
  float k0, k1, k2, k3;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(k0), "=f"(k1), "=f"(k2), "=f"(k3)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(kr))));
  float s = 0.f;
  s += k0 * u[0];
  s += k1 * u[1];
  s += k2 * u[2];
  s += k3 * u[3];
  return s;
}

// The cluster variant (see the header): grid nb*CL blocks in clusters of CL;
// each block stages up to `cap` entries a pass in dynamic shared memory.
// pos [nb, NL, C]: the position in its window row's scatter list of local
// result (c, i), -1 for a padding cell.
constexpr int kMaxCluster = 8;  // blocks of a cluster, at most (portable)

// At most 512 threads a block and 40 registers a thread (__launch_bounds__
// (512, 3)), so that three blocks share an SM: the card then holds 45 of the
// cavity's 68 clusters at once instead of 30 (cudaOccupancyMaxActiveClusters,
// PERF.md).
constexpr int kClusterThreads = 512;

template <int DIM, int NL>
__global__ void __launch_bounds__(kClusterThreads, 3)
winstiff_cluster_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
                        const float* __restrict__ valid, const float* __restrict__ cg,
                        const float* __restrict__ kref, const int* __restrict__ rowptr,
                        const int* __restrict__ pos, float* __restrict__ out, int S,
                        int W, int C, int cap) {
  namespace coop = cooperative_groups;
  constexpr int D2 = DIM * DIM;
  constexpr int KT = D2 * NL * NL;
  __shared__ __align__(16) float kref_s[KT];  // [D2*NL, NL]
  extern __shared__ __align__(16) float stage_s[];

  coop::cluster_group cluster = coop::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CL;
  const int T = blockDim.x;

  for (int t = threadIdx.x; t < KT; t += T) kref_s[t] = kref[t];
  const float* xw = x + static_cast<long long>(b) * S;
  const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
  const float* valid_b = valid + static_cast<long long>(b) * C;
  const float* cg_b = cg + static_cast<long long>(b) * D2 * C;
  const int* rp = rowptr + static_cast<long long>(b) * (W + 1);
  const int* pos_b = pos + static_cast<long long>(b) * NL * C;
  float* out_b = out + static_cast<long long>(b) * W;
  const int cells = (C + CL - 1) / CL;  // this block's cells [c0, c1)
  const int c0 = rank * cells;
  const int c1 = min(C, c0 + cells);

  // first row w in [lo, hi] with rp[w] >= target, or hi (rp ascends),
  // found by the whole block: each round probes T rows evenly spread over
  // the interval left and keeps the gap where rp crosses target, so that
  // two or three rounds of parallel loads replace a chain of log2(W)
  // dependent ones. Every thread calls it with the same arguments.
  auto row_at = [&](long long target, int lo, int hi) {
    while (lo < hi) {
      const int stride = (hi - lo + T - 1) / T;
      const int probe = lo + threadIdx.x * stride;
      const int below = __syncthreads_count(probe < hi && rp[probe] < target);
      if (below == 0) break;  // rp[lo] >= target
      lo += (below - 1) * stride + 1;
      hi = min(hi, lo - 1 + stride);
    }
    return lo;
  };
  // Kref is staged, and every block of the cluster has started: a block may
  // write another's shared memory only after this
  cluster.sync();

  // passes over whole rows [r0, r1) whose entries [e0, e1) fit the
  // cluster's CL*cap staged values; the layout's rows fit one pass unless
  // its local results exceed the cluster's shared memory
  for (int r0 = 0; r0 < W;) {
    const int e0 = rp[r0];
    const int r1 = rp[W] - e0 <= static_cast<long long>(CL) * cap
                       ? W : row_at(e0 + static_cast<long long>(CL) * cap + 1, r0, W) - 1;
    if (r1 <= r0) __trap();  // a row longer than the cluster's stage
    const int e1 = rp[r1];
    const int Q = (e1 - e0 + CL - 1) / CL;  // entries [e0 + r*Q, +Q) on block r
    // the block that stages position q: q / Q through a float reciprocal,
    // corrected to the exact quotient
    const float inv_q = 1.f / static_cast<float>(Q);
    auto holder_of = [&](int q) {
      int h = __float2int_rz(static_cast<float>(q) * inv_q);
      if ((h + 1) * Q <= q) ++h;
      if (h * Q > q) --h;
      return h;
    };
    // cells: the NL local results of each of this block's cells, each
    // stored at its list position, in the shared memory of the block that
    // stages that position (distributed shared memory)
    for (int c = c0 + threadIdx.x; c < c1; c += T) {
      float u[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
      float g[D2];
#pragma unroll
      for (int kl = 0; kl < D2; ++kl) g[kl] = cg_b[kl * C + c];
      const float v = valid_b[c];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int q = pos_b[i * C + c] - e0;
        if (q < 0 || q >= e1 - e0) continue;
        float loc = 0.f;
#pragma unroll
        for (int kl = 0; kl < D2; ++kl)
          loc += g[kl] * kref_row_dot<NL>(kref_s + (kl * NL + i) * NL, u);
        const int holder = holder_of(q);
        *cluster.map_shared_rank(stage_s + (q - holder * Q), holder) = loc * v;
      }
    }
    cluster.sync();  // every staged value of this pass is written
    // rows: those whose first entry this block stages sum their lists in
    // order (a row that runs past the block's entries reads the rest from
    // the blocks that stage them)
    const int ra = rank == 0 ? r0 : row_at(e0 + static_cast<long long>(rank) * Q, r0, r1);
    const int rb = rank == CL - 1 ? r1
                                  : row_at(e0 + static_cast<long long>(rank + 1) * Q, r0, r1);
    for (int w = ra + threadIdx.x; w < rb; w += T) {
      const int last = rp[w + 1] - e0;
      float acc = 0.f;
      for (int q = rp[w] - e0; q < last; ++q) {
        const int holder = holder_of(q);
        const float* held = stage_s + (q - holder * Q);
        acc += holder == rank ? *held : *cluster.map_shared_rank(held, holder);
      }
      out_b[w] = acc;
    }
    cluster.sync();  // no block overwrites or leaves what another still reads
    r0 = r1;
  }
}

// The launch of the cluster variant (cudaLaunchKernelEx with a cluster
// dimension); with `max_clusters` set, instead of launching, the number of
// such clusters that can be resident on the card at once.
template <int DIM, int NL>
int launch_cluster(const void* x, const void* lidx, const void* valid, const void* cg,
                   const void* kref, const void* rowptr, const void* pos, void* out,
                   int nb, int S, int W, int C, int cl, int threads, int cap,
                   void* stream, int* max_clusters = nullptr) {
  if (nb <= 0 || C <= 0 || W <= 0 || cl < 1 || cl > kMaxCluster || threads < 32 ||
      threads > kClusterThreads || threads % 32 || cap <= 0 || cap > 227 * 1024 / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * cap;
  auto kernel = winstiff_cluster_kernel<DIM, NL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(nb * cl, 1, 1);
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
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(x),
                           static_cast<const int*>(lidx), static_cast<const float*>(valid),
                           static_cast<const float*>(cg), static_cast<const float*>(kref),
                           static_cast<const int*>(rowptr), static_cast<const int*>(pos),
                           static_cast<float*>(out), S, W, C, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM, int NL, int THREADS>
int launch(const void* x, const void* lidx, const void* valid, const void* cg,
           const void* kref, const void* rowptr, const void* ent,
           void* scratch, void* out, int nb, int S, int W, int C,
           void* stream) {
  if (nb <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  winstiff_kernel<DIM, NL, THREADS>
      <<<nb, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const int*>(lidx),
          static_cast<const float*>(valid), static_cast<const float*>(cg),
          static_cast<const float*>(kref), static_cast<const int*>(rowptr),
          static_cast<const int*>(ent), static_cast<float*>(scratch),
          static_cast<float*>(out), S, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int winstiff_p1_2d(const void* x, const void* lidx,
                              const void* valid, const void* cg,
                              const void* kref, const void* rowptr,
                              const void* ent, void* scratch, void* out,
                              int nb, int S, int W, int C, void* stream) {
  return launch<2, 3, 256>(x, lidx, valid, cg, kref, rowptr, ent, scratch,
                           out, nb, S, W, C, stream);
}

extern "C" int winstiff_p1_3d(const void* x, const void* lidx,
                              const void* valid, const void* cg,
                              const void* kref, const void* rowptr,
                              const void* pos, void* out, int nb, int S, int W,
                              int C, int cl, int threads, int cap, void* stream) {
  return launch_cluster<3, 4>(x, lidx, valid, cg, kref, rowptr, pos, out, nb, S,
                              W, C, cl, threads, cap, stream);
}

// cudaOccupancyMaxActiveClusters of winstiff_p1_3d's launch, into *out.
extern "C" int winstiff_p1_3d_clusters(int nb, int W, int C, int cl, int threads,
                                       int cap, int* out) {
  return launch_cluster<3, 4>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nb, 0, W, C, cl, threads, cap,
                              nullptr, out);
}

extern "C" int winstiff_p2_2d(const void* x, const void* lidx,
                              const void* valid, const void* cg,
                              const void* kref, const void* rowptr,
                              const void* ent, void* scratch, void* out,
                              int nb, int S, int W, int C, void* stream) {
  return launch<2, 6, 256>(x, lidx, valid, cg, kref, rowptr, ent,
                                  scratch, out, nb, S, W, C, stream);
}

extern "C" int winstiff_p2_3d(const void* x, const void* lidx,
                              const void* valid, const void* cg,
                              const void* kref, const void* rowptr,
                              const void* ent, void* scratch, void* out,
                              int nb, int S, int W, int C, void* stream) {
  return launch<3, 10, 1024>(x, lidx, valid, cg, kref, rowptr, ent,
                                    scratch, out, nb, S, W, C, stream);
}
