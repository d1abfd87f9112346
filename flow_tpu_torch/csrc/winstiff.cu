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
// route (Karman in 2-D, the cavity in 3-D), the operator of the large 2-D
// multigrid levels, and the operator of any P2 space a caller builds it on.
//
// Bound: memory bandwidth. Per cell it reads NL indices, DIM^2 geometry
// factors, a mask and NL window values and does ~100 (2-D P1), ~370 (3-D
// P1), ~360 (2-D P2) or ~1,900 (3-D P2) flops. The scatter lists, which
// only this design needs, add one index per (cell, local dof) and one row
// pointer per window dof on top of the function's own bytes; the device
// scratch of winstiff_p1_2d adds two floats per local result.
//
// Design of winstiff_p1_2d (the Karman pressure operator and multigrid
// levels): one block of 256 threads per window block b. The Kref table is
// staged in shared memory. Threads take cells in turn, gather the NL window
// values (the window of one block spans a few thousand contiguous floats,
// so the gathers hit L1/L2), and write the NL local results to a device
// scratch [nb, C*NL] that the wrapper allocates, so any C fits. Then the
// block sums them into its window along the host-built scatter lists, in a
// fixed order and with no atomics (scatter_window, csrc/winscatter.cuh);
// __syncthreads() makes the block's global writes visible to the block
// before the sums.
//
// Design of winstiff_p1_3d, winstiff_p2_2d and winstiff_p2_3d: the
// thread-block-cluster walk of csrc/wincluster.cuh, which winmass.cu and
// winform.cu share. The cluster's shared memory (distributed shared memory,
// DSMEM) holds what the TPU kernel kept in VMEM: every local result of the
// window block, stored at its position in the scatter lists (the host-built
// inverse of the lists, window.py::scatter_positions), so no device scratch
// is written or read back and no list is gathered. Each row then sums
// contiguous shared memory in list order, the order of scatter_window, so
// the windows are those of the scratch design bitwise. A layout whose
// entries exceed the cluster's stage runs in passes over whole rows. Each
// cell's results are computed in the scratch design's order: for each
// (k, l) the Kref row's dot with the window values in j order, then the
// (k, l) terms in order, then the mask.
// winstiff_p1_3d (the cavity's pressure operator: nb = 68, C = 23,958, W =
// 20,480 at N=64) runs clusters of CL blocks of at most 512 threads a
// window block (attic/winkernel.CLUSTER_3D), so that 68 window blocks spread
// over the 132 SMs, and reads its 144-float Kref table from shared memory,
// a row of four as one 16-byte load (kref_row_dot).
// The P2 variants (winstiff_p2_kernel) take K4a's and K5's launch rule
// (attic/winkernel.window_plan): one block of 1,024 threads a window block
// at the P2 Poisson layouts (nb = 68 tets at NL = 10, 121 triangle blocks
// at NL = 6). Their cell phase leads (32 of 54 us at NL = 10 on an H100
// with the table in shared memory, PERF.md), and its 900 (3-D) or 144 (2-D)
// Kref values a cell cost 270 or 48 shared-memory loads even as 16-byte
// broadcasts, and a spill. So the table is a kernel parameter (__grid_constant__, 3,600 or
// 576 bytes of the 4 KB parameter space): with every index known at compile
// time, each multiply-add reads its Kref value straight from the constant
// bank, and no load or register holds the table.
//
// Plain C interface (loaded with ctypes): the fixed arguments of a launch
// (the tables, the layout and, for the cluster variants, the launch) come
// in one WinstiffArgs struct that the caller keeps, so that a call passes
// four or five arguments; each entry launches on the given stream and
// returns the cudaError_t of the launch (0 on success); the query entries
// write how many clusters of a launch the card holds at once.
#include <cuda_runtime.h>

#include <cstring>

#include "wincluster.cuh"
#include "winscatter.cuh"

// The fixed arguments of a launch, in the layout of the ctypes Structure
// attic/winkernel.py::_WinstiffArgs.
struct WinstiffArgs {
  const int* lidx;         // [nb, NL, C]
  const float* valid;      // [nb, C]
  const float* cg;         // [nb, DIM*DIM, C]
  const float* kref;       // [DIM*DIM*NL, NL] on the device (the P1 variants)
  const float* kref_host;  // the same in host memory (the P2 variants)
  const int* rowptr;       // [nb, W + 1]
  const int* lists;        // ent [nb, C*NL] (winstiff_p1_2d) or pos [nb, NL*C]
  int nb, S, W, C;
  int clusters, cl, threads, cap;  // the cluster variants' launch
};

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
        const float* kr = kref_s + (kl * NL + i) * NL;
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

// At most 512 threads a block and 40 registers a thread (__launch_bounds__
// (512, 3)), so that three blocks share an SM: the card then holds 45 of the
// cavity's 68 clusters at once instead of 30 (cudaOccupancyMaxActiveClusters,
// PERF.md).
constexpr int kClusterThreads = 512;

// The cluster variant (see the header): the walk of csrc/wincluster.cuh,
// each cell's NL results computed as in winstiff_kernel. pos [nb, NL, C]:
// the position in its window row's scatter list of local result (c, i), -1
// for a padding cell.
template <int DIM, int NL>
__global__ void __launch_bounds__(kClusterThreads, 3)
winstiff_cluster_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
                        const float* __restrict__ valid, const float* __restrict__ cg,
                        const float* __restrict__ kref, const int* __restrict__ rowptr,
                        const int* __restrict__ pos, float* __restrict__ out, int nb,
                        int S, int W, int C, int cap) {
  constexpr int D2 = DIM * DIM;
  constexpr int KT = D2 * NL * NL;
  __shared__ __align__(16) float kref_s[KT];  // [D2*NL, NL]
  for (int t = threadIdx.x; t < KT; t += blockDim.x) kref_s[t] = kref[t];
  wincluster::stage_and_sum<NL>(
      rowptr, pos, out, nb, W, C, cap, [&](int b, int c) {
        const float* xw = x + static_cast<long long>(b) * S;
        const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
        const float* cg_b = cg + static_cast<long long>(b) * D2 * C;
        float u[NL];
#pragma unroll
        for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
        float g[D2];
#pragma unroll
        for (int kl = 0; kl < D2; ++kl) g[kl] = cg_b[kl * C + c];
        const float v = valid[static_cast<long long>(b) * C + c];
        return [=](int i) {
          float s = 0.f;
#pragma unroll
          for (int kl = 0; kl < D2; ++kl)
            s += g[kl] * kref_row_dot<NL>(kref_s + (kl * NL + i) * NL, u);
          return s * v;
        };
      });
}

// The P2 Kref table [DIM*DIM*NL, NL], passed by value as a kernel parameter.
template <int N>
struct KrefTable {
  float v[N];
};

constexpr int kP2Threads = 1024;

// The P2 variants (see the header): the walk of csrc/wincluster.cuh, at
// most 1,024 threads a block, Kref read from the parameter space.
template <int DIM, int NL>
__global__ void __launch_bounds__(kP2Threads)
winstiff_p2_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
                   const float* __restrict__ valid, const float* __restrict__ cg,
                   const __grid_constant__ KrefTable<DIM * DIM * NL * NL> kref,
                   const int* __restrict__ rowptr, const int* __restrict__ pos,
                   float* __restrict__ out, int nb, int S, int W, int C, int cap) {
  constexpr int D2 = DIM * DIM;
  wincluster::stage_and_sum<NL>(
      rowptr, pos, out, nb, W, C, cap, [&](int b, int c) {
        const float* xw = x + static_cast<long long>(b) * S;
        const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
        const float* cg_b = cg + static_cast<long long>(b) * D2 * C;
        float u[NL];
#pragma unroll
        for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
        float g[D2];
#pragma unroll
        for (int kl = 0; kl < D2; ++kl) g[kl] = cg_b[kl * C + c];
        const float v = valid[static_cast<long long>(b) * C + c];
        // kref by reference: a copy would move the table into registers
        return [=, &kref](int i) {
          float s = 0.f;
#pragma unroll
          for (int kl = 0; kl < D2; ++kl) {
            const float* kr = kref.v + (kl * NL + i) * NL;
            float d = 0.f;
#pragma unroll
            for (int j = 0; j < NL; ++j) d += kr[j] * u[j];
            s += g[kl] * d;
          }
          return s * v;
        };
      });
}

// The launch of winstiff_p1_3d (wincluster::launch) with the arguments of
// `a`; with `max_clusters` set, instead of launching, the number of such
// clusters that the card holds at once.
int launch_p1_3d(const WinstiffArgs* a, const void* x, void* out, void* stream,
                 int* max_clusters = nullptr) {
  if (a == nullptr || a->nb <= 0 || a->C <= 0 || a->W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return wincluster::launch(
      winstiff_cluster_kernel<3, 4>, a->clusters, a->cl, a->threads, kClusterThreads,
      a->cap, stream, max_clusters, static_cast<const float*>(x), a->lidx, a->valid,
      a->cg, a->kref, a->rowptr, a->lists, static_cast<float*>(out), a->nb, a->S, a->W,
      a->C, a->cap);
}

// The launch of a P2 variant, the same way; the Kref table is copied from
// a->kref_host into the launch's parameters (not read for the query).
template <int DIM, int NL>
int launch_p2(const WinstiffArgs* a, const void* x, void* out, void* stream,
              int* max_clusters = nullptr) {
  if (a == nullptr || a->nb <= 0 || a->C <= 0 || a->W <= 0 ||
      (max_clusters == nullptr && a->kref_host == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  KrefTable<DIM * DIM * NL * NL> kref = {};
  if (max_clusters == nullptr) std::memcpy(kref.v, a->kref_host, sizeof(kref.v));
  return wincluster::launch(
      winstiff_p2_kernel<DIM, NL>, a->clusters, a->cl, a->threads, kP2Threads, a->cap,
      stream, max_clusters, static_cast<const float*>(x), a->lidx, a->valid, a->cg, kref,
      a->rowptr, a->lists, static_cast<float*>(out), a->nb, a->S, a->W, a->C, a->cap);
}

// The query arguments of a cluster launch of clusters of `cl` blocks of
// `threads` threads staging `cap` values each.
WinstiffArgs query_args(int cl, int threads, int cap) {
  WinstiffArgs a = {};
  a.nb = a.W = a.C = a.clusters = 1;
  a.cl = cl;
  a.threads = threads;
  a.cap = cap;
  return a;
}

}  // namespace

extern "C" int winstiff_p1_2d(const WinstiffArgs* a, const void* x, void* scratch,
                              void* out, void* stream) {
  if (a == nullptr || a->nb <= 0 || a->C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  winstiff_kernel<2, 3, 256><<<a->nb, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), a->lidx, a->valid, a->cg, a->kref, a->rowptr,
      a->lists, static_cast<float*>(scratch), static_cast<float*>(out), a->S, a->W, a->C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int winstiff_p1_3d(const WinstiffArgs* a, const void* x, void* out,
                              void* stream) {
  return launch_p1_3d(a, x, out, stream);
}

// cudaOccupancyMaxActiveClusters of a cluster launch, into *out; the same
// for the P2 variants below.
extern "C" int winstiff_p1_3d_clusters(int cl, int threads, int cap, int* out) {
  const WinstiffArgs a = query_args(cl, threads, cap);
  return launch_p1_3d(&a, nullptr, nullptr, nullptr, out);
}

extern "C" int winstiff_p2_2d(const WinstiffArgs* a, const void* x, void* out,
                              void* stream) {
  return launch_p2<2, 6>(a, x, out, stream);
}

extern "C" int winstiff_p2_2d_clusters(int cl, int threads, int cap, int* out) {
  const WinstiffArgs a = query_args(cl, threads, cap);
  return launch_p2<2, 6>(&a, nullptr, nullptr, nullptr, out);
}

extern "C" int winstiff_p2_3d(const WinstiffArgs* a, const void* x, void* out,
                              void* stream) {
  return launch_p2<3, 10>(a, x, out, stream);
}

extern "C" int winstiff_p2_3d_clusters(int cl, int threads, int cap, int* out) {
  const WinstiffArgs a = query_args(cl, threads, cap);
  return launch_p2<3, 10>(&a, nullptr, nullptr, nullptr, out);
}
