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
// (scatter_window, csrc/winscatter.cuh).
// The local results live in a device scratch [nb, C*NL] that the wrapper
// allocates, so any C fits; __syncthreads() makes the block's global writes
// visible to the block before the sums. A 3-D block has 1,024 threads, a
// 2-D block 256.
//
// Design of winstiff_p1_3d (the cavity's pressure operator: nb = 68, C =
// 23,958, W = 20,480 at N=64): the thread-block-cluster walk of
// csrc/wincluster.cuh, which winmass.cu and winform.cu share, with clusters
// of CL blocks a window block (attic/winkernel.CLUSTER_3D), so that 68
// window blocks spread over the 132 SMs. The cluster's shared memory
// (distributed shared memory, DSMEM) holds what the TPU kernel kept in
// VMEM: every local result of the window block, stored at its position in
// the scatter lists (the host-built inverse of the lists,
// window.py::scatter_positions), so no device scratch is written or read
// back and no list is gathered. Each row then sums contiguous shared
// memory in list order, the order of the other variants' scatter_window.
// A layout whose entries exceed the cluster's stage runs in passes over
// whole rows.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

#include <type_traits>

#include "wincluster.cuh"
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

// The launch of the cluster variant (wincluster::launch); with
// `max_clusters` set, instead of launching, the number of such clusters
// that the card holds at once.
int launch_cluster(const void* x, const void* lidx, const void* valid, const void* cg,
                   const void* kref, const void* rowptr, const void* pos, void* out,
                   int nb, int S, int W, int C, int clusters, int cl, int threads,
                   int cap, void* stream, int* max_clusters = nullptr) {
  if (nb <= 0 || C <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return wincluster::launch(
      winstiff_cluster_kernel<3, 4>, clusters, cl, threads, kClusterThreads, cap, stream,
      max_clusters, static_cast<const float*>(x), static_cast<const int*>(lidx),
      static_cast<const float*>(valid), static_cast<const float*>(cg),
      static_cast<const float*>(kref), static_cast<const int*>(rowptr),
      static_cast<const int*>(pos), static_cast<float*>(out), nb, S, W, C, cap);
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
                              int C, int clusters, int cl, int threads, int cap,
                              void* stream) {
  return launch_cluster(x, lidx, valid, cg, kref, rowptr, pos, out, nb, S, W, C,
                        clusters, cl, threads, cap, stream);
}

// cudaOccupancyMaxActiveClusters of winstiff_p1_3d's launch, into *out.
extern "C" int winstiff_p1_3d_clusters(int cl, int threads, int cap, int* out) {
  return launch_cluster(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, 1, 0, 1, 1, 1, cl, threads, cap, nullptr, out);
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
