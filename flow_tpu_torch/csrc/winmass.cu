// Window-blocked consistent scalar mass apply on a P1 or P2 space, triangles
// or tets (NL = 3, 6, 4, 10 local dofs):
//
//   out[b, w] = sum over the real cells c of block b and local dofs i with
//               lidx[b, i, c] == w of
//               detj[b, c] * valid[b, c]
//               * sum_j Mref[i, j] * x[b*S + lidx[b, j, c]]
//
// x is the permuted, zero-padded input [nb*S + W]; out holds one window
// [nb, W] per block, which the caller overlap-adds (attic/window.py).
//
// Replaces flow_tpu/attic/winkernel.py::WindowMassOperator._pallas (K4a),
// whose TPU kernel DMAs the window into VMEM and gathers and scatters with
// one-hot MXU contractions. It is the mass right-hand side of implicit
// steps on the window layout.
//
// Bound: memory bandwidth. Per cell it reads NL indices, detJ, a mask and
// NL window values (the window of a block spans a few thousand contiguous
// floats, so the gathers hit L1/L2) and does 2 NL^2 + 2 NL flops; the
// output windows are written once. The lists' inverse and row pointers,
// which only this design reads, move NL indices per cell and one index per
// window dof on top.
//
// Design, the same as csrc/winform.cu: the thread-block-cluster walk of
// csrc/wincluster.cuh (shared with winstiff.cu's winstiff_p1_3d). A window
// block's cells are split over a cluster of CL blocks, the least whose
// shared memory stages the window block's results in one pass, with 1,024
// threads a block where the blocks are no more than the SMs, else 512
// (attic/winkernel.window_plan; at NL = 10 one block of 1,024 threads a
// window block beat clusters that spread it over all the SMs, PERF.md). Each cell's NL local
// results are stored at their scatter-list positions in the shared memory
// of the cluster, each window row then sums them in list order: no device
// scratch, no read of the lists, and the sums of scatter_window
// (winscatter.cuh), bitwise. Mref is staged in shared memory; for NL = 10
// (100 floats) it is read through a volatile pointer, so that every use
// reads shared memory: otherwise nvcc hoists the loop-invariant table out
// of the cell loop into registers and spills it.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success); the
// query entry writes how many clusters of a launch the card holds at once.
#include <cuda_runtime.h>

#include <type_traits>

#include "wincluster.cuh"
#include "winscatter.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int NL>
__global__ void __launch_bounds__(kMaxThreads)
winmass_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
               const float* __restrict__ valid, const float* __restrict__ detj,
               const float* __restrict__ mref, const int* __restrict__ rowptr,
               const int* __restrict__ pos, float* __restrict__ out, int nb, int S,
               int W, int C, int cap) {
  using MrefPtr = std::conditional_t<(NL * NL > 64), const volatile float*,
                                     const float*>;
  __shared__ float mref_s[NL * NL];
  for (int t = threadIdx.x; t < NL * NL; t += blockDim.x) mref_s[t] = mref[t];
  MrefPtr mr = mref_s;
  wincluster::stage_and_sum<NL>(
      rowptr, pos, out, nb, W, C, cap, [&](int b, int c) {
        const float* xw = x + static_cast<long long>(b) * S;
        const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
        const long long bc = static_cast<long long>(b) * C + c;
        float u[NL];
#pragma unroll
        for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
        const float s = detj[bc] * valid[bc];
        return [=](int i) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < NL; ++j) acc += mr[i * NL + j] * u[j];
          return s * acc;
        };
      });
}

// The launch (wincluster::launch) at NL; with `max_clusters` set, instead
// of launching, the number of such clusters the card holds at once.
int launch(const void* x, const void* lidx, const void* valid, const void* detj,
           const void* mref, const void* rowptr, const void* pos, void* out, int nb,
           int S, int W, int C, int NL, int clusters, int cl, int threads, int cap,
           void* stream, int* max_clusters = nullptr) {
  if (nb <= 0 || C <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_nl(NL, [&](auto nl) {
    return wincluster::launch(
        winmass_kernel<decltype(nl)::value>, clusters, cl, threads, kMaxThreads, cap,
        stream, max_clusters, static_cast<const float*>(x),
        static_cast<const int*>(lidx), static_cast<const float*>(valid),
        static_cast<const float*>(detj), static_cast<const float*>(mref),
        static_cast<const int*>(rowptr), static_cast<const int*>(pos),
        static_cast<float*>(out), nb, S, W, C, cap);
  });
}

}  // namespace

extern "C" int winmass(const void* x, const void* lidx, const void* valid,
                       const void* detj, const void* mref, const void* rowptr,
                       const void* pos, void* out, int nb, int S, int W, int C, int NL,
                       int clusters, int cl, int threads, int cap, void* stream) {
  return launch(x, lidx, valid, detj, mref, rowptr, pos, out, nb, S, W, C, NL, clusters,
                cl, threads, cap, stream);
}

// cudaOccupancyMaxActiveClusters of winmass's launch at NL, into *out.
extern "C" int winmass_clusters(int NL, int cl, int threads, int cap, int* out) {
  return launch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                1, 0, 1, 1, NL, 1, cl, threads, cap, nullptr, out);
}
