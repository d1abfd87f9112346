// Window-blocked apply of a per-cell element matrix on a scalar P1 or P2
// space, triangles or tets (NL = 3, 6, 4, 10 local dofs):
//
//   out[b, w] = sum over the real cells c of block b and local dofs i with
//               lidx[b, i, c] == w of
//               valid[b, c] * sum_j A[b, i*NL + j, c] * x[b*S + lidx[b, j, c]]
//
// A is the blocked element matrix [nb, NL*NL, C] of any scalar bilinear form
// compiled by fem/formlang.py (attic/winform.py blocks it); x is the
// permuted, zero-padded input [nb*S + W]; out holds one window [nb, W] per
// block, which the caller overlap-adds (attic/window.py).
//
// Replaces flow_tpu/attic/winform.py::WindowElementOperator._pallas (K5),
// whose TPU kernel DMAs the window into VMEM, applies the element-matrix
// rows as lane-vector FMAs and gathers and scatters with one-hot MXU
// contractions. It is the matvec of coefficient-bearing forms (convection-
// diffusion, SUPG-stabilised heat) in implicit steps.
//
// Bound: memory bandwidth, dominated by the element matrix: NL^2 floats per
// cell (36 for P2 triangles, 100 for P2 tets) read once per apply, against
// 2 NL^2 flops.
//
// Design, the same as csrc/winmass.cu: the thread-block-cluster walk of
// csrc/wincluster.cuh (shared with winstiff.cu's winstiff_p1_3d). A window
// block's cells are split over a cluster of CL blocks, the least whose
// shared memory stages the window block's results in one pass, with 1,024
// threads a block where the blocks are no more than the SMs, else 512
// (attic/winkernel.window_plan; at NL = 10 one block of 1,024 threads a
// window block beat clusters that spread it over all the SMs, PERF.md).
// The threads of a warp take neighbouring cells, so each row
// A[b, i*NL + j, :] is read coalesced across the cells, and a cell loads
// its whole matrix before the walk asks for its first result. Each cell's NL local results are stored at their
// scatter-list positions in the shared memory of the cluster, each window
// row then sums them in list order: no device scratch, no read of the
// lists, and the sums of scatter_window (winscatter.cuh), bitwise.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success); the
// query entry writes how many clusters of a launch the card holds at once.
#include <cuda_runtime.h>

#include "wincluster.cuh"
#include "winscatter.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int NL>
__global__ void __launch_bounds__(kMaxThreads)
winform_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
               const float* __restrict__ valid, const float* __restrict__ aloc,
               const int* __restrict__ rowptr, const int* __restrict__ pos,
               float* __restrict__ out, int nb, int S, int W, int C, int cap) {
  wincluster::stage_and_sum<NL>(
      rowptr, pos, out, nb, W, C, cap, [&](int b, int c) {
        const float* xw = x + static_cast<long long>(b) * S;
        const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
        const float* a_b = aloc + static_cast<long long>(b) * NL * NL * C;
        float u[NL];
#pragma unroll
        for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
        const float v = valid[static_cast<long long>(b) * C + c];
        // every result here, so that the matrix rows are all asked for
        // before the first is used
        float loc[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          float acc = 0.f;
          // 32-bit offsets: the wrapper keeps the whole matrix below 2^31
          // floats (64-bit ones cost NL = 10 a spill)
#pragma unroll
          for (int j = 0; j < NL; ++j) acc += a_b[(i * NL + j) * C + c] * u[j];
          loc[i] = acc * v;
        }
        return [=](int i) { return loc[i]; };
      });
}

// The launch (wincluster::launch) at NL; with `max_clusters` set, instead
// of launching, the number of such clusters the card holds at once.
int launch(const void* x, const void* lidx, const void* valid, const void* aloc,
           const void* rowptr, const void* pos, void* out, int nb, int S, int W, int C,
           int NL, int clusters, int cl, int threads, int cap, void* stream,
           int* max_clusters = nullptr) {
  if (nb <= 0 || C <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_nl(NL, [&](auto nl) {
    return wincluster::launch(
        winform_kernel<decltype(nl)::value>, clusters, cl, threads, kMaxThreads, cap,
        stream, max_clusters, static_cast<const float*>(x),
        static_cast<const int*>(lidx), static_cast<const float*>(valid),
        static_cast<const float*>(aloc), static_cast<const int*>(rowptr),
        static_cast<const int*>(pos), static_cast<float*>(out), nb, S, W, C, cap);
  });
}

}  // namespace

extern "C" int winform(const void* x, const void* lidx, const void* valid,
                       const void* aloc, const void* rowptr, const void* pos, void* out,
                       int nb, int S, int W, int C, int NL, int clusters, int cl,
                       int threads, int cap, void* stream) {
  return launch(x, lidx, valid, aloc, rowptr, pos, out, nb, S, W, C, NL, clusters, cl,
                threads, cap, stream);
}

// cudaOccupancyMaxActiveClusters of winform's launch at NL, into *out.
extern "C" int winform_clusters(int NL, int cl, int threads, int cap, int* out) {
  return launch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 0, 1, 1,
                NL, 1, cl, threads, cap, nullptr, out);
}
