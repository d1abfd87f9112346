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
// Design, the same as csrc/winmass.cu: one block per window block b, one
// cell per thread in turn; the threads of a warp take neighbouring cells, so
// each row A[b, i*NL + j, :] is read coalesced across the cells. Each thread
// writes its cells' NL local results to a device scratch [nb, C*NL] that the
// wrapper allocates, so any C fits, in 2-D and 3-D. After __syncthreads()
// the block sums them into its window along the host-built scatter lists,
// in a fixed order and with no atomics (scatter_window,
// csrc/winscatter.cuh).
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

#include "winscatter.cuh"

namespace {

constexpr int kThreads = 512;

template <int NL>
__global__ void __launch_bounds__(kThreads)
winform_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
               const float* __restrict__ valid, const float* __restrict__ aloc,
               const int* __restrict__ rowptr, const int* __restrict__ ent,
               float* __restrict__ scratch, float* __restrict__ out, int S,
               int W, int C) {
  const int b = blockIdx.x;
  float* loc_b = scratch + static_cast<long long>(b) * C * NL;
  const float* xw = x + static_cast<long long>(b) * S;
  const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
  const float* valid_b = valid + static_cast<long long>(b) * C;
  const float* a_b = aloc + static_cast<long long>(b) * NL * NL * C;
  const int* rp = rowptr + static_cast<long long>(b) * (W + 1);
  const int* en = ent + static_cast<long long>(b) * C * NL;
  float* out_b = out + static_cast<long long>(b) * W;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float u[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
    const float v = valid_b[c];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float acc = 0.f;
      // 32-bit offsets: the wrapper keeps the whole matrix below 2^31
      // floats (64-bit ones cost NL = 10 a spill)
#pragma unroll
      for (int j = 0; j < NL; ++j) acc += a_b[(i * NL + j) * C + c] * u[j];
      loc_b[c * NL + i] = acc * v;
    }
  }
  __syncthreads();
  scatter_window(loc_b, rp, en, out_b, W);
}

}  // namespace

extern "C" int winform(const void* x, const void* lidx, const void* valid,
                       const void* aloc, const void* rowptr, const void* ent,
                       void* scratch, void* out, int nb, int S, int W, int C,
                       int NL, void* stream) {
  if (nb <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_nl(NL, [&](auto nl) {
    winform_kernel<decltype(nl)::value>
        <<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(x), static_cast<const int*>(lidx),
            static_cast<const float*>(valid), static_cast<const float*>(aloc),
            static_cast<const int*>(rowptr), static_cast<const int*>(ent),
            static_cast<float*>(scratch), static_cast<float*>(out), S, W, C);
    return static_cast<int>(cudaGetLastError());
  });
}
