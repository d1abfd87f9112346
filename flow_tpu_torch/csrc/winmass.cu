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
// output windows are written once. The scatter lists and the scratch,
// which only this design needs, move NL indices and 2 NL floats per cell
// on top.
//
// Design, the same as csrc/winform.cu: one block per window block b, one
// cell per thread in turn. Mref is staged in shared memory; for NL = 10
// (100 floats) it is read through a volatile pointer, so that every use
// reads shared memory: otherwise nvcc hoists the loop-invariant table out
// of the cell loop into registers and spills it. Each thread writes its
// cells' NL local results to a device scratch [nb, C*NL] that the wrapper
// allocates, so any C fits, in 2-D and 3-D. After __syncthreads() the block
// sums them into its window along the host-built scatter lists, in a fixed
// order and with no atomics (scatter_window, csrc/winscatter.cuh).
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

#include <type_traits>

#include "winscatter.cuh"

namespace {

constexpr int kThreads = 512;

template <int NL>
__global__ void __launch_bounds__(kThreads)
winmass_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
               const float* __restrict__ valid, const float* __restrict__ detj,
               const float* __restrict__ mref, const int* __restrict__ rowptr,
               const int* __restrict__ ent, float* __restrict__ scratch,
               float* __restrict__ out, int S, int W, int C) {
  using MrefPtr = std::conditional_t<(NL * NL > 64), const volatile float*,
                                     const float*>;
  __shared__ float mref_s[NL * NL];
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < NL * NL; t += blockDim.x) mref_s[t] = mref[t];

  float* loc_b = scratch + static_cast<long long>(b) * C * NL;
  const float* xw = x + static_cast<long long>(b) * S;
  const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
  const float* valid_b = valid + static_cast<long long>(b) * C;
  const float* detj_b = detj + static_cast<long long>(b) * C;
  const int* rp = rowptr + static_cast<long long>(b) * (W + 1);
  const int* en = ent + static_cast<long long>(b) * C * NL;
  float* out_b = out + static_cast<long long>(b) * W;
  __syncthreads();

  MrefPtr mr = mref_s;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float u[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) u[j] = xw[lidx_b[j * C + c]];
    const float s = detj_b[c] * valid_b[c];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NL; ++j) acc += mr[i * NL + j] * u[j];
      loc_b[c * NL + i] = s * acc;
    }
  }
  __syncthreads();
  scatter_window(loc_b, rp, en, out_b, W);
}

}  // namespace

extern "C" int winmass(const void* x, const void* lidx, const void* valid,
                       const void* detj, const void* mref, const void* rowptr,
                       const void* ent, void* scratch, void* out, int nb, int S,
                       int W, int C, int NL, void* stream) {
  if (nb <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_nl(NL, [&](auto nl) {
    winmass_kernel<decltype(nl)::value>
        <<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(x), static_cast<const int*>(lidx),
            static_cast<const float*>(valid), static_cast<const float*>(detj),
            static_cast<const float*>(mref), static_cast<const int*>(rowptr),
            static_cast<const int*>(ent), static_cast<float*>(scratch),
            static_cast<float*>(out), S, W, C);
    return static_cast<int>(cudaGetLastError());
  });
}
