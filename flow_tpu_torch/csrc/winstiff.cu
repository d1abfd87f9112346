// Window-blocked scalar stiffness apply on a 2-D P1 space (DIM=2, NL=3):
//
//   out[b, w] = sum over the real cells c of block b and local dofs i with
//               lidx[b, i, c] == w of
//               valid[b, c] * sum_{k,l} Cg[b, 2k+l, c]
//                             * sum_j Kref[k, l, i, j] * x[b*S + lidx[b, j, c]]
//
// x is the permuted, zero-padded input [nb*S + W]; out holds one window
// [nb, W] per block, which the caller overlap-adds (attic/window.py).
//
// Replaces flow_tpu/attic/winkernel.py::WindowStiffnessOperator._pallas
// (K4b), whose TPU kernel DMAs the window into VMEM and gathers and scatters
// with one-hot MXU contractions. It is the pressure operator of the Karman
// window route and the operator of the large multigrid levels.
//
// Bound: memory bandwidth. Per cell it reads 3 indices, 4 geometry factors,
// a mask and 3 window values and does ~40 flops. The scatter lists, which
// only this design needs, add one index per (cell, local dof) and one row
// pointer per window dof on top of the function's own bytes.
//
// Design: one block per window block b. The 36-entry Kref table is staged
// in shared memory. Threads take cells in turn, gather the 3 window values
// (the window of one block spans a few thousand contiguous floats, so the
// gathers hit L1/L2), and write the 3 local results to shared memory. Then
// each thread takes window dofs in turn and sums the local results of its
// dof along the block's scatter list (rowptr, ent), built on the host in
// ascending (cell, local dof) order: a fixed order, so the result is
// bitwise repeatable (no atomics). All C cells of a block are in shared
// memory at once (12 B each, with S <= 4096 far below the opt-in limit of
// ~19,000 cells); the launcher refuses a layout whose C does not fit.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int DIM, int NL>
__global__ void __launch_bounds__(kThreads)
winstiff_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
                const float* __restrict__ valid, const float* __restrict__ cg,
                const float* __restrict__ kref, const int* __restrict__ rowptr,
                const int* __restrict__ ent, float* __restrict__ out, int S,
                int W, int C) {
  constexpr int D2 = DIM * DIM;
  constexpr int KT = D2 * NL * NL;
  extern __shared__ float smem[];
  float* kref_s = smem;       // [D2*NL, NL]
  float* loc_s = smem + KT;   // [C, NL]

  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < KT; t += blockDim.x) kref_s[t] = kref[t];

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
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float acc = 0.f;
    for (int p = rp[w]; p < rp[w + 1]; ++p) acc += loc_s[en[p]];
    out_b[w] = acc;
  }
}

// Shared memory of a block: the Kref table plus the local results of its C
// cells. A layout that needs more than the device grants one block is
// refused with cudaErrorInvalidValue.
template <int DIM, int NL>
int launch(const void* x, const void* lidx, const void* valid, const void* cg,
           const void* kref, const void* rowptr, const void* ent, void* out,
           int nb, int S, int W, int C, void* stream) {
  if (nb <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int table = DIM * DIM * NL * NL * static_cast<int>(sizeof(float));
  const int per_cell = NL * static_cast<int>(sizeof(float));
  if (C > (optin - table) / per_cell) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = table + C * per_cell;
  err = cudaFuncSetAttribute(winstiff_kernel<DIM, NL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  winstiff_kernel<DIM, NL><<<nb, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(lidx),
      static_cast<const float*>(valid), static_cast<const float*>(cg),
      static_cast<const float*>(kref), static_cast<const int*>(rowptr),
      static_cast<const int*>(ent), static_cast<float*>(out), S, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int winstiff_p1_2d(const void* x, const void* lidx,
                              const void* valid, const void* cg,
                              const void* kref, const void* rowptr,
                              const void* ent, void* out, int nb, int S, int W,
                              int C, void* stream) {
  return launch<2, 3>(x, lidx, valid, cg, kref, rowptr, ent, out, nb, S, W, C,
                      stream);
}
