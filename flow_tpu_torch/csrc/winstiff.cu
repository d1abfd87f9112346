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
// P1), ~360 (2-D P2) or ~1,900 (3-D P2) flops. The scatter lists and the
// scratch, which only this design needs, add one index per (cell, local
// dof), one row pointer per window dof and two floats per local result on
// top of the function's own bytes.
//
// Design: one block per window block b. The Kref table is staged in shared
// memory. Threads take cells in turn, gather the NL window values (the
// window of one block spans a few thousand contiguous floats, so the
// gathers hit L1/L2), and write the NL local results. Then the block sums
// them into its window along the host-built scatter lists, in a fixed order
// and with no atomics (scatter_window, csrc/winscatter.cuh, as in
// winmass.cu and winform.cu). The local results live in a device scratch
// [nb, C*NL] that the wrapper allocates, so any C fits (C = 23,958 at the
// cavity's N=64, 383 KB a block); __syncthreads() makes the block's global
// writes visible to the block before the sums. The 3-D layouts have few
// blocks (68 at N=64), so a 3-D block has 1,024 threads; a 2-D block 256.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
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
                              const void* ent, void* scratch, void* out,
                              int nb, int S, int W, int C, void* stream) {
  return launch<3, 4, 1024>(x, lidx, valid, cg, kref, rowptr, ent,
                                   scratch, out, nb, S, W, C, stream);
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
