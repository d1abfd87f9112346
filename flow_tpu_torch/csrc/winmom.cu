// Window-blocked momentum operator on a 2-D vector-P2 space (DIM=2, NL=6,
// NQ=7), lagged or Newton:
//
//   A v = mass_w M v + s_rho c(T; v) + s_mu sym_grad(v)          (lagged)
//   J v = A v + s_rho c(v; x)                                   (Newton)
//
// per component m and window dof w of block b:
//   out[m, b, w] = sum over the real cells c of block b and local dofs i
//                  with lidx[b, i, c] == w of loc[m][i](c),
// with loc the element contributions of the mass, the skew convection
// 0.5 [(T.grad v) phi_i - (T.grad phi_i) v] with the transport T frozen at
// the quadrature points (Tq), the stress form 2 eps(v):eps(phi_i), and in
// Newton mode the reaction term 0.5 [(v.grad x)_m phi_i - (v.grad phi_i)
// x_m] about the state x, whose values are the transport (Tq: the Newton
// tangent transports with x itself) and whose physical gradients are gu
// [nb, DIM*DIM*NQ, C] (row (d*DIM+m)*NQ+q holds d_d x_m). The input is the
// permuted, zero-padded components x [DIM, n_pad]; out holds one window
// [DIM, nb, W] per block, which the caller overlap-adds.
//
// Replaces flow_tpu/attic/winmom.py::momentum_tables_apply with its kernels
// _mom_kernel_2d and _mom_newton_kernel_2d (K3, lagged and Newton 2-D),
// whose TPU kernels DMA both component windows into VMEM and gather and
// scatter with one-hot MXU contractions. The arithmetic per cell is the
// same, term by term (_mom_body, winmom.py:47).
//
// Bound: memory bandwidth and operations about equally. Per cell the lagged
// apply reads 6 indices, detJ, 4 G, 4 C, a mask, 14 transport values and
// 12 window values (~47 values) and does ~3,600 flops; the Newton apply
// reads 28 gradient values more and does ~900 flops more. Both write 12
// local results to the scratch and read them back. The scatter lists and
// the scratch, which only this design needs, add one index per (cell, local
// dof), one row pointer per window dof and two floats per local result on
// top of the function's own bytes.
//
// Design: one block per window block b. The small tables (phi, dphi, w,
// Mref, Kref: 313 floats) and the three weights are staged in shared
// memory and read through volatile pointers. Threads take cells in turn, gather the 12 window values through
// L1/L2 (a block's window is a few thousand contiguous floats per
// component), and write the 12 local results to a device scratch
// [nb, DIM, C*NL] that the wrapper allocates, as the 3-D kernel
// (csrc/winmom3d.cu) does, so a block of any C cells fits. After
// __syncthreads(), which makes the block's global writes visible to the
// block, each thread takes window dofs in turn and sums, per component, the
// local results of its dof along the block's scatter list (rowptr, ent),
// built on the host in ascending (cell, local dof) order: a fixed order, so
// the result is bitwise repeatable (no atomics). The Newton variant is the same kernel with the reaction term added
// after the lagged terms (template parameter NEWTON; the lagged
// instantiation is unchanged). It needs the direction values of both
// components at every quadrature point, so it loops over quadrature points
// outside the components and reads gu at each point, instead of holding the
// 28 gradients in registers.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int DIM, int NL, int NQ>
struct Tables {
  static constexpr int kPhi = 0;                        // [NQ, NL]
  static constexpr int kDphi = kPhi + NQ * NL;          // [DIM*NQ, NL]
  static constexpr int kW = kDphi + DIM * NQ * NL;      // [NQ]
  static constexpr int kMref = kW + NQ;                 // [NL, NL]
  static constexpr int kKref = kMref + NL * NL;         // [DIM*DIM*NL, NL]
  static constexpr int kSize = kKref + DIM * DIM * NL * NL;
  static constexpr int kSmem = kSize + 3;               // + mass_w, s_rho, s_mu
};

template <int DIM, int NL, int NQ, bool NEWTON>
__global__ void __launch_bounds__(kThreads)
winmom_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
              const float* __restrict__ valid, const float* __restrict__ detj,
              const float* __restrict__ g4, const float* __restrict__ cg4,
              const float* __restrict__ tq, const float* __restrict__ gu,
              const float* __restrict__ tabs,
              const float* __restrict__ scal, const int* __restrict__ rowptr,
              const int* __restrict__ ent, float* __restrict__ scratch,
              float* __restrict__ out, int nb, int S, int W, int C, int n_pad) {
  using T = Tables<DIM, NL, NQ>;
  constexpr int D2 = DIM * DIM;
  __shared__ float tab[T::kSmem];         // T::kSize tables, then 3 weights

  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < T::kSize; t += blockDim.x) tab[t] = tabs[t];
  for (int t = threadIdx.x; t < 3; t += blockDim.x) tab[T::kSize + t] = scal[t];

  // volatile: every use reads shared memory. With the local results in
  // global memory nothing in the cell loop can alias the tables, and nvcc
  // then hoists their loop-invariant reads into registers and spills
  // (~1 KB a thread; scripts/torch_ptxas_report.py), as in winmom3d.cu
  const volatile float* phi = tab + T::kPhi;
  const volatile float* dphi = tab + T::kDphi;
  const volatile float* wq = tab + T::kW;
  const volatile float* mref = tab + T::kMref;
  const volatile float* kref = tab + T::kKref;

  const long long boff = static_cast<long long>(b) * S;
  const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
  const float* valid_b = valid + static_cast<long long>(b) * C;
  const float* detj_b = detj + static_cast<long long>(b) * C;
  const float* g_b = g4 + static_cast<long long>(b) * D2 * C;
  const float* cg_b = cg4 + static_cast<long long>(b) * D2 * C;
  const float* tq_b = tq + static_cast<long long>(b) * DIM * NQ * C;
  const int* rp = rowptr + static_cast<long long>(b) * (W + 1);
  const int* en = ent + static_cast<long long>(b) * C * NL;
  float* loc_g = scratch + static_cast<long long>(b) * DIM * C * NL;  // [DIM, C, NL]
  __syncthreads();
  const float mass_w = tab[T::kSize];
  const float s_rho = tab[T::kSize + 1];
  const float s_mu = tab[T::kSize + 2];

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    int li[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) li[j] = lidx_b[j * C + c];
    float U[DIM][NL];
#pragma unroll
    for (int m = 0; m < DIM; ++m)
#pragma unroll
      for (int j = 0; j < NL; ++j)
        U[m][j] = x[static_cast<long long>(m) * n_pad + boff + li[j]];
    const float dj = detj_b[c];
    float G[DIM][DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
      for (int k = 0; k < DIM; ++k) G[d][k] = g_b[(DIM * d + k) * C + c];
    float Cg[D2];
#pragma unroll
    for (int kl = 0; kl < D2; ++kl) Cg[kl] = cg_b[kl * C + c];
    float Tq[DIM][NQ];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
      for (int q = 0; q < NQ; ++q) Tq[d][q] = tq_b[(d * NQ + q) * C + c];
    float wd[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) wd[q] = wq[q] * dj;

    float loc[DIM][NL];
#pragma unroll
    for (int m = 0; m < DIM; ++m) {
      const float* u = U[m];
      float vq[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += phi[q * NL + j] * u[j];
        vq[q] = s;
      }
      // reference gradients, then physical, at the quadrature points
      float gv[DIM][NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float rg[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < NL; ++j) s += dphi[(k * NQ + q) * NL + j] * u[j];
          rg[k] = s;
        }
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) s += G[d][k] * rg[k];
          gv[d][q] = s;
        }
      }
      // skew convection c(T; v): 0.5 (T.grad v) phi - 0.5 (T.grad phi) v
      float wv[NQ];
      float wg[DIM][NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) s += Tq[d][q] * gv[d][q];
        wv[q] = wd[q] * 0.5f * s;
#pragma unroll
        for (int d = 0; d < DIM; ++d) wg[d][q] = wd[q] * (-0.5f) * Tq[d][q] * vq[q];
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float mm = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) mm += mref[i * NL + j] * u[j];
        float lm = mass_w * dj * mm;
        float conv = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) conv += wv[q] * phi[q * NL + i];
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            float s = 0.f;
#pragma unroll
            for (int q = 0; q < NQ; ++q) s += wg[d][q] * dphi[(k * NQ + q) * NL + i];
            conv += G[d][k] * s;
          }
        lm += s_rho * conv;
        // stress, component-diagonal part: Cg[k,l] Kref[k,l,i,j] u_j
        float st = 0.f;
#pragma unroll
        for (int kl = 0; kl < D2; ++kl) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < NL; ++j) s += kref[(kl * NL + i) * NL + j] * u[j];
          st += Cg[kl] * s;
        }
        loc[m][i] = lm + s_mu * st;
      }
    }
    // stress coupling: loc[a][i] += s_mu detj G[a,k] G[n,l] K[k,l,j,i] u_n_j
#pragma unroll
    for (int k = 0; k < DIM; ++k)
#pragma unroll
      for (int l = 0; l < DIM; ++l)
#pragma unroll
        for (int n = 0; n < DIM; ++n)
#pragma unroll
          for (int i = 0; i < NL; ++i) {
            float mb = 0.f;
#pragma unroll
            for (int j = 0; j < NL; ++j)
              mb += kref[((DIM * k + l) * NL + j) * NL + i] * U[n][j];
            const float smb = s_mu * dj * mb;
#pragma unroll
            for (int a = 0; a < DIM; ++a) loc[a][i] += G[a][k] * G[n][l] * smb;
          }
    if constexpr (NEWTON) {
      // Newton reaction c(v; x): 0.5 [(v.grad x)_m phi_i - (v.grad phi_i) x_m]
      // with x_m = Tq[m] at the quadrature points and d_d x_m from gu
      const float* gu_b = gu + static_cast<long long>(b) * DIM * DIM * NQ * C;
      float re[DIM][NL];
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int i = 0; i < NL; ++i) re[m][i] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float vq[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < NL; ++j) s += phi[q * NL + j] * U[d][j];
          vq[d] = s;
        }
        const float hw = 0.5f * wd[q];
        // v.grad phi_i at q, with grad phi_i = G dphi_i
        float vg[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d)
#pragma unroll
            for (int k = 0; k < DIM; ++k)
              s += vq[d] * G[d][k] * dphi[(k * NQ + q) * NL + i];
          vg[i] = s;
        }
#pragma unroll
        for (int m = 0; m < DIM; ++m) {
          float a = 0.f;  // (v.grad x)_m
#pragma unroll
          for (int d = 0; d < DIM; ++d) a += vq[d] * gu_b[((d * DIM + m) * NQ + q) * C + c];
          const float wt = hw * a;
          const float xs = hw * Tq[m][q];
#pragma unroll
          for (int i = 0; i < NL; ++i) re[m][i] += wt * phi[q * NL + i] - xs * vg[i];
        }
      }
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int i = 0; i < NL; ++i) loc[m][i] += s_rho * re[m][i];
    }
    const float v = valid_b[c];
#pragma unroll
    for (int m = 0; m < DIM; ++m)
#pragma unroll
      for (int i = 0; i < NL; ++i)
        loc_g[(static_cast<long long>(m) * C + c) * NL + i] = loc[m][i] * v;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float acc[DIM];
#pragma unroll
    for (int m = 0; m < DIM; ++m) acc[m] = 0.f;
    for (int p = rp[w]; p < rp[w + 1]; ++p) {
      const int e = en[p];
#pragma unroll
      for (int m = 0; m < DIM; ++m) acc[m] += loc_g[static_cast<long long>(m) * C * NL + e];
    }
#pragma unroll
    for (int m = 0; m < DIM; ++m)
      out[(static_cast<long long>(m) * nb + b) * W + w] = acc[m];
  }
}

template <int DIM, int NL, int NQ, bool NEWTON>
int launch(const void* x, const void* lidx, const void* valid,
           const void* detj, const void* g4, const void* cg4, const void* tq,
           const void* gu, const void* tabs, const void* scal, const void* rowptr,
           const void* ent, void* scratch, void* out, int nb, int S, int W,
           int C, int n_pad, void* stream) {
  if (nb <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  winmom_kernel<DIM, NL, NQ, NEWTON><<<nb, kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(lidx),
      static_cast<const float*>(valid), static_cast<const float*>(detj),
      static_cast<const float*>(g4), static_cast<const float*>(cg4),
      static_cast<const float*>(tq), static_cast<const float*>(gu),
      static_cast<const float*>(tabs),
      static_cast<const float*>(scal), static_cast<const int*>(rowptr),
      static_cast<const int*>(ent), static_cast<float*>(scratch),
      static_cast<float*>(out), nb, S, W, C, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int winmom_p2_2d_lagged(const void* x, const void* lidx,
                                   const void* valid, const void* detj,
                                   const void* g4, const void* cg4,
                                   const void* tq, const void* tabs,
                                   const void* scal, const void* rowptr,
                                   const void* ent, void* scratch, void* out,
                                   int nb, int S, int W, int C, int n_pad,
                                   void* stream) {
  return launch<2, 6, 7, false>(x, lidx, valid, detj, g4, cg4, tq, nullptr,
                                tabs, scal, rowptr, ent, scratch, out, nb, S,
                                W, C, n_pad, stream);
}

extern "C" int winmom_p2_2d_newton(const void* x, const void* lidx,
                                   const void* valid, const void* detj,
                                   const void* g4, const void* cg4,
                                   const void* tq, const void* gu,
                                   const void* tabs, const void* scal,
                                   const void* rowptr, const void* ent,
                                   void* scratch, void* out, int nb, int S,
                                   int W, int C, int n_pad, void* stream) {
  return launch<2, 6, 7, true>(x, lidx, valid, detj, g4, cg4, tq, gu, tabs,
                               scal, rowptr, ent, scratch, out, nb, S, W, C,
                               n_pad, stream);
}
