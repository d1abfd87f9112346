// Window-blocked momentum operator on a 3-D vector-P2 space (tets: DIM=3,
// NL=10, NQ=27, the conical degree-5 rule), lagged or Newton:
//
//   A v = mass_w M v + s_rho c(T; v) + s_mu sym_grad(v)          (lagged)
//   J v = A v + s_rho c(v; x)                                   (Newton)
//
// The same function as csrc/winmom.cu at DIM=3, on the same row layouts
// (attic/winmom.py header): per component m and window dof w of block b,
//   out[m, b, w] = sum over the real cells c of block b and local dofs i
//                  with lidx[b, i, c] == w of loc[m][i](c),
// loc the element contributions of the mass, the skew convection
// 0.5 [(T.grad v) phi_i - (T.grad phi_i) v] with the transport T frozen at
// the quadrature points (tq), the stress form 2 eps(v):eps(phi_i), and in
// Newton mode the reaction term 0.5 [(v.grad x)_m phi_i - (v.grad phi_i)
// x_m] about the state x, whose values are tq and whose physical gradients
// are gu [nb, DIM*DIM*NQ, C] (row (d*DIM+m)*NQ+q holds d_d x_m).
//
// Replaces flow_tpu/attic/winmom.py::momentum_tables_apply with its kernels
// _mom_kernel_3d and _mom_newton_kernel_3d (K3, lagged and Newton 3-D).
//
// Bound: operations (lagged) and bytes (Newton). Per cell the lagged apply
// reads 10 indices, detJ, 9 G, 9 C, a mask, 81 transport values and 30
// window values and does ~15,000 flops; the Newton apply reads 243
// gradient values more (1.56 GB over the cavity's 1.57M cells at N=64).
// The output windows are [DIM, nb, W] float32, W/S of them per block.
//
// Design, and how it differs from the 2-D kernel:
// - Registers. The 2-D kernel holds the transport of every quadrature
//   point and per-point temporaries (255 registers in Newton mode); at
//   NQ=27 that would spill heavily. Here a thread holds only its cell's 30
//   window values U, G and the 30 accumulators; the quadrature loop is the
//   outermost loop of the convection and reaction terms, and reads the
//   transport and gradient rows of each point from global memory (the
//   [nb, rows, C] layout puts consecutive cells at consecutive addresses,
//   so one thread per cell reads them coalesced). The convection is
//   factored per point through T.grad phi_i (10 values) and the reaction
//   through v.grad phi_i; the stress runs row by row through the element
//   matrix sum_kl Cg[kl] Kref[kl] and through G^T U per (k, l).
// - Local results. The cells of a block (C = 3,063 at N=64, 120 B each)
//   do not fit in the 227 KB of shared memory a block may have. They go to
//   a device scratch [nb, DIM, C*NL] that the wrapper allocates; after
//   __syncthreads(), which makes the block's global writes visible to the
//   block, each thread takes window dofs in turn and sums, per component,
//   the local results of its dof along the block's scatter list (rowptr,
//   ent), built on the host in ascending (cell, local dof) order: a fixed
//   order, so the result is bitwise repeatable (no atomics), at any C.
// - The small tables (phi, dphi, w, Mref, Kref: 2,107 floats) and the
//   three weights are staged in shared memory and read through volatile
//   pointers, so that they stay there. Every loop that indexes a register
//   array is unrolled; the quadrature loop, which indexes only shared and
//   global memory, is not.
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int DIM = 3, NL = 10, NQ = 27;
constexpr int D2 = DIM * DIM;

struct Tables {
  static constexpr int kPhi = 0;                        // [NQ, NL]
  static constexpr int kDphi = kPhi + NQ * NL;          // [DIM*NQ, NL]
  static constexpr int kW = kDphi + DIM * NQ * NL;      // [NQ]
  static constexpr int kMref = kW + NQ;                 // [NL, NL]
  static constexpr int kKref = kMref + NL * NL;         // [DIM*DIM*NL, NL]
  static constexpr int kSize = kKref + D2 * NL * NL;
  static constexpr int kSmem = kSize + 3;               // + mass_w, s_rho, s_mu
};

template <bool NEWTON>
__global__ void __launch_bounds__(kThreads)
winmom3d_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
                const float* __restrict__ valid, const float* __restrict__ detj,
                const float* __restrict__ g4, const float* __restrict__ cg4,
                const float* __restrict__ tq, const float* __restrict__ gu,
                const float* __restrict__ tabs, const float* __restrict__ scal,
                const int* __restrict__ rowptr, const int* __restrict__ ent,
                float* __restrict__ scratch, float* __restrict__ out, int nb,
                int S, int W, int C, int n_pad) {
  __shared__ float tab[Tables::kSmem];
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < Tables::kSize; t += blockDim.x) tab[t] = tabs[t];
  for (int t = threadIdx.x; t < 3; t += blockDim.x) tab[Tables::kSize + t] = scal[t];

  // volatile: every use reads shared memory. Otherwise the compiler hoists
  // the loop-invariant reads of the unrolled mass and stress terms (1,000
  // floats) out of the cell loop and spills them to local memory
  // (scripts/torch_ptxas_report.py shows the stack and spills)
  const volatile float* phi = tab + Tables::kPhi;
  const volatile float* dphi = tab + Tables::kDphi;
  const volatile float* wq = tab + Tables::kW;
  const volatile float* mref = tab + Tables::kMref;
  const volatile float* kref = tab + Tables::kKref;

  const long long boff = static_cast<long long>(b) * S;
  const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
  const float* valid_b = valid + static_cast<long long>(b) * C;
  const float* detj_b = detj + static_cast<long long>(b) * C;
  const float* g_b = g4 + static_cast<long long>(b) * D2 * C;
  const float* cg_b = cg4 + static_cast<long long>(b) * D2 * C;
  const float* tq_b = tq + static_cast<long long>(b) * DIM * NQ * C;
  const float* gu_b = NEWTON ? gu + static_cast<long long>(b) * D2 * NQ * C : nullptr;
  const int* rp = rowptr + static_cast<long long>(b) * (W + 1);
  const int* en = ent + static_cast<long long>(b) * C * NL;
  float* loc_g = scratch + static_cast<long long>(b) * DIM * C * NL;  // [DIM, C, NL]
  __syncthreads();
  const float mass_w = tab[Tables::kSize];
  const float s_rho = tab[Tables::kSize + 1];
  const float s_mu = tab[Tables::kSize + 2];

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float U[DIM][NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long li = boff + lidx_b[j * C + c];
#pragma unroll
      for (int m = 0; m < DIM; ++m) U[m][j] = x[static_cast<long long>(m) * n_pad + li];
    }
    const float dj = detj_b[c];
    float G[DIM][DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
      for (int k = 0; k < DIM; ++k) G[d][k] = g_b[(DIM * d + k) * C + c];

    float loc[DIM][NL];
    // mass: mass_w detj Mref u
#pragma unroll
    for (int i = 0; i < NL; ++i) {
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += mref[i * NL + j] * U[m][j];
        loc[m][i] = mass_w * dj * s;
      }
    }
    // stress, component-diagonal part: row i of the element matrix
    // A[i, :] = sum_kl Cg[kl] Kref[kl, i, :], applied to each component
    float cg[D2];
#pragma unroll
    for (int kl = 0; kl < D2; ++kl) cg[kl] = cg_b[kl * C + c];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float a[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) a[j] = 0.f;
#pragma unroll
      for (int kl = 0; kl < D2; ++kl)
#pragma unroll
        for (int j = 0; j < NL; ++j) a[j] += cg[kl] * kref[(kl * NL + i) * NL + j];
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += a[j] * U[m][j];
        loc[m][i] += s_mu * s;
      }
    }
    // stress coupling: loc[a][i] += s_mu detj sum_kl G[a,k]
    //                               sum_j K[k,l,j,i] (sum_n G[n,l] u_n_j)
    const float smd = s_mu * dj;
#pragma unroll
    for (int kl = 0; kl < D2; ++kl) {
      const int k = kl / DIM, l = kl % DIM;
      float w[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        float s = 0.f;
#pragma unroll
        for (int n = 0; n < DIM; ++n) s += G[n][l] * U[n][j];
        w[j] = s;
      }
      float gk[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) gk[a] = smd * G[a][k];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) t += kref[(kl * NL + j) * NL + i] * w[j];
#pragma unroll
        for (int a = 0; a < DIM; ++a) loc[a][i] += gk[a] * t;
      }
    }
    // convection (and the Newton reaction), one quadrature point at a time
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      const volatile float* ph = phi + q * NL;
      const float hw = 0.5f * wq[q] * dj;
      float T[DIM], vq[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) T[d] = tq_b[(d * NQ + q) * C + c];
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += ph[j] * U[m][j];
        vq[m] = s;
      }
      // T.grad phi_i = (G^T T)_k dphi_k,i
      float tg[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) s += G[d][k] * T[d];
        tg[k] = s;
      }
      float tgphi[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) s += tg[k] * dphi[(k * NQ + q) * NL + i];
        tgphi[i] = s;
      }
      // c(T; v)_m,i = hw [(T.grad v_m) phi_i - (T.grad phi_i) v_m]
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += tgphi[j] * U[m][j];
        const float wa = s_rho * hw * s;
        const float wb = s_rho * hw * vq[m];
#pragma unroll
        for (int i = 0; i < NL; ++i) loc[m][i] += wa * ph[i] - wb * tgphi[i];
      }
      if constexpr (NEWTON) {
        // c(v; x)_m,i = hw [(v.grad x)_m phi_i - (v.grad phi_i) x_m]
        float vg[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d) s += G[d][k] * vq[d];
          vg[k] = s;
        }
        float vgphi[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) s += vg[k] * dphi[(k * NQ + q) * NL + i];
          vgphi[i] = s;
        }
#pragma unroll
        for (int m = 0; m < DIM; ++m) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d) s += vq[d] * gu_b[((d * DIM + m) * NQ + q) * C + c];
          const float wa = s_rho * hw * s;
          const float wb = s_rho * hw * T[m];
#pragma unroll
          for (int i = 0; i < NL; ++i) loc[m][i] += wa * ph[i] - wb * vgphi[i];
        }
      }
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

template <bool NEWTON>
int launch(const void* x, const void* lidx, const void* valid, const void* detj,
           const void* g4, const void* cg4, const void* tq, const void* gu,
           const void* tabs, const void* scal, const void* rowptr,
           const void* ent, void* scratch, void* out, int nb, int S, int W,
           int C, int n_pad, void* stream) {
  if (nb <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  winmom3d_kernel<NEWTON><<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(lidx),
      static_cast<const float*>(valid), static_cast<const float*>(detj),
      static_cast<const float*>(g4), static_cast<const float*>(cg4),
      static_cast<const float*>(tq), static_cast<const float*>(gu),
      static_cast<const float*>(tabs), static_cast<const float*>(scal),
      static_cast<const int*>(rowptr), static_cast<const int*>(ent),
      static_cast<float*>(scratch), static_cast<float*>(out), nb, S, W, C,
      n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int winmom_p2_3d_lagged(const void* x, const void* lidx,
                                   const void* valid, const void* detj,
                                   const void* g4, const void* cg4,
                                   const void* tq, const void* tabs,
                                   const void* scal, const void* rowptr,
                                   const void* ent, void* scratch, void* out,
                                   int nb, int S, int W, int C, int n_pad,
                                   void* stream) {
  return launch<false>(x, lidx, valid, detj, g4, cg4, tq, nullptr, tabs, scal,
                       rowptr, ent, scratch, out, nb, S, W, C, n_pad, stream);
}

extern "C" int winmom_p2_3d_newton(const void* x, const void* lidx,
                                   const void* valid, const void* detj,
                                   const void* g4, const void* cg4,
                                   const void* tq, const void* gu,
                                   const void* tabs, const void* scal,
                                   const void* rowptr, const void* ent,
                                   void* scratch, void* out, int nb, int S,
                                   int W, int C, int n_pad, void* stream) {
  return launch<true>(x, lidx, valid, detj, g4, cg4, tq, gu, tabs, scal,
                      rowptr, ent, scratch, out, nb, S, W, C, n_pad, stream);
}
