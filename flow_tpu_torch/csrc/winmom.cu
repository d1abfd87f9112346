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
// Bound: operations (lagged) and bytes (Newton) on paper (chip_smoke.py's
// count at the Karman 1.9M velocity layout: lagged ~3,600 flops a cell,
// 22.7 us at 67 TFLOP/s; Newton 28 gradient values a cell more, 35.6 us of
// bytes at 3.35 TB/s). Per cell the lagged apply reads 6 indices, detJ, 4
// G, 4 C, a mask, 14 transport values and 12 window values; the output
// windows [DIM, nb, W] are 13.6 MB there, a third of whose rows no local
// result lands on. On the card the cells bound it (75% of a window block's
// time): 1,629 FFMA a lagged cell and 2,005 a Newton one, issued by at
// most 16 warps an SM (128 registers a thread), and a grid of whole window
// blocks, 5 on some SMs against 4.18 on average (PERF.md).
//
// Design: the thread-block-cluster walk of csrc/wincluster.cuh (shared with
// winmom3d.cu, winstiff.cu, winmass.cu and winform.cu) with two values a
// position:
// - Local results. The cells of a window block are split over a cluster of
//   blocks, each cell's 6 local results stored, both components, at their
//   scatter-list positions in the shared memory of the cluster (two planes
//   a block). At the Karman 1.9M layout (C = 771) one block of 512 threads
//   stages a window block's 4,626 positions (37 KB) in one pass, in two
//   rounds of cells (attic/winkernel.momentum_plan: the cluster size whose
//   one-wave grid gives a cluster the fewest window blocks). Each listed
//   window row then sums its positions in list order, per component, from
//   0: the order of the device-scratch design this replaces, so the
//   windows are bitwise those of a kernel that wrote every local result to
//   a scratch and read it back along the lists (rowptr, ent). No scratch,
//   no list read; a persistent grid of one wave.
// - Rows. The walk takes the window block's compressed rows (the rows some
//   local result lands on, attic/window.compact_lists): the window is
//   zeroed with 16-byte stores interleaved with the cells, then only those
//   rows are summed and written.
// - Tables. The small tables sit in shared memory as rows of at most 8
//   values at a 16-byte stride, each read by two 16-byte loads (load_row)
//   that serve both components: phi by points and by local dofs, dphi by
//   (direction, point) and by (direction, local dof), Mref, Kref by rows
//   and by columns. That is ~240 loads a Newton cell against ~1,650 loads
//   of a volatile float, one per operand. The transport and C values are
//   loaded where they are used (load_once), not held for the whole cell.
// - Order. Every local result is computed in the order of operations of
//   the scratch kernel it replaces: the convection weights point by point
//   from the values and physical gradients there, then per local dof the
//   mass, the convection and the component-diagonal stress, then the
//   stress coupling in (k, l, n) order per result, then, in Newton mode,
//   the reaction summed over the points in order and added last. Only
//   loads and loops moved, so the results round alike.
//
// Plain C interface (loaded with ctypes): the fixed arguments of a launch
// come in one WinmomArgs struct (winmom.cuh) that the caller keeps; each
// entry launches on the given stream and returns the cudaError_t of the
// launch (0 on success); the query entry writes how many clusters of a
// launch the card holds at once.
#include <cuda_runtime.h>

#include "wincluster.cuh"
#include "winmom.cuh"

namespace {

// At most 512 threads a block, so 128 registers a thread.
constexpr int kMaxThreads = 512;
constexpr int DIM = 2, NL = 6, NQ = 7;
constexpr int D2 = DIM * DIM;

// The small tables as the kernel keeps them in shared memory: rows of at
// most kRow values at a 16-byte stride (padding as zeros).
constexpr int kRow = 8;
struct Smem {
  static constexpr int kPhi = 0;                         // row q: phi[q, :]
  static constexpr int kPhiT = kPhi + NQ * kRow;         // row i: phi[:, i]
  static constexpr int kDphi = kPhiT + NL * kRow;        // row k*NQ + q: dphi[q, :, k]
  static constexpr int kDphiT = kDphi + DIM * NQ * kRow; // row k*NL + i: dphi[:, i, k]
  static constexpr int kMref = kDphiT + DIM * NL * kRow; // row i: Mref[i, :]
  static constexpr int kKref = kMref + NL * kRow;        // row kl*NL + i: Kref[kl, i, :]
  static constexpr int kKrefT = kKref + D2 * NL * kRow;  // row kl*NL + i: Kref[kl, :, i]
  static constexpr int kW = kKrefT + D2 * NL * kRow;     // one row: w[:]
  static constexpr int kSize = kW + kRow;
};
// ... and where attic/winmom.py::smem_tables puts them, flat
struct Flat {
  static constexpr int kPhi = 0;                         // [NQ, NL]
  static constexpr int kDphi = kPhi + NQ * NL;           // [DIM*NQ, NL]
  static constexpr int kW = kDphi + DIM * NQ * NL;       // [NQ]
  static constexpr int kMref = kW + NQ;                  // [NL, NL]
  static constexpr int kKref = kMref + NL * NL;          // [DIM*DIM*NL, NL]
};

// Entry t of the shared-memory tables (Smem), from the flat ones.
__device__ __forceinline__ float table_entry(const float* __restrict__ tabs, int t) {
  const int r = t / kRow, j = t % kRow;
  if (t < Smem::kPhiT) return j < NL ? tabs[Flat::kPhi + r * NL + j] : 0.f;
  if (t < Smem::kDphi) {
    const int i = r - Smem::kPhiT / kRow;
    return j < NQ ? tabs[Flat::kPhi + j * NL + i] : 0.f;
  }
  if (t < Smem::kDphiT) {
    const int kq = r - Smem::kDphi / kRow;
    return j < NL ? tabs[Flat::kDphi + kq * NL + j] : 0.f;
  }
  if (t < Smem::kMref) {
    const int ki = r - Smem::kDphiT / kRow, k = ki / NL, i = ki % NL;
    return j < NQ ? tabs[Flat::kDphi + (k * NQ + j) * NL + i] : 0.f;
  }
  if (t < Smem::kKref) {
    const int i = r - Smem::kMref / kRow;
    return j < NL ? tabs[Flat::kMref + i * NL + j] : 0.f;
  }
  if (t < Smem::kKrefT) {
    const int kli = r - Smem::kKref / kRow;
    return j < NL ? tabs[Flat::kKref + kli * NL + j] : 0.f;
  }
  if (t < Smem::kW) {
    const int kli = r - Smem::kKrefT / kRow, kl = kli / NL, i = kli % NL;
    return j < NL ? tabs[Flat::kKref + (kl * NL + j) * NL + i] : 0.f;
  }
  return j < NQ ? tabs[Flat::kW + j] : 0.f;
}

// The kRow values of the table row at p (shared memory, 16-byte aligned),
// into v, as two 16-byte loads. asm volatile, so that they stay where they
// are used: the compiler neither hoists a table out of the cell loop (and
// spills it) nor merges a row's loads across terms. VOLATILE: as
// ld.volatile, which the assembler does not merge either. The Newton cell
// reads the rows of phi and dphi twice, in the convection and in the
// reaction; with plain loads the assembler kept the first reads in
// registers for the second and spilled 1.6 KB a thread (PERF.md). The
// lagged cell reads each row once, and plain loads may be scheduled early.
template <bool VOLATILE>
__device__ __forceinline__ void load_row(const float* p, float (&v)[kRow]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (VOLATILE) {
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a));
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4+16];"
                 : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7]) : "r"(a));
  } else {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a));
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+16];"
                 : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7]) : "r"(a));
  }
}

// The float at p (global memory, read-only), loaded where it is used: asm
// volatile, so that the compiler does not keep a table that each component
// reads again in registers for the whole cell.
__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <bool NEWTON>
__global__ void __launch_bounds__(kMaxThreads)
winmom_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
              const float* __restrict__ valid, const float* __restrict__ detj,
              const float* __restrict__ g4, const float* __restrict__ cg4,
              const float* __restrict__ tq, const float* __restrict__ gu,
              const float* __restrict__ tabs, const float* __restrict__ scal,
              const int* __restrict__ rptr, const int* __restrict__ rows,
              const int* __restrict__ pos, float* __restrict__ out, int nb, int S, int W,
              int C, int R, int n_pad, int cap) {
  __shared__ __align__(16) float tab[Smem::kSize];
  for (int t = threadIdx.x; t < Smem::kSize; t += blockDim.x) tab[t] = table_entry(tabs, t);
  const volatile float* wq = tab + Smem::kW;
  const float mass_w = scal[0];
  const float s_rho = scal[1];
  const float s_mu = scal[2];
  // the walk's first cluster barrier orders the staged tables before any use
  wincluster::walk<NL, DIM, true>(rptr, rows, R, pos, out, nb, W, C, cap, [&](int b, int c) {
    const long long boff = static_cast<long long>(b) * S;
    const int* lidx_b = lidx + static_cast<long long>(b) * NL * C;
    const float* g_b = g4 + static_cast<long long>(b) * D2 * C;
    const float* cg_b = cg4 + static_cast<long long>(b) * D2 * C;
    // Tq[d][q] of this cell at tq_c[(d*NQ + q) * C]
    const float* tq_c = tq + static_cast<long long>(b) * DIM * NQ * C + c;
    float U[DIM][NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const long long li = boff + lidx_b[j * C + c];
#pragma unroll
      for (int m = 0; m < DIM; ++m) U[m][j] = x[static_cast<long long>(m) * n_pad + li];
    }
    const float dj = detj[static_cast<long long>(b) * C + c];
    float G[DIM][DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
#pragma unroll
      for (int k = 0; k < DIM; ++k) G[d][k] = g_b[(DIM * d + k) * C + c];
    float r[kRow];  // a table row

    // skew convection c(T; v): 0.5 (T.grad v) phi - 0.5 (T.grad phi) v,
    // its weights point by point from the values and the reference, then
    // physical, gradients there, both components from each table row
    float wv[DIM][NQ];
    float wg[DIM][DIM][NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      load_row<NEWTON>(tab + Smem::kPhi + q * kRow, r);
      float vq[DIM];
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += r[j] * U[m][j];
        vq[m] = s;
      }
      float rg[DIM][DIM];  // [m][k]
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        load_row<NEWTON>(tab + Smem::kDphi + (k * NQ + q) * kRow, r);
#pragma unroll
        for (int m = 0; m < DIM; ++m) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < NL; ++j) t += r[j] * U[m][j];
          rg[m][k] = t;
        }
      }
      float T[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) T[d] = load_once(tq_c + (d * NQ + q) * C);
      const float wd = wq[q] * dj;
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float gv[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          float t = 0.f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) t += G[d][k] * rg[m][k];
          gv[d] = t;
        }
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) s += T[d] * gv[d];
        wv[m][q] = wd * 0.5f * s;
#pragma unroll
        for (int d = 0; d < DIM; ++d) wg[m][d][q] = wd * (-0.5f) * T[d] * vq[m];
      }
    }
    // per local dof: the mass, the convection and the component-diagonal
    // stress, both components from each table row
    const float* cg_c = cg_b + c;
    float loc[DIM][NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float lm[DIM], conv[DIM];
      load_row<NEWTON>(tab + Smem::kMref + i * kRow, r);
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float mm = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) mm += r[j] * U[m][j];
        lm[m] = mass_w * dj * mm;
      }
      load_row<NEWTON>(tab + Smem::kPhiT + i * kRow, r);  // phi[:, i]
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) t += wv[m][q] * r[q];
        conv[m] = t;
      }
      // sum_q wg[d][q] dphi[q, i, k] for each (d, k), a row of dphi by
      // local dofs at a time, added to conv in (d, k) order
      float sdk[DIM][DIM][DIM];  // [m][d][k]
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        load_row<NEWTON>(tab + Smem::kDphiT + (k * NL + i) * kRow, r);  // dphi[:, i, k]
#pragma unroll
        for (int m = 0; m < DIM; ++m)
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            float t = 0.f;
#pragma unroll
            for (int q = 0; q < NQ; ++q) t += wg[m][d][q] * r[q];
            sdk[m][d][k] = t;
          }
      }
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
#pragma unroll
        for (int d = 0; d < DIM; ++d)
#pragma unroll
          for (int k = 0; k < DIM; ++k) conv[m] += G[d][k] * sdk[m][d][k];
        lm[m] += s_rho * conv[m];
      }
      // stress, component-diagonal part: Cg[k,l] Kref[k,l,i,j] u_j
      float st[DIM] = {};
#pragma unroll
      for (int kl = 0; kl < D2; ++kl) {
        load_row<NEWTON>(tab + Smem::kKref + (kl * NL + i) * kRow, r);
        const float cg = load_once(cg_c + kl * C);
#pragma unroll
        for (int m = 0; m < DIM; ++m) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < NL; ++j) t += r[j] * U[m][j];
          st[m] += cg * t;
        }
      }
#pragma unroll
      for (int m = 0; m < DIM; ++m) loc[m][i] = lm[m] + s_mu * st[m];
    }
    // stress coupling: loc[a][i] += s_mu detj G[a,k] G[n,l] K[k,l,j,i] u_n_j,
    // per result in (k, l, n) order
#pragma unroll
    for (int k = 0; k < DIM; ++k)
#pragma unroll
      for (int l = 0; l < DIM; ++l)
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          load_row<NEWTON>(tab + Smem::kKrefT + ((DIM * k + l) * NL + i) * kRow, r);  // Kref[k, l, :, i]
#pragma unroll
          for (int n = 0; n < DIM; ++n) {
            float mb = 0.f;
#pragma unroll
            for (int j = 0; j < NL; ++j) mb += r[j] * U[n][j];
            const float smb = s_mu * dj * mb;
#pragma unroll
            for (int a = 0; a < DIM; ++a) loc[a][i] += G[a][k] * G[n][l] * smb;
          }
        }
    if constexpr (NEWTON) {
      // Newton reaction c(v; x): 0.5 [(v.grad x)_m phi_i - (v.grad phi_i) x_m]
      // with x_m = Tq[m] at the quadrature points and d_d x_m from gu,
      // summed over the points in order and added last
      const float* gu_c = gu + static_cast<long long>(b) * DIM * DIM * NQ * C + c;
      float re[DIM][NL];
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int i = 0; i < NL; ++i) re[m][i] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        load_row<NEWTON>(tab + Smem::kPhi + q * kRow, r);
        float vq[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < NL; ++j) s += r[j] * U[d][j];
          vq[d] = s;
        }
        const float hw = 0.5f * (wq[q] * dj);
        // v.grad phi_i at q, with grad phi_i = G dphi_i, over (d, k) in order
        float r1[kRow];
        load_row<NEWTON>(tab + Smem::kDphi + q * kRow, r);          // dphi[q, :, 0]
        load_row<NEWTON>(tab + Smem::kDphi + (NQ + q) * kRow, r1);  // dphi[q, :, 1]
        float vg[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d)
#pragma unroll
            for (int k = 0; k < DIM; ++k) s += vq[d] * G[d][k] * (k == 0 ? r[i] : r1[i]);
          vg[i] = s;
        }
        load_row<NEWTON>(tab + Smem::kPhi + q * kRow, r);
#pragma unroll
        for (int m = 0; m < DIM; ++m) {
          float a = 0.f;  // (v.grad x)_m
#pragma unroll
          for (int d = 0; d < DIM; ++d) a += vq[d] * gu_c[((d * DIM + m) * NQ + q) * C];
          const float wt = hw * a;
          const float xs = hw * load_once(tq_c + (m * NQ + q) * C);
#pragma unroll
          for (int i = 0; i < NL; ++i) re[m][i] += wt * r[i] - xs * vg[i];
        }
      }
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int i = 0; i < NL; ++i) loc[m][i] += s_rho * re[m][i];
    }
    const float v = valid[static_cast<long long>(b) * C + c];
    return [=](int i, int m) { return loc[m][i] * v; };
  });
}

// The launch of a variant (wincluster::launch) with the arguments of `a`:
// a->clusters clusters of a->cl blocks of a->threads threads, each staging
// a->cap positions (2*cap floats). With `max_clusters` set, instead of
// launching, the number of such clusters the card holds at once (no
// pointer read).
template <bool NEWTON>
int launch(const WinmomArgs* a, const void* x, const void* scal, void* out, void* stream,
           int* max_clusters = nullptr) {
  if (a == nullptr || a->nb <= 0 || a->C <= 0 || a->W <= 0 || a->W % 4 || a->R <= 0 ||
      a->cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return wincluster::launch(
      winmom_kernel<NEWTON>, a->clusters, a->cl, a->threads, kMaxThreads, DIM * a->cap,
      stream, max_clusters, static_cast<const float*>(x), a->lidx, a->valid, a->detj,
      a->g4, a->cg4, a->tq, a->gu, a->tabs, static_cast<const float*>(scal), a->rptr,
      a->rows, a->pos, static_cast<float*>(out), a->nb, a->S, a->W, a->C, a->R, a->n_pad,
      a->cap);
}

}  // namespace

extern "C" int winmom_p2_2d_lagged(const WinmomArgs* a, const void* x, const void* scal,
                                   void* out, void* stream) {
  return launch<false>(a, x, scal, out, stream);
}

extern "C" int winmom_p2_2d_newton(const WinmomArgs* a, const void* x, const void* scal,
                                   void* out, void* stream) {
  return launch<true>(a, x, scal, out, stream);
}

// cudaOccupancyMaxActiveClusters of a launch of either variant (NEWTON 0
// or 1) of clusters of `cl` blocks of `threads` threads staging `cap`
// positions each, into *out.
extern "C" int winmom_p2_2d_clusters(int newton, int cl, int threads, int cap, int* out) {
  WinmomArgs a = {};
  a.nb = a.C = a.R = a.clusters = 1;
  a.W = 4;
  a.cl = cl;
  a.threads = threads;
  a.cap = cap;
  return newton ? launch<true>(&a, nullptr, nullptr, nullptr, nullptr, out)
                : launch<false>(&a, nullptr, nullptr, nullptr, nullptr, out);
}
