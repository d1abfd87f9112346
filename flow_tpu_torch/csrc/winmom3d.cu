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
// Bound: bytes, both variants (chip_smoke.py's count at the cavity's N=64
// layout: 1,386 MB lagged, 414 us at 3.35 TB/s against 353 us of 23.7
// GFLOP at 67 TFLOP/s; Newton 2,949 MB, 880 us, against 498 us). Per cell
// the lagged apply reads 10 indices, detJ, 9 G, 9 C, a mask, 81 transport
// values and 30 window values and does ~15,000 flops; the Newton apply
// reads 243 gradient values more. The output windows are [DIM, nb, W]
// float32 (645 MB at N=64), 93% of whose rows no local result lands on.
// On the card the kernel is bound by neither: the cell's ~10,000
// instructions at 16 warps an SM (128 registers a thread) issue at about
// 40% of the SM's rate (PERF.md).
//
// Design: the thread-block-cluster walk of csrc/wincluster.cuh (shared with
// winstiff.cu, winmass.cu and winform.cu) with three values a position:
// - Local results. The cells of a window block (C = 3,063 at N=64) are
//   split over a cluster of blocks, each cell's 10 local results stored,
//   three components each, at their scatter-list positions in the shared
//   memory of the cluster (three planes a block): 30,630 positions x 12 B
//   = 359 KB, one pass of a cluster of two at N=64, of three at N=32
//   (attic/winkernel.momentum_plan: the size whose one-wave grid takes the
//   fewest rounds of cells). Each window row then sums its positions in
//   list order, per component, from 0: the order of the device-scratch
//   design this replaces, so the windows are bitwise those of a kernel
//   that wrote every local result to a scratch and read it back along the
//   lists. No scratch, no list (ent) read; a persistent grid of one wave.
// - Rows. The walk takes the window block's compressed rows (the rows some
//   local result lands on, attic/window.compact_lists, ~7% of them): the
//   window is first zeroed with 16-byte stores interleaved with the cells,
//   then only those rows are summed and written, so an empty row costs no
//   pointer load.
// - Tables. The small tables (phi, dphi, w, Mref, Kref and Kref by
//   columns: 3,604 floats with padding) are staged in shared memory as rows
//   of NL values at a 16-byte stride and read a row at a time by three
//   16-byte loads (load_row), ~1 load to 5 multiply-adds against the one
//   load each of volatile floats. As a kernel parameter (__grid_constant__)
//   or __constant__ array, read from the constant bank, nvcc kept 1,000
//   table values in registers and spilled 3-5 KB a thread. A thread holds
//   its cell's 30 window values U, G and the 30 accumulators; the
//   quadrature loop is the outermost loop of the convection and reaction
//   terms and reads the transport and gradient rows of each point from
//   global memory (the [nb, rows, C] layout puts consecutive cells at
//   consecutive addresses, so one thread per cell reads them coalesced).
//   The convection is factored per point through T.grad phi_i (10 values)
//   and the reaction through v.grad phi_i; the stress runs row by row
//   through the element matrix sum_kl Cg[kl] Kref[kl] and through G^T U per
//   (k, l). Every local result is computed in the scratch design's order.
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
constexpr int DIM = 3, NL = 10, NQ = 27;
constexpr int D2 = DIM * DIM;

// The small tables as the kernel keeps them in shared memory: rows of NL
// values at a 16-byte stride of kRow floats (two of padding), and Kref
// twice, by rows and by columns, so that every table operand of the cell
// comes with a row of three 16-byte loads.
constexpr int kRow = 12;
struct Smem {
  static constexpr int kPhi = 0;                         // row q: phi[q, :]
  static constexpr int kDphi = kPhi + NQ * kRow;         // row k*NQ + q: dphi[q, :, k]
  static constexpr int kMref = kDphi + DIM * NQ * kRow;  // row i: Mref[i, :]
  static constexpr int kKref = kMref + NL * kRow;        // row kl*NL + i: Kref[kl, i, :]
  static constexpr int kKrefT = kKref + D2 * NL * kRow;  // row kl*NL + i: Kref[kl, :, i]
  static constexpr int kW = kKrefT + D2 * NL * kRow;     // w[q]
  static constexpr int kSize = kW + NQ;
};
// ... and where attic/winmom.py::smem_tables puts them, flat
struct Flat {
  static constexpr int kPhi = 0;                         // [NQ, NL]
  static constexpr int kDphi = kPhi + NQ * NL;           // [DIM*NQ, NL]
  static constexpr int kW = kDphi + DIM * NQ * NL;       // [NQ]
  static constexpr int kMref = kW + NQ;                  // [NL, NL]
  static constexpr int kKref = kMref + NL * NL;          // [DIM*DIM*NL, NL]
};

// The NL values of the table row at p (shared memory, 16-byte aligned),
// into v, as three 16-byte loads. asm volatile, so that they stay in the
// cell: the compiler neither hoists a table out of the cell loop (and
// spills it) nor merges a row's loads across terms; plain ld.shared, so
// that the assembler may still schedule them ahead of their use.
__device__ __forceinline__ void load_row(const float* p, float (&v)[NL]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  float pad0, pad1;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+16];"
               : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7]) : "r"(a));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4+32];"
               : "=f"(v[8]), "=f"(v[9]), "=f"(pad0), "=f"(pad1) : "r"(a));
}

template <bool NEWTON>
__global__ void __launch_bounds__(kMaxThreads)
winmom3d_kernel(const float* __restrict__ x, const int* __restrict__ lidx,
                const float* __restrict__ valid, const float* __restrict__ detj,
                const float* __restrict__ g4, const float* __restrict__ cg4,
                const float* __restrict__ tq, const float* __restrict__ gu,
                const float* __restrict__ tabs, const float* __restrict__ scal,
                const int* __restrict__ rptr, const int* __restrict__ rows,
                const int* __restrict__ pos, float* __restrict__ out, int nb, int S,
                int W, int C, int R, int n_pad, int cap) {
  __shared__ __align__(16) float tab[Smem::kSize];
  // stage the tables: every entry of every row, padding as zeros
  for (int t = threadIdx.x; t < Smem::kW; t += blockDim.x) {
    const int r = t / kRow, j = t % kRow;
    float v = 0.f;
    if (j < NL) {
      if (t < Smem::kDphi) v = tabs[Flat::kPhi + r * NL + j];
      else if (t < Smem::kMref) v = tabs[Flat::kDphi + (r - NQ) * NL + j];
      else if (t < Smem::kKref) v = tabs[Flat::kMref + (r - NQ - DIM * NQ) * NL + j];
      else if (t < Smem::kKrefT) v = tabs[Flat::kKref + (r - NQ - DIM * NQ - NL) * NL + j];
      else {
        const int rr = r - NQ - DIM * NQ - NL - D2 * NL;  // kl*NL + i
        const int kl = rr / NL, i = rr % NL;
        v = tabs[Flat::kKref + (kl * NL + j) * NL + i];
      }
    }
    tab[t] = v;
  }
  for (int q = threadIdx.x; q < NQ; q += blockDim.x) tab[Smem::kW + q] = tabs[Flat::kW + q];
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
    const float* tq_b = tq + static_cast<long long>(b) * DIM * NQ * C;
    const float* gu_b = NEWTON ? gu + static_cast<long long>(b) * D2 * NQ * C : nullptr;
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

    float loc[DIM][NL];
    float r[NL];  // a table row
    // mass: mass_w detj Mref u
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      load_row(tab + Smem::kMref + i * kRow, r);
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) s += r[j] * U[m][j];
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
      for (int kl = 0; kl < D2; ++kl) {
        load_row(tab + Smem::kKref + (kl * NL + i) * kRow, r);
#pragma unroll
        for (int j = 0; j < NL; ++j) a[j] += cg[kl] * r[j];
      }
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
        load_row(tab + Smem::kKrefT + (kl * NL + i) * kRow, r);  // Kref[kl, :, i]
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) t += r[j] * w[j];
#pragma unroll
        for (int a = 0; a < DIM; ++a) loc[a][i] += gk[a] * t;
      }
    }
    // convection (and the Newton reaction), one quadrature point at a time
    // (unrolled by 3 or 27 it spilled and ran slower on the card, PERF.md)
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      float T[DIM], vq[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) T[d] = tq_b[(d * NQ + q) * C + c];
      float ph[NL];
      load_row(tab + Smem::kPhi + q * kRow, ph);
      const float hw = 0.5f * wq[q] * dj;
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
      for (int i = 0; i < NL; ++i) tgphi[i] = 0.f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        load_row(tab + Smem::kDphi + (k * NQ + q) * kRow, r);
#pragma unroll
        for (int i = 0; i < NL; ++i) tgphi[i] += tg[k] * r[i];
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
        for (int i = 0; i < NL; ++i) vgphi[i] = 0.f;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          load_row(tab + Smem::kDphi + (k * NQ + q) * kRow, r);
#pragma unroll
          for (int i = 0; i < NL; ++i) vgphi[i] += vg[k] * r[i];
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
    const float v = valid[static_cast<long long>(b) * C + c];
    return [=](int i, int m) { return loc[m][i] * v; };
  });
}

// The launch of a variant (wincluster::launch) with the arguments of `a`:
// a->clusters clusters of a->cl blocks of a->threads threads, each staging
// a->cap positions (3*cap floats). With `max_clusters` set, instead of
// launching, the number of such clusters the card holds at once (no
// pointer read).
template <bool NEWTON>
int launch(const WinmomArgs* a, const void* x, const void* scal, void* out, void* stream,
           int* max_clusters = nullptr) {
  if (a == nullptr || a->nb <= 0 || a->C <= 0 || a->W <= 0 || a->W % 4 || a->R <= 0 ||
      a->cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return wincluster::launch(
      winmom3d_kernel<NEWTON>, a->clusters, a->cl, a->threads, kMaxThreads, DIM * a->cap,
      stream, max_clusters, static_cast<const float*>(x), a->lidx, a->valid, a->detj,
      a->g4, a->cg4, a->tq, a->gu, a->tabs, static_cast<const float*>(scal), a->rptr,
      a->rows, a->pos, static_cast<float*>(out), a->nb, a->S, a->W, a->C, a->R, a->n_pad,
      a->cap);
}

}  // namespace

extern "C" int winmom_p2_3d_lagged(const WinmomArgs* a, const void* x, const void* scal,
                                   void* out, void* stream) {
  return launch<false>(a, x, scal, out, stream);
}

extern "C" int winmom_p2_3d_newton(const WinmomArgs* a, const void* x, const void* scal,
                                   void* out, void* stream) {
  return launch<true>(a, x, scal, out, stream);
}

// cudaOccupancyMaxActiveClusters of a launch of either variant (NEWTON 0
// or 1) of clusters of `cl` blocks of `threads` threads staging `cap`
// positions each, into *out.
extern "C" int winmom_p2_3d_clusters(int newton, int cl, int threads, int cap, int* out) {
  WinmomArgs a = {};
  a.nb = a.C = a.R = a.clusters = 1;
  a.W = 4;
  a.cl = cl;
  a.threads = threads;
  a.cap = cap;
  return newton ? launch<true>(&a, nullptr, nullptr, nullptr, nullptr, out)
                : launch<false>(&a, nullptr, nullptr, nullptr, nullptr, out);
}
