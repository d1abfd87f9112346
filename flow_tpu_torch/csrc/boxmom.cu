// The box stepper's lagged momentum operator on the box-packed P2 layout
// (fem/boxpack.py), in one pass over the cubes:
//
//   y = [M + s_mu (grad u + grad u^T : grad v) + s_rho skew-conv(T)] x
//
// on the 6 Kuhn tets of every cube of box_mesh(Nx, Ny, Nz). x, T and y are
// the flat [3 n2] packed vectors (component-major; each component's 8
// parity blocks of the doubled grid, fastest axis last).
//
// Replaces no TPU kernel: the JAX package left the operator to XLA, and the
// plain version (fem/boxpack.py::BoxPack.momentum_apply on the tables of
// conv_tables) stacks 3 x 10 window copies a tet type, reads 27 x 10
// transport tables of the grid's size a type (5.3 GiB at N = 96 in
// float32) and adds 30 windows back. Here the transport is formed at the
// quadrature points from T's local values, and nothing of the size of the
// grid is stored but the tile sums below.
//
// Bound: operations. A tet takes 6,141 FMA: T's local values into the
// reference frame (90); at each of the 27 points of the degree-5 rule
// (187 a point) T there, A_m = T . grad phi_m, <A, x>, <phi, x> and the two
// sums of the mass and the collapsed skew convection; the symmetric stress
// on the 4-point degree-2 rule, exact for its products of gradients (243 a
// point); the scale by detJ (30). At N = 96: 6 x 96^3 tets, 65.2 GFLOP,
// 0.97 ms at 67 TFLOP/s in float32 (1.9 ms in float64) against 259 MB of
// x, T and y (0.08 ms at 3.35 TB/s).
//
// Design:
// - A block owns a tile of TX x TY x TZ cubes, a thread a cube. It stages
//   the tile's points of the doubled grid ((2TX+1)(2TY+1)(2TZ+1), its 8
//   parity classes one after the other, as the packed layout keeps them) of
//   x and T in shared memory, with the rule's tables (a 52-value record a
//   point, read as 16-byte loads that all threads share).
// - For each tet type t in 0..5 every thread computes its tet's 30 local
//   results in registers (float64 keeps T's 30 local values in shared memory
//   instead, read by volatile loads so that they are not hoisted into
//   registers), then adds them into the tile's node sums in shared memory
//   in four phases split by barriers: phase 0 adds local dof 0 and the six
//   edge midpoints (i = 4..9), phase k adds vertex k. Within a tet type the
//   edge midpoints' parities differ from each other and from the vertices'
//   (ops/boxmom.py checks it), so no two threads add into one node in a
//   phase, and each node's sum is taken in the plain version's order:
//   for t, for i. No atomics: a call is deterministic.
// - The tiles overlap on their faces, so each writes its node sums to a tile
//   buffer, and a second kernel sums the (1 to 8) tiles of each node in a
//   fixed order, tile by tile, lexicographic: an interior node's value is
//   its tile's sum as it stands. This costs a pass over ~1.3 y of tile sums
//   and a write of y (0.06 ms at 3.35 TB/s at N = 96) against recomputing
//   each tile's one-cube halo (1.8x the operations for 4 x 4 x 8 tiles) or
//   colouring the tiles into 8 launches (each a partial wave of the card).
// - s_mu and s_rho are read through device pointers (0-d tensors of the
//   state dtype), so that no call waits for the host.
//
// Plain C interface (loaded with ctypes): each entry takes the launch's
// BoxMomArgs, launches both kernels on the given stream and returns the
// cudaError_t of the launches (0 on success).
#include <cuda_runtime.h>

// The arguments of a launch, in the layout of ops/boxmom.py::_BoxMomArgs.
struct BoxMomArgs {
  int nx, ny, nz;     // cubes per axis
  int ntx, nty, ntz;  // tiles per axis
  int n2;             // values of one component
  int off[8];         // the parity blocks' offsets in a component
  unsigned char loc[6][10];  // a tet type's local dofs: offset ox * 9 + oy * 3 + oz
  double smu, srho;   // the scales where their pointers are null
  const void* smu_ptr;
  const void* srho_ptr;
  const void* consts;  // ops/boxmom.py::momentum_constants in the dtype
};

namespace {

constexpr int kQ = 27;      // points of the degree-5 rule
constexpr int kQRec = 52;   // phi[10], dphi[10][3], w phi[10], w, pad
constexpr int kS = 4;       // points of the degree-2 rule
constexpr int kSRec = 32;   // dphi[10][3], w, pad
constexpr int kTypes = 6;
constexpr int kTypeRec = 12;  // G[3][3], detJ, pad
constexpr int kConsts = kQ * kQRec + kS * kSRec + kTypes * kTypeRec;
constexpr int kSumThreads = 256;

// The tile's points in shared memory: parity class p = px * 4 + py * 2 + pz
// holds the points 2 b + (px, py, pz), b < (cx(p), cy(p), cz(p)), z fastest.
template <int TX, int TY, int TZ>
struct Tile {
  static constexpr int kThreads = TX * TY * TZ;
  static constexpr int kPoints = (2 * TX + 1) * (2 * TY + 1) * (2 * TZ + 1);
  __host__ __device__ static constexpr int cx(int p) { return TX + 1 - (p >> 2); }
  __host__ __device__ static constexpr int cy(int p) { return TY + 1 - ((p >> 1) & 1); }
  __host__ __device__ static constexpr int cz(int p) { return TZ + 1 - (p & 1); }
  __host__ __device__ static constexpr int size(int p) { return cx(p) * cy(p) * cz(p); }
  __host__ __device__ static constexpr int start(int p) {
    return (p >> 2) * (TX + 1) * (2 * TY + 1) * (2 * TZ + 1) +
           ((p >> 1) & 1) * cx(p) * (TY + 1) * (2 * TZ + 1) + (p & 1) * cx(p) * cy(p) * (TZ + 1);
  }
  // the point of offset o = (ox, oy, oz) in {0, 1, 2}^3 from cube (0, 0, 0):
  // its class in the top byte, its place in the low bits
  __device__ static int entry(int code) {
    const int ox = code / 9, oy = (code / 3) % 3, oz = code % 3;
    const int p = (ox & 1) * 4 + (oy & 1) * 2 + (oz & 1);
    return (p << 24) | (start(p) + ((ox >> 1) * cy(p) + (oy >> 1)) * cz(p) + (oz >> 1));
  }
  // that point from cube (ci, cj, ck) of the tile
  __device__ static int at(int e, int ci, int cj, int ck) {
    const int p = e >> 24;
    return (e & 0xffffff) + (ci * cy(p) + cj) * cz(p) + ck;
  }
};

// N values from 16-byte aligned shared memory, as 16-byte loads
template <int N>
__device__ __forceinline__ void load_rec(const float* src, float (&dst)[N]) {
  static_assert(N % 4 == 0, "whole 16-byte rows");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_rec(const double* src, double (&dst)[N]) {
  static_assert(N % 2 == 0, "whole 16-byte rows");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const double2 v = reinterpret_cast<const double2*>(src)[i];
    dst[2 * i] = v.x;
    dst[2 * i + 1] = v.y;
  }
}

// T's 30 local values in the reference frame, T'[k][l] = sum_d G[d][k] T_d[l]:
// in registers (float32) or in the thread's column of shared memory
// (float64, where registers would spill)
template <typename T, int NT, bool SHARED = (sizeof(T) == 8)>
struct Transport {
  T v[3][10];
  __device__ void set(int k, int l, T value, T*, int) { v[k][l] = value; }
  __device__ T get(int k, int l, const T*, int) const { return v[k][l]; }
};

template <typename T, int NT>
struct Transport<T, NT, true> {
  __device__ void set(int k, int l, T value, T* col, int tid) {
    static_cast<volatile T*>(col)[(k * 10 + l) * NT + tid] = value;
  }
  __device__ T get(int k, int l, const T* col, int tid) const {
    return static_cast<const volatile T*>(col)[(k * 10 + l) * NT + tid];
  }
};

template <typename T, int TX, int TY, int TZ>
__global__ void __launch_bounds__(TX * TY * TZ)
boxmom_tiles(const BoxMomArgs a, const T* __restrict__ x, const T* __restrict__ tr,
             T* __restrict__ partial) {
  using Tl = Tile<TX, TY, TZ>;
  constexpr int NT = Tl::kThreads, LP = Tl::kPoints;
  constexpr bool kShared = sizeof(T) == 8;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* cs = reinterpret_cast<T*>(smem_bytes);  // the rules' and types' tables
  T* xs = cs + kConsts;                        // x at the tile's points [3][LP]
  T* ts = xs + 3 * LP;                         // T at the tile's points [3][LP]
  T* acc = ts + 3 * LP;                        // the node sums [3][LP]
  T* col = acc + 3 * LP;                       // float64: T' [30][NT]
  int* ent = reinterpret_cast<int*>(col + (kShared ? 30 * NT : 0));  // [6][10]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int tz0 = tile % a.ntz, ty0 = (tile / a.ntz) % a.nty, tx0 = tile / (a.ntz * a.nty);
  const int X0 = tx0 * TX, Y0 = ty0 * TY, Z0 = tz0 * TZ;

  const T* cg = static_cast<const T*>(a.consts);
  for (int i = tid; i < kConsts; i += NT) cs[i] = cg[i];
  for (int i = tid; i < kTypes * 10; i += NT) ent[i] = Tl::entry(a.loc[i / 10][i % 10]);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int DY = a.ny + 1 - ((p >> 1) & 1), DZ = a.nz + 1 - (p & 1);
    const int DX = a.nx + 1 - (p >> 2);
    for (int i = tid; i < Tl::size(p); i += NT) {
      const int bz = i % Tl::cz(p), by = (i / Tl::cz(p)) % Tl::cy(p);
      const int bx = i / (Tl::cz(p) * Tl::cy(p));
      const int gx = X0 + bx, gy = Y0 + by, gz = Z0 + bz;
      const bool in = gx < DX && gy < DY && gz < DZ;
      const int slot = a.off[p] + (gx * DY + gy) * DZ + gz;
      const int s = Tl::start(p) + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xs[c * LP + s] = in ? x[c * a.n2 + slot] : T(0);
        ts[c * LP + s] = in ? tr[c * a.n2 + slot] : T(0);
        acc[c * LP + s] = T(0);
      }
    }
  }
  __syncthreads();

  const int ck = tid % TZ, cj = (tid / TZ) % TY, ci = tid / (TZ * TY);
  const bool valid = X0 + ci < a.nx && Y0 + cj < a.ny && Z0 + ck < a.nz;
  const T smu = a.smu_ptr ? *static_cast<const T*>(a.smu_ptr) : static_cast<T>(a.smu);
  const T srho = a.srho_ptr ? *static_cast<const T*>(a.srho_ptr) : static_cast<T>(a.srho);
  const T c = T(0.5) * srho;

#pragma unroll 1
  for (int t = 0; t < kTypes; ++t) {
    T y[3][10];
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int i = 0; i < 10; ++i) y[b][i] = T(0);
    if (valid) {
      T G[12];
      load_rec(cs + kQ * kQRec + kS * kSRec + t * kTypeRec, G);
      T xl[3][10];
      Transport<T, NT> tp;
#pragma unroll
      for (int l = 0; l < 10; ++l) {
        const int s = Tl::at(ent[t * 10 + l], ci, cj, ck);
        T tl[3];
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          xl[b][l] = xs[b * LP + s];
          tl[b] = ts[b * LP + s];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tp.set(k, l, fma(G[6 + k], tl[2], fma(G[3 + k], tl[1], G[k] * tl[0])), col, tid);
      }

      // mass and skew convection on the degree-5 rule:
      // y_i += w phi_i (<phi, x> + c <A, x>) - c w A_i <phi, x>
#pragma unroll 1
      for (int q = 0; q < kQ; ++q) {
        T r[kQRec];
        load_rec(cs + q * kQRec, r);
        T tq[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          T s = r[0] * tp.get(k, 0, col, tid);
#pragma unroll
          for (int l = 1; l < 10; ++l) s = fma(r[l], tp.get(k, l, col, tid), s);
          tq[k] = s;
        }
        T A[10];
#pragma unroll
        for (int m = 0; m < 10; ++m)
          A[m] = fma(r[10 + 3 * m + 2], tq[2], fma(r[10 + 3 * m + 1], tq[1], r[10 + 3 * m] * tq[0]));
        const T cw = c * r[50];
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          T xa = A[0] * xl[b][0], xp = r[0] * xl[b][0];
#pragma unroll
          for (int j = 1; j < 10; ++j) {
            xa = fma(A[j], xl[b][j], xa);
            xp = fma(r[j], xl[b][j], xp);
          }
          const T u = fma(c, xa, xp), v = cw * xp;
#pragma unroll
          for (int i = 0; i < 10; ++i) y[b][i] = fma(-A[i], v, fma(r[40 + i], u, y[b][i]));
        }
      }

      // the stress s_mu (grad u + grad u^T) : grad v on the degree-2 rule
#pragma unroll 1
      for (int q = 0; q < kS; ++q) {
        T r[kSRec];
        load_rec(cs + kQ * kQRec + q * kSRec, r);
        T gp[3][3];  // gp[b][d] = d_d u_b
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          T gr[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            T s = r[k] * xl[b][0];
#pragma unroll
            for (int j = 1; j < 10; ++j) s = fma(r[3 * j + k], xl[b][j], s);
            gr[k] = s;
          }
#pragma unroll
          for (int d = 0; d < 3; ++d)
            gp[b][d] = fma(G[3 * d + 2], gr[2], fma(G[3 * d + 1], gr[1], G[3 * d] * gr[0]));
        }
        const T ws = r[30] * smu;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          T h[3];  // h[l] = w s_mu sum_e (d_e u_b + d_b u_e) G[e][l]
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            T s = (gp[b][0] + gp[0][b]) * G[l];
            s = fma(gp[b][1] + gp[1][b], G[3 + l], s);
            s = fma(gp[b][2] + gp[2][b], G[6 + l], s);
            h[l] = ws * s;
          }
#pragma unroll
          for (int i = 0; i < 10; ++i)
            y[b][i] = fma(h[2], r[3 * i + 2], fma(h[1], r[3 * i + 1], fma(h[0], r[3 * i], y[b][i])));
        }
      }
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int i = 0; i < 10; ++i) y[b][i] *= G[9];
    }

    // into the node sums: phase 0 local dof 0 and the edge midpoints, phase k
    // vertex k
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      __syncthreads();
      if (valid) {
#pragma unroll
        for (int i = 0; i < 10; ++i) {
          if (i == ph || (ph == 0 && i >= 4)) {
            const int s = Tl::at(ent[t * 10 + i], ci, cj, ck);
#pragma unroll
            for (int b = 0; b < 3; ++b) acc[b * LP + s] += y[b][i];
          }
        }
      }
    }
  }
  __syncthreads();
  T* out = partial + static_cast<long long>(tile) * 3 * LP;
  for (int i = tid; i < 3 * LP; i += NT) out[i] = acc[i];
}

// tiles of one axis that hold point g of the doubled grid: the last at
// local point l, and the one before at l + 2 T where l = 0
struct Cover {
  int tile, local, n;
};

__device__ __forceinline__ Cover cover(int g, int two_t, int n_tiles) {
  const int t = min(g / two_t, n_tiles - 1);
  const int l = g - two_t * t;
  return {t, l, (l == 0 && t > 0) ? 2 : 1};
}

template <typename T, int TX, int TY, int TZ>
__global__ void __launch_bounds__(kSumThreads)
boxmom_sum(const BoxMomArgs a, const T* __restrict__ partial, T* __restrict__ y) {
  using Tl = Tile<TX, TY, TZ>;
  constexpr int LP = Tl::kPoints;
  const int s = blockIdx.x * kSumThreads + threadIdx.x;
  if (s < 3 * a.n2) {
    const int c = s / a.n2, slot = s - c * a.n2;
    int p = 0;
#pragma unroll
    for (int k = 1; k < 8; ++k) p += slot >= a.off[k];
    const int px = p >> 2, py = (p >> 1) & 1, pz = p & 1;
    const int DY = a.ny + 1 - py, DZ = a.nz + 1 - pz;
    const int loc = slot - a.off[p];
    const int bz = loc % DZ, by = (loc / DZ) % DY, bx = loc / (DZ * DY);
    const Cover cx = cover(2 * bx + px, 2 * TX, a.ntx);
    const Cover cy = cover(2 * by + py, 2 * TY, a.nty);
    const Cover cz = cover(2 * bz + pz, 2 * TZ, a.ntz);
    T v = T(0);
    for (int ix = 2 - cx.n; ix < 2; ++ix) {
      const int tx = cx.tile - 1 + ix, lx = cx.local + (1 - ix) * 2 * TX;
      for (int iy = 2 - cy.n; iy < 2; ++iy) {
        const int ty = cy.tile - 1 + iy, ly = cy.local + (1 - iy) * 2 * TY;
        for (int iz = 2 - cz.n; iz < 2; ++iz) {
          const int tz = cz.tile - 1 + iz, lz = cz.local + (1 - iz) * 2 * TZ;
          const long long tile = (static_cast<long long>(tx) * a.nty + ty) * a.ntz + tz;
          const int at = Tl::start(p) + ((lx >> 1) * Tl::cy(p) + (ly >> 1)) * Tl::cz(p) + (lz >> 1);
          v += partial[(tile * 3 + c) * LP + at];
        }
      }
    }
    y[s] = v;
  }
}

template <typename T, int TX, int TY, int TZ>
int launch(const BoxMomArgs* a, const void* x, const void* tr, void* y, void* partial,
           void* stream) {
  using Tl = Tile<TX, TY, TZ>;
  constexpr int NT = Tl::kThreads;
  const size_t smem = sizeof(T) * (kConsts + 9 * Tl::kPoints + (sizeof(T) == 8 ? 30 * NT : 0)) +
                      sizeof(int) * kTypes * 10;
  auto* tiles = boxmom_tiles<T, TX, TY, TZ>;
  static cudaError_t attr = cudaFuncSetAttribute(
      tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = a->ntx * a->nty * a->ntz;
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiles<<<n_tiles, NT, smem, s>>>(*a, static_cast<const T*>(x), static_cast<const T*>(tr),
                                  static_cast<T*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sum_blocks = (3 * a->n2 + kSumThreads - 1) / kSumThreads;
  boxmom_sum<T, TX, TY, TZ><<<sum_blocks, kSumThreads, 0, s>>>(
      *a, static_cast<const T*>(partial), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tiles of 4 x 4 x 8 cubes in float32 (56 KB of shared memory, three blocks
// an SM) and 4 x 4 x 4 in float64 (81 KB, two blocks)
extern "C" int boxmom_f32(const BoxMomArgs* a, const void* x, const void* tr, void* y,
                          void* partial, void* stream) {
  return launch<float, 4, 4, 8>(a, x, tr, y, partial, stream);
}

extern "C" int boxmom_f64(const BoxMomArgs* a, const void* x, const void* tr, void* y,
                          void* partial, void* stream) {
  return launch<double, 4, 4, 4>(a, x, tr, y, partial, stream);
}
