// 9-point constant-coefficient stencil on a structured 2-D vertex grid:
//
//   y[i,j] = sum_{d in {-1,0,1}^2} K[d] * x[i+dx, j+dy]
//
// with zero padding and cross-correlation order (no flip); x, y are
// contiguous [X, Y] (y fastest: the vertex id i*Y + j of rectangle_mesh).
// Any X, Y >= 1 with X*Y < 2^31.
//
// Replaces flow_tpu/ops/pallas_stencil.py::stencil_apply_2d (the Pallas
// kernel of the JAX package, one program per grid row with a 3-row DMA
// window and lane rolls). It is the interior part of the P1 Laplacian
// (ops/structured.py) on 2-D rectangle grids, the operator of every level
// of the structured multigrid hierarchy.
//
// Bound: memory bandwidth (9 FMAs a point against one read and one write
// of the grid). A design of one thread a point spends ~150 instructions on
// each (64-bit division for i, j; 9 predicated loads with 64-bit addresses;
// 9 shared-memory coefficient reads) and is bound by them instead. Here:
//
// - A block owns a tile of columns (30 a warp: lanes 1-30 own one each,
//   lanes 0 and 31 load the columns either side; ops/stencil.py::plan_2d
//   balances the tiles) and marches down a strip of `rows` rows. Each
//   thread keeps its column's x[i-1], x[i], x[i+1] with their j-1 and j+1
//   neighbours in registers and rolls them as i advances: a row costs one
//   coalesced load, two warp shuffles for the neighbours, 9 FMAs and a
//   store. Each value is read from device memory once a strip, plus two
//   halo rows a strip (and the two columns either side of a warp's, from
//   the caches). Strips whose halo rows lie inside the grid take a path
//   without row guards.
// - Rows are loaded in groups (8 in float32, 4 in float64), each group
//   while the one before it is summed, so that many loads are in flight a
//   thread (rows of 2,049 floats are 8,196 bytes, not a multiple of 16: no
//   TMA tensor map and no aligned 16-byte row loads).
// - 32-bit indices from blockIdx, no division a point; the coefficients
//   are in registers, loaded from the device once a thread.
// - The sum of a point is taken as the plain version's and the previous
//   one-thread-a-point kernel's: dx outer, dy inner, acc = fma(K, x, acc)
//   from acc = +0. An out-of-range neighbour reads as 0, and fma(K, 0, acc)
//   == acc (acc is never -0), so the outputs are bitwise those of the
//   kernel that skipped those terms.
//
// Plain C interface (loaded with ctypes): each entry takes the launch's
// StencilArgs (csrc/stencil.cuh), launches on the given stream and returns
// the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kOwned = 30;  // columns a warp owns

template <typename T>
struct Row {
  T l, c, r;  // x[i, j-1], x[i, j], x[i, j+1]
};

template <typename T>
__device__ __forceinline__ T sum9(const T (&k)[9], const Row<T>& a, const Row<T>& b,
                                  const Row<T>& c) {
  T acc = T(0);
  acc = fma(k[0], a.l, acc);
  acc = fma(k[1], a.c, acc);
  acc = fma(k[2], a.r, acc);
  acc = fma(k[3], b.l, acc);
  acc = fma(k[4], b.c, acc);
  acc = fma(k[5], b.r, acc);
  acc = fma(k[6], c.l, acc);
  acc = fma(k[7], c.c, acc);
  acc = fma(k[8], c.r, acc);
  return acc;
}

// One strip of the block's columns, with (INNER) or without guards on the
// rows: INNER strips have both halo rows inside the grid.
template <bool INNER, typename T>
__device__ __forceinline__ void strip(const T (&k)[9], const T* __restrict__ x,
                                      T* __restrict__ y, int X, int Y, int j, bool col,
                                      bool own, int i0, int i1) {
  constexpr int kGroup = sizeof(T) == 4 ? 8 : 4;
  const int jc = col ? j : 0;  // a column inside the grid, for the addresses
  auto load = [&](int r) {
    return (col && (INNER || (r >= 0 && r < X))) ? x[r * Y + jc] : T(0);
  };
  // x[i, j-1], x[i, j], x[i, j+1] from the lanes beside; every lane takes
  // part (lanes 0 and 31 get no neighbour on one side and store nothing)
  auto spread = [](T v) {
    return Row<T>{__shfl_up_sync(0xffffffffu, v, 1), v, __shfl_down_sync(0xffffffffu, v, 1)};
  };

  // the halo row above the strip, its first row and its first group (rows
  // i0+1 .. i0+kGroup, up to the halo row below it), all in flight together
  T v0 = load(i0 - 1), v1 = load(i0), vs[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) vs[g] = i0 + 1 + g <= i1 ? load(i0 + 1 + g) : T(0);
  Row<T> up = spread(v0);
  Row<T> mid = spread(v1);
  int i = i0;
  // groups whose next group lies inside the strip too: each loads the next
  // while it sums its rows, with no row guards
  for (; i + 2 * kGroup <= i1; i += kGroup) {
    T vn[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) vn[g] = load(i + kGroup + 1 + g);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const Row<T> down = spread(vs[g]);
      if (own) y[(i + g) * Y + jc] = sum9(k, up, mid, down);
      up = mid;
      mid = down;
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) vs[g] = vn[g];
  }
  // the last one or two groups, with row guards
  for (; i < i1; i += kGroup) {
    const bool more = i + kGroup < i1;
    T vn[kGroup];
    if (more) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        vn[g] = i + kGroup + 1 + g <= i1 ? load(i + kGroup + 1 + g) : T(0);
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const Row<T> down = spread(vs[g]);
      if (own && i + g < i1) y[(i + g) * Y + jc] = sum9(k, up, mid, down);
      up = mid;
      mid = down;
    }
    if (more) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) vs[g] = vn[g];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
stencil9_kernel(const StencilArgs a, const T* __restrict__ x, T* __restrict__ y) {
  T k[9];
  load_coef(a, k);
  const int X = a.X, Y = a.Y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp owns 30 columns, its lanes 1-30; lanes 0 and 31 load the column
  // on either side (0 outside the grid)
  const int j = blockIdx.x * a.tile_z + warp * kOwned + lane - 1;
  const bool col = j >= 0 && j < Y;
  const bool own = lane >= 1 && lane <= kOwned && j < Y;
  const int i0 = blockIdx.y * a.rows;
  const int i1 = min(i0 + a.rows, X);
  if (i0 >= 1 && i1 <= X - 1) {
    strip<true>(k, x, y, X, Y, j, col, own, i0, i1);
  } else {
    strip<false>(k, x, y, X, Y, j, col, own, i0, i1);
  }
}

template <typename T>
int launch(const StencilArgs* a, const void* x, void* y, void* stream) {
  if (a->X <= 0 || a->Y <= 0) return 0;
  if (a->threads <= 0 || a->threads > kMaxThreads || a->threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  stencil9_kernel<T><<<dim3(a->grid_x, a->grid_y), a->threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *a, static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil9_f32(const StencilArgs* a, const void* x, void* y, void* stream) {
  return launch<float>(a, x, y, stream);
}

extern "C" int stencil9_f64(const StencilArgs* a, const void* x, void* y, void* stream) {
  return launch<double>(a, x, y, stream);
}
