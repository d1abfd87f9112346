// The arguments of a launch of the structured stencils (K1: stencil3d.cu,
// K2: stencil2d.cu), in the layout of the ctypes Structure
// ops/stencil.py::_StencilArgs: a device pointer to the coefficients, the
// grid and the tile plan of ops/stencil.py's plan_2d/plan_3d. A
// StructuredLaplacian keeps one per operator, so that a call passes the
// struct, x, the output and the stream. The kernels take
// the struct by value, as a kernel parameter.
#pragma once

struct StencilArgs {
  const void* kdev;  // the coefficients on the device in the grid's dtype:
                     // K[dx][dy][dz] (3-D) or K[dx][dy] (2-D), lexicographic
  int X, Y, Z;       // the grid (Z = 1 in 2-D), fastest axis last
  int rows;          // rows of a strip (2-D) or planes of a chunk (3-D)
  int tile_y, tile_z;  // the (Y, Z) tile a block owns (2-D: tile_z columns)
  int grid_x, grid_y, grid_z, threads;
  int smem;          // dynamic shared-memory bytes a block
};

// The coefficients into registers, once a thread.
template <typename T, int N>
__device__ __forceinline__ void load_coef(const StencilArgs& a, T (&k)[N]) {
  const T* kd = static_cast<const T*>(a.kdev);
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = __ldg(kd + i);
}
