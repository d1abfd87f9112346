// 9-point constant-coefficient stencil on a structured 2-D vertex grid:
//
//   y[i,j] = sum_{d in {-1,0,1}^2} K[d] * x[i+dx, j+dy]
//
// with zero padding and cross-correlation order (no flip); x, y are
// contiguous [X, Y] (y fastest: the vertex id i*Y + j of rectangle_mesh),
// K is a contiguous [3, 3] device buffer. Any X, Y >= 1.
//
// Replaces flow_tpu/ops/pallas_stencil.py::stencil_apply_2d (the Pallas
// kernel of the JAX package, one program per grid row with a 3-row DMA
// window and lane rolls). It is the interior part of the P1 Laplacian
// (ops/structured.py) on 2-D rectangle grids, the operator of every level
// of the structured multigrid hierarchy.
//
// Bound: memory bandwidth. 9 FMAs per point against, ideally, one read and
// one write of the grid; the 9-fold reuse of each input value comes from
// the caches (three neighbouring rows of a 2,049-point row are 24 KB in
// f32).
//
// Design: one thread per output point, linear index with j fastest so the
// loads and the store of a warp are coalesced; the 9 coefficients are
// staged once per block in shared memory; the summation order is the plain
// PyTorch version's (dx, dy lexicographic), so the two differ only by FMA
// contraction.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil9_kernel(const T* __restrict__ x, const T* __restrict__ coef,
                T* __restrict__ y, int X, int Y) {
  __shared__ T ks[9];
  if (threadIdx.x < 9) ks[threadIdx.x] = coef[threadIdx.x];
  __syncthreads();

  const long long n = static_cast<long long>(X) * Y;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int j = static_cast<int>(idx % Y);
  const int i = static_cast<int>(idx / Y);

  T acc = T(0);
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    const int ii = i + dx;
    const bool okx = (ii >= 0) && (ii < X);
    const long long row = static_cast<long long>(ii) * Y;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int jj = j + dy;
      if (okx && jj >= 0 && jj < Y) {
        acc += ks[(dx + 1) * 3 + (dy + 1)] * x[row + jj];
      }
    }
  }
  y[idx] = acc;
}

template <typename T>
int launch(const void* x, const void* coef, void* y, int X, int Y,
           void* stream) {
  const long long n = static_cast<long long>(X) * Y;
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  stencil9_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(coef),
      static_cast<T*>(y), X, Y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil9_f32(const void* x, const void* coef, void* y, int X,
                            int Y, void* stream) {
  return launch<float>(x, coef, y, X, Y, stream);
}

extern "C" int stencil9_f64(const void* x, const void* coef, void* y, int X,
                            int Y, void* stream) {
  return launch<double>(x, coef, y, X, Y, stream);
}
