// 27-point constant-coefficient stencil on a structured 3-D vertex grid:
//
//   y[i,j,k] = sum_{d in {-1,0,1}^3} K[d] * x[i+dx, j+dy, k+dz]
//
// with zero padding and cross-correlation order (no flip); x, y are
// contiguous [X, Y, Z] (z fastest), K is a contiguous [3, 3, 3] device
// buffer. Any X, Y, Z >= 1.
//
// Replaces flow_tpu/ops/pallas_stencil.py::stencil_apply_3d (the Pallas
// kernel of the JAX package, one program per x-plane with a 3-plane DMA
// window). It is the interior part of the P1 pressure Laplacian
// (ops/structured.py) on the finest grid and on every multigrid level.
//
// Bound: memory bandwidth. 27 FMAs per point against, ideally, one read and
// one write of the grid; the 27-fold reuse of each input value comes from
// the caches. At cavity N=64 the fine grid is 65^3 points (about 1.1 MB in
// f32), so it sits in the card's 50 MB L2 and the neighbour loads hit L1/L2.
//
// Design: one thread per output point, linear index with z fastest so the
// loads and the store of a warp are coalesced; the 27 coefficients are
// staged once per block in shared memory; the summation order is the plain
// PyTorch reference's (dx, dy, dz lexicographic), so the two differ only by
// FMA contraction. A shared-memory tile with a halo is left to later work.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil27_kernel(const T* __restrict__ x, const T* __restrict__ coef,
                 T* __restrict__ y, int X, int Y, int Z) {
  __shared__ T ks[27];
  if (threadIdx.x < 27) ks[threadIdx.x] = coef[threadIdx.x];
  __syncthreads();

  const long long n = static_cast<long long>(X) * Y * Z;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int k = static_cast<int>(idx % Z);
  const long long t = idx / Z;
  const int j = static_cast<int>(t % Y);
  const int i = static_cast<int>(t / Y);

  T acc = T(0);
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    const int ii = i + dx;
    const bool okx = (ii >= 0) && (ii < X);
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int jj = j + dy;
      const bool oky = okx && (jj >= 0) && (jj < Y);
      const long long row = (static_cast<long long>(ii) * Y + jj) * Z;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        const int kk = k + dz;
        if (oky && kk >= 0 && kk < Z) {
          acc += ks[(dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)] * x[row + kk];
        }
      }
    }
  }
  y[idx] = acc;
}

template <typename T>
int launch(const void* x, const void* coef, void* y, int X, int Y, int Z,
           void* stream) {
  const long long n = static_cast<long long>(X) * Y * Z;
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  stencil27_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(coef),
      static_cast<T*>(y), X, Y, Z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil27_f32(const void* x, const void* coef, void* y, int X,
                             int Y, int Z, void* stream) {
  return launch<float>(x, coef, y, X, Y, Z, stream);
}

extern "C" int stencil27_f64(const void* x, const void* coef, void* y, int X,
                             int Y, int Z, void* stream) {
  return launch<double>(x, coef, y, X, Y, Z, stream);
}
