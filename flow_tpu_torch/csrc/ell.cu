// Padded-ELL row apply y[r] = sum_k vals[r, k] * x[cols[r, k]], the operator
// of the assembled P1 stiffness (fem/ell.py::ELLMatrix): the pressure
// operator of FastStepper's einsum route and every P1Hierarchy level the
// window kernels do not take. Two kernels, both over the column-major
// ("lane") layout vals_t, cols_t [K, n], in which thread r reads entry k at
// k*n + r, so a warp's reads of one k are coalesced:
//
// - ell_direct: one thread per row walks its K entries in order k = 0..K-1
//   and reads x through the read-only path (__ldg), which L1/L2 cache.
//   Replaces scripts/pallas_gather_probe.py::run (P1), whose TPU kernel
//   keeps all of x in VMEM and gathers from it in tiles of 2,048 rows.
// - ell_window: a block of R = 128 rows first copies its window
//   x[w0[b] : w0[b] + W] into dynamic shared memory (opted in above 48 KB),
//   then each thread gathers its row through the block-local indices
//   lidx_t = cols - w0[b], in the same k order. Replaces
//   scripts/onehot_window_probe.py::pallas_onehot and ::pallas_two (P2),
//   which DMA the same window into VMEM. Their one-hot compare-and-sum and
//   two-level MXU split stand in for a gather the TPU lacks; a thread here
//   indexes shared memory directly, so neither is carried over.
//
// Bound: memory bandwidth. An apply reads vals and the int32 indices once
// (n K (sizeof(T) + 4) bytes), x once and writes y once (2 n sizeof(T));
// it does 2 n K flops. The window kernel also reads each block's window
// from L2 into shared memory, which only this design needs. Both sum in the
// order of the plain version's k, one product at a time.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

namespace {

constexpr int kDirectThreads = 256;
constexpr int kWindowRows = 128;

template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
ell_direct_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                  const T* __restrict__ x, T* __restrict__ y, int n, int K) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  T acc = vals[r] * __ldg(x + cols[r]);
  for (int k = 1; k < K; ++k) {
    const long long e = static_cast<long long>(k) * n + r;
    acc += vals[e] * __ldg(x + cols[e]);
  }
  y[r] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kWindowRows)
ell_window_kernel(const T* __restrict__ vals, const int* __restrict__ lidx,
                  const int* __restrict__ w0, const T* __restrict__ x,
                  T* __restrict__ y, int n, int K, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int start = w0[b];
  const int len = min(W, n - start);
  for (int t = threadIdx.x; t < len; t += blockDim.x) win[t] = x[start + t];
  __syncthreads();
  const int r = b * kWindowRows + threadIdx.x;
  if (r >= n) return;
  T acc = vals[r] * win[lidx[r]];
  for (int k = 1; k < K; ++k) {
    const long long e = static_cast<long long>(k) * n + r;
    acc += vals[e] * win[lidx[e]];
  }
  y[r] = acc;
}

template <typename T>
int launch_direct(const void* vals, const void* cols, const void* x, void* y,
                  int n, int K, void* stream) {
  if (n <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kDirectThreads - 1) / kDirectThreads;
  ell_direct_kernel<T><<<blocks, kDirectThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(cols),
      static_cast<const T*>(x), static_cast<T*>(y), n, K);
  return static_cast<int>(cudaGetLastError());
}

// A window of W values that does not fit the shared memory a block may opt
// in to is refused with cudaErrorInvalidValue.
template <typename T>
int launch_window(const void* vals, const void* lidx, const void* w0,
                  const void* x, void* y, int n, int K, int W, void* stream) {
  if (n <= 0 || K <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = static_cast<long long>(W) * sizeof(T);
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ell_window_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kWindowRows - 1) / kWindowRows;
  ell_window_kernel<T><<<blocks, kWindowRows, static_cast<int>(bytes),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(lidx),
      static_cast<const int*>(w0), static_cast<const T*>(x),
      static_cast<T*>(y), n, K, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ell_direct_f32(const void* vals, const void* cols, const void* x,
                              void* y, int n, int K, void* stream) {
  return launch_direct<float>(vals, cols, x, y, n, K, stream);
}

extern "C" int ell_direct_f64(const void* vals, const void* cols, const void* x,
                              void* y, int n, int K, void* stream) {
  return launch_direct<double>(vals, cols, x, y, n, K, stream);
}

extern "C" int ell_window_f32(const void* vals, const void* lidx, const void* w0,
                              const void* x, void* y, int n, int K, int W,
                              void* stream) {
  return launch_window<float>(vals, lidx, w0, x, y, n, K, W, stream);
}

extern "C" int ell_window_f64(const void* vals, const void* lidx, const void* w0,
                              const void* x, void* y, int n, int K, int W,
                              void* stream) {
  return launch_window<double>(vals, lidx, w0, x, y, n, K, W, stream);
}
