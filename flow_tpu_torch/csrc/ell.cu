// Padded-ELL row apply y[r] = sum_k vals[r, k] * x[cols[r, k]], the operator
// of the assembled P1 stiffness (fem/ell.py::ELLMatrix): the pressure
// operator of FastStepper's einsum route and every P1Hierarchy level the
// window kernels do not take. Two kernels, both over the column-major
// ("lane") layout [K, n], in which thread r reads entry k at k*n + r, so a
// warp's reads of one k are coalesced:
//
// - ell_direct: one thread per row walks its K entries in order k = 0..K-1
//   and reads x through the read-only path (__ldg), which L1/L2 cache.
//   Replaces scripts/pallas_gather_probe.py::run (P1), whose TPU kernel
//   keeps all of x in VMEM and gathers from it in tiles of 2,048 rows.
// - ell_window: a block takes a tile of `rows` rows, one thread each. The
//   tile's segments of x (fem/ell.py::ell_window_tables: 32-aligned, merged
//   across small gaps, at most WINDOW_SEGMENTS = 16 a tile; the kernel's cap
//   is 32, a warp's lanes) are staged into dynamic shared memory, one bulk
//   copy (cp.async.bulk) per segment, issued by one lane of warp 0 each and
//   completing on an mbarrier; a segment cut short by the end of x has its
//   last < 16 bytes copied by plain loads. Meanwhile every thread loads its
//   row's first entries (vals and 16-bit tile-local indices), which do not
//   depend on the window; then it gathers through the window. Replaces
//   scripts/onehot_window_probe.py::pallas_onehot and ::pallas_two (P2),
//   which DMA one contiguous window into VMEM. Their one-hot
//   compare-and-sum and two-level MXU split stand in for a gather the TPU
//   lacks; a thread here indexes shared memory directly, so neither is
//   carried over.
//
// Bound: memory bandwidth. An apply reads vals and the indices once
// (n K (sizeof(T) + 4) bytes with int32 columns, n K (sizeof(T) + 2) with
// the window's 16-bit ones), x once and writes y once (2 n sizeof(T)); it
// does 2 n K flops. x is small and stays in L2, so the window's staging is
// L2 traffic: what the window saves is 2 bytes of device memory per entry,
// which fem/ell.py's rule weighs against the staged bytes. Both kernels sum
// in the order of the plain version's k, one product at a time, in the same
// expression, so they agree bitwise.
//
// Plain C interface (loaded with ctypes): each entry launches on the given
// stream and returns the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

#include <cstdint>

#include "bulkcopy.cuh"

namespace {

constexpr int kDirectThreads = 256;
constexpr int kMaxWindowRows = 1024;
constexpr int kMaxSegments = 32;  // one lane of warp 0 each
constexpr int kPrefetch = 16;     // entries a thread loads before the window lands

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
__global__ void __launch_bounds__(kMaxWindowRows)
ell_window_kernel(const T* __restrict__ vals, const unsigned short* __restrict__ lidx,
                  const int* __restrict__ seg_start, const int* __restrict__ seg_len,
                  const int* __restrict__ seg_off, const T* __restrict__ x,
                  T* __restrict__ y, int n, int K, int G) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  T* win = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x;
  const int r = t * blockDim.x + threadIdx.x;
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int start = 0, len = 0, off = 0;
    if (lane < G) {
      start = seg_start[t * G + lane];
      len = seg_len[t * G + lane];
      off = seg_off[t * G + lane];
    }
    const int bulk = (len * static_cast<int>(sizeof(T))) & ~15;
    int total = bulk;
    for (int s = 16; s > 0; s >>= 1) total += __shfl_xor_sync(0xffffffffu, total, s);
    if (lane == 0) mbar_arrive_expect_tx(&bar, static_cast<uint32_t>(total));
    __syncwarp();
    if (bulk > 0) bulk_copy_g2s(win + off, x + start, static_cast<uint32_t>(bulk), &bar);
    for (int i = bulk / static_cast<int>(sizeof(T)); i < len; ++i)
      win[off + i] = x[start + i];
  }
  const bool row = r < n;
  T v[kPrefetch];
  unsigned short li[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    if (row && k < K) {
      const long long e = static_cast<long long>(k) * n + r;
      v[k] = vals[e];
      li[k] = lidx[e];
    }
  }
  mbar_wait(&bar, 0);
  __syncthreads();  // the tails, written by plain stores
  if (!row) return;
  T acc = v[0] * win[li[0]];
#pragma unroll
  for (int k = 1; k < kPrefetch; ++k) {
    if (k < K) acc += v[k] * win[li[k]];
  }
  for (int k = kPrefetch; k < K; ++k) {
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

// rows: threads of a block (a multiple of 32, at most 1,024); G: segments
// of a tile (at most 32); width: the largest window of a tile, in values.
// A window that does not fit the shared memory a block may opt in to is
// refused with cudaErrorInvalidValue.
template <typename T>
int launch_window(const void* vals, const void* lidx, const void* seg_start,
                  const void* seg_len, const void* seg_off, const void* x, void* y,
                  int n, int K, int rows, int G, int width, void* stream) {
  if (n <= 0 || K <= 0 || width <= 0 || rows <= 0 || rows % 32 ||
      rows > kMaxWindowRows || G <= 0 || G > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = static_cast<long long>(width) * sizeof(T);
  if (bytes > optin - 16) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ell_window_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + rows - 1) / rows;
  ell_window_kernel<T><<<blocks, rows, static_cast<int>(bytes),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const unsigned short*>(lidx),
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_len),
      static_cast<const int*>(seg_off), static_cast<const T*>(x),
      static_cast<T*>(y), n, K, G);
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

extern "C" int ell_window_f32(const void* vals, const void* lidx,
                              const void* seg_start, const void* seg_len,
                              const void* seg_off, const void* x, void* y, int n,
                              int K, int rows, int G, int width, void* stream) {
  return launch_window<float>(vals, lidx, seg_start, seg_len, seg_off, x, y, n, K,
                              rows, G, width, stream);
}

extern "C" int ell_window_f64(const void* vals, const void* lidx,
                              const void* seg_start, const void* seg_len,
                              const void* seg_off, const void* x, void* y, int n,
                              int K, int rows, int G, int width, void* stream) {
  return launch_window<double>(vals, lidx, seg_start, seg_len, seg_off, x, y, n, K,
                               rows, G, width, stream);
}
