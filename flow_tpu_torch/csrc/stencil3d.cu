// 27-point constant-coefficient stencil on a structured 3-D vertex grid:
//
//   y[i,j,k] = sum_{d in {-1,0,1}^3} K[d] * x[i+dx, j+dy, k+dz]
//
// with zero padding and cross-correlation order (no flip); x, y are
// contiguous [X, Y, Z] (z fastest). Any X, Y, Z >= 1 with X*Y*Z < 2^31.
//
// Replaces flow_tpu/ops/pallas_stencil.py::stencil_apply_3d (the Pallas
// kernel of the JAX package, one program per x-plane with a 3-plane DMA
// window). It is the interior part of the P1 pressure Laplacian
// (ops/structured.py) on the finest grid and on every multigrid level.
//
// Bound: memory bandwidth on paper (27 FMAs a point against one read and
// one write of the grid), but at the cavity's grids (65^3, 33^3: 1.1 MB
// and 0.14 MB in float32, in the 50 MB L2) the bound (0.66 us at 65^3) is
// below a launch's floor: the kernel is bound by its latency and its
// instructions. A design of one thread a point spends ~300 instructions on
// each (two 64-bit divisions, 27 predicated loads with 64-bit addresses and
// shared-memory coefficient reads). Here:
//
// - A block owns a (Y, Z) tile (tile_y x tile_z points, a thread each;
//   ops/stencil.py::plan_3d) and marches along x over a chunk of `rows`
//   planes; the chunks give the card enough blocks at 65^3 and 33^3. Each
//   plane of the tile, with a one-point halo, is copied into a ring of
//   three planes in shared memory by 4- or 8-byte cp.async two planes
//   ahead of its use (one barrier a plane; no register waits on a load;
//   the copies' addresses are computed once a thread, and each copy is a
//   predicated instruction, not a branch); each thread reads its 3x3
//   neighbourhood of the staged plane once and keeps the neighbourhoods of
//   three planes in registers, their roles rotating with the plane so that
//   nothing moves between registers: a point costs ~1-4 copies, 9
//   shared-memory reads, 27 FMAs and a store. Each value is read from
//   memory once a chunk, plus two halo planes a chunk and a halo ring a
//   tile.
// - 32-bit indices from blockIdx; the thread's place in its tile and the
//   plane offsets of the cells it stages are computed once a thread; the
//   coefficients are in registers, loaded from the device once a thread.
// - Rows of 65 floats are 260 bytes: no TMA tensor map.
// - The sum of a point is taken as the plain version's and the previous
//   one-thread-a-point kernel's: dx, dy, dz lexicographic, acc = fma(K, x,
//   acc) from acc = +0. An out-of-range neighbour reads as 0, and
//   fma(K, 0, acc) == acc (acc is never -0), so the outputs are bitwise
//   those of the kernel that skipped those terms.
//
// Plain C interface (loaded with ctypes): each entry takes the launch's
// StencilArgs (csrc/stencil.cuh), launches on the given stream and returns
// the cudaError_t of the launch (0 on success).
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSlots = 4;   // staged cells a thread copies a plane, at most
constexpr int kStages = 3;  // planes in the shared ring: one read, two in flight

// A SIZE-byte asynchronous copy from device to shared memory (cp.async,
// through L1), issued where `issue`: `bytes` of it read from src, the rest
// zero-filled (bytes = 0: src is not read).
template <int SIZE>
__device__ __forceinline__ void copy_async(unsigned dst, const void* src, int bytes,
                                           bool issue) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], %4, %2;\n}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(static_cast<int>(issue)), "n"(SIZE)
      : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
stencil27_kernel(const StencilArgs a, const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  const T* ring = reinterpret_cast<const T*>(ring_bytes);
  T k[27];
  load_coef(a, k);
  const int X = a.X, Y = a.Y, Z = a.Z, YZ = Y * Z;
  const int TY = a.tile_y, TZ = a.tile_z, W = TZ + 2, cells = (TY + 2) * W;
  const int t = threadIdx.x, nt = blockDim.x;
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * a.rows, x1 = min(x0 + a.rows, X);
  const int planes = x1 - x0 + 2;  // the chunk's planes and a halo plane each side

  // this thread's point of the tile, and the corner of its 3x3
  // neighbourhood in a staged plane
  const int ty = t / TZ, tz = t - ty * TZ;
  const bool inside = t < TY * TZ;
  const bool point = inside && y0 + ty < Y && z0 + tz < Z;
  const int at = ty * W + tz;
  const int out = (y0 + ty) * Z + z0 + tz;
  // the staged cells s = t + m nt this thread copies: the cell's offset in
  // a plane of x (0 outside the grid, where it is zero-filled), the bytes
  // read, and whether the cell exists; its place in ring slot 0
  const unsigned ring0 = static_cast<unsigned>(__cvta_generic_to_shared(ring_bytes));
  const unsigned slot_bytes = cells * sizeof(T);
  int src[kSlots], bytes[kSlots];
  bool cell[kSlots];
  unsigned dst[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int s = t + m * nt;
    const int r = s / W, c = s - r * W;
    const int gy = y0 - 1 + r, gz = z0 - 1 + c;
    const bool grid = gy >= 0 && gy < Y && gz >= 0 && gz < Z;
    cell[m] = s < cells;
    src[m] = grid ? gy * Z + gz : 0;
    bytes[m] = grid ? static_cast<int>(sizeof(T)) : 0;
    dst[m] = ring0 + s * sizeof(T);
  }
  // copy the chunk's plane q (x = x0 - 1 + q) into ring slot `slot`, as one
  // copy group (empty past the chunk)
  auto stage = [&](int q, int slot) {
    const int p = x0 - 1 + q;
    const bool in = p >= 0 && p < X;
    const T* xp = x + (in ? p * YZ : 0);
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
      copy_async<sizeof(T)>(dst[m] + slot * slot_bytes, xp + src[m], in ? bytes[m] : 0,
                            cell[m] && q < planes);
    copy_commit();
  };
  // plane q: its 3x3 neighbourhood from ring slot q % 3 into hi, the copy of
  // plane q + 2 into the slot of plane q - 1 (which every thread has read
  // before the barrier), and the output of plane q - 1 from the
  // neighbourhoods of planes q - 2, q - 1 and q
  auto step = [&](int q, int slot, T (&lo)[9], T (&mid)[9], T (&hi)[9]) {
    copy_wait<kStages - 2>();  // plane q has landed (q + 1 may be in flight)
    __syncthreads();
    if (inside) {
      const T* plane = ring + slot * cells + at;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) hi[dy * 3 + dz] = plane[dy * W + dz];
    }
    stage(q + 2, slot == 0 ? 2 : slot - 1);
    if (point && q >= 2) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < 9; ++i) acc = fma(k[i], lo[i], acc);
#pragma unroll
      for (int i = 0; i < 9; ++i) acc = fma(k[9 + i], mid[i], acc);
#pragma unroll
      for (int i = 0; i < 9; ++i) acc = fma(k[18 + i], hi[i], acc);
      y[(x0 + q - 2) * YZ + out] = acc;
    }
  };

  // the neighbourhoods of three planes, their roles rotating with q % 3 so
  // that nothing is moved between registers
  T A[9], B[9], C[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    A[i] = T(0);
    B[i] = T(0);
    C[i] = T(0);
  }
  stage(0, 0);
  stage(1, 1);
  for (int q = 0; q < planes; q += 3) {
    step(q, 0, B, C, A);
    if (q + 1 < planes) step(q + 1, 1, C, A, B);
    if (q + 2 < planes) step(q + 2, 2, A, B, C);
  }
}

template <typename T>
int launch(const StencilArgs* a, const void* x, void* y, void* stream) {
  if (a->X <= 0 || a->Y <= 0 || a->Z <= 0) return 0;
  const int cells = (a->tile_y + 2) * (a->tile_z + 2);
  if (a->threads <= 0 || a->threads > kMaxThreads || a->threads % 32 != 0 ||
      a->tile_y * a->tile_z > a->threads || cells > kSlots * a->threads ||
      a->smem < kStages * cells * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  stencil27_kernel<T><<<dim3(a->grid_x, a->grid_y, a->grid_z), a->threads, a->smem,
                        static_cast<cudaStream_t>(stream)>>>(
      *a, static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil27_f32(const StencilArgs* a, const void* x, void* y, void* stream) {
  return launch<float>(a, x, y, stream);
}

extern "C" int stencil27_f64(const StencilArgs* a, const void* x, void* y, void* stream) {
  return launch<double>(a, x, y, stream);
}
