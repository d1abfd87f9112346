// What the window kernels share: the deterministic scatter phase that sums
// a block's local results into its output window (winstiff.cu's
// winstiff_p1_2d), and the dispatch on the local-dof count NL (winmass.cu,
// winform.cu). The cluster kernels (winstiff.cu's other variants, winmass,
// winform) sum in the same order from the cluster's shared memory instead
// (wincluster.cuh).
//
// The scatter lists (rowptr [W + 1], ent [C*NL] of block b) are built on the
// host by attic/window.py::build_scatter_lists: for window dof w, the
// entries ent[rowptr[w]:rowptr[w + 1]] are the offsets c*NL + i of the
// (cell, local dof) pairs that land on w, in ascending order. Summing along
// them is a fixed order, so an apply is bitwise repeatable (no atomics).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// out_b[w] = sum of loc[ent[p]] over p in [rowptr[w], rowptr[w + 1]), each
// thread of the block taking window dofs in turn. The caller has written
// loc (shared memory or the block's rows of a device scratch) and passed a
// __syncthreads(), which also makes the block's global writes visible.
__device__ __forceinline__ void scatter_window(const float* loc, const int* rowptr,
                                               const int* ent, float* out_b, int W) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float acc = 0.f;
    for (int p = rowptr[w]; p < rowptr[w + 1]; ++p) acc += loc[ent[p]];
    out_b[w] = acc;
  }
}

// Calls launch(std::integral_constant<int, NL>{}) for the local-dof counts
// the window kernels are instantiated for: P1 and P2 on triangles (3, 6) and
// tets (4, 10). Returns launch's cudaError_t, or cudaErrorInvalidValue for
// any other NL.
template <typename Launch>
int dispatch_nl(int NL, Launch&& launch) {
  switch (NL) {
    case 3: return launch(std::integral_constant<int, 3>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 6: return launch(std::integral_constant<int, 6>{});
    case 10: return launch(std::integral_constant<int, 10>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
