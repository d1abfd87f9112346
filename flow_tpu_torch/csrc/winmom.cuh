// The fixed arguments of a launch of the window momentum kernels (K3:
// winmom.cu in 2-D, winmom3d.cu in 3-D), in the layout of the ctypes
// Structure attic/winmom.py::_WinmomArgs: the tables' pointers, the layout
// and the cluster launch. The caller keeps one per variant and layout, so
// that a call passes the struct, x, the three weights, the output and the
// stream.
#pragma once

struct WinmomArgs {
  const int* lidx;     // [nb, NL, C]
  const float* valid;  // [nb, C]
  const float* detj;   // [nb, C]
  const float* g4;     // [nb, DIM*DIM, C]
  const float* cg4;    // [nb, DIM*DIM, C]
  const float* tq;     // [nb, DIM*NQ, C], the transport (the state, Newton)
  const float* gu;     // [nb, DIM*DIM*NQ, C], the state's gradients (Newton)
  const float* tabs;   // the small tables (attic/winmom.py::smem_tables)
  const int* rptr;     // [nb, R + 1], the compressed rows' list positions
  const int* rows;     // [nb, R], the compressed rows, padded with W
  const int* pos;      // [nb, NL*C], the lists' inverse
  int nb, S, W, C, R, n_pad;
  int clusters, cl, threads, cap;  // the cluster launch
};
