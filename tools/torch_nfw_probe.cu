// Probe kernels for tools/measure_torch_nfw.py, never linked into the
// port's library: hmvec::nfw_u (hmvec_tpu_torch/csrc/nfw_u.cuh) with the
// Si/Ci domains of x and x2 fixed at compile time, one element per thread,
// so that each probe's SASS is the path that an element with x and x2 in
// those two domains runs.  x2 = (1+c) x > x, so D2 >= D1.

#include "nfw_u.cuh"

template <typename T, int D1, int D2>
__global__ void nfw_u_probe(const double* __restrict__ ks,
                            hmvec::RowConst<T> r, T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  out[j] = hmvec::nfw_u<T, D1, D2>(ks[j], r);
}

#define PROBE(T, D1, D2)                                                  \
  template __global__ void nfw_u_probe<T, D1, D2>(const double*,          \
                                                   hmvec::RowConst<T>, T*);
#define PROBES(T)                                                         \
  PROBE(T, 0, 0) PROBE(T, 0, 1) PROBE(T, 0, 2) PROBE(T, 0, 3)             \
  PROBE(T, 1, 1) PROBE(T, 1, 2) PROBE(T, 1, 3) PROBE(T, 2, 2)             \
  PROBE(T, 2, 3) PROBE(T, 3, 3)

PROBES(float)
PROBES(double)
