// Hand-written Hopper (sm_90a) kernel for the resample step of the numeric
// profile transform (hmvec_tpu_torch/ops/sine_transform.py:
// resample_uniform_source), with a plain C interface for ctypes
// (hmvec_tpu_torch/kernels/_build.py builds it with nvcc; the Python
// wrappers are in hmvec_tpu_torch/ops/resample_kernels.py).
//
// Replaces hmvec_tpu/ops/pallas_resample.py:select_pairs -- the kernels
// _select_pair_kernel (float64 u through hi/lo float32 pairs, T = double)
// and _select_pair_kernel_f32 (T = float) -- and fuses what XLA did around
// them in sine_transform.resample_uniform_source: the index math, the lerp
// and the two boundary selects.  For each row b of u (B, nkt) and target
// k_j:
//   p    = k_j s_b / dkt
//   i0   = clamp(floor(p), 1, nkt - 2),  frac = p - i0
//   val  = u[b, i0] + frac (u[b, i0 + 1] - u[b, i0])
//   val  = u[b, 1]  where p < 1         (flat below the first kt > 0)
//   val  = 0        where p > nkt - 1   (zero above Nyquist)
// so neither i0 nor frac is ever written to device memory.
//
// The TPU kernel's one-hot lane reductions and hi/lo split existed because
// Mosaic has no float64 and XLA's TPU gather was slow; here each thread
// loads its two samples directly.  T is only the storage type of u: the
// index math and the lerp run in float64 for both instantiations, and the
// output is float64.  The arithmetic uses the round-to-nearest intrinsics
// in the plain version's order (multiply, then divide by dkt; no FMA
// contraction of the lerp), so the kernel agrees with
// resample_kernels.pair_lerp_plain bit for bit.
//
// What bounds it on this card: a few float64 operations per output
// element against 8 bytes written and two samples read, so device memory
// bandwidth.  This first version is the simple one: one thread per output
// element, rows on gridDim.x (the kSZ paths bring batches of ~1,000 masses
// per redshift), 256 targets per block along gridDim.y, read-only cached
// loads; the samples a warp touches are neighbours in one row, since the
// targets are sorted.  Staging each row's touched window in shared memory
// and vector loads are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // targets per block

template <typename T>
__global__ void pair_lerp_kernel(const T* __restrict__ u,
                                 const double* __restrict__ scales,
                                 const double* __restrict__ ks, double dkt,
                                 double* __restrict__ out, int nkt, int nk) {
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= nk) return;
  const long long b = blockIdx.x;
  const T* row = u + b * nkt;
  const double p = __ddiv_rn(__dmul_rn(__ldg(ks + j), __ldg(scales + b)), dkt);
  double val;
  if (p > static_cast<double>(nkt - 1)) {
    val = 0.0;
  } else if (p < 1.0) {
    val = static_cast<double>(__ldg(row + 1));
  } else {
    // p >= 1, so floor(p) >= 1 and only the upper clamp can act
    const double i0d = fmin(floor(p), static_cast<double>(nkt - 2));
    const int i0 = static_cast<int>(i0d);
    const double frac = __dsub_rn(p, i0d);
    const double u0 = static_cast<double>(__ldg(row + i0));
    const double u1 = static_cast<double>(__ldg(row + i0 + 1));
    val = __dadd_rn(u0, __dmul_rn(frac, __dsub_rn(u1, u0)));
  }
  out[b * nk + j] = val;
}

template <typename T>
int launch_pair_lerp(const T* u, const double* scales, const double* ks,
                     double dkt, double* out, int rows, int nkt, int nk,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(rows, (nk + kThreads - 1) / kThreads);
  pair_lerp_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, scales, ks, dkt, out, nkt, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each function launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
// u is (rows, nkt), scales (rows,), ks (nk,), out (rows, nk), all
// contiguous; the wrapper checks rows <= 2^31 - 1 and the grid's y limit.

int hmvec_pair_lerp_f64(const double* u, const double* scales,
                        const double* ks, double dkt, double* out, int rows,
                        int nkt, int nk, int device, void* stream) {
  return launch_pair_lerp<double>(u, scales, ks, dkt, out, rows, nkt, nk,
                                  device, stream);
}

int hmvec_pair_lerp_f32(const float* u, const double* scales,
                        const double* ks, double dkt, double* out, int rows,
                        int nkt, int nk, int device, void* stream) {
  return launch_pair_lerp<float>(u, scales, ks, dkt, out, rows, nkt, nk,
                                 device, stream);
}

}  // extern "C"
