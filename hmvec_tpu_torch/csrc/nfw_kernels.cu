// Hand-written Hopper (sm_90a) kernels for the NFW profile stage of the
// config-1 Pmm pipeline, with a plain C interface for ctypes
// (hmvec_tpu_torch/kernels/_build.py builds this file with nvcc; the
// Python wrappers are in hmvec_tpu_torch/ops/nfw_kernels.py).
//
// What bounds them on this card.  Each output element costs two sin/cos,
// two pairs of series (or asymptotic tails) for Si/Ci and the assembly: a
// hundred and more instructions against 4 or 8 bytes written, so memory is
// far from the limit.  Nor are the flops: counted over the data sheet's
// peaks they come to a third of the kernels' time.  What the kernels run
// into is instruction issue (four warp-instructions per SM per clock),
// since compares, selects, conversions, reciprocals and branches take an
// issue slot each, as an FMA does.  So the design cuts instructions per
// element (nfw_u.cuh): a branch per Si/Ci argument into a body compiled
// for its domain, its series evaluated by Horner with every coefficient an
// immediate or constant-bank operand, and no series where the asymptotic
// tail is used; one reciprocal per argument in place of the divisions; in
// both tiers, sin/cos polynomials on a phase reduced to its quadrant in
// float64, and in the float64 tier, whose pipe issues at half rate, each
// series cut at its table's noise floor and a reciprocal from the
// hardware's seed.  The per-row constants (s2, ln(1+c), 1/F(c)) are computed
// once per row in the kernel, in float64, into a shared-memory row cache,
// so a wrapper call is one launch.  PERF.md gives each kernel's time
// beside its bound and its issue floor (tools/measure_torch_nfw.py).

#include <cuda_runtime.h>

#include "nfw_u.cuh"

namespace {

using hmvec::RowConst;

constexpr int kUkK = 32;     // k per warp: a warp is 32 neighbouring k
constexpr int kUkRows = 8;   // rows per block, one warp each
constexpr int kUkTiles = 4;  // k tiles of 32 per block, looped by each warp

// Replaces hmvec_tpu/ops/pallas_kernels.py:nfw_uk_pallas (kernel
// _nfw_uk_kernel, tile math _nfw_u_tile) for T = float, and
// nfw_uk_pallas_ds (kernel _nfw_uk_kernel_ds, math _nfw_uk_ds_math) for
// T = double.  A block holds kUkRows rows and kUkTiles * 32 k; the first
// warp fills the block's row cache, then each warp walks its row's k tiles,
// one output element per thread and tile, so a warp stores 32 neighbouring
// outputs.  The ragged edges are masked.  Rows ride on gridDim.x (up to
// 2^31 - 1 blocks), so a batch of cosmologies folded into the rows is one
// launch; the k blocks ride on gridDim.y.
template <typename T>
__global__ void __launch_bounds__(kUkK * kUkRows)
nfw_uk_kernel(const double* __restrict__ ks, const double* __restrict__ scales,
              const double* __restrict__ cs, T* __restrict__ out, int nrows,
              int nk) {
  __shared__ RowConst<T> rows[kUkRows];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = blockIdx.x * kUkRows;
  if (ty == 0 && tx < kUkRows && row0 + tx < nrows)
    rows[tx] = hmvec::row_constants<T>(scales[row0 + tx], cs[row0 + tx]);
  __syncthreads();
  const int i = row0 + ty;
  if (i >= nrows) return;
  const RowConst<T> r = rows[ty];
  T* dst = out + static_cast<long long>(i) * nk;
  const int j0 = blockIdx.y * kUkK * kUkTiles;
  const int j_end = min(nk, j0 + kUkK * kUkTiles);
  for (int j = j0 + tx; j < j_end; j += kUkK) dst[j] = hmvec::nfw_u<T>(ks[j], r);
}

constexpr int kContractK = 32;  // k per block: one warp wide
constexpr int kContractM = 8;   // m slices per block, one warp each
constexpr int kRowChunk = 64;   // rows per fill of the row cache
constexpr int kContractMinBlocks = 5;  // resident blocks per SM

// Replaces hmvec_tpu/ops/pallas_kernels.py:nfw_contract_pallas (kernel
// _nfw_contract_kernel): u(k) reduced on the spot to
//   S1(z, k) = sum_m a_zm u^2,   S2(z, k) = sum_m b_zm u,
// so the (z, m, k) cube is never written.  u is the float32 tier's
// nfw_u<float> (the TPU kernel's own tile precision, and what the JAX
// fused path asks for); both sums are kept in float64.
//
// One block per (z, 32-k tile) caches the z's row constants and weights in
// shared memory, kRowChunk rows at a time, and its kContractM warps walk
// them two rows at a time (two independent u evaluations per iteration).
// The first warp then sums the warps' partials in a fixed order through
// shared memory and stores.  One launch, no atomics, the same bits on
// every run.  The TPU's one-hot weight matrices (pallas_kernels.py:277-284)
// only worked around Mosaic's (8, 128) output tiles and have no
// counterpart here.
//
// The grid runs in one wave: kContractMinBlocks holds the kernel to at
// most 48 registers, so that at least 5 blocks of 256 threads stay
// resident per SM (660 on 132 SMs), and config 1's 20 z x 32 k tiles = 640
// blocks all run at once, with no tail wave.  (It compiles to 40
// registers on sm_90a: 6 blocks per SM, 640 of 792 slots.)
__global__ void __launch_bounds__(kContractK * kContractM, kContractMinBlocks)
nfw_contract_kernel(const double* __restrict__ ks,
                    const double* __restrict__ scales,
                    const double* __restrict__ cs, const double* __restrict__ a,
                    const double* __restrict__ b, double* __restrict__ s1,
                    double* __restrict__ s2, int nm, int nk) {
  __shared__ RowConst<float> rows[kRowChunk];
  __shared__ double wa[kRowChunk], wb[kRowChunk];
  __shared__ double part1[kContractM][kContractK];
  __shared__ double part2[kContractM][kContractK];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kContractK + tx;
  const int j = blockIdx.x * kContractK + tx;
  const int z = blockIdx.y;
  const double k = j < nk ? ks[j] : 0.0;

  double acc1 = 0.0, acc2 = 0.0;
  for (int m0 = 0; m0 < nm; m0 += kRowChunk) {
    const int n = min(kRowChunk, nm - m0);
    if (tid < n) {
      const long long row = static_cast<long long>(z) * nm + m0 + tid;
      rows[tid] = hmvec::row_constants<float>(scales[row], cs[row]);
      wa[tid] = a[row];
      wb[tid] = b[row];
    }
    __syncthreads();
    if (j < nk) {
      for (int q = ty; q < n; q += 2 * kContractM) {
        const int q2 = q + kContractM;
        const double u = hmvec::nfw_u<float>(k, rows[q]);
        const double u2 = q2 < n ? hmvec::nfw_u<float>(k, rows[q2]) : 0.0;
        acc1 += wa[q] * (u * u);
        acc2 += wb[q] * u;
        if (q2 < n) {
          acc1 += wa[q2] * (u2 * u2);
          acc2 += wb[q2] * u2;
        }
      }
    }
    __syncthreads();
  }

  part1[ty][tx] = acc1;
  part2[ty][tx] = acc2;
  __syncthreads();
  if (ty == 0 && j < nk) {
    double t1 = 0.0, t2 = 0.0;
#pragma unroll
    for (int w = 0; w < kContractM; ++w) {
      t1 += part1[w][tx];
      t2 += part2[w][tx];
    }
    s1[static_cast<long long>(z) * nk + j] = t1;
    s2[static_cast<long long>(z) * nk + j] = t2;
  }
}

dim3 uk_grid(int nrows, int nk) {
  return dim3((nrows + kUkRows - 1) / kUkRows,
              (nk + kUkK * kUkTiles - 1) / (kUkK * kUkTiles));
}

dim3 contract_grid(int nz, int nk) {
  return dim3((nk + kContractK - 1) / kContractK, nz);
}

template <typename T>
int launch_nfw_uk(const double* ks, const double* scales, const double* cs,
                  T* out, int nrows, int nk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nfw_uk_kernel<T><<<uk_grid(nrows, nk), dim3(kUkK, kUkRows), 0,
                     static_cast<cudaStream_t>(stream)>>>(ks, scales, cs, out,
                                                          nrows, nk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each function launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
// scales = r_s (1+z) and cs are per row (nrows, or nz x nm row-major).

int hmvec_nfw_uk_f64(const double* ks, const double* scales, const double* cs,
                     double* out, int nrows, int nk, int device, void* stream) {
  return launch_nfw_uk<double>(ks, scales, cs, out, nrows, nk, device, stream);
}

int hmvec_nfw_uk_f32(const double* ks, const double* scales, const double* cs,
                     float* out, int nrows, int nk, int device, void* stream) {
  return launch_nfw_uk<float>(ks, scales, cs, out, nrows, nk, device, stream);
}

int hmvec_nfw_contract(const double* ks, const double* scales, const double* cs,
                       const double* a, const double* b, double* s1,
                       double* s2, int nz, int nm, int nk, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nfw_contract_kernel<<<contract_grid(nz, nk), dim3(kContractK, kContractM),
                        0, static_cast<cudaStream_t>(stream)>>>(
      ks, scales, cs, a, b, s1, s2, nm, nk);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts of kernel `which` (0 nfw_uk f32, 1 nfw_uk f64, 2
// nfw_contract) on `device`, for nrows rows (nfw_uk) or nz x nm rows
// (nfw_contract; nrows is then nz) and nk k: info[0] registers per thread,
// info[1] local (stack) bytes per thread, info[2] static shared bytes per
// block, info[3] threads per block, info[4] resident blocks per SM,
// info[5] blocks in the launch.  An occupancy query the runtime refuses
// leaves -1 (and its error is cleared, so that no later launch reports
// it).  Returns the cudaError_t of reading the attributes (0 on success).
int hmvec_nfw_kernel_info(int which, int device, int nrows, int nk, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool contract = which == 2;
  const void* fn = which == 0   ? reinterpret_cast<const void*>(nfw_uk_kernel<float>)
                   : which == 1 ? reinterpret_cast<const void*>(nfw_uk_kernel<double>)
                                : reinterpret_cast<const void*>(nfw_contract_kernel);
  const dim3 block = contract ? dim3(kContractK, kContractM) : dim3(kUkK, kUkRows);
  const dim3 grid = contract ? contract_grid(nrows, nk) : uk_grid(nrows, nk);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(block.x * block.y);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4], fn, info[3], 0) !=
      cudaSuccess) {
    info[4] = -1;
    cudaGetLastError();
  }
  info[5] = static_cast<int>(grid.x * grid.y);
  return 0;
}

}  // extern "C"
