// Hand-written Hopper (sm_90a) kernels for the resample step of the numeric
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
// so neither i0 nor frac is ever written to device memory.  Below p = 1
// the clamp gives i0 = 1, so u[b, i0] is already u[b, 1]: every target
// loads the same two samples, whatever its branch.
//
// The TPU kernel's one-hot lane reductions and hi/lo split existed because
// Mosaic has no float64 and XLA's TPU gather was slow; here each thread
// loads its samples directly.  T is only the storage type of u: the index
// math and the lerp run in float64 for both instantiations, and the output
// is float64.  The arithmetic uses the round-to-nearest intrinsics in the
// plain version's order (multiply, then divide by dkt; no reciprocal, no
// FMA contraction of the lerp), so the kernel agrees with
// resample_kernels.pair_lerp_plain bit for bit.
//
// What bounds it on this card: the float64 output, 8 bytes per target,
// against a sparse read of the table (a row's targets touch a few hundred
// of its thousands of samples) and ~20 float64 operations per target (the
// correctly rounded division among them).  A large call is bound by
// device memory, mostly the write stream, with the instructions that
// issue the gathers close behind; a small one by the latency of one chain
// of two dependent loads.  So two kernels:
// - large calls (the 4,000-row tables, 4.0 M targets): the output is one
//   flat array of rows x nk doubles, written in 16-byte pairs (one
//   st.global.v2.f64 each) whatever the row length; a pair may straddle
//   two rows when nk is odd, its two targets then taking their own row's
//   scale and samples.  A thread owns two pairs, pair i of thread t at
//   i x 256 + t of its block's range, so that each store instruction of a
//   warp writes 512 contiguous bytes; it computes its four positions,
//   issues its eight sample loads and only then lerps and stores, so that
//   its own loads cover each other's latency.  The grid is one wave
//   (blocks per SM from the occupancy API), each block striding over the
//   output.  Indices are 32-bit where they fit, the column of a flat
//   index by a multiply-high with a magic number (no division by nk).
// - small calls (one wave of one-target threads: the kSZ call's 500 x 101,
//   the survey's 2,000 x 101): as many whole rows a block as 256 threads
//   hold, one target a thread on a 2-d block (column, row: no division),
//   loading only the samples its branch reads, so that a row stays in one
//   block and one L1.
// Tried and not kept (PERF.md, PR 12): streaming stores (st.global.cs,
// faster only while the L2 holds the table, not with the L2 flushed);
// loads predicated by branch in the large kernel (more registers, fewer
// blocks per SM); one or two targets a thread of the flat output (slower
// than two pairs on the large tables and than whole rows on the small);
// 128-thread blocks; in the small kernel, the clamp before the first
// load and __launch_bounds__ (kSZ ~1% slower).  Staging each row's
// touched window of u in shared memory was not tried: the window, 16-29%
// of a row on average at the 4,000-row tables, holds more bytes than the
// 32-byte sectors that the gathers read.
//
// The same file holds the Catmull-Rom fill of the serving path
// (hmvec_tpu_torch/pipeline.py: _Grids.resample), catmull_fill_kernel<T>.
// It replaces no TPU kernel (the JAX package fills with jnp gathers): it
// takes the place of four gathers, four multiplies and four adds over the
// fast tier's float64 (B, z, m, k) u cube.  For each row b of y (rows,
// nkq) and target column j of nk, with the four taps (tap_i, tap_w), each
// (4, nk), made once per grid:
//   out[b, j] = (((0 + y[b, i0] w0) + y[b, i1] w1) + y[b, i2] w2)
//               + y[b, i3] w3
// in float64, in that order, each product and sum rounded on its own
// (__dmul_rn, __dadd_rn: no FMA), as the plain version
// (resample_kernels.catmull_fill_plain) computes it, so the two agree bit
// for bit.  T is y's storage (float: B1's u, widened exactly as it is
// read; double: the fused tier's sums).
//
// What bounds it: device memory.  It has to read y once and write the
// float64 output once (at the fast cell's 512,000 x 589 -> 1,001 from
// float32, 1.21 GB and 4.10 GB: 1.58 ms at 3.35 TB/s), against 8 float64
// operations an output.  So:
// - a block takes kFillRows consecutive rows of y, one contiguous span,
//   and copies it into shared memory by cp.async (16-byte pieces where
//   the span is 16-byte aligned), so that the four gathers read shared
//   memory; while the copy is in flight each thread loads the taps of its
//   kFillCols columns j, j + 256, ... into registers, for every row of
//   the block (above 1,024 columns, tiles on gridDim.y); the other
//   resident blocks' copies and stores cover its own.  Where the span would take more than the 48 KB a block has
//   without opting in (nkq over 3,072 float32 or 1,536 float64), the
//   gathers read y in device memory instead, through L1: the four taps of
//   a warp's 32 columns fall in a few neighbouring sectors of a row.
//   Slower at the fast cell's shape (PERF.md, the F1 findings): a one-wave
//   grid striding over the rows with two stages in flight (2.04 ms against
//   1.81), plain loads into shared memory (1.98), each column's taps
//   loaded after the copy (2.07);
// - each store of a warp writes 32 consecutive float64 of a row, with
//   the streaming hint (st.global.cs): the output does not fit in L2 and
//   is not read again by this kernel;
// - row and output offsets are 64-bit (B = 512 on one card gives 2.05 G
//   outputs).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kPairs = 2;      // 16-byte target pairs a thread, large calls

// n / d and n % d for the launch's one divisor d = nk: in 32 bits by a
// multiply-high with a magic number where every flat index is below
// 2^31 (Narrow), else in 64 bits.  For d > 1, m = ceil(2^p / d) with p =
// 31 + ceil(log2 d) gives floor(n m / 2^p) = floor(n / d) for n < 2^31
// (the error n (m - 2^p / d) / 2^p stays below 1/d); d = 1 is n itself.
struct Divisor {
  long long d;
  unsigned magic;
  int shift;
};

Divisor make_divisor(int d) {
  Divisor out{d, 0u, 0};
  if (d > 1) {
    int log2d = 0;
    while ((1LL << log2d) < d) ++log2d;
    const int p = 31 + log2d;
    out.magic = static_cast<unsigned>(((1ULL << p) + d - 1) / d);
    out.shift = p - 32;
  }
  return out;
}

template <bool Narrow>
__device__ __forceinline__ void row_col(long long e, const Divisor& div,
                                        long long& b, long long& j) {
  if (Narrow) {
    const unsigned n = static_cast<unsigned>(e);
    const unsigned q = div.magic ? __umulhi(n, div.magic) >> div.shift : n;
    b = q;
    j = n - q * static_cast<unsigned>(div.d);
  } else {
    b = e / div.d;
    j = e - b * div.d;
  }
}

// The resample of one target at position p in a row of u: only the
// samples its branch reads are loaded (none above Nyquist, u[b, 1] below
// p = 1, before any clamp), which shortens the one chain of a
// latency-bound call.
template <typename T>
__device__ __forceinline__ double lerp_one(const T* __restrict__ row,
                                           double p, int nkt) {
  if (p > static_cast<double>(nkt - 1)) return 0.0;
  if (p < 1.0) return static_cast<double>(__ldg(row + 1));
  // p >= 1, so floor(p) >= 1 and only the upper clamp can act
  const double i0d = fmin(floor(p), static_cast<double>(nkt - 2));
  const int i0 = static_cast<int>(i0d);
  const double u0 = static_cast<double>(__ldg(row + i0));
  const double u1 = static_cast<double>(__ldg(row + i0 + 1));
  return __dadd_rn(u0, __dmul_rn(__dsub_rn(p, i0d), __dsub_rn(u1, u0)));
}

// Small calls (one wave of one-target threads, nk <= 256): whole rows a
// block, thread (x, y) on column x of the block's row y, the block nk
// rounded up to whole warps wide, so that a row's targets and samples stay
// in one block and its SM's L1 and a thread finds its target without a
// division.
template <typename T>
__global__ void pair_lerp_rows_kernel(const T* __restrict__ u,
                                      const double* __restrict__ scales,
                                      const double* __restrict__ ks,
                                      double dkt, double* __restrict__ out,
                                      int nkt, int nk, int rows) {
  const int j = threadIdx.x;
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (j >= nk || b >= rows) return;
  const double p =
      __ddiv_rn(__dmul_rn(__ldg(ks + j), __ldg(scales + b)), dkt);
  out[b * nk + j] = lerp_one(u + b * nkt, p, nkt);
}

// Large calls: the flat output in 16-byte pairs, kPairs pairs a thread.
template <typename T, bool Narrow>
__global__ void __launch_bounds__(kThreads)
    pair_lerp_kernel(const T* __restrict__ u,
                     const double* __restrict__ scales,
                     const double* __restrict__ ks, double dkt,
                     double* __restrict__ out, int nkt, Divisor nk,
                     long long total) {
  // flat indices, row offsets of u and columns in 32 bits where they fit
  using Index = typename std::conditional<Narrow, int, long long>::type;
  constexpr int V = 2 * kPairs;  // targets a thread
  const Index n = static_cast<Index>(total);
  const Index npairs = (n + 1) / 2;
  const Index per_block = kThreads * kPairs;
  const double top = static_cast<double>(nkt - 1);
  const double last = static_cast<double>(nkt - 2);
  for (Index base = static_cast<Index>(blockIdx.x) * per_block;
       base < npairs; base += static_cast<Index>(gridDim.x) * per_block) {
    double p[V], i0d[V], u0[V], u1[V];
    Index off[V];
    bool ok[V];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const Index e =
          2 * (base + i * kThreads + static_cast<Index>(threadIdx.x));
      long long b, j;
      row_col<Narrow>(e, nk, b, j);
      // the pair's second target: the next column, or the next row's
      // first (a pair straddles two rows when nk is odd)
      const bool seam = j + 1 == nk.d;
      ok[2 * i] = e < n;
      ok[2 * i + 1] = e + 1 < n;
      const double s0 = ok[2 * i] ? __ldg(scales + b) : 0.0;
      const double s[2] = {
          s0, seam && ok[2 * i + 1] ? __ldg(scales + b + 1) : s0};
      const double k[2] = {
          ok[2 * i] ? __ldg(ks + j) : 0.0,
          ok[2 * i + 1] ? __ldg(ks + (seam ? 0 : j + 1)) : 0.0};
      const Index row0 = static_cast<Index>(b) * nkt;
      const Index row[2] = {row0, seam ? row0 + nkt : row0};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * i + h;
        p[v] = __ddiv_rn(__dmul_rn(k[h], s[h]), dkt);
        i0d[v] = fmin(fmax(floor(p[v]), 1.0), last);
        off[v] = row[h] + static_cast<int>(i0d[v]);
      }
    }
    // every sample load of the thread in flight before the first lerp;
    // each target loads both samples, whatever its branch (predicating
    // them by branch costs registers, and so occupancy, more than the
    // loads: PERF.md, PR 12)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      u0[v] = ok[v] ? static_cast<double>(__ldg(u + off[v])) : 0.0;
      u1[v] = ok[v] ? static_cast<double>(__ldg(u + off[v] + 1)) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      double val[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 2 * i + h;
        const double frac = __dsub_rn(p[v], i0d[v]);
        const double lerp =
            __dadd_rn(u0[v], __dmul_rn(frac, __dsub_rn(u1[v], u0[v])));
        val[h] = p[v] > top ? 0.0 : (p[v] < 1.0 ? u0[v] : lerp);
      }
      const Index e =
          2 * (base + i * kThreads + static_cast<Index>(threadIdx.x));
      if (ok[2 * i + 1]) {
        *reinterpret_cast<double2*>(out + e) = make_double2(val[0], val[1]);
      } else if (ok[2 * i]) {
        out[e] = val[0];
      }
    }
  }
}

template <typename T>
int launch_pair_lerp(const T* u, const double* scales, const double* ks,
                     double dkt, double* out, int rows, int nkt, int nk,
                     int blocks, int rows_per_block, int device,
                     void* stream) {
  const hmvec::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (reinterpret_cast<std::uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block > 0) {
    const dim3 block((nk + 31) / 32 * 32, rows_per_block);
    if (static_cast<long long>(block.x) * block.y > kThreads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pair_lerp_rows_kernel<T><<<blocks, block, 0, s>>>(u, scales, ks, dkt,
                                                       out, nkt, nk, rows);
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(rows) * nk;
  // every flat index a launch forms, and every offset into u, below 2^31
  const bool narrow =
      total + 2LL * kThreads * kPairs * blocks < (1LL << 31) &&
      static_cast<long long>(rows + 1) * nkt < (1LL << 31);
  const Divisor div = make_divisor(nk);
  if (narrow) {
    pair_lerp_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        u, scales, ks, dkt, out, nkt, div, total);
  } else {
    pair_lerp_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        u, scales, ks, dkt, out, nkt, div, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// resident blocks per SM of the kernel of whole rows a block (rows) or of
// the flat one, at 256 threads a block (the flat kernel's 32-bit
// instantiation, which every launch at the main path's shapes takes)
template <typename T>
int blocks_per_sm(bool rows, int* out) {
  return static_cast<int>(
      rows ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 out, pair_lerp_rows_kernel<T>, kThreads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 out, pair_lerp_kernel<T, true>, kThreads, 0));
}

constexpr int kFillRows = 4;   // rows of y a block
constexpr int kFillCols = 4;   // columns a thread: 1,024 a column tile
constexpr int kFillStagedBytes = 48 * 1024;  // the most a block stages

// Starts the copy of n elements of y at src into shared memory at dst
// (16-byte aligned) by cp.async: in 16-byte pieces where src is 16-byte
// aligned, the rest element by element.
template <typename T>
__device__ __forceinline__ void copy_async(const T* src, T* dst, int n) {
  int done = 0;
  if (reinterpret_cast<std::uintptr_t>(src) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
    const int pieces = n / kPer;
    for (int v = threadIdx.x; v < pieces; v += kThreads) {
      __pipeline_memcpy_async(dst + v * kPer, src + v * kPer, 16);
    }
    done = pieces * kPer;
  }
  for (int e = done + threadIdx.x; e < n; e += kThreads) {
    __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
  }
  __pipeline_commit();
}

// The fill of nr rows of y at src (rows of nkq: shared memory or device
// memory) into out, the first of those rows' outputs, by the taps of the
// thread's columns col.
template <typename T>
__device__ __forceinline__ void fill_rows(const T* src, int nr, int nkq,
                                          const int (&col)[kFillCols],
                                          const int (&idx)[kFillCols][4],
                                          const double (&w)[kFillCols][4],
                                          double* __restrict__ out, int nk) {
  for (int r = 0; r < nr; ++r) {
    const T* row = src + r * nkq;
#pragma unroll
    for (int c = 0; c < kFillCols; ++c) {
      if (col[c] < nk) {
        double acc = 0.0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc = __dadd_rn(acc, __dmul_rn(static_cast<double>(row[idx[c][q]]),
                                         w[c][q]));
        }
        __stcs(out + static_cast<long long>(r) * nk + col[c], acc);
      }
    }
  }
}

// Block (x, y) fills rows [x kFillRows, x kFillRows + nr) in column tile y,
// from a copy of the rows in shared memory where `staged`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    catmull_fill_kernel(const T* __restrict__ y,
                        const int* __restrict__ tap_i,
                        const double* __restrict__ tap_w,
                        double* __restrict__ out, long long rows, int nkq,
                        int nk, int staged) {
  extern __shared__ __align__(16) unsigned char fill_smem[];
  const long long r0 = static_cast<long long>(blockIdx.x) * kFillRows;
  const int nr = static_cast<int>(
      min(static_cast<long long>(kFillRows), rows - r0));
  const T* src = y + r0 * nkq;
  double* dst = out + r0 * nk;
  T* stage = reinterpret_cast<T*>(fill_smem);
  if (staged) copy_async(src, stage, nr * nkq);
  int col[kFillCols], idx[kFillCols][4];
  double w[kFillCols][4];
#pragma unroll
  for (int c = 0; c < kFillCols; ++c) {
    col[c] = (static_cast<int>(blockIdx.y) * kFillCols + c) * kThreads +
             static_cast<int>(threadIdx.x);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // an index outside [0, nkq) (the taps' contract) reads the row's
      // nearest end, never past the rows
      idx[c][q] = col[c] < nk
                      ? min(max(__ldg(tap_i + q * nk + col[c]), 0), nkq - 1)
                      : 0;
      w[c][q] = col[c] < nk ? __ldg(tap_w + q * nk + col[c]) : 0.0;
    }
  }
  if (staged) {
    __pipeline_wait_prior(0);
    __syncthreads();
    fill_rows(static_cast<const T*>(stage), nr, nkq, col, idx, w, dst, nk);
  } else {
    fill_rows(src, nr, nkq, col, idx, w, dst, nk);
  }
}

template <typename T>
int launch_catmull_fill(const T* y, const int* tap_i, const double* tap_w,
                        double* out, long long rows, int nkq, int nk,
                        int device, void* stream) {
  const hmvec::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (rows <= 0 || nk <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (rows + kFillRows - 1) / kFillRows;
  const int tiles = (nk + kFillCols * kThreads - 1) / (kFillCols * kThreads);
  if (nkq < 1 || blocks > 0x7fffffffLL || tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t span = static_cast<size_t>(kFillRows) * nkq * sizeof(T);
  const int staged = span <= kFillStagedBytes;
  catmull_fill_kernel<T>
      <<<dim3(static_cast<unsigned>(blocks), tiles), kThreads,
         staged ? span : 0, static_cast<cudaStream_t>(stream)>>>(
          y, tap_i, tap_w, out, rows, nkq, nk, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launch function launches on `stream` (PyTorch's current stream),
// does not synchronise, and returns the cudaError_t of the launch (0 on
// success).  u is (rows, nkt), scales (rows,), ks (nk,), out (rows, nk), all
// contiguous, out 16-byte aligned.  With rows_per_block > 0, `blocks`
// blocks of rows_per_block whole rows, one target a thread (nk rounded up
// to whole warps, times rows_per_block, at most 256 threads); else
// `blocks` blocks of 256 threads, each two pairs of targets of the flat
// output per pass of its block's stride (resample_kernels.
// pair_lerp_geometry chooses both).

int hmvec_pair_lerp_f64(const double* u, const double* scales,
                        const double* ks, double dkt, double* out, int rows,
                        int nkt, int nk, int blocks, int rows_per_block,
                        int device, void* stream) {
  return launch_pair_lerp<double>(u, scales, ks, dkt, out, rows, nkt, nk,
                                  blocks, rows_per_block, device, stream);
}

int hmvec_pair_lerp_f32(const float* u, const double* scales,
                        const double* ks, double dkt, double* out, int rows,
                        int nkt, int nk, int blocks, int rows_per_block,
                        int device, void* stream) {
  return launch_pair_lerp<float>(u, scales, ks, dkt, out, rows, nkt, nk,
                                 blocks, rows_per_block, device, stream);
}

// Resident blocks per SM of the kernel of whole rows (rows != 0) or the
// flat one for float32 (f32 != 0) or float64 storage, into *out; returns
// the cudaError_t.
int hmvec_pair_lerp_blocks_per_sm(int f32, int rows, int device, int* out) {
  const hmvec::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  return f32 ? blocks_per_sm<float>(rows != 0, out)
             : blocks_per_sm<double>(rows != 0, out);
}

// The Catmull-Rom fill of y (rows, nkq), float32 or float64, into out
// (rows, nk) float64 by the taps tap_i (4, nk) int32, every index in [0,
// nkq), and tap_w (4, nk) float64, all contiguous: a block of 256 threads
// for each 4 rows and 1,024 columns; returns the cudaError_t.
int hmvec_catmull_fill_f32(const float* y, const int* tap_i,
                           const double* tap_w, double* out, long long rows,
                           int nkq, int nk, int device, void* stream) {
  return launch_catmull_fill<float>(y, tap_i, tap_w, out, rows, nkq, nk,
                                    device, stream);
}

int hmvec_catmull_fill_f64(const double* y, const int* tap_i,
                           const double* tap_w, double* out, long long rows,
                           int nkq, int nk, int device, void* stream) {
  return launch_catmull_fill<double>(y, tap_i, tap_w, out, rows, nkq, nk,
                                     device, stream);
}

}  // extern "C"
