// Normalized truncated-NFW u(k | z, m) for one (row, k) element, on Hopper.
//
// Device-side counterpart of hmvec_tpu_torch.models.profiles.nfw_uk_x
// (itself a port of hmvec_tpu/models/profiles.py:nfw_uk_x), with the Si/Ci
// of ops/special.sici_with_trig inlined.  Si/Ci take one branch per
// argument on its domain (x <= 4, 4 < x <= 10, 10 < x <= 40, x > 40) into a
// body compiled for that domain alone: the domain's two Chebyshev series,
// as polynomials in the Chebyshev variable t evaluated by Horner (one FMA
// per term, each coefficient a compile-time constant: an immediate or a
// constant-bank load at a fixed offset, never an indexed load), or, above
// 40, the
// asymptotic f/g tail and no series.  The coefficients come from
// sici_coeffs.cuh, which kernels/_build.py converts at build time from the
// Chebyshev tables of hmvec_tpu_torch/ops/_sici_coeffs.py.  The callers'
// warps are 32 neighbouring k of one row, so x is monotone across a warp
// and only the warps that straddle a domain edge run two bodies.
//
// T = double is the exact tier, designed for the float64 pipe, which issues
// at half the rate of the others: every operation in float64, each series
// to the noise floor of its table (12, 17 and 15 terms by domain), the
// 13-term tail, sin/cos as polynomials on a phase reduced with a two-part
// pi/2, the reciprocal as the hardware's seed and two Newton steps, and no
// call into the math library but the one log of the mixed branch.
// T = float is the fast tier: the phases x = k s1 and (1+c)x = k s2 are
// formed and reduced to a quadrant in float64, the reduced phase r in
// [-pi/4, pi/4] goes to float32, and sin/cos, the 16-term series, the
// 7-term tail and the assembly run in float32.  This replaces the TPU's
// double-single machinery (pallas_kernels.py _two_prod/_ds_*), which
// existed only because Pallas on the TPU has no float64.
//
// Divisions: one reciprocal per argument (v = 1/x, shared by the Chebyshev
// variable, f = A v, g = B v^2, the tail's y = v^2 and sin(cx)/x2), and the
// constant spans of the Chebyshev variable as multiplications by their
// reciprocals.  These, and the polynomial form of the series, move results
// in the last bits only.
//
// The difference forms of the TPU kernel (pallas_kernels.py:_nfw_u_tile)
// are kept, since at float32 width the large constants would otherwise
// cancel:
//   Si(x2) - Si(x)  = (f1 cos x + g1 sin x) - (f2 cos x2 + g2 sin x2)
//                     when x > 4 (both in the auxiliary branch; the pi/2
//                     constants cancel analytically);
//   Ci(x2) - Ci(x)  = ln(1+c) + (B2 - B1) when x2 <= 4 (both in the
//                     series branch; ln x2 - ln x = ln(1+c) exactly).
#pragma once

#include <cuda_runtime.h>

#include "sici_coeffs.cuh"

namespace hmvec {

template <typename T> struct Prec;

// Constants of Prec<double>::sincos_phase, in constant memory: a float64
// constant is no immediate of its FMA (the instruction holds 32 bits), so
// written as a literal it costs two integer moves, while from constant
// memory at a fixed offset it costs one uniform load, off the integer pipe.
// 2/pi; pi/2 = hi + lo; the fdlibm minimax coefficients of
// (sin r - r) / r^3 and (cos r - 1 + r^2/2) / r^4 in z = r^2, highest first.
static __constant__ double kTwoOverPi = 0.6366197723675814;
static __constant__ double kPio2Hi = 1.5707963267948966;
static __constant__ double kPio2Lo = 6.123233995736766e-17;
static __constant__ double kSinPoly[6] = {
    1.58969099521155010221e-10, -2.50507602534068634195e-08,
    2.75573137070700676789e-06, -1.98412698298579493134e-04,
    8.33333333332248946124e-03, -1.66666666666666324348e-01};
static __constant__ double kCosPoly[6] = {
    -1.13596475577881948265e-11, 2.08757232129817482790e-09,
    -2.75573143513906633035e-07, 2.48015872894767294178e-05,
    -1.38888888888741095749e-03, 4.16666666666666019037e-02};

template <> struct Prec<double> {
  static constexpr double tiny = 1e-300;
  // Only the assembly's branch x <= 4 < x2 takes a log (a tenth of
  // config 1's elements), so the math library's is kept.
  __device__ static __forceinline__ double log(double x) { return ::log(x); }
  // 1/x from the hardware's seed (MUFU.RCP64H, about 20 bits) and two
  // Newton steps y += y (1 - x y) with the residual from one FMA each:
  // within an ulp or two, without the IEEE-rounded reciprocal's range
  // checks and slow path.  x >= 1e-300 is never subnormal, and neither is
  // 1/x below x = 2^1022.
  __device__ static __forceinline__ double rcp(double x) {
    double y;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
    y = fma(y, fma(-x, y, 1.0), y);
    return fma(y, fma(-x, y, 1.0), y);
  }
  // v with its sign flipped where bit 31 of `bits` is set
  __device__ static __forceinline__ double flip_sign(double v, unsigned bits) {
    return __hiloint2double(__double2hiint(v) ^ static_cast<int>(bits & 0x80000000u),
                            __double2loint(v));
  }
  // sin and cos of a float64 phase in float64, without the math library:
  // n = x 2/pi rounded to an integer (by adding 1.5 * 2^52, whose sum holds
  // n in its low word, so the quadrant needs no 64-bit conversion), then
  // r = x - n pi/2 with pi/2 = hi + lo to 107 bits and one FMA for each
  // part (Cody-Waite; the FMA keeps x - n hi exact up to its one rounding),
  // so that r in [-pi/4, pi/4] is good to ~1e-16 whatever n; then the
  // fdlibm minimax polynomials of sin (to r^13) and cos (to r^14) on that
  // interval (error < 2^-57), swapped and negated by quadrant.  Valid for
  // 0 <= x < 2^51 quadrants (the sum must hold n exactly); sin and cos stay
  // within 1.2e-16 of the library's up to x = 1e12, far above any phase
  // k (1+c) r_s (1+z) that float64 can carry to the exact tier's accuracy
  // (at x = 1e9 one ulp of x is already 1.2e-7 rad).
  __device__ static __forceinline__ void sincos_phase(double x, double* s, double* c) {
    constexpr double kRound = 6755399441055744.0;  // 1.5 * 2^52
    const double big = fma(x, kTwoOverPi, kRound);
    const double n = big - kRound;
    const unsigned q = static_cast<unsigned>(__double2loint(big));
    const double r = fma(-n, kPio2Lo, fma(-n, kPio2Hi, x));
    const double z = r * r;
    double ps = kSinPoly[0], pc = kCosPoly[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      ps = fma(ps, z, kSinPoly[i]);
      pc = fma(pc, z, kCosPoly[i]);
    }
    const double sr = fma(z * r, ps, r);
    const double cr = fma(fma(pc, z, -0.5), z, 1.0);
    const bool odd = q & 1u;
    *s = flip_sign(odd ? cr : sr, q << 30);
    *c = flip_sign(odd ? sr : cr, (q + 1) << 30);
  }
};

template <> struct Prec<float> {
  static constexpr float tiny = 1e-30f;
  __device__ static __forceinline__ float log(float x) { return ::logf(x); }
  // the hardware reciprocal alone (MUFU.RCP, within 1 ulp), without the
  // IEEE-rounded reciprocal's range checks and slow path: x >= 1e-30 is
  // never subnormal, and neither is 1/x below x = 2^126
  __device__ static __forceinline__ float rcp(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  }
  // The float64 phase is reduced to its quadrant in float64, n = x 2/pi
  // rounded to an integer and r = x - n pi/2 (error ~ n * 6e-17: ~2e-12 rad
  // at the largest phases, ~4e4), so float32 sees r in [-pi/4, pi/4] only
  // and needs no range reduction of its own; sin r and cos r are the Cephes
  // sinf/cosf minimax polynomials on that interval (error < 1e-7), swapped
  // and negated by quadrant.  n is rounded by adding and subtracting
  // 1.5 * 2^52, whose sum holds n in its low bits, so that the float64
  // pipe does the rounding and the quadrant needs no conversion (a 64-bit
  // conversion issues at a quarter of the float64 rate).
  __device__ static __forceinline__ void sincos_phase(double x, float* s, float* c) {
    constexpr double kRound = 6755399441055744.0;  // 1.5 * 2^52
    const double big = fma(x, 0.6366197723675814, kRound);  // 2 / pi
    const double n = big - kRound;
    const float r = static_cast<float>(fma(-n, 1.5707963267948966, x));
    const int q = __double2loint(big);
    const float r2 = r * r;
    const float ps = fmaf(fmaf(-1.9515295891e-4f, r2, 8.3321608736e-3f), r2,
                          -1.6666654611e-1f);
    const float pc = fmaf(fmaf(2.443315711809948e-5f, r2, -1.388731625493765e-3f),
                          r2, 4.166664568298827e-2f);
    const float sr = fmaf(ps * r2, r, r);
    const float cr = fmaf(fmaf(pc, r2, -0.5f), r2, 1.0f);
    float sv = (q & 1) ? cr : sr;
    float cv = (q & 1) ? sr : cr;
    *s = (q & 2) ? -sv : sv;
    *c = ((q + 1) & 2) ? -cv : cv;
  }
};

// The two numbers Si/Ci hand to the assembly: in the series domain
// (x <= 4) p = A = Si(x)/x and q = B = Ci(x) - gamma - ln x; above it
// p = f and q = g, the auxiliaries of Si = pi/2 - f cos x - g sin x and
// Ci = f sin x - g cos x.
template <typename T> struct SiciParts {
  T p, q;
};

// sum_{k >= K} c_k t^(k - K) for the two series of domain D, by Horner;
// the coefficients are read at compile-time indices, so each is an
// immediate of its FMA (float) or one constant-bank load (double).
template <typename T, int D, int K = 0>
__device__ __forceinline__ SiciParts<T> series(T t) {
  using S = SiciTables<T>;
  const T ca = S::template coef<0, D, K>();
  const T cb = S::template coef<1, D, K>();
  if constexpr (K == S::len[D] - 1) {
    return {ca, cb};
  } else {
    const SiciParts<T> h = series<T, D, K + 1>(t);
    return {h.p * t + ca, h.q * t + cb};
  }
}

// sum_{n >= N} c_n y^(n - N) for the asymptotic tails of f and g.
template <typename T, int N = 0>
__device__ __forceinline__ SiciParts<T> asymptotic(T y) {
  using S = SiciTables<T>;
  const T cf = S::template asy<0, N>();
  const T cg = S::template asy<1, N>();
  if constexpr (N == S::nasy - 1) {
    return {cf, cg};
  } else {
    const SiciParts<T> h = asymptotic<T, N + 1>(y);
    return {h.p * y + cf, h.q * y + cg};
  }
}

// Si/Ci parts of x (> 0) in domain D, with v = 1/x; the arithmetic of
// ops/special.py:sici_with_trig up to the reciprocals and the series'
// polynomial form.
template <typename T, int D>
__device__ __forceinline__ SiciParts<T> sici_domain(T x, T v) {
  if constexpr (D == 0) {
    // t = 2 (x/4)^2 - 1.  In float64, whose pipe sets the pace, as one
    // product and one FMA: the scalings by powers of two round nothing, so
    // the bits are those of the three-operation form.
    if constexpr (sizeof(T) == sizeof(double)) {
      return series<T, 0>(fma(x * x, T(0.125), T(-1)));
    } else {
      const T q = x * T(0.25);
      return series<T, 0>(T(2) * (q * q) - T(1));
    }
  } else if constexpr (D == 3) {
    const T y = v * v;
    const SiciParts<T> fg = asymptotic<T>(y);
    return {fg.p * v, fg.q * y};
  } else {
    // Chebyshev variable of v on [lo, hi] = [1/10, 1/4] or [1/40, 1/10]
    constexpr T lo = D == 1 ? T(0.1) : T(0.025);
    constexpr T hi = D == 1 ? T(0.25) : T(0.1);
    constexpr T mid = lo + hi;
    constexpr T rspan = T(1) / (hi - lo);
    const T cl = v < lo ? lo : (v > hi ? hi : v);
    const SiciParts<T> ab = series<T, D>((T(2) * cl - mid) * rspan);
    return {ab.p * v, ab.q * v * v};
  }
}

// Si/Ci parts of x with one branch on its domain.  D = -1, the kernels'
// case, branches on x.  D >= 0 fixes the domain at compile time; no kernel
// of the port uses it: only the SASS probes of tools/torch_nfw_probe.cu
// do, to count one domain's path.
template <typename T, int D>
__device__ __forceinline__ SiciParts<T> sici_parts(T x, T v) {
  if constexpr (D >= 0) {
    return sici_domain<T, D>(x, v);
  } else {
    if (x <= T(4)) return sici_domain<T, 0>(x, v);
    if (x <= T(10)) return sici_domain<T, 1>(x, v);
    if (x <= T(40)) return sici_domain<T, 2>(x, v);
    return sici_domain<T, 3>(x, v);
  }
}

// Per-row constants, from the row's scale r_s (1+z) and concentration c in
// float64 with the plain version's formulas: s1 = scale, s2 = (1+c) s1,
// 1/F(c) with F(c) = ln(1+c) - c/(1+c), and ln(1+c).
template <typename T> struct RowConst {
  double s1, s2;
  T inv_mc, ln1pc;
};

template <typename T>
__device__ __forceinline__ RowConst<T> row_constants(double scale, double c) {
  const double ln1pc = ::log(1.0 + c);
  const double mc = ln1pc - c / (1.0 + c);
  return {scale, (1.0 + c) * scale, static_cast<T>(1.0 / mc),
          static_cast<T>(ln1pc)};
}

// u(k | row) for x = k s1, x2 = k s2 = (1+c)x.  The kernels leave D1, D2
// at -1; D1, D2 >= 0 fix the domains of x and x2 at compile time for the
// SASS probes alone (see sici_parts).
template <typename T, int D1 = -1, int D2 = -1>
__device__ __forceinline__ T nfw_u(double k, const RowConst<T>& r) {
  using P = Prec<T>;
  const double x = k * r.s1;
  const double x2 = k * r.s2;
  T sx, cx, sx2, cx2;
  P::sincos_phase(x, &sx, &cx);
  P::sincos_phase(x2, &sx2, &cx2);
  const T xt = static_cast<T>(x) > P::tiny ? static_cast<T>(x) : P::tiny;
  const T x2t = static_cast<T>(x2) > P::tiny ? static_cast<T>(x2) : P::tiny;
  const T v1 = P::rcp(xt);
  const T v2 = P::rcp(x2t);
  const SiciParts<T> p1 = sici_parts<T, D1>(xt, v1);
  const SiciParts<T> p2 = sici_parts<T, D2>(x2t, v2);
  const bool in01 = D1 >= 0 ? D1 == 0 : xt <= T(4);
  const bool in02 = D2 >= 0 ? D2 == 0 : x2t <= T(4);
  const T sin_cx = sx2 * cx - cx2 * sx;  // sin(cx) = sin(x2 - x)
  T dsi, dci;
  if (in02) {  // both in the series branch (x < x2 <= 4)
    dci = r.ln1pc + (p2.q - p1.q);
    dsi = x2t * p2.p - xt * p1.p;
  } else {
    const T ci2 = p2.p * sx2 - p2.q * cx2;
    if (in01) {
      dci = ci2 - (T(SICI_EULER_GAMMA) + P::log(xt) + p1.q);
      dsi = (T(1.5707963267948966) - p2.p * cx2 - p2.q * sx2) - xt * p1.p;
    } else {
      dci = ci2 - (p1.p * sx - p1.q * cx);
      dsi = (p1.p * cx + p1.q * sx) - (p2.p * cx2 + p2.q * sx2);
    }
  }
  return (sx * dsi - sin_cx * v2 + cx * dci) * r.inv_mc;
}

}  // namespace hmvec
