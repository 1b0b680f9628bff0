// Hand-written Hopper (sm_90a) kernels for the two serial integrators of
// the Boltzmann group, with a plain C interface for ctypes
// (hmvec_tpu_torch/kernels/_build.py builds it with nvcc; the Python
// wrappers and the plain PyTorch versions are in
// hmvec_tpu_torch/ops/boltz_kernels.py).
//
// Neither replaces a Pallas kernel: the JAX package writes both loops as
// lax.scans that XLA compiles into one device-resident loop each
// (hmvec_tpu/models/recomb.py:190, the x_e recurrence; boltzlite.py:540-553
// vmapped at :624, the perturbation hierarchy).  Written step by step in
// eager PyTorch they would launch ~10^8 small kernels per call, so each is
// one kernel here, with every x-only quantity tabulated beforehand by
// vectorised PyTorch (the wrappers' callers) and only the recurrence left
// to the kernel.
//
// What bounds them on this card: neither bytes nor operations.  Each is a
// chain of thousands of dependent RK4 steps, one thread per independent
// row (per cosmology, per k), so the time is the number of steps times the
// latency of one step's dependent float64 arithmetic (its divisions
// chief among them); the card's rates are far away.  The design does the
// simple thing about it: one thread a row, one warp a block so that each
// warp has an SM's schedulers to itself, the state in registers (spilled
// to local memory where the 34-double hierarchy state and its RK4 stages
// do not fit), the shared x-only table read by every thread of a step
// from the same addresses.  A warp per k, or stages shared across
// threads, is later work.
//
// The arithmetic is that of the plain versions, in the same order, and
// this file is built with -fmad=false (SOURCE_FLAGS in
// hmvec_tpu_torch/kernels/_build.py), so no multiply-add is contracted to
// an FMA and each kernel equals its plain version on the card bit for bit.
// The reason: the tight-coupling era of the solve amplifies a one-ulp
// difference some 1e7 times, past the 1e-10 gate that holds a kernel
// against its plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

// ---- recombination: x_e by RK4 on the Peebles branch ---------------------
// tab (batch, nsteps, 3, 7): at the sub-points x, x + dx/2, x + dx of each
// step, n_H, H [1/s], H Lya_pref, n_H alpha2, beta, beta2, Saha switch.
constexpr int kRecCols = 7;
constexpr double kLambda2s1s = 8.227;

__device__ __forceinline__ double peebles(double xe, const double* p) {
  if (p[6] != 0.0) return 0.0;              // Saha branch: rate 0
  const double n1s = fmax((1.0 - xe) * p[0], 1e-30);
  const double lam = p[2] / n1s;
  const double cr = (kLambda2s1s + lam) / (kLambda2s1s + lam + p[5]);
  const double dxe_dt = cr * (p[4] * (1.0 - xe) - p[3] * (xe * xe));
  return dxe_dt / p[1];
}

__global__ void __launch_bounds__(kThreads)
recomb_rk4_kernel(const double* __restrict__ tab,
                  const double* __restrict__ saha_next,
                  const double* __restrict__ xe0, double dx, int nsteps,
                  int batch, double* __restrict__ xe_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const double* t = tab + static_cast<size_t>(b) * nsteps * 3 * kRecCols;
  const double* sn = saha_next + static_cast<size_t>(b) * nsteps;
  double* out = xe_out + static_cast<size_t>(b) * (nsteps + 1);
  const double half = 0.5 * dx;
  const double sixth = dx / 6.0;
  double xe = xe0[b];
  out[0] = xe;
  for (int i = 0; i < nsteps; ++i) {
    const double* p = t + static_cast<size_t>(i) * 3 * kRecCols;
    if (p[6] != 0.0) {
      xe = sn[i];                          // in equilibrium: Saha at x + dx
    } else {
      const double k1 = peebles(xe, p);
      const double k2 = peebles(xe + half * k1, p + kRecCols);
      const double k3 = peebles(xe + half * k2, p + kRecCols);
      const double k4 = peebles(xe + dx * k3, p + 2 * kRecCols);
      xe = xe + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4);
    }
    out[i + 1] = xe;
  }
}

// ---- the perturbation hierarchy -----------------------------------------
// state: [Phi, dc, vc, db, vb, Th0..Th8, ThP0..ThP8, N0..N8, dn, vn]
constexpr int kL = 8;
constexpr int kNth = kL + 1;
constexpr int kPhi = 0, kVc = 2, kVb = 4;
constexpr int kTh = 5, kThp = kTh + kNth, kN = kThp + kNth, kNm = kN + kNth;
constexpr int kNstate = kNm + 2;
// x-only table (nsteps, 3, kXCols): a, Hp, tau_x, tau_xx, dln Hp/dx, eta,
// rho_nu, w_nu, c_g^2 and the x-only half of the tight-coupling test
constexpr int kXCols = 10;
enum { kA, kHp, kTaux, kTauxx, kDlnhp, kEta, kRho, kW, kCg2, kTcx };

struct Consts {
  double h0m, omg, omnu, omb, omc;
};

__device__ __forceinline__ bool tight(const double* q, double k) {
  return q[kTcx] != 0.0 && fabs(q[kTaux]) > 10.0 * k / q[kHp];
}

// Theta_2..L and the polarization multipoles from Theta_1, in place
__device__ __forceinline__ void slave(const double* q, double k, double* s) {
  const double ckhti = k / (q[kHp] * q[kTaux]);
  double c[kNth];
#pragma unroll
  for (int l = 3; l < kNth; ++l) c[l] = -(l / (2.0 * l + 1.0)) * ckhti;
  const double th2 = -(8.0 / 15.0) * ckhti * s[kTh + 1];
  s[kTh + 2] = th2;
#pragma unroll
  for (int l = 3; l < kNth; ++l) s[kTh + l] = c[l] * s[kTh + l - 1];
  s[kThp] = 1.25 * th2;
  s[kThp + 1] = -0.25 * ckhti * th2;
  s[kThp + 2] = 0.25 * th2;
#pragma unroll
  for (int l = 3; l < kNth; ++l) s[kThp + l] = c[l] * s[kThp + l - 1];
}

// (Psi, Phi', ck/Hp): the metric from the momentum constraint
__device__ __forceinline__ void metric(const Consts& c, const double* q,
                                       double k, const double* s,
                                       double& psi, double& dphi,
                                       double& ckh) {
  const double a = q[kA], hp = q[kHp];
  ckh = k / hp;
  const double r = c.h0m / (k * a);
  psi = -s[kPhi] - 12.0 * (r * r) * (c.omg * s[kTh + 2]
                                     + c.omnu * s[kN + 2]);
  const double a2 = a * a;
  const double src = c.omc / a * s[kVc] + c.omb / a * s[kVb]
                     - 4.0 * c.omg / a2 * s[kTh + 1]
                     - 4.0 * c.omnu / a2 * s[kN + 1]
                     + q[kRho] * (1.0 + q[kW]) * a2 * s[kNm + 1];
  const double rh = c.h0m / hp;
  dphi = psi + 1.5 * (rh * rh) * (hp / k) * src;
}

// d/dx of multipoles 2..L of one hierarchy (v: its L + 1 values) into
// d[0..L-2]; kScatter adds the Thomson term (photons), with Pi/10 at l = 2
template <bool kScatter>
__device__ __forceinline__ void hierarchy(double ckh, const double* v,
                                          double taux, double pi_eq,
                                          double ctop, double* d) {
#pragma unroll
  for (int l = 2; l < kL; ++l) {
    double t = ckh * l / (2 * l + 1) * v[l - 1]
               - ckh * (l + 1) / (2 * l + 1) * v[l + 1];
    if (kScatter) t = t + taux * (l == 2 ? v[2] - pi_eq / 10.0 : v[l]);
    d[l - 2] = t;
  }
  double top = ckh * v[kL - 1] - ctop * v[kL];
  if (kScatter) top = top + taux * v[kL];
  d[kL - 2] = top;
}

// the massless neutrinos and the massive-nu fluid, shared by both branches
__device__ __forceinline__ void neutrinos(const double* q, const double* s,
                                          double psi, double dphi,
                                          double ckh, double ctop,
                                          double* ds) {
  const double* nn = s + kN;
  ds[kN] = -ckh * nn[1] - dphi;
  ds[kN + 1] = (ckh / 3.0) * (nn[0] + psi) - (2.0 * ckh / 3.0) * nn[2];
  hierarchy<false>(ckh, nn, 0.0, 0.0, ctop, ds + kN + 2);
  const double w = q[kW], cg2 = q[kCg2];
  const double dn = s[kNm], vn = s[kNm + 1];
  ds[kNm] = (1.0 + w) * (ckh * vn - 3.0 * dphi) - 3.0 * (cg2 - w) * dn;
  ds[kNm + 1] = -(1.0 - 3.0 * cg2) * vn
                - ckh * (cg2 * dn / (1.0 + w) + psi);
}

__device__ void rhs_full(const Consts& c, const double* q, double k,
                         const double* s, double* ds) {
  double psi, dphi, ckh;
  metric(c, q, k, s, psi, dphi, ckh);
  const double a = q[kA], taux = q[kTaux];
  const double ctop = (kL + 1) / (q[kHp] * q[kEta]);
  const double* th = s + kTh;
  const double* thp = s + kThp;
  const double pi_eq = th[2] + thp[0] + thp[2];
  const double vc = s[kVc], vb = s[kVb];
  ds[kPhi] = dphi;
  ds[1] = ckh * vc - 3.0 * dphi;
  ds[kVc] = -vc - ckh * psi;
  ds[3] = ckh * vb - 3.0 * dphi;
  const double rb = 4.0 * c.omg / (3.0 * c.omb * a);
  ds[kVb] = -vb - ckh * psi + taux * rb * (3.0 * th[1] + vb);
  ds[kTh] = -ckh * th[1] - dphi;
  ds[kTh + 1] = (ckh / 3.0) * (th[0] + psi) - (2.0 * ckh / 3.0) * th[2]
                + taux * (th[1] + vb / 3.0);
  hierarchy<true>(ckh, th, taux, pi_eq, ctop, ds + kTh + 2);
  ds[kThp] = -ckh * thp[1] + taux * (thp[0] - pi_eq / 2.0);
  ds[kThp + 1] = (ckh / 3.0) * thp[0] - (2.0 * ckh / 3.0) * thp[2]
                 + taux * thp[1];
  hierarchy<true>(ckh, thp, taux, pi_eq, ctop, ds + kThp + 2);
  neutrinos(q, s, psi, dphi, ckh, ctop, ds);
}

// tight coupling (Callin eqs. 70-71); slaves s in place first
__device__ void rhs_tc(const Consts& c, const double* q, double k, double* s,
                       double* ds) {
  slave(q, k, s);
  double psi, dphi, ckh;
  metric(c, q, k, s, psi, dphi, ckh);
  const double a = q[kA], taux = q[kTaux], tauxx = q[kTauxx];
  const double dlnhp = q[kDlnhp];
  const double ctop = (kL + 1) / (q[kHp] * q[kEta]);
  const double th0 = s[kTh], th1 = s[kTh + 1], th2 = s[kTh + 2];
  const double vb = s[kVb], vc = s[kVc];
  const double rb = 4.0 * c.omg / (3.0 * c.omb * a);
  const double dth0 = -ckh * th1 - dphi;
  const double qq = (-((1.0 - 2.0 * rb) * taux + (1.0 + rb) * tauxx)
                         * (3.0 * th1 + vb)
                     - ckh * psi
                     + (1.0 - dlnhp) * ckh * (-th0 + 2.0 * th2)
                     - ckh * dth0)
                    / ((1.0 + rb) * taux + dlnhp - 1.0);
  const double dvb = (-vb - ckh * psi
                      + rb * (qq + ckh * (-th0 + 2.0 * th2) - ckh * psi))
                     / (1.0 + rb);
  ds[kPhi] = dphi;
  ds[1] = ckh * vc - 3.0 * dphi;
  ds[kVc] = -vc - ckh * psi;
  ds[3] = ckh * vb - 3.0 * dphi;
  ds[kVb] = dvb;
  ds[kTh] = dth0;
  ds[kTh + 1] = (qq - dvb) / 3.0;
#pragma unroll
  for (int i = kTh + 2; i < kN; ++i) ds[i] = 0.0;   // slaved multipoles
  neutrinos(q, s, psi, dphi, ckh, ctop, ds);
}

// ds = f(x, s) at the sub-point q; s is scratch (the TC branch slaves it)
__device__ __forceinline__ void rhs(const Consts& c, const double* q,
                                    double k, double* s, double* ds) {
  if (tight(q, k)) {
    rhs_tc(c, q, k, s, ds);
  } else {
    rhs_full(c, q, k, s, ds);
  }
}

__global__ void __launch_bounds__(kThreads)
hierarchy_rk4_kernel(const double* __restrict__ xtab,
                     const double* __restrict__ ks,
                     const double* __restrict__ consts,
                     const double* __restrict__ s0, double dx, int n_outer,
                     int n_inner, int rows, double* __restrict__ s_out,
                     double* __restrict__ stored) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const Consts c{consts[0], consts[1], consts[2], consts[3], consts[4]};
  const double k = ks[r];
  const double half = 0.5 * dx;
  const double sixth = dx / 6.0;
  double s[kNstate], acc[kNstate], st[kNstate], ds[kNstate];
#pragma unroll
  for (int i = 0; i < kNstate; ++i) s[i] = s0[static_cast<size_t>(r) * kNstate + i];
  for (int io = 0; io < n_outer; ++io) {
    for (int j = 0; j < n_inner; ++j) {
      const double* q0 =
          xtab + (static_cast<size_t>(io) * n_inner + j) * 3 * kXCols;
      const double* q1 = q0 + kXCols;
      const double* q2 = q1 + kXCols;
#pragma unroll
      for (int i = 0; i < kNstate; ++i) st[i] = s[i];
      rhs(c, q0, k, st, ds);                                  // k1
#pragma unroll
      for (int i = 0; i < kNstate; ++i) {
        acc[i] = ds[i];
        st[i] = s[i] + half * ds[i];
      }
      rhs(c, q1, k, st, ds);                                  // k2
#pragma unroll
      for (int i = 0; i < kNstate; ++i) {
        acc[i] = acc[i] + 2.0 * ds[i];
        st[i] = s[i] + half * ds[i];
      }
      rhs(c, q1, k, st, ds);                                  // k3
#pragma unroll
      for (int i = 0; i < kNstate; ++i) {
        acc[i] = acc[i] + 2.0 * ds[i];
        st[i] = s[i] + dx * ds[i];
      }
      rhs(c, q2, k, st, ds);                                  // k4
#pragma unroll
      for (int i = 0; i < kNstate; ++i) s[i] = s[i] + sixth * (acc[i] + ds[i]);
      // while tight-coupled, the slaved multipoles at the new time
      if (tight(q2, k)) slave(q2, k, s);
    }
    if (stored != nullptr) {
      double* o = stored + (static_cast<size_t>(r) * n_outer + io) * kNstate;
#pragma unroll
      for (int i = 0; i < kNstate; ++i) o[i] = s[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kNstate; ++i) s_out[static_cast<size_t>(r) * kNstate + i] = s[i];
}

int grid_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Each launch function sets `device`, launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns the cudaError_t of
// the launch (0 on success).  Every array is contiguous float64.

// x_e (batch, nsteps + 1) from tab (batch, nsteps, 3, 7), saha_next
// (batch, nsteps) and xe0 (batch,): one thread a cosmology.
int hmvec_recomb_rk4(const double* tab, const double* saha_next,
                     const double* xe0, double dx, int nsteps, int batch,
                     double* xe, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  recomb_rk4_kernel<<<grid_of(batch), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, saha_next, xe0, dx, nsteps, batch, xe);
  return static_cast<int>(cudaGetLastError());
}

// n_outer x n_inner RK4 steps of the hierarchy for rows k (rows,) from
// s0 (rows, 34) on the x-only table xtab (n_outer n_inner, 3, 10), with
// consts = (H0/c, Omega_gamma, Omega_nu massless, Omega_b, Omega_c): the
// final state into s_out (rows, 34) and, unless stored is null, the state
// after each outer block into stored (rows, n_outer, 34).  One thread a k.
int hmvec_hierarchy_rk4(const double* xtab, const double* ks,
                        const double* consts, const double* s0, double dx,
                        int n_outer, int n_inner, int rows, double* s_out,
                        double* stored, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  hierarchy_rk4_kernel<<<grid_of(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      xtab, ks, consts, s0, dx, n_outer, n_inner, rows, s_out, stored);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
