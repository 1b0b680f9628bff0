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
// chain of thousands of dependent RK4 steps, so the time is the number of
// steps times the latency of one step's dependent float64 arithmetic (its
// divisions chief among them); the card's rates are far away.  The design
// shortens that chain:
//
// * hierarchy_rk4: a warp a k, four k a block.  Lane i owns state
//   component i (0-31) and every lane carries the massive-nu fluid's two
//   (32, 33), so a lane keeps 3 x 4 doubles (state, RK4 sum, stage input,
//   derivative) in registers.  Each lane evaluates its own component's
//   derivative, every lane the same instructions: one template
//   (A X - B Y) + C (G W + E), E = P / D, whose operands each lane picks
//   by its role (shuffles from per-lane source lanes and selects, never a
//   branch: a branch on the role would serialise the warp), with the
//   missing terms' exact identities (x + -0, x - 0 * 0,
//   x + -0 * (0 + -0), x * 1) standing in for the terms a component lacks.
//   The quantities shared by all components (Psi, Phi', Pi; in tight
//   coupling the slip and dv_b) every lane computes itself, in the same
//   order; neighbouring multipoles and the components the metric reads
//   come by __shfl_sync.  Tight coupling is decided per k, so a warp never
//   diverges on it.  Every division of a step has an x-only or constant
//   divisor, so it is a multiplication by the divisor's reciprocal and two
//   FMA corrections (div_rcp: RN(a/b) as the division gives it, with no
//   branch).  The x-only table is staged into shared memory in chunks of
//   kChunk steps, double-buffered with cp.async; once a chunk the block
//   derives every x-only coefficient of its sub-points and their
//   divisors' reciprocals (one thread a sub-point) and each warp the
//   k-dependent ones of its k (one lane a sub-point), so a step reads
//   shared memory only.
// * recomb_rk4: a block a cosmology.  Whenever the Saha flag at x is set,
//   the output is the table's Saha value whatever the state, so those
//   steps are written in parallel by the staging warps; one thread
//   integrates only the Peebles runs (each starts from x_e0 or the Saha
//   value before it), from table rows that the staging warps have
//   compacted into shared memory ahead of it (cp.async, double-buffered)
//   with 1/H at each sub-point, so no global load is left on its chain
//   and its division by H is div_rcp; its two divisions by the state
//   remain.
//
// The arithmetic is that of the plain versions, in the same order, and
// this file is built with -fmad=false (SOURCE_FLAGS in
// hmvec_tpu_torch/kernels/_build.py), so no multiply-add is contracted to
// an FMA (div_rcp's FMAs are explicit and round as the division does) and
// each kernel equals its plain version on the card bit for bit.
// The reason: the tight-coupling era of the solve amplifies a one-ulp
// difference some 1e7 times, past the 1e-10 gate that holds a kernel
// against its plain version.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- cp.async: 8-byte copies global -> shared, in commit groups ---------
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a / b as the IEEE division rounds it, given y = RN(1/b) (an IEEE
// division made off the chain, or a constant): q = a y, then two
// corrections q + (a - b q) y by FMA.  The first makes q faithful (within
// an ulp of a/b), the second then gives RN(a/b) (Markstein: y within half
// an ulp of 1/b, q within an ulp); a zero a keeps its sign.  It holds for
// normal operands whose quotient and remainders neither overflow nor
// underflow, as every quotient of these right-hand sides.  Five dependent
// operations with no branch, where the division's own code ends in a
// range check that branches to its slow path, so nothing after it is
// scheduled ahead of it.
__device__ __forceinline__ double div_rcp(double a, double b, double y) {
  const double q0 = a * y;
  double q = __fma_rn(__fma_rn(-b, q0, a), y, q0);
  q = __fma_rn(__fma_rn(-b, q, a), y, q);
  return a == 0.0 ? q0 : q;
}

constexpr double kThird = 1.0 / 3.0;   // RN(1/3)

// ---- recombination: x_e by RK4 on the Peebles branch ---------------------
// tab (batch, nsteps, 3, 7): at the sub-points x, x + dx/2, x + dx of each
// step, n_H, H [1/s], H Lya_pref, n_H alpha2, beta, beta2, Saha switch.
constexpr int kRecCols = 7;
constexpr int kRecRow = 3 * kRecCols;     // one step's table values
constexpr double kLambda2s1s = 8.227;
// warp 0: its lane 0 integrates; warps 1-3 stage, one step a thread
constexpr int kRecStagers = 96;
constexpr int kRecThreads = 32 + kRecStagers;
constexpr int kRecWindow = kRecStagers;   // steps a staging window
// a staged Peebles step: its 21 table values, where the sub-point-0 Saha
// switch (0 in a Peebles step) gives way to the x_e the step starts from
// when it starts a run, then RN(1/H) at the three sub-points
constexpr int kRecStart = 6;
constexpr int kRecEntry = kRecRow + 3;

// dx_e/dx at one sub-point of a step (p: its 7 values, y_h = RN(1/H)); the
// Saha switch is read by the caller
__device__ __forceinline__ double peebles(double xe, const double* p,
                                          double y_h) {
  const double n1s = fmax((1.0 - xe) * p[0], 1e-30);
  const double lam = p[2] / n1s;
  const double cr = (kLambda2s1s + lam) / (kLambda2s1s + lam + p[5]);
  const double dxe_dt = cr * (p[4] * (1.0 - xe) - p[3] * (xe * xe));
  return div_rcp(dxe_dt, p[1], y_h);
}

// A window's Peebles steps, compacted in step order: their entries and
// step index (~index where the step starts a run).
struct RecBuf {
  double e[kRecWindow][kRecEntry];
  int meta[kRecWindow];
  int count;
};

// Stage window w into buf (the staging threads): write its Saha steps,
// copy its Peebles steps' rows.  Leaves the copies in flight (committed).
__device__ __forceinline__ void rec_stage(
    const double* __restrict__ tab, const double* __restrict__ sn,
    const double* __restrict__ xe0, double* __restrict__ out, int nsteps,
    int w, RecBuf& buf, int* warp_count) {
  const int t = threadIdx.x - 32;
  const int i = w * kRecWindow + t;
  bool peeb = false, restart = false;
  const double* row = tab + static_cast<size_t>(i) * kRecRow;
  if (i < nsteps) {
    if (row[6] != 0.0) {
      out[i + 1] = sn[i];                  // in equilibrium: Saha at x + dx
    } else {
      peeb = true;
      restart = i == 0 || row[6 - kRecRow] != 0.0;
    }
  }
  const unsigned ballot = __ballot_sync(kFull, peeb);
  const int wid = t >> 5, lane = t & 31;
  if (lane == 0) warp_count[wid] = __popc(ballot);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRecStagers) : "memory");
  int slot = __popc(ballot & ((1u << lane) - 1u));
  int total = 0;
#pragma unroll
  for (int v = 0; v < kRecStagers / 32; ++v) {
    slot += v < wid ? warp_count[v] : 0;
    total += warp_count[v];
  }
  if (peeb) {
    double* e = buf.e[slot];
#pragma unroll
    for (int c = 0; c < kRecRow; ++c) {
      if (c != kRecStart) cp_async8(e + c, row + c);
    }
    if (restart) cp_async8(e + kRecStart, i == 0 ? xe0 : sn + i - 1);
#pragma unroll
    for (int s = 0; s < 3; ++s) e[kRecRow + s] = 1.0 / row[s * kRecCols + 1];
    buf.meta[slot] = restart ? ~i : i;
  }
  if (t == 0) buf.count = total;
  cp_async_commit();
}

__global__ void __launch_bounds__(kRecThreads)
recomb_rk4_kernel(const double* __restrict__ tab,
                  const double* __restrict__ saha_next,
                  const double* __restrict__ xe0, double dx, int nsteps,
                  double* __restrict__ xe_out) {
  __shared__ RecBuf buf[2];
  __shared__ int warp_count[kRecStagers / 32];
  const int b = blockIdx.x;
  const double* t = tab + static_cast<size_t>(b) * nsteps * kRecRow;
  const double* sn = saha_next + static_cast<size_t>(b) * nsteps;
  double* out = xe_out + static_cast<size_t>(b) * (nsteps + 1);
  const bool stager = threadIdx.x >= 32;
  const int nwin = (nsteps + kRecWindow - 1) / kRecWindow;
  if (stager) {
    if (threadIdx.x == 32) out[0] = xe0[b];
    if (nwin > 0) rec_stage(t, sn, xe0 + b, out, nsteps, 0, buf[0],
                            warp_count);
    cp_async_wait<0>();
  }
  __syncthreads();
  const double half = 0.5 * dx;
  const double sixth = dx / 6.0;
  double xe = 0.0;   // every Peebles run begins with a restart entry
  for (int w = 0; w < nwin; ++w) {
    if (stager && w + 1 < nwin) {
      rec_stage(t, sn, xe0 + b, out, nsteps, w + 1, buf[(w + 1) & 1],
                warp_count);
    }
    if (threadIdx.x == 0) {
      const RecBuf& cur = buf[w & 1];
      const int m = cur.count;
      // the next entry is read while this one integrates
      double p[kRecEntry], nxt[kRecEntry];
#pragma unroll
      for (int c = 0; c < kRecEntry; ++c) p[c] = cur.e[0][c];
      int meta = cur.meta[0];
      for (int e = 0; e < m; ++e) {
        const int en = e + 1 < m ? e + 1 : e;
#pragma unroll
        for (int c = 0; c < kRecEntry; ++c) nxt[c] = cur.e[en][c];
        const int meta_n = cur.meta[en];
        if (meta < 0) xe = p[kRecStart];
        // a later sub-point in Saha equilibrium has rate 0
        const double* y = p + kRecRow;
        const bool saha1 = p[kRecCols + 6] != 0.0;
        const bool saha2 = p[2 * kRecCols + 6] != 0.0;
        const double k1 = peebles(xe, p, y[0]);
        double k2 = peebles(xe + half * k1, p + kRecCols, y[1]);
        k2 = saha1 ? 0.0 : k2;
        double k3 = peebles(xe + half * k2, p + kRecCols, y[1]);
        k3 = saha1 ? 0.0 : k3;
        double k4 = peebles(xe + dx * k3, p + 2 * kRecCols, y[2]);
        k4 = saha2 ? 0.0 : k4;
        xe = xe + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4);
        out[(meta < 0 ? ~meta : meta) + 1] = xe;
#pragma unroll
        for (int c = 0; c < kRecEntry; ++c) p[c] = nxt[c];
        meta = meta_n;
      }
    }
    if (stager) cp_async_wait<0>();
    __syncthreads();
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

constexpr int kHierWarps = 4;                  // k a block
constexpr int kHierThreads = 32 * kHierWarps;
constexpr int kChunk = 32;                     // steps staged at a time
constexpr int kSub = 3 * kChunk;               // their sub-points
static_assert(kSub <= kHierThreads, "one thread a sub-point");

// the x-only coefficients of a sub-point, as the right-hand sides form them
// and the reciprocals RN(1/x) of its three divisors
enum {
  dOmca, dOmba, dOmg4, dOmnu4, dRhow, dCtop, dRb, dTrb, dTaux, dQa, dDl1,
  dQden, dRb1, dW1, dCw3, dC13, dCg2, dYqden, dYrb1, dYw1, kDer
};
// the k-dependent ones: ck/Hp, 12 (H0/(c k a))^2, 1.5 (H0/(c Hp))^2 Hp/k,
// the tight-coupling test (1 or 0), k/(Hp tau_x)
enum { kdCkh, kdR12, kdDpc, kdTight, kdCkhti, kKd };

struct Consts {
  double h0m, omg, omnu, omb, omc;
};

__device__ __forceinline__ void derive(const Consts& c, const double* q,
                                       double* d) {
  const double a = q[kA], hp = q[kHp], taux = q[kTaux];
  const double a2 = a * a;
  d[dOmca] = c.omc / a;
  d[dOmba] = c.omb / a;
  d[dOmg4] = 4.0 * c.omg / a2;
  d[dOmnu4] = 4.0 * c.omnu / a2;
  d[dRhow] = q[kRho] * (1.0 + q[kW]) * a2;
  d[dCtop] = (kL + 1) / (hp * q[kEta]);
  const double rb = 4.0 * c.omg / (3.0 * c.omb * a);
  d[dRb] = rb;
  d[dTrb] = taux * rb;
  d[dTaux] = taux;
  d[dQa] = -((1.0 - 2.0 * rb) * taux + (1.0 + rb) * q[kTauxx]);
  d[dDl1] = 1.0 - q[kDlnhp];
  d[dQden] = (1.0 + rb) * taux + q[kDlnhp] - 1.0;
  d[dRb1] = 1.0 + rb;
  d[dW1] = 1.0 + q[kW];
  d[dCw3] = 3.0 * (q[kCg2] - q[kW]);
  d[dC13] = -(1.0 - 3.0 * q[kCg2]);
  d[dCg2] = q[kCg2];
  d[dYqden] = 1.0 / d[dQden];
  d[dYrb1] = 1.0 / d[dRb1];
  d[dYw1] = 1.0 / d[dW1];
}

__device__ __forceinline__ void k_derive(const Consts& c, double k,
                                         const double* q, double* kd) {
  const double hp = q[kHp];
  kd[kdCkh] = k / hp;
  const double r = c.h0m / (k * q[kA]);
  kd[kdR12] = 12.0 * (r * r);
  const double rh = c.h0m / hp;
  kd[kdDpc] = 1.5 * (rh * rh) * (hp / k);
  kd[kdTight] =
      q[kTcx] != 0.0 && fabs(q[kTaux]) > 10.0 * k / hp ? 1.0 : 0.0;
  kd[kdCkhti] = k / (hp * q[kTaux]);
}

// c ? a : b as a select (selp), never a branch: the lanes of a warp pick
// different operands, and a branch on a lane's role would serialise them
__device__ __forceinline__ double pick(bool c, double a, double b) {
  double r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
      "selp.f64 %0, %2, %3, p;\n\t}"
      : "=d"(r)
      : "r"(static_cast<int>(c)), "d"(a), "d"(b));
  return r;
}

// A lane's role: where each operand of its template comes from.  ix, iy,
// iw: the lanes whose stage input X, Y, W are (the lane's own, the one
// below (l - 1), the one above (l + 1), or Theta_1's), unless a flag puts
// Phi', Psi, +0 or -0 in their place; P is -0 unless v_b or -Pi; A and B
// are constants unless (ck/Hp n) / d or the truncation coefficient; C is
// -0 unless tau_x or tau_x R_b.  In tight coupling tc_dvb, tc_q and
// tc_zero give dv_b, (q - dv_b)/3 or 0 (a slaved multipole).  lvl: the
// slaved multipole's l (2 where no product follows), 0 where not slaved;
// base_q: its base is (-1/4 ck/(Hp tau_x)) Theta_2, else bm Theta_2.
// ya, yb, ydv: RN(1/ad), RN(1/bd), RN(1/dv).
struct Lane {
  int ix, iy, iw, lvl;
  bool x_dphi, x_psi, y_dphi, y_psi, y_zero, w_zero, p_vb, p_pi, a_ckh,
      b_ckh, b_top, c_taux, c_trb, tc_dvb, tc_q, tc_zero, base_q;
  double an, ad, ac, bn, bd, bc, g, dv, bm, ya, yb, ydv;
};

__device__ Lane lane_role(int i) {
  Lane L{};
  L.ix = L.iy = L.iw = i;
  L.y_zero = L.w_zero = true;
  L.an = L.ad = L.bn = L.bd = L.g = L.dv = L.bm = 1.0;
  auto ckh_a = [&](double n, double d) { L.a_ckh = true; L.an = n; L.ad = d; };
  auto ckh_b = [&](double n, double d) { L.b_ckh = true; L.bn = n; L.bd = d; };
  auto y_from = [&](int lane) { L.y_zero = false; L.iy = lane; };
  auto w_own = [&]() { L.w_zero = false; };
  if (i == kPhi) {                                  // Phi'
    L.x_dphi = true; L.ac = 1.0;
  } else if (i == 1 || i == 3) {                    // dc, db: ck v - 3 Phi'
    L.ix = i + 1; ckh_a(1.0, 1.0);
    L.y_zero = false; L.y_dphi = true; L.bc = 3.0;
  } else if (i == kVc || i == kVb) {                // -v - ck Psi (+ drag)
    L.ac = -1.0; L.y_zero = false; L.y_psi = true; ckh_b(1.0, 1.0);
    if (i == kVb) {
      L.c_trb = true; w_own(); L.iw = kTh + 1; L.g = 3.0; L.p_vb = true;
      L.tc_dvb = true;
    }
  } else if (i == kTh || i == kN) {                 // -ck v1 - Phi'
    L.ix = i + 1; ckh_a(-1.0, 1.0);
    L.y_zero = false; L.y_dphi = true; L.bc = 1.0;
  } else if (i == kTh + 1 || i == kN + 1 || i == kThp + 1) {
    // ck/3 (v0 + Psi) - 2ck/3 v2 (+ tau_x (v1 + v_b/3))
    L.ix = i - 1; L.x_psi = i != kThp + 1; ckh_a(1.0, 3.0);
    y_from(i + 1); ckh_b(2.0, 3.0);
    if (i != kN + 1) { L.c_taux = true; w_own(); }
    if (i == kTh + 1) { L.p_vb = true; L.dv = 3.0; L.tc_q = true; }
    if (i == kThp + 1) { L.tc_zero = true; L.lvl = 2; L.base_q = true; }
  } else if (i == kThp) {                           // -ck P1 + tau_x (P0 - Pi/2)
    L.ix = i + 1; ckh_a(-1.0, 1.0); L.c_taux = true; w_own();
    L.p_pi = true; L.dv = 2.0; L.tc_zero = true; L.lvl = 2; L.bm = 1.25;
  } else {                                          // multipoles 2..L
    const int h = i < kThp ? kTh : i < kN ? kThp : kN;
    const int l = i - h;
    L.ix = i - 1;
    if (l < kL) {
      ckh_a(l, 2 * l + 1); y_from(i + 1); ckh_b(l + 1, 2 * l + 1);
    } else {
      ckh_a(1.0, 1.0); y_from(i); L.b_top = true;
    }
    if (h != kN) {                                  // Thomson scattering
      L.c_taux = true; w_own(); L.tc_zero = true; L.lvl = l;
      L.bm = h == kTh ? 1.0 : 0.25;
      if (l == 2) { L.p_pi = true; L.dv = 10.0; }
    }
  }
  L.ya = 1.0 / L.ad;
  L.yb = 1.0 / L.bd;
  L.ydv = 1.0 / L.dv;
  return L;
}

// The lane's share of f(x, s) at one sub-point: the derivative of its own
// component (ds) and of the fluid's two (ddn, dvn).  own, dn, vn: the
// stage input; A, B, C: the lane's coefficients at this sub-point; tc:
// tight coupling at this sub-point for this k (the same on every lane).
__device__ __forceinline__ void lane_rhs(
    const Lane& L, const Consts& c, const double* d, const double* kd,
    double A, double B, double C, bool tc, double own, double dn,
    double vn, double& ds, double& ddn, double& dvn) {
  const double xs = __shfl_sync(kFull, own, L.ix);
  const double ys = __shfl_sync(kFull, own, L.iy);
  const double ws = __shfl_sync(kFull, own, L.iw);
  const double phi = __shfl_sync(kFull, own, kPhi);
  const double vc = __shfl_sync(kFull, own, kVc);
  const double vb = __shfl_sync(kFull, own, kVb);
  const double th0 = __shfl_sync(kFull, own, kTh);
  const double th1 = __shfl_sync(kFull, own, kTh + 1);
  const double th2b = __shfl_sync(kFull, own, kTh + 2);
  const double thp0 = __shfl_sync(kFull, own, kThp);
  const double thp2 = __shfl_sync(kFull, own, kThp + 2);
  const double nu1 = __shfl_sync(kFull, own, kN + 1);
  const double nu2 = __shfl_sync(kFull, own, kN + 2);
  const double ckh = kd[kdCkh];
  // tight coupling slaves Theta_2 from Theta_1 (the one slaved multipole
  // that its right-hand side reads)
  const double th2 = tc ? -(8.0 / 15.0) * kd[kdCkhti] * th1 : th2b;
  // the metric: Psi from the anisotropic stress, Phi' from the momentum
  // constraint
  const double psi = -phi - kd[kdR12] * (c.omg * th2 + c.omnu * nu2);
  const double src = d[dOmca] * vc + d[dOmba] * vb - d[dOmg4] * th1
                     - d[dOmnu4] * nu1 + d[dRhow] * vn;
  const double dphi = psi + kd[kdDpc] * src;
  // the template
  const double pi_eq = th2b + thp0 + thp2;
  const double x = pick(L.x_dphi, dphi, xs) + pick(L.x_psi, psi, -0.0);
  const double y =
      pick(L.y_dphi, dphi, pick(L.y_psi, psi, pick(L.y_zero, 0.0, ys)));
  const double w = pick(L.w_zero, 0.0, ws);
  const double p = pick(L.p_vb, vb, pick(L.p_pi, -pi_eq, -0.0));
  const double e = div_rcp(p, L.dv, L.ydv);
  double t = (A * x - B * y) + C * (L.g * w + e);
  if (tc) {
    // Callin eqs. 70-71: the slip and dv_b
    const double dth0 = -ckh * th1 - dphi;
    const double slip = -th0 + 2.0 * th2;
    const double qq = div_rcp(d[dQa] * (3.0 * th1 + vb) - ckh * psi
                              + d[dDl1] * ckh * slip - ckh * dth0,
                              d[dQden], d[dYqden]);
    const double dvb = div_rcp(-vb - ckh * psi
                               + d[dRb] * (qq + ckh * slip - ckh * psi),
                               d[dRb1], d[dYrb1]);
    t = pick(L.tc_dvb, dvb,
             pick(L.tc_q, div_rcp(qq - dvb, 3.0, kThird),
                  pick(L.tc_zero, 0.0, t)));
  }
  ds = t;
  // the massive-nu fluid, on every lane
  ddn = d[dW1] * (ckh * vn - 3.0 * dphi) - d[dCw3] * dn;
  dvn = d[dC13] * vn
        - ckh * (div_rcp(d[dCg2] * dn, d[dW1], d[dYw1]) + psi);
}

// the lane's A, B and C at a sub-point
__device__ __forceinline__ void lane_coefs(const Lane& L, const double* d,
                                           const double* kd, double& A,
                                           double& B, double& C) {
  const double ckh = kd[kdCkh];
  const double qa = div_rcp(ckh * L.an, L.ad, L.ya);
  const double qb = div_rcp(ckh * L.bn, L.bd, L.yb);
  const double top = d[dCtop], taux = d[dTaux], trb = d[dTrb];
  A = pick(L.a_ckh, qa, L.ac);
  B = pick(L.b_ckh, qb, pick(L.b_top, top, L.bc));
  C = pick(L.c_taux, taux, pick(L.c_trb, trb, -0.0));
}

__global__ void __launch_bounds__(kHierThreads)
hierarchy_rk4_kernel(const double* __restrict__ xtab,
                     const double* __restrict__ ks,
                     const double* __restrict__ consts,
                     const double* __restrict__ s0, double dx, int n_outer,
                     int n_inner, int rows, double* __restrict__ s_out,
                     double* __restrict__ stored) {
  __shared__ double raw[2][kSub * kXCols];
  __shared__ double der[kSub][kDer];
  __shared__ double kdt[kHierWarps][kSub][kKd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kHierWarps + warp;
  const bool active = r < rows;
  const Consts c{consts[0], consts[1], consts[2], consts[3], consts[4]};
  const long long nsteps = static_cast<long long>(n_outer) * n_inner;
  const int nchunks = static_cast<int>((nsteps + kChunk - 1) / kChunk);
  auto stage = [&](int ch) {
    const long long base = static_cast<long long>(ch) * kChunk;
    const int n = static_cast<int>(
        (nsteps - base < kChunk ? nsteps - base : kChunk) * 3 * kXCols);
    const double* src = xtab + base * 3 * kXCols;
    double* dst = raw[ch & 1];
    for (int e = threadIdx.x; e < n; e += kHierThreads)
      cp_async8(dst + e, src + e);
  };
  if (nchunks > 0) stage(0);
  cp_async_commit();
  if (nchunks > 1) stage(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const Lane L = lane_role(lane);
  const double k = active ? ks[r] : 1.0;
  const double half = 0.5 * dx;
  const double sixth = dx / 6.0;
  double s = 0.0, sdn = 0.0, svn = 0.0;
  if (active) {
    const double* in = s0 + static_cast<size_t>(r) * kNstate;
    s = in[lane];
    sdn = in[kNm];
    svn = in[kNm + 1];
  }
  int j = 0, io = 0;
  for (int ch = 0; ch < nchunks; ++ch) {
    const long long base = static_cast<long long>(ch) * kChunk;
    const int nst =
        static_cast<int>(nsteps - base < kChunk ? nsteps - base : kChunk);
    const double* q = raw[ch & 1];
    if (threadIdx.x < 3 * nst)
      derive(c, q + threadIdx.x * kXCols, der[threadIdx.x]);
    if (active) {
      for (int sp = lane; sp < 3 * nst; sp += 32)
        k_derive(c, k, q + sp * kXCols, kdt[warp][sp]);
    }
    __syncthreads();
    if (ch + 2 < nchunks) stage(ch + 2);
    cp_async_commit();
    if (active) {
      for (int st = 0; st < nst; ++st) {
        const double* d0 = der[3 * st];
        const double* d1 = der[3 * st + 1];
        const double* d2 = der[3 * st + 2];
        const double* kd0 = kdt[warp][3 * st];
        const double* kd1 = kdt[warp][3 * st + 1];
        const double* kd2 = kdt[warp][3 * st + 2];
        double A, B, C, ds, ddn, dvn;
        lane_coefs(L, d0, kd0, A, B, C);
        lane_rhs(L, c, d0, kd0, A, B, C, kd0[kdTight] != 0.0, s, sdn, svn,
                 ds, ddn, dvn);                                    // k1
        double acc = ds, adn = ddn, avn = dvn;
        double t = s + half * ds, tdn = sdn + half * ddn,
               tvn = svn + half * dvn;
        lane_coefs(L, d1, kd1, A, B, C);
        const bool tc1 = kd1[kdTight] != 0.0;
        lane_rhs(L, c, d1, kd1, A, B, C, tc1, t, tdn, tvn, ds, ddn,
                 dvn);                                             // k2
        acc = acc + 2.0 * ds;
        adn = adn + 2.0 * ddn;
        avn = avn + 2.0 * dvn;
        t = s + half * ds;
        tdn = sdn + half * ddn;
        tvn = svn + half * dvn;
        lane_rhs(L, c, d1, kd1, A, B, C, tc1, t, tdn, tvn, ds, ddn,
                 dvn);                                             // k3
        acc = acc + 2.0 * ds;
        adn = adn + 2.0 * ddn;
        avn = avn + 2.0 * dvn;
        t = s + dx * ds;
        tdn = sdn + dx * ddn;
        tvn = svn + dx * dvn;
        lane_coefs(L, d2, kd2, A, B, C);
        const bool tc2 = kd2[kdTight] != 0.0;
        lane_rhs(L, c, d2, kd2, A, B, C, tc2, t, tdn, tvn, ds, ddn,
                 dvn);                                             // k4
        s = s + sixth * (acc + ds);
        sdn = sdn + sixth * (adn + ddn);
        svn = svn + sixth * (avn + dvn);
        if (tc2) {
          // while tight-coupled, the slaved multipoles at the new time:
          // each above l = 2 the one below times -(l/(2l+1)) ck/(Hp tau_x)
          const double ckhti = kd2[kdCkhti];
          const double th2 =
              -(8.0 / 15.0) * ckhti * __shfl_sync(kFull, s, kTh + 1);
          double v = pick(L.base_q, -0.25 * ckhti * th2, L.bm * th2);
#pragma unroll
          for (int l = 3; l < kNth; ++l) {
            const double cl = -(l / (2.0 * l + 1.0)) * ckhti;
            v = pick(l <= L.lvl, cl * v, v);
          }
          s = pick(L.lvl != 0, v, s);
        }
        if (++j == n_inner) {
          j = 0;
          if (stored != nullptr) {
            double* o =
                stored + (static_cast<size_t>(r) * n_outer + io) * kNstate;
            o[lane] = s;
            if (lane == 0) o[kNm] = sdn;
            if (lane == 1) o[kNm + 1] = svn;
          }
          ++io;
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();
  }
  if (active) {
    double* o = s_out + static_cast<size_t>(r) * kNstate;
    o[lane] = s;
    if (lane == 0) o[kNm] = sdn;
    if (lane == 1) o[kNm + 1] = svn;
  }
}

}  // namespace

extern "C" {

// Each launch function launches on `device` (and restores the caller's
// current device before it returns) and on `stream` (PyTorch's current
// stream), does not synchronise, and returns the cudaError_t of the launch
// (0 on success).  Every array is contiguous float64.

// x_e (batch, nsteps + 1) from tab (batch, nsteps, 3, 7), saha_next
// (batch, nsteps) and xe0 (batch,): one block a cosmology.
int hmvec_recomb_rk4(const double* tab, const double* saha_next,
                     const double* xe0, double dx, int nsteps, int batch,
                     double* xe, int device, void* stream) {
  const hmvec::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  recomb_rk4_kernel<<<batch, kRecThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, saha_next, xe0, dx, nsteps, xe);
  return static_cast<int>(cudaGetLastError());
}

// n_outer x n_inner RK4 steps of the hierarchy for rows k (rows,) from
// s0 (rows, 34) on the x-only table xtab (n_outer n_inner, 3, 10), with
// consts = (H0/c, Omega_gamma, Omega_nu massless, Omega_b, Omega_c): the
// final state into s_out (rows, 34) and, unless stored is null, the state
// after each outer block into stored (rows, n_outer, 34).  One warp a k,
// four k a block.
int hmvec_hierarchy_rk4(const double* xtab, const double* ks,
                        const double* consts, const double* s0, double dx,
                        int n_outer, int n_inner, int rows, double* s_out,
                        double* stored, int device, void* stream) {
  const hmvec::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  hierarchy_rk4_kernel<<<(rows + kHierWarps - 1) / kHierWarps,
                         kHierThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      xtab, ks, consts, s0, dx, n_outer, n_inner, rows, s_out, stored);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
