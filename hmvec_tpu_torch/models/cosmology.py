"""The user-facing Cosmology class on float64 tensors (port of
hmvec_tpu/models/cosmology.py).

A plain class over the staged functions of the port (background,
transfer, linear_power, limber) with the JAX class's method names and
signatures.  Everything it stores is a float64 tensor on one device, the
card unless ``device="cpu"`` is given; a ``device="cuda"`` without a card
raises.  Arguments may be Python numbers, numpy arrays or tensors; results
are tensors on the instance's device.

The scalars the JAX class reads back as Python floats (h, omm0, omk0,
oml0, ombh2, as8, YHe) are formed here on the host from the parameters,
with the background's own arithmetic, so building an instance reads
nothing back from the card; only a tensor parameter (moved to the
instance's device as ``params.to_torch_params`` moves it), or the sigma8 /
S8 rescale of As, is read back.

Nonlinear matter power (``halofit=``, ``P_mm_nonlinear``,
``get_pk_interpolator(nonlinear=True)``) dispatches as the JAX class does:
a tabulated engine's nonlinear table, else HMcode for 'mead*' and halofit
for the other versions.  ``theta100`` solves H0 on the host before the
background is built.

Every method of the JAX class answers (``DEFERRED`` is empty), the
engine-free primary CMB spectra (``get_cmb_cls(approx=True)``, the
boltzlite solver) and ``engine="boltz"`` included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import merge_params, to_torch_params
from ..utils.weights import on_device_of_inputs
from . import background as bgmod
from . import distances_ext as dext
from . import ia as iam
from . import limber as limb
from . import linear_power as lpm
from . import nonlimber as nlm
from .transfer import transfer_eh98

_F64 = torch.float64


# Cosmology methods whose module is still in A9, by group: none is left
DEFERRED = {}


@on_device_of_inputs
def a2z(a):
    """Scale factor -> redshift."""
    return 1.0 / torch.atleast_1d(torch.as_tensor(a, dtype=_F64)) - 1.0


def get_eds_model(fb=0.15, H0=68.0, YHe=0.25):
    """Einstein-de Sitter params from baryon fraction + H0."""
    om = 1.0
    h0 = H0 / 100.0
    return {"omch2": (1 - fb) * om * h0**2, "ombh2": fb * om * h0**2,
            "H0": H0, "mnu": 0.0, "YHe": YHe}


def _host(v) -> float:
    """A parameter as a Python float; a tensor is read back."""
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def _host_background(p):
    """(omm0, omk0, oml0, ombh2) on the host with the arithmetic of
    ``background.background``."""
    h = _host(p["H0"]) / 100.0
    omch2 = _host(p["omch2"])
    if p.get("omm") is not None:
        omch2 = _host(p["omm"]) * h**2 - _host(p["ombh2"])
    omm0 = (omch2 + _host(p["ombh2"])) / h**2
    omk0 = _host(p["omk"])
    return omm0, omk0, 1.0 - omm0 - omk0, _host(p["ombh2"])


class Cosmology:
    def __init__(self, params=None, halofit=None, engine="eh",
                 accuracy="medium", pk_table=None, cls_table=None,
                 growth="auto", engine_opts=None, device="cuda"):
        # imported here: the pipeline module imports models.ksz, which
        # imports this module
        from ..pipeline import _resolve_device

        self.device = _resolve_device(device)
        self.accuracy = accuracy
        self.p = merge_params(params)
        # a tensor parameter goes to the instance's device in float64 and
        # keeps its autograd history
        self.p.update(to_torch_params(
            {k: v for k, v in (params or {}).items()
             if isinstance(v, torch.Tensor)}, self.device))
        self.growth_mode = (bgmod.growth_mode_for(self.p)
                            if growth == "auto" else growth)
        self.params = self.p
        self.engine_name = engine if isinstance(engine, str) else \
            getattr(engine, "name", "custom")
        self._engine_opts = engine_opts
        self.halofit = halofit
        self.cls_table = dict(cls_table) if cls_table is not None else None
        # theta100: H0 solved on the host for the requested acoustic
        # scale (the EH98 / Hu-Sugiyama approximation of cosmomc_theta)
        if params and "theta100" in params:
            self.p["H0"] = dext.solve_h0_from_theta100(self.p,
                                                       params["theta100"])
        # the engine after theta100: a "boltz" solve must see the solved H0
        self.engine = lpm.make_engine(engine, pk_table, params=self.p,
                                      engine_opts=engine_opts,
                                      device=self.device)
        self.bg = bgmod.background(self.p, self.device)

        # sigma8 / S8: P_lin is linear in As, so As is rescaled to the
        # requested amplitude (one read of sigma8 back to the host)
        if params and ("sigma8" in params or "S8" in params):
            h = _host(self.p["H0"]) / 100.0
            omm0 = _host_background(self.p)[0]
            target = (params["sigma8"] if "sigma8" in params
                      else params["S8"] / np.sqrt(omm0 / 0.3))
            ks_s2 = lpm.sigma2_k_grid(self.p)
            z0 = self._t([0.0])
            spzk = self.engine.plin(self.bg, z0, self._t(ks_s2),
                                    accuracy="medium",
                                    growth_mode=self.growth_mode)
            s2 = lpm.sigma2_R(self.bg, self._t([8.0 / h]), z0, spzk, ks_s2,
                              self.p["Wkr_taylor_switch"])
            sigma8_now = float(torch.sqrt(s2[0, 0]))
            self.p["As"] = self.p["As"] * (target / sigma8_now) ** 2
            self.bg = bgmod.background(self.p, self.device)
        self.h = _host(self.p["H0"]) / 100.0
        self.omm0, self.omk0, self.oml0, self.ombh2 = _host_background(self.p)
        self.as8 = _host(self.p.get("as8", 1.0))
        self.YHe = _host(self.p.get("Yp", 0.24))

    def _t(self, x):
        """x as a float64 tensor on the instance's device."""
        return torch.as_tensor(x, dtype=_F64, device=self.device)

    # ---- background ----
    def hubble_parameter(self, z):
        return bgmod.hubble_parameter(self.bg, self._t(z))

    def h_of_z(self, z):
        return bgmod.h_of_z(self.bg, self._t(z))

    def comoving_radial_distance(self, z):
        return bgmod.comoving_radial_distance(self.bg, self._t(z))

    def angular_diameter_distance(self, z1, z2=None):
        return bgmod.angular_diameter_distance(
            self.bg, self._t(z1), None if z2 is None else self._t(z2))

    def redshift_at_comoving_radial_distance(self, chi, zmax=1e4):
        return bgmod.redshift_at_comoving_radial_distance(
            self.bg, self._t(chi), zmax)

    def sigma_crit(self, zlens, zsource):
        return bgmod.sigma_crit(self.bg, self._t(zlens), self._t(zsource))

    def rho_critical_z(self, z):
        return bgmod.rho_critical_z(self.bg, self._t(z))

    def rho_matter_z(self, z):
        return bgmod.rho_matter_z(self.bg, self._t(z))

    def omz(self, z):
        return bgmod.omz(self.bg, self._t(z))

    # ---- growth ----
    def D_growth_approx(self, a):
        return bgmod.growth_unnormalized(self.bg, self._t(a))

    def D_growth(self, a, type="anorm", exact=False):
        """D(a) normalized by ``type`` ('anorm' or 'z0norm'); exact=True
        forces the integrated growing mode, else the instance's mode."""
        mode = "ode" if exact else self.growth_mode
        return bgmod.d_growth(self.bg, self._t(a), norm=type, mode=mode)

    def D_growth_exact_arbitrary_norm(self, a):
        """The unnormalized integrated growing mode (D -> a in matter
        domination)."""
        return bgmod.growth_unnormalized(self.bg, self._t(a), mode="ode")

    def get_growth_rate_f(self, zs):
        return bgmod.growth_rate_f(self.bg, self._t(zs),
                                   mode=self.growth_mode)

    def bias_fnl(self, bg_bias, fnl, z, ks, deltac=1.42):
        """Scale-dependent local-fNL bias b + fnl 2 deltac (b - 1) / alpha."""
        beta = 2.0 * deltac * (bg_bias - 1.0)
        a = 1.0 / (1.0 + self._t(z))
        ks = self._t(ks)
        alpha = ((2.0 * ks**2 * self.Tk(ks, "eisenhu_osc"))
                 / (3.0 * self.bg.omm0 * bgmod.h_of_z(self.bg, 0.0) ** 2)
                 * bgmod.d_growth(self.bg, a, norm="anorm",
                                  mode=self.growth_mode))
        return bg_bias + fnl * (beta / alpha)

    def alpha_fnl(self, zs, ks, deltac=None):
        """alpha(z, k) of the fNL bias relation on the (nz, nk) grid."""
        del deltac
        zs = torch.atleast_1d(self._t(zs))
        ks = self._t(ks)
        D = bgmod.d_growth(self.bg, 1.0 / (1.0 + zs), norm="anorm",
                           mode=self.growth_mode)
        return ((2.0 * ks**2 * self.Tk(ks, "eisenhu_osc"))[None, :]
                / (3.0 * self.bg.omm0 * bgmod.h_of_z(self.bg, 0.0) ** 2)
                * D[:, None])

    # ---- linear power ----
    def Tk(self, ks, type="eisenhu_osc"):
        return transfer_eh98(self.bg, self._t(ks), type)

    def P_lin(self, ks, zs, knorm=1e-4, kmax=None):
        del knorm, kmax
        return self.engine.plin(self.bg, self._t(zs), self._t(ks),
                                accuracy="medium",
                                growth_mode=self.growth_mode)

    def P_lin_slow(self, ks, zs, kmax=None):
        del kmax
        return self.engine.plin(self.bg, self._t(zs), self._t(ks),
                                accuracy="high"
                                if self.engine.name == "tabulated"
                                else "medium",
                                growth_mode=self.growth_mode)

    def P_lin_approx(self, ks, zs, type="eisenhu_osc"):
        return lpm.plin_approx(self.bg, self._t(zs), self._t(ks), type,
                               growth_mode=self.growth_mode)

    def P_mm_linear(self, zs, ks):
        """Linear matter power on (zs, ks)."""
        return self._get_matter_power(zs, ks, nonlinear=False)

    def P_mm_nonlinear(self, ks, zs, halofit_version="mead"):
        """Nonlinear matter power on (zs, ks) for a halofit version (a
        tabulated engine: its nonlinear table)."""
        old = self.halofit
        self.halofit = halofit_version
        try:
            return self._get_matter_power(zs, ks, nonlinear=True)
        finally:
            self.halofit = old

    def P_mm_1loop(self, zs, ks, n_q=512, n_x=256, n_q13=1024,
                   qmin=1e-4, qmax=1e2, ir_resum=False):
        """One-loop SPT matter power P_lin + P22 + P13 (models/spt.py) on
        (zs, ks).  The loops are evaluated once at z = 0 and scaled by
        D(z)^4; ir_resum=True applies the IR resummation of the BAO
        wiggles (spt.p1loop_ir, the wiggles split against the EH98
        zero-baryon template) at each z."""
        from . import spt
        from .transfer import _eh_scales
        zs = torch.atleast_1d(self._t(zs))
        ks = self._t(ks)
        ks_tab = np.geomspace(1e-5, 1e3, 1200)
        if not ir_resum:
            pk0 = self.P_lin(ks_tab, [0.0])[0]
            loops0 = (spt.p22(ks, ks_tab, pk0, n_q=n_q, n_x=n_x,
                              qmin=qmin, qmax=qmax)
                      + spt.p13(ks, ks_tab, pk0, n_q=n_q13,
                                qmin=qmin, qmax=qmax))
            Plin = self.P_lin(ks, zs)
            D = self.D_growth(1.0 / (1.0 + zs))
            D0 = self.D_growth(1.0)
            return Plin + ((D / D0) ** 4)[:, None] * loops0[None, :]
        sc = _eh_scales(self.bg)
        ell_bao = sc["sh_d"] / sc["h"]
        tmpl = lpm.plin_approx(self.bg, self._t([0.0]), self._t(ks_tab),
                               "eisenhu", growth_mode=self.growth_mode)[0]
        pk_z = self.P_lin(ks_tab, zs)                       # (nz, nkt)
        rows = [spt.p1loop_ir(ks, ks_tab, pk_z[i], tmpl, ell_bao,
                              n_q=n_q, n_x=n_x, n_q13=n_q13,
                              qmin=qmin, qmax=qmax)
                for i in range(zs.shape[0])]
        return torch.stack(rows, dim=0)

    def get_rsd_multipoles(self, zs, ks, b=1.0, model="tns",
                           sigma_v=None, fog="gaussian", ells=(0, 2, 4),
                           n_mu=32, n_q=256, n_x=128, n_q13=512,
                           qmin=1e-4, qmax=1e2):
        """Redshift-space power multipoles P_ell(k, z), {ell: (nz, nk)}.

        model: 'kaiser' (linear), 'scoccimarro' (the nonlinear Kaiser
        bracket on the one-loop density/velocity spectra) or 'tns' (with
        the A/B terms).  f(z) is the growth rate; every loop ingredient
        is computed once at z = 0 and carried to each z by powers of
        D(z)/D(0) (P_lin ~ D^2, the loops and A/B ~ D^4).  b: linear
        bias, scalar or (nz,); sigma_v: the FoG scale in Mpc, scalar,
        (nz,) or None (f(z) D(z) sigma_v_lin(z = 0))."""
        from . import rsd, spt, tns
        zs = torch.atleast_1d(self._t(zs))
        ks = self._t(ks)
        nz = zs.shape[0]
        a = 1.0 / (1.0 + zs)
        Dz = self.D_growth(a) / self.D_growth(1.0)
        fz = self.get_growth_rate_f(zs).expand(nz)
        bz = self._t(b).expand(nz)
        ks_tab = np.geomspace(1e-5, 1e3, 1200)
        pk0 = self.P_lin(ks_tab, [0.0])[0]
        if sigma_v is None:
            sv = fz * Dz * rsd.sigma_v_lin(ks_tab, pk0)
        else:
            sv = self._t(sigma_v).expand(nz)
        if model == "kaiser":
            Plin = self.P_lin(ks, zs)                      # (nz, nk)
            return rsd.rsd_multipoles(ks, Plin, bz, fz, sigma_v=sv,
                                      ells=ells, fog=fog, n_mu=n_mu)
        lnkt = torch.log(self._t(ks_tab))
        Plin0 = spt._pk_eval(lnkt, torch.log(pk0), ks)     # (nk,)
        pv0 = spt.pk_velocity_1loop(ks, ks_tab, pk0, n_q=n_q, n_x=n_x,
                                    n_q13=n_q13, qmin=qmin, qmax=qmax)
        loops0 = {ab: pv0[ab] - Plin0 for ab in ("dd", "dt", "tt")}
        D2 = Dz[:, None] ** 2
        D4 = Dz[:, None] ** 4
        pz = {ab: D2 * Plin0[None, :] + D4 * loops0[ab][None, :]
              for ab in ("dd", "dt", "tt")}
        if model == "scoccimarro":
            return rsd.scoccimarro_multipoles(
                ks, pz["dd"], pz["dt"], pz["tt"], bz, fz, sigma_v=sv,
                ells=ells, fog=fog, n_mu=n_mu)
        if model != "tns":
            raise ValueError(f"model {model!r}: expected 'kaiser', "
                             "'scoccimarro' or 'tns'")
        ab0 = tns.tns_ab_integrals(ks, ks_tab, pk0, n_q=n_q, n_x=n_x,
                                   qmin=qmin, qmax=qmax)
        rows = []
        for i in range(nz):
            abz = {"A": {k_: Dz[i] ** 4 * v for k_, v in
                         ab0["A"].items()},
                   "B": {k_: Dz[i] ** 4 * v for k_, v in
                         ab0["B"].items()}}
            rows.append(tns.tns_multipoles(
                ks, pz["dd"][i], pz["dt"][i], pz["tt"][i], bz[i], fz[i],
                abz, sigma_v=sv[i], ells=ells, fog=fog, n_mu=n_mu))
        return {ell: torch.stack([r[ell] for r in rows], dim=0)
                for ell in ells}

    def get_pk_interpolator(self, zs, kmax, var="weyl", nonlinear=False,
                            return_z_k=False, k_per_logint=None,
                            log_interp=True, extrap_kmax=None):
        """A P(z, k) evaluator with the reference's interface: an object
        whose ``.P(zs, ks, grid=True)`` evaluates 'total' (matter), 'cb'
        (cold matter, linear) or 'weyl' (the Weyl-potential spectrum by
        the Poisson relation) exactly on the requested points."""
        del k_per_logint, log_interp, extrap_kmax
        cosmo = self

        class _PK:
            def P(self, pzs, pks, grid=True):
                pzs = torch.atleast_1d(cosmo._t(pzs))
                pks = torch.atleast_1d(cosmo._t(pks))
                if var == "cb":
                    if nonlinear:
                        raise NotImplementedError(
                            "var='cb' nonlinear needs a cb table; use "
                            "var='total' or linear")
                    p = cosmo.engine.plin(cosmo.bg, pzs, pks,
                                          accuracy="medium",
                                          growth_mode=cosmo.growth_mode,
                                          component="cb")
                else:
                    p = cosmo._get_matter_power(pzs, pks,
                                                nonlinear=nonlinear)
                if var == "weyl":
                    h0i = cosmo.bg.H0 / dext.CSPEED_KMS
                    pref = (1.5 * cosmo.bg.omm0 * h0i**2
                            * (1.0 + pzs))[:, None] ** 2
                    p = pref * p / pks[None, :] ** 4
                if not grid:
                    p = torch.diagonal(p)
                return p

        pk = _PK()
        if return_z_k:
            zarr = np.atleast_1d(np.asarray(zs, dtype=np.float64))
            karr = np.geomspace(1e-4, float(kmax), 256)
            return pk, zarr, karr
        return pk

    def _get_matter_power(self, zs, ks, nonlinear=False):
        zs, ks = self._t(zs), self._t(ks)
        if nonlinear:
            if self.engine.name == "tabulated":
                return self.engine.pzk_grid(self.bg, zs, ks, nonlinear=True)
            # the halofit string is CAMB's halofit_version (default 'mead')
            version = self.halofit
            if version in (None, True):
                version = self.p.get("default_halofit", "mead")
            hmcode = {"mead": "2016", "mead2016": "2016", "hmcode": "2016",
                      "mead2015": "2015", "mead2020": "2020",
                      "mead2020_feedback": "2020_feedback"}
            if version in hmcode:
                from .hmcode import hmcode_power
                return hmcode_power(self, zs, ks, version=hmcode[version])
            from .halofit import halofit_power
            if version in ("original", "smith", "smith03"):
                return halofit_power(self, zs, ks, version="original")
            if version in ("takahashi", "bird", "peacock", "casarini"):
                return halofit_power(self, zs, ks, version=version)
            raise ValueError(
                f"halofit version {version!r}: supported are 'mead' "
                "(HMcode-2016, default), 'mead2015', 'mead2020', "
                "'mead2020_feedback', 'takahashi', 'original', 'bird', "
                "'peacock', 'casarini' (the reference's "
                "bin/test_halofit.py sweep + CAMB>=1.3's defaults)")
        return self.engine.pzk_grid(self.bg, zs, ks, nonlinear=False,
                                    growth_mode=self.growth_mode)

    def get_sigma2_R(self, R, zs, kmin=None, kmax=None, numks=None):
        """sigma^2(z, R), shape (nz, nR)."""
        p = dict(self.p)
        for key, val in (("sigma2_kmin", kmin), ("sigma2_kmax", kmax),
                         ("sigma2_numks", numks)):
            if val is not None:
                p[key] = val
        ks_s2 = lpm.sigma2_k_grid(p)
        zs = self._t(zs)
        spzk = self.engine.plin(self.bg, zs, self._t(ks_s2),
                                accuracy=self.accuracy,
                                growth_mode=self.growth_mode)
        R = torch.atleast_1d(self._t(R))
        return lpm.sigma2_R(self.bg, R, zs, spzk, ks_s2,
                            self.p["Wkr_taylor_switch"])

    def get_sigma8(self, zs, kmin=1e-4, kmax=None, numks=1000):
        r = self.get_sigma2_R(8.0 / self.p["H0"] * 100.0, zs,
                              kmin=kmin, kmax=kmax, numks=numks)
        return torch.sqrt(r[:, 0])

    # ---- Limber projections (the limber module) ----
    def lensing_window(self, ezs, zs, dndz=None):
        return limb.lensing_window(self.bg, ezs, zs, dndz)

    def C_kk(self, ells, zs, ks, Pmm, **kw):
        return limb.C_kk(self.bg, ells, zs, ks, Pmm, **kw)

    def C_kg(self, ells, zs, ks, Pgm, gzs, **kw):
        return limb.C_kg(self.bg, ells, zs, ks, Pgm, gzs, **kw)

    def C_gg(self, ells, zs, ks, Pgg, gzs, **kw):
        return limb.C_gg(self.bg, ells, zs, ks, Pgg, gzs, **kw)

    def C_gy(self, ells, zs, ks, Pgp, gzs, **kw):
        return limb.C_gy(self.bg, ells, zs, ks, Pgp, gzs, **kw)

    def C_ky(self, ells, zs, ks, Pym, **kw):
        return limb.C_ky(self.bg, ells, zs, ks, Pym, **kw)

    def C_yy(self, ells, zs, ks, Ppp, **kw):
        return limb.C_yy(self.bg, ells, zs, ks, Ppp, **kw)

    # ---- intrinsic alignments and magnification (the ia module) ----
    def C_II(self, ells, zs, ks, Pmm, gzs, dndz1, **kw):
        """NLA intrinsic-intrinsic spectrum (models/ia.py)."""
        kw.setdefault("growth_mode", self.growth_mode)
        return iam.C_II(self.bg, ells, zs, ks, Pmm, gzs, dndz1, **kw)

    def C_kI(self, ells, zs, ks, Pmm, gzs, sdndz, **kw):
        """NLA GI spectrum, lensing x intrinsic (models/ia.py)."""
        kw.setdefault("growth_mode", self.growth_mode)
        return iam.C_kI(self.bg, ells, zs, ks, Pmm, gzs, sdndz, **kw)

    def C_gI(self, ells, zs, ks, Pgm, gzs, gdndz, sdndz, **kw):
        """Lens density x source intrinsic alignment (models/ia.py)."""
        kw.setdefault("growth_mode", self.growth_mode)
        return iam.C_gI(self.bg, ells, zs, ks, Pgm, gzs, gdndz, sdndz, **kw)

    def shear_cls_with_ia(self, ells, zs, ks, Pmm, gzs, sdndz1, **kw):
        """{'GG', 'GI', 'II', 'total'} observed shear spectra
        (models/ia.py)."""
        kw.setdefault("growth_mode", self.growth_mode)
        return iam.shear_cls_with_ia(self.bg, ells, zs, ks, Pmm, gzs,
                                     sdndz1, **kw)

    def C_gg_mag(self, ells, zs, ks, Pgg, Pgm, Pmm, gzs, gdndz, s_mag, **kw):
        """Clustering with magnification bias (models/ia.py)."""
        return iam.C_gg_mag(self.bg, ells, zs, ks, Pgg, Pgm, Pmm, gzs,
                            gdndz, s_mag, **kw)

    def C_kg_mag(self, ells, zs, ks, Pgm, Pmm, gzs, gdndz, s_mag, **kw):
        """Lensing x galaxies with lens magnification (models/ia.py)."""
        return iam.C_kg_mag(self.bg, ells, zs, ks, Pgm, Pmm, gzs, gdndz,
                            s_mag, **kw)

    # ---- exact (non-Limber) linear projections (the nonlimber module) ----
    def C_gg_exact(self, ells, ks, pk0, gzs, gdndz, **kw):
        """Exact low-ell linear galaxy C_l (models/nonlimber.py)."""
        kw.setdefault("growth_mode", self.growth_mode)
        return nlm.C_gg_exact(self.bg, ells, ks, pk0, gzs, gdndz, **kw)

    def C_kg_exact(self, ells, ks, pk0, gzs, gdndz, **kw):
        kw.setdefault("growth_mode", self.growth_mode)
        return nlm.C_kg_exact(self.bg, ells, ks, pk0, gzs, gdndz, **kw)

    def C_kk_exact(self, ells, ks, pk0, **kw):
        kw.setdefault("growth_mode", self.growth_mode)
        return nlm.C_kk_exact(self.bg, ells, ks, pk0, **kw)

    def C_gg_hybrid(self, ells, ks, pk0, zs_nl, pzk_nl, gzs, gdndz, **kw):
        """Exact-low-ell + Limber-high-ell galaxy spectrum of a full
        nonlinear P_gg (models/nonlimber.C_gg_hybrid)."""
        return nlm.C_gg_hybrid(self.bg, ells, ks, pk0, zs_nl, pzk_nl,
                               gzs, gdndz, **kw)

    def C_kk_hybrid(self, ells, ks, pk0, zs_nl, pzk_nl, **kw):
        """Exact-low-ell + Limber-high-ell convergence spectrum of a full
        nonlinear P_mm (models/nonlimber.C_kk_hybrid)."""
        return nlm.C_kk_hybrid(self.bg, ells, ks, pk0, zs_nl, pzk_nl, **kw)

    def get_Omega_nu(self):
        """Massive-neutrino density fraction."""
        return self.bg.omnu0

    # ---- conformal time, recombination, BAO (the distances_ext module) ----
    def conformal_time(self, z):
        """eta(z) in Mpc; the conformal age below z = 1e-5; a 0-d tensor
        for one redshift."""
        z = torch.atleast_1d(self._t(z))
        out = torch.where(z < 1e-5, dext.conformal_age(self.bg),
                          dext.conformal_time(self.bg, z))
        return out if out.numel() > 1 else out[0]

    def get_tau_star(self):
        return dext.tau_star(self.bg)

    def z_of_tau(self, tau):
        return dext.z_of_tau(self.bg, self._t(tau))

    def get_bao_rs_dV(self, zs):
        return dext.get_bao_rs_dV(self.bg, self._t(zs))

    def cmb_lensing_limber(self, lmax, nonlinear=False):
        return dext.cmb_lensing_limber(self, lmax, nonlinear=nonlinear)

    # ---- primary CMB spectra ----
    def get_cmb_cls(self, lmax=3000, lens_potential_accuracy=4,
                    nonlinear=True, approx=False, lens_method="resummed"):
        """Primary CMB power spectra: the dict {'total', 'unlensed_scalar',
        'lens_potential'} (muK^2, raw C_l, rows 0..lmax) as float64
        tensors on the instance's device.

        From the constructor's ``cls_table`` (as CAMB would give them;
        tools/gen_camb_table.py writes one): the table's keys
        ('cls_lensed', 'cls_unlensed', 'cls_lens_potential'), cut or
        NaN-padded to lmax + 1.  Without a table, ``approx=True`` runs the
        built-in reduced Boltzmann solver (models/boltzlite.py) to
        lmax + 400: its unlensed TT/EE/TE, and a lensing potential that
        blends its exact (non-Limber) projection below L = 80 into
        ``cmb_lensing_limber(nonlinear=)`` above L = 130, linearly in
        between; 'total' lenses them by the resummed correlation-function
        method (``lens_method='resummed'``, models/lensed_cf.py) or the
        first-order convolution (``'first_order'``, models/lensed_cls.py).
        The dict then carries ``'approx': True``."""
        del lens_potential_accuracy
        if self.cls_table is None:
            if not approx:
                raise NotImplementedError(
                    "Primary CMB Cls need a Boltzmann product; pass "
                    "cls_table=... to the ctor (generate offline with "
                    "tools/gen_camb_table.py) for CAMB precision, or call "
                    "with approx=True for the built-in few-percent "
                    "boltzlite solver (models/boltzlite.py).")
            return self._cmb_cls_boltzlite(lmax, nonlinear, lens_method)
        del nonlinear, lens_method

        def cut(arr):
            arr = np.asarray(arr, dtype=np.float64)
            n = lmax + 1
            if arr.shape[0] >= n:
                return self._t(arr[:n])
            pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
            return self._t(np.pad(arr, pad, constant_values=np.nan))

        keys = {"total": "cls_lensed", "unlensed_scalar": "cls_unlensed",
                "lens_potential": "cls_lens_potential"}
        out = {name: cut(self.cls_table[key]) for name, key in keys.items()
               if key in self.cls_table}
        if not out:
            raise ValueError(
                "cls_table has none of the recognized keys "
                "('cls_lensed', 'cls_unlensed', 'cls_lens_potential')")
        return out

    def _cmb_cls_boltzlite(self, lmax, nonlinear, lens_method):
        """get_cmb_cls(approx=True) without a table (see there)."""
        from . import boltzlite, lensed_cf, lensed_cls
        if lens_method == "resummed":
            lens_fn = lensed_cf.lens_cls_flat_sky_resummed
        elif lens_method == "first_order":
            lens_fn = lensed_cls.lens_cls_flat_sky
        else:
            raise ValueError(f"unknown lens_method {lens_method!r}")
        lpad = lmax + 400
        unl, clpp_exact = boltzlite.compute_cls(dict(self.p), lmax=lpad,
                                                lens_potential=True,
                                                device=self.device)
        unl = self._t(unl)
        _, clkk = self.cmb_lensing_limber(lpad, nonlinear=nonlinear)
        ells = torch.arange(lpad + 1, dtype=_F64, device=self.device)
        e2 = ells[2:]
        clpp = torch.zeros(lpad + 1, dtype=_F64, device=self.device)
        clpp[2:] = 4.0 * self._t(clkk) / (e2 * e2 * ((e2 + 1.0)
                                                     * (e2 + 1.0)))
        # low L: the exact LOS projection of the solve replaces Limber;
        # linear blend over L in [80, 130], Limber alone above
        wts = torch.clamp((ells - 80.0) / 50.0, 0.0, 1.0)
        clpp = wts * clpp + (1.0 - wts) * self._t(clpp_exact)[:lpad + 1]
        total = lens_fn(unl, clpp, lmax_out=lmax)
        el = ells[2:lmax + 1]
        ll1 = el * (el + 1.0)
        dd = torch.zeros((lmax + 1, 3), dtype=_F64, device=self.device)
        dd[2:, 0] = clpp[2:lmax + 1] * (ll1 * ll1) / (2.0 * np.pi)
        return {"total": self._t(total), "unlensed_scalar": unl[:lmax + 1],
                "lens_potential": dd, "approx": True}

    def cmb_lensing_kk_exact(self, lmax, lens_potential_accuracy=4):
        """Exact (non-Limber) C_kappakappa from the table's lensing
        potential (CAMB's deflection C_l [L(L+1)]^2 C_phiphi / 2pi, times
        2pi / 4), NaN-padded to lmax + 1: (ells, C_kk) on the instance's
        device."""
        del lens_potential_accuracy
        if self.cls_table is None or "cls_lens_potential" not in (
                self.cls_table or {}):
            raise NotImplementedError(
                "Exact C_kk requires a tabulated lensing potential "
                "(cls_table['cls_lens_potential'], from "
                "tools/gen_camb_table.py); use cmb_lensing_limber "
                "otherwise.")
        cl = np.asarray(self.cls_table["cls_lens_potential"],
                        dtype=np.float64)
        if cl.ndim > 1:          # CAMB's get_lens_potential_cls: (nl, 3)
            cl = cl[:, 0]
        if cl.size < lmax + 1:   # NaN-padded like get_cmb_cls
            cl = np.concatenate([cl, np.full(lmax + 1 - cl.size, np.nan)])
        cl = cl[:lmax + 1]
        ells = np.arange(cl.size)
        return (torch.as_tensor(ells, device=self.device),
                self._t(cl * 2.0 * np.pi / 4.0))

    # ---- baryon combinators ----
    def total_matter_power_spectrum(self, Pnn, Pne, Pee):
        from .power import total_matter_power_spectrum
        return total_matter_power_spectrum(self.p["omch2"], self.p["ombh2"],
                                           Pnn, Pne, Pee)

    def total_matter_galaxy_power_spectrum(self, Pgn, Pge):
        from .power import total_matter_galaxy_power_spectrum
        return total_matter_galaxy_power_spectrum(self.p["omch2"],
                                                  self.p["ombh2"], Pgn, Pge)

