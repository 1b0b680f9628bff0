"""TNS redshift-space power spectrum on float64 tensors (port of
hmvec_tpu/models/tns.py).

The Taruya-Nishimichi-Saito (2010) model adds the A(k, mu) and B(k, mu)
correction terms to the nonlinear Kaiser bracket:

    P_s(k,mu) = D_FoG(k mu sigma_v)
                [ b^2 P_dd + 2 b f mu^2 P_dt + f^2 mu^4 P_tt
                  + b^3 A(k,mu; beta) + b^4 B(k,mu; beta) ],  beta = f/b.

All the mu and f dependence is analytic: the 27 reduced kernels
(``_tns_kernels``) are contracted once per k against Gauss-Legendre
(ln q, ln y) node grids (the geometry of ``spt.p22``), and P_s at any
(mu, f, b, sigma_v) afterwards costs O(nk).  The k axis is evaluated in
chunks, as in ``spt``, so that each temporary stays within
``spt.PANEL_ELEMENTS``.
"""

from __future__ import annotations

import math

import torch

from ._tns_kernels import a_kernels, b_kernels
from .rsd import _fog, _legendre, _mu_nodes
from ..utils.weights import f64, on_device_of_inputs, tensor_or_f64
from .spt import _chunked, _pk_eval, _split, _tables

_F64 = torch.float64
_A_KEYS = ((1, 0), (1, 1), (3, 1), (3, 2), (5, 2))
_B_KEYS = ((0, 0), (0, 1), (0, 2), (2, 0), (2, 1), (2, 2), (4, 1), (4, 2),
           (6, 2))


def _ab_panel(ks, lnk_tab, lnp_tab, lnpdt_tab, lnptt_tab, lnlo, lnhi,
              tq, wq0, tx, wx, yfl):
    """One outer ln-q panel of all 27 TNS kernel integrals: the inner
    integral in y = |k-q|/k on ln-spaced nodes from max(|1-r|, qmin/k) to
    1+r.  Returns ({A key: (nk,)}, {B key: (nk,)})."""
    lnq = lnlo[:, None] + (lnhi - lnlo)[:, None] * tq[None, :]  # (nk,nq)
    wq = (lnhi - lnlo)[:, None] * wq0[None, :]
    q = torch.exp(lnq)
    r = (q / ks[:, None])[..., None]                            # (nk,nq,1)
    ymin = torch.maximum(torch.abs(1.0 - r), yfl[:, None, None])
    lny = torch.log(ymin) + (torch.log(1.0 + r) - torch.log(ymin)) * tx
    wy = torch.log((1.0 + r) / ymin) * wx                       # (nk,nq,ny)
    y = torch.exp(lny)

    ka = a_kernels(r, y)
    kb = b_kernels(r, y)

    # the P evaluations shared by all terms
    P_r = _pk_eval(lnk_tab, lnp_tab, q)                         # (nk,nq)
    P_y = _pk_eval(lnk_tab, lnp_tab, ks[:, None, None] * y)     # (nk,nq,ny)
    P_k = _pk_eval(lnk_tab, lnp_tab, ks)                        # (nk,)
    Pdt_r = _pk_eval(lnk_tab, lnpdt_tab, q)
    Pdt_y = _pk_eval(lnk_tab, lnpdt_tab, ks[:, None, None] * y)
    Ptt_r = _pk_eval(lnk_tab, lnptt_tab, q)
    Ptt_y = _pk_eval(lnk_tab, lnptt_tab, ks[:, None, None] * y)

    a_base = {"ry": P_r[..., None] * P_y,
              "rk": (P_r * P_k[:, None])[..., None],
              "yk": P_y * P_k[:, None, None]}
    b_base = {"dd": Pdt_r[..., None] * Pdt_y,
              "dt": Pdt_r[..., None] * Ptt_y,
              "td": Ptt_r[..., None] * Pdt_y,
              "tt": Ptt_r[..., None] * Ptt_y}

    def contract(kerns, bases):
        out = {}
        for (m, n, j), C in kerns.items():
            inner = torch.sum(wy * C * bases[j], dim=-1)        # (nk,nq)
            val = torch.sum(wq * inner, dim=-1)                 # (nk,)
            key = (m, n)
            out[key] = out.get(key, 0.0) + val
        return out

    return contract(ka, a_base), contract(kb, b_base)


@on_device_of_inputs
def tns_ab_integrals(ks, ks_tab, pk_tab, pdt_tab=None, ptt_tab=None,
                     n_q=256, n_x=128, qmin=None, qmax=None,
                     r_max=1000.0):
    """The mu/f-independent TNS integrals

        A(k,mu,f) = (mu f)   sum_{m,n} mu^m f^n I^A_mn(k),
        B(k,mu,f) = (mu f)^2 sum_{m,n} mu^m f^n I^B_mn(k),

    as {"A": {(m,n): (nk,)}, "B": {(m,n): (nk,)}} with k^3/4pi^2 folded
    in.  pk_tab: the linear power; pdt_tab/ptt_tab optionally replace the
    B-term's P_dt/P_tt legs.  r_max caps the q support at q <= r_max k:
    the A-term kernels cancel catastrophically in float64 beyond
    r = q/k ~ 3e3, while the physical UV tail of A is converged to ~1e-3
    by r ~ 1e3 (the cap binds only at the lowest ks)."""
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    lnk_tab, lnp_tab = _tables(dev, ks_tab, pk_tab)
    lnpdt = lnp_tab if pdt_tab is None else torch.log(f64(pdt_tab, dev))
    lnptt = lnp_tab if ptt_tab is None else torch.log(f64(ptt_tab, dev))
    nodes, lo, mid, hi, yfl = _split(ks, ks_tab, n_q, n_x, qmin, qmax, dev,
                                     r_max=r_max)

    def panel(k, a, b, fl):
        pa, pb = _ab_panel(k, lnk_tab, lnp_tab, lnpdt, lnptt, a, b, *nodes,
                           fl)
        return tuple(pa[key] for key in _A_KEYS) + tuple(pb[key]
                                                          for key in _B_KEYS)

    vals = _chunked(panel, ks, lo, mid, hi, yfl, (n_q // 2) * n_x)
    norm = ks**3 / (4.0 * math.pi**2)
    nA = len(_A_KEYS)
    A = {key: norm * v for key, v in zip(_A_KEYS, vals[:nA])}
    B = {key: norm * v for key, v in zip(_B_KEYS, vals[nA:])}
    return {"A": A, "B": B}


@on_device_of_inputs
def tns_a_term(ks, mu, f, ab, b=1.0):
    """b^3 A(k, mu; beta = f/b) from the ``tns_ab_integrals`` output; mu a
    scalar or (nmu,).  Returns (..., nk)."""
    ab = {"A": {mn: tensor_or_f64(I) for mn, I in ab["A"].items()}}
    dev = next(iter(ab["A"].values())).device
    mu = f64(mu, dev)[..., None]
    beta = f / b
    out = 0.0
    for (m, n), I in ab["A"].items():
        out = out + mu**m * beta**n * I
    return b**3 * (mu * beta) * out


@on_device_of_inputs
def tns_b_term(ks, mu, f, ab, b=1.0):
    """b^4 B(k, mu; beta = f/b) from the ``tns_ab_integrals`` output."""
    ab = {"B": {mn: tensor_or_f64(I) for mn, I in ab["B"].items()}}
    dev = next(iter(ab["B"].values())).device
    mu = f64(mu, dev)[..., None]
    beta = f / b
    out = 0.0
    for (m, n), I in ab["B"].items():
        out = out + mu**m * beta**n * I
    return b**4 * (mu * beta) ** 2 * out


@on_device_of_inputs
def tns_pk_mu(ks, mus, p_dd, p_dt, p_tt, b, f, ab, sigma_v=0.0,
              fog="gaussian"):
    """The TNS P_s(k, mu): the nonlinear Kaiser bracket on the one-loop
    P_dd/P_dt/P_tt plus the A and B terms, times the FoG factor.
    Returns (nmu, nk)."""
    p_dd = torch.as_tensor(p_dd, dtype=_F64)
    dev = p_dd.device
    ks, mus = f64(ks, dev), f64(mus, dev)
    mu = mus[:, None]
    core = (b**2 * p_dd[None, :]
            + 2.0 * b * f * mu**2 * f64(p_dt, dev)[None, :]
            + f**2 * mu**4 * f64(p_tt, dev)[None, :]
            + tns_a_term(ks, mus, f, ab, b=b)
            + tns_b_term(ks, mus, f, ab, b=b))
    return _fog(ks[None, :] * mu, sigma_v, fog) * core


@on_device_of_inputs
def tns_multipoles(ks, p_dd, p_dt, p_tt, b, f, ab, sigma_v=0.0,
                   ells=(0, 2, 4), fog="gaussian", n_mu=32):
    """Legendre multipoles of ``tns_pk_mu`` (Gauss-Legendre in mu).
    Returns {ell: (nk,)}."""
    p_dd = torch.as_tensor(p_dd, dtype=_F64)
    mus, w = _mu_nodes(n_mu, p_dd.device)
    ps = tns_pk_mu(ks, mus, p_dd, p_dt, p_tt, b, f, ab, sigma_v, fog)
    out = {}
    for ell in ells:
        wl = w * _legendre(ell, mus) * (2.0 * ell + 1.0) / 2.0
        out[ell] = torch.einsum("m,mk->k", wl, ps)
    return out


@on_device_of_inputs
def tns_power(ks, ks_tab, pk_tab, b=1.0, f=0.5, sigma_v=None,
              fog="gaussian", one_loop=True, n_q=256, n_x=128,
              qmin=None, qmax=None, ells=(0, 2, 4), n_mu=32):
    """TNS multipoles from a linear power table: one-loop P_dd/P_dt/P_tt
    (tree level with one_loop=False), A/B from the same table, and
    sigma_v defaulting to f * rsd.sigma_v_lin.  Returns (multipoles,
    {"pk_velocity", "ab", "sigma_v"})."""
    from .rsd import sigma_v_lin
    from .spt import pk_velocity_1loop
    pk_tab = torch.as_tensor(pk_tab, dtype=_F64)
    dev = pk_tab.device
    ks = f64(ks, dev)
    if one_loop:
        pv = pk_velocity_1loop(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x,
                               qmin=qmin, qmax=qmax)
    else:
        lnk, lnp = _tables(dev, ks_tab, pk_tab)
        Pl = _pk_eval(lnk, lnp, ks)
        pv = {"dd": Pl, "dt": Pl, "tt": Pl}
    ab = tns_ab_integrals(ks, ks_tab, pk_tab, n_q=n_q, n_x=n_x,
                          qmin=qmin, qmax=qmax)
    if sigma_v is None:
        sigma_v = f * sigma_v_lin(ks_tab, pk_tab)
    mp = tns_multipoles(ks, pv["dd"], pv["dt"], pv["tt"], b, f, ab,
                        sigma_v=sigma_v, fog=fog, ells=ells, n_mu=n_mu)
    return mp, {"pk_velocity": pv, "ab": ab, "sigma_v": sigma_v}
