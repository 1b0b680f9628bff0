"""Curved-sky two-point sums over Wigner small-d matrices on float64
tensors: the part of hmvec_tpu/models/shear.py that the covariance module
needs (``wigner_d_sum``, with which ``cov.angular_correlation`` sums the
Legendre series).  xi_+/xi_-, gamma_t and the rest come with the
shear/ia/master group of ROADMAP A9.

    sum_l (2l+1)/(4pi) C_l d^l_{mn}(theta)

by the upward three-term recurrence in l for all angles at once.  The JAX
package runs it as one ``lax.scan``; here it is a Python loop over l with
each step's coefficients formed on the host in float64, so a sum over nl
multipoles is about 8 nl launches of (..., ntheta) element-wise work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F64 = torch.float64

# (d^{lmin}_{mn}(x), d^{lmin+1}_{mn}(x)) at lmin = max(|m|, |n|) as closed
# forms in x = cos(theta): the recurrence's denominator vanishes at l = 0,
# so the (0, 0) case needs both seeds
_SEEDS = {
    (0, 0): (lambda x: torch.ones_like(x),
             lambda x: x),
    (2, 2): (lambda x: ((1.0 + x) / 2.0) ** 2,
             lambda x: ((1.0 + x) / 2.0) ** 2 * (3.0 * x - 2.0)),
    (2, -2): (lambda x: ((1.0 - x) / 2.0) ** 2,
              lambda x: ((1.0 - x) / 2.0) ** 2 * (3.0 * x + 2.0)),
    (2, 0): (lambda x: math.sqrt(6.0) / 4.0 * (1.0 - x**2),
             lambda x: math.sqrt(30.0) / 4.0 * x * (1.0 - x**2)),
}


def wigner_d_sum(ells, cls, thetas_rad, mn=(0, 0)):
    """sum_l (2l+1)/(4pi) C_l d^l_{mn}(theta) by upward recurrence
    (Varshalovich 4.8.1):

        d^{l+1} = [ (2l+1)(l(l+1) x - m n) d^l
                    - (l+1) sqrt((l^2-m^2)(l^2-n^2)) d^{l-1} ]
                  / [ l sqrt(((l+1)^2-m^2)((l+1)^2-n^2)) ]

    ells: (nl,) consecutive integers from any l0 >= 0 (rows below
    max(|m|, |n|) multiply d's that vanish and are ignored); cls (..., nl),
    a tensor whose device runs the sum; thetas_rad (nt,).  Returns
    (..., nt)."""
    m, n = int(mn[0]), int(mn[1])
    if (m, n) not in _SEEDS:
        raise ValueError(f"unsupported (m, n) = {(m, n)}; "
                         f"available: {sorted(_SEEDS)}")
    lmin = max(abs(m), abs(n))
    ells = np.asarray(ells)
    if ells.ndim != 1 or not np.all(np.diff(ells) == 1):
        raise ValueError("ells must be consecutive integers")
    cls = torch.as_tensor(cls, dtype=_F64)
    dev = cls.device
    x = torch.cos(torch.as_tensor(thetas_rad, dtype=_F64, device=dev))
    # weights (2l+1)/(4pi) C_l on the dense l range from lmin, (nl, ..., 1)
    nl_total = int(ells[-1]) + 1 - lmin
    wcls = cls * ((2.0 * torch.as_tensor(ells, dtype=_F64, device=dev) + 1.0)
                  / (4.0 * math.pi))
    keep = ells >= lmin
    w = torch.zeros((nl_total,) + cls.shape[:-1] + (1,), dtype=_F64,
                    device=dev)
    w[torch.as_tensor(ells[keep] - lmin, device=dev)] = \
        wcls[..., torch.as_tensor(np.nonzero(keep)[0], device=dev)] \
        .movedim(-1, 0)[..., None]
    fm, fn = float(m), float(n)
    seed0, seed1 = _SEEDS[(m, n)]
    dm1, d = seed0(x), seed1(x)
    # the l = lmin term first; the recurrence starts at l = lmin + 1, whose
    # denominator is nonzero for every supported spin pair
    acc = torch.zeros(cls.shape[:-1] + x.shape, dtype=_F64, device=dev) \
        + w[0] * dm1
    for j in range(1, nl_total):
        l = float(lmin + j)
        acc = acc + w[j] * d
        num = ((2.0 * l + 1.0) * (l * (l + 1.0) * x - fm * fn) * d
               - (l + 1.0) * math.sqrt((l**2 - fm**2) * (l**2 - fn**2)) * dm1)
        den = l * math.sqrt(((l + 1.0) ** 2 - fm**2)
                            * ((l + 1.0) ** 2 - fn**2))
        dm1, d = d, num / den
    return acc
