"""Linear-theory pairwise velocities on float64 tensors: the part of
hmvec_tpu/models/rsd.py that the pairwise kSZ forecast needs
(``mean_pairwise_velocity``).  The Kaiser and Scoccimarro spectra, their
multipoles and the correlation multipoles come with the rsd/tns/spt group
of ROADMAP A9.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fftlog import correlation_function, fftlog_lnkr, fftlog_sphbessel_jl


def mean_pairwise_velocity(ks, pk, f, aH, b=1.0):
    """Mean pairwise (infall) velocity of tracers of linear bias b,

        v12(r) = -(2/3) f (aH) r b xibar(r) / (1 + b^2 xi(r)),

    with xibar(r) = (3 / (2 pi^2 r)) int dk k P(k) j1(kr) by the j1 FFTLog
    transform of P / k on the j0 transform's grid.  ks (nk,) a log-uniform
    numpy grid, pk (nk,) the matter power as a tensor; aH = a H(z) in
    km/s/Mpc gives v12 in km/s.  Returns (rs [comoving Mpc], v12)."""
    ks = np.asarray(ks, dtype=np.float64)
    pk = torch.as_tensor(pk, dtype=torch.float64)
    rs, xi = correlation_function(ks, pk)
    _, F1 = fftlog_sphbessel_jl(pk / torch.as_tensor(ks, device=pk.device),
                                ks, 1, lnkr=fftlog_lnkr(ks, mu=0.5))
    xibar = 3.0 * F1 / (2.0 * math.pi**2) / rs
    v12 = -(2.0 / 3.0) * f * aH * rs * b * xibar / (1.0 + b**2 * xi)
    return rs, v12
