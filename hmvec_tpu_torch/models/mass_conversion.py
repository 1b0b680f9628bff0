"""NFW mass-definition conversion M1 at Delta1 -> M2 at Delta2 (port of
hmvec_tpu/models/mass_conversion.py).

Solves M1 / F(C1) = M2 / F(C2) with C2 = C1 ((M2/M1)(drho1/drho2))^(1/3) by
fixed-count bisection on log M2 (the objective is strictly decreasing),
over the whole (z, m) grid at once.

Derivatives: as in the JAX package, the bisection passes no derivative to
M2.  The bracket log M1 +- 10 is built from M1 + 0 C1, whose derivative is
zero, and ``torch.where`` only selects among such values, so
d M2 / d theta is exactly 0 (ROADMAP C5).
"""

from __future__ import annotations

import torch

from ..ops.rootfind import solve_bisection_root
from ..utils.weights import on_device_of_inputs, tensor_or_f64
from .profiles import fcon


@on_device_of_inputs
def mdelta_from_mdelta(M1, C1, delta_rhos1, delta_rhos2,
                       num_iter: int = 90, log_bracket: float = 10.0):
    """Convert masses M1 (nm,) at overdensity density delta_rhos1 (nz,) to
    M2 (nz, nm) at delta_rhos2 (nz,), given concentrations C1 (nz, nm)."""
    M1, C1, delta_rhos1, delta_rhos2 = map(
        tensor_or_f64, (M1, C1, delta_rhos1, delta_rhos2))
    M1g = M1[None, :] + 0.0 * C1
    logM1 = torch.log(M1g)
    dr1 = delta_rhos1[:, None]
    dr2 = delta_rhos2[:, None]
    F1 = 1.0 / fcon(C1)

    def objective(logM2):
        C2 = C1 * (torch.exp(logM2 - logM1) * (dr1 / dr2)) ** (1.0 / 3.0)
        return M1g * F1 - torch.exp(logM2) / fcon(C2)

    logM2 = solve_bisection_root(objective, logM1 - log_bracket,
                                 logM1 + log_bracket, num_iter)
    return torch.exp(logM2)


@on_device_of_inputs
def mdelta_from_mdelta_unvectorized(M1, C1, delta_rhos1, delta_rhos2,
                                    num_iter: int = 90,
                                    log_bracket: float = 10.0):
    """The same bisection on mutually broadcastable M1, C1, delta_rhos1,
    delta_rhos2 (scalars or any shapes); returns M2 with the broadcast
    shape."""
    args = (M1, C1, delta_rhos1, delta_rhos2)
    dev = next((v.device for v in args if isinstance(v, torch.Tensor)), None)
    M1, C1, dr1, dr2 = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float64, device=dev) for v in args))
    logM1 = torch.log(M1)
    F1 = 1.0 / fcon(C1)

    def objective(logM2):
        C2 = C1 * (torch.exp(logM2 - logM1) * (dr1 / dr2)) ** (1.0 / 3.0)
        return M1 * F1 - torch.exp(logM2) / fcon(C2)

    logM2 = solve_bisection_root(objective, logM1 - log_bracket,
                                 logM1 + log_bracket, num_iter)
    return torch.exp(logM2)
