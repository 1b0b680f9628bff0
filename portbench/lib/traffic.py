"""The one traffic generator: a closed loop of batched calls whose
parameters a traffic file (``portbench/traffic/<name>.json``) sets.

A file gives ``batch`` (cosmologies a call) and ``params``: for each varied
parameter its [low, high], drawn uniformly and independently.  Every draw
comes from ``--seed``: the same seed gives the same calls, in the same
order, and every seed gives calls of the same sizes.
"""

from __future__ import annotations

import numpy as np


def streams(seed: int, n: int):
    """n independent generators derived from one seed (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [np.random.default_rng(s) for s in ss.spawn(n)]


class Traffic:
    def __init__(self, spec: dict, rng: np.random.Generator):
        if spec.get("loop", "closed") != "closed":
            raise ValueError(f"traffic {spec.get('name')!r}: only the "
                             f"closed loop is generated")
        self.batch = int(spec["batch"])
        self.names = tuple(spec["params"])
        bounds = np.array([spec["params"][k] for k in self.names], float)
        self.low, self.width = bounds[:, 0], bounds[:, 1] - bounds[:, 0]
        self.rng = rng

    def next_batch(self) -> np.ndarray:
        """theta (batch, len(names)) float64 for the next call."""
        u = self.rng.random((self.batch, len(self.names)))
        return self.low + self.width * u

    def row(self, theta_row) -> dict:
        return dict(zip(self.names, (float(v) for v in theta_row)))
