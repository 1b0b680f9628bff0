"""Device time per call of the kernels launched from models/power.py (the
1-halo and 2-halo mass integrals over the (z, m, k) cube)."""


def read(trace):
    us = trace.launched_us_per_call("models/power.py")
    return us / 1e3 if us > 0 else None
