"""Device time per call of the kernels launched outside models/power.py
and the hand-written kernels: the background, transfer, linear power,
mass function and profile stages and the pipeline's Catmull-Rom fill."""


def read(trace):
    kernels = trace.kernels()
    if not kernels:
        return None
    hand = sum(e - s for name, _, s, e in kernels
               if any(h in name for h in trace.context["hand_kernels"]))
    total = sum(e - s for _, _, s, e in kernels)
    per_call = ((total - hand) / trace.n_calls
                - trace.launched_us_per_call("models/power.py"))
    return per_call / 1e3
