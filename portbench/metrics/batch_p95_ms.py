"""The 95th percentile of the window's batched calls, each timed on the
host clock from issue until its spectra are in host memory."""

import numpy as np


def read(window):
    return float(np.percentile(np.asarray(window.latencies_ms), 95))
