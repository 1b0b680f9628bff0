"""Cosmologies whose spectra reached the host, over the whole window: from
the first call's issue to the last call's spectra in host memory."""


def read(window):
    return window.cosmologies / window.window_s
