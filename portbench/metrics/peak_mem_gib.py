"""torch.cuda.max_memory_allocated() over the window, on the fullest card."""


def read(window):
    return window.peak_bytes / 2**30
