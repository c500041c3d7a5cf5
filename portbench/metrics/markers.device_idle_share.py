"""markers.device_idle_share: the device's idle share of the traced
window, 1 - (the union of its kernels, copies and fills) / the window,
from torch.profiler's device records."""


def read(run):
    s = run.summary
    return 1.0 - s["busy_s"] / s["window_s"] if s and s["window_s"] else None
