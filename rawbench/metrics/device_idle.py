"""Share (%) of the traced window in which no operation ran on the
device, from the torch.profiler trace."""


def read(r):
    if r.window is None or r.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.window.busy_s() / r.window.window_s)
