"""device.idle_share: the share of the traced window in which no operation
ran on the device: 1 − the union of the intervals of every kernel, copy and
fill, over the window."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
