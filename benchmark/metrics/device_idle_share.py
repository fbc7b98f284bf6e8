"""The device's idle share of the profiled window, %: one less the union
of its kernel and memory intervals over the window."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
