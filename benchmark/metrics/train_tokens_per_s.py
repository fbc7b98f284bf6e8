"""Target tokens trained a second: the non-pad target tokens over which
each step's masked loss is taken, over every step the window started,
divided by the whole window, which ends in a synchronisation."""


def read(ctx):
    return ctx["work"] / ctx["window_s"]
