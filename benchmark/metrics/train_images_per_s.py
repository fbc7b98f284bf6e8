"""Images trained a second: every image of every step the window
started, divided by the whole window, which ends in a synchronisation."""


def read(ctx):
    return ctx["work"] / ctx["window_s"]
