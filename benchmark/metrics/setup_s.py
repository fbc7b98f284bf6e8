"""Seconds from the process's start to the first timed step: imports,
the kernels' build or load, the model, weights and traffic, the three
checked steps and the warm-up of every shape."""


def read(ctx):
    return ctx["setup_s"]
