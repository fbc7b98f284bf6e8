"""The whole step's share of the card's dense bf16 peak, %: the model
FLOPs of the profiled steps (`drivers/<family>.py`'s count of the products the
inputs need, backward as twice the forward) over the profiled window."""


def read(ctx):
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / ctx["peak_flops"]
