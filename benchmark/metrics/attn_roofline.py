"""The attention kernels' share of their roofline, %: the least time of
every launch of K1, delta, K2 and K3 in the profiled steps (the largest
of its bytes over the memory rate, its FLOPs over the bf16 rate and its
exponentials over the exponential rate, counted from the step's real
masks by `benchmark/counts.py`), over their device time."""

GROUPS = ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")


def read(ctx):
    ms = ctx["ms_per_step"](*GROUPS)
    if ms <= 0 or not ctx["attn_least_s"]:
        return None
    return 100.0 * ctx["attn_least_s"] / (ms * ctx["steps"] / 1e3)
