"""Device milliseconds a step in the port's attention kernels: every
instance of K1 (`flash_fwd*`), K2 (`flash_dq*`), K3 (`flash_dkv*`) and
the backward's delta (`flash_bwd_delta*`)."""

GROUPS = ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")


def read(ctx):
    ms = ctx["ms_per_step"](*GROUPS)
    return ms if ms > 0 else None
