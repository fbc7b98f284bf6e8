"""`workloads/profile_step.py`'s kernel groups: every flash-attention
kernel instance lands in its kernel's group (K1, K2, K3 or the backward's
delta), whatever its dtype, tile or feed, and nothing else lands there."""
import glob
import os
import re

import pytest

from shockwave_tpu_torch.ops import flash_attention as fa
from shockwave_tpu_torch.workloads import profile_step

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "shockwave_tpu_torch", "csrc")
FAMILIES = ("flash_bwd_delta", "flash_fwd", "flash_dq", "flash_dkv")


def _family(name: str) -> str:
    return next(f for f in FAMILIES if name.startswith(f))


def _kernel_functions():
    """The `__global__` functions of the port's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        names |= set(re.findall(r"__global__.*?\b(flash_\w+_kernel)\s*\(", src, flags=re.S))
    return names


@pytest.mark.parametrize("name", sorted(fa.LAUNCHES))
def test_every_launch_counter_gets_its_flash_group(name):
    assert profile_step.group_of(name) == _family(name)


def test_every_kernel_function_gets_its_flash_group():
    """As the profiler names them: demangled, in the anonymous namespace,
    with template arguments (the TMA-fed, f32 and wide instances landed in
    "other" while the groups matched `flash_fwd_kernel` and the like)."""
    functions = _kernel_functions()
    assert {"flash_fwd_tma_f32_kernel", "flash_dq_wide_f32_kernel", "flash_dkv_tma_kernel",
            "flash_bwd_delta_kernel", "flash_fwd_kernel"} <= functions
    for fn in functions:
        shown = f"void (anonymous namespace)::{fn}<64>(CUtensorMap, float const*, int)"
        assert profile_step.group_of(shown) == _family(fn), fn
    for other in ("ampere_bf16_s16816gemm_bf16_128x64", "vectorized_elementwise_kernel",
                  "reduce_kernel<512, 1>", "cudnn::bn_fw_tr_1C11_kernel"):
        assert not profile_step.group_of(other).startswith("flash")
