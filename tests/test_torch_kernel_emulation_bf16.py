"""The kernels' CUDA source, run on the CPU, against the plain versions:
the bf16 instances (the f32 ones are `test_torch_kernel_emulation.py`,
whose emulated library, checks and tolerances these tests share; the two
files are apart so that the test workers can run them side by side).
"""
import os
import sys

import pytest
import torch

from shockwave_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_kernel_emulation import (CASES, PADDED_CASES, _reached,  # noqa: E402
                                         check_kernels, lib)  # noqa: F401 (a fixture)

# The bf16 instances: both tiles (32 up to T = 32, 64 beyond) at every
# head dim, ragged ends, Tq != Tk, the row that sees no key at each tile,
# and d = 96 padded to 128; at D = 256 the short tile with the row that
# sees no key, the long tile at Tq != Tk, and d = 200 padded to 256 with
# the row that sees no key at the long tile; at D = 512 the wide bf16
# instances (K2 and K3 on the short tile, 32 rows of each of two (batch,
# head) pairs, the second missing at BH = 1; K3 in two 256-column
# slices), causal and ragged, with the row that sees no key.
BF16_CASES = [
    (1, 17, 17, 1, 512, True, "key0"),
    (1, 32, 32, 1, 256, True, "key0"),
    (1, 24, 40, 1, 256, False, "tail"),
    (1, 40, 40, 1, 200, True, "key0"),
    (2, 17, 17, 2, 128, True, "tail"),
    (1, 40, 72, 1, 128, False, "key0"),
    (1, 65, 65, 1, 128, True, "tail"),
    (2, 32, 32, 2, 64, True, "key0"),
    (1, 48, 48, 2, 64, False, "tail"),
    (2, 24, 24, 2, 32, True, "tail"),
    (1, 33, 64, 1, 32, False, None),
    (1, 72, 72, 1, 96, True, "key0"),
]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,mask_kind", BF16_CASES)
def test_bf16_kernels_match_the_plain_versions(lib, b, tq, tk, h, d, causal, mask_kind):
    check_kernels(lib, torch.bfloat16, b, tq, tk, h, d, causal, mask_kind)


def test_every_bf16_tile_is_emulated():
    """The bf16 cases reach both tiles of each bf16 instance at every head
    dim (K1-K3's long tile through their TMA-fed instances, each at every
    one of its widths), the row that
    sees no key at both tiles (at D = 256 too), and d = 96 and 200
    padded."""
    for name in fa.KERNELS:
        assert _reached(BF16_CASES, name) == {(tile, d) for d in fa.KERNEL_HEAD_DIMS
                                              for tile in fa.KERNEL_TILES[name, d][:2]}, name
        for widths in (fa.KERNEL_HEAD_DIMS, (256,)):
            met = set()
            for c in BF16_CASES:
                width = fa.kernel_head_dim(c[4])
                if c[6] == "key0" and width in widths:
                    tile = fa.launch_config(c[1], c[2], width, name)
                    met.add("short" if tile == fa.KERNEL_TILES[name, width][0] else "long")
            assert met == {"short", "long"}, (name, widths)
    reached = {(fa.instance(name, torch.bfloat16, fa.kernel_head_dim(c[4]), c[1], c[2]),
                fa.kernel_head_dim(c[4])) for name in fa.KERNELS for c in BF16_CASES}
    assert {(name, d) for name in fa.TMA_INSTANCES if "_f32" not in name
            for d in fa.TMA_HEAD_DIMS[name]} <= reached
    assert {fa.kernel_head_dim(d) for _, _, _, _, d, _, _ in BF16_CASES
            if fa.kernel_head_dim(d) != d} == {128, 256}


def test_every_wide_instance_is_emulated():
    """One case each: the bf16 wide instances at D = 512, the f32 ones at d
    = 320 padded to 512; each at the tile T = 17 takes, both causal with
    the row that sees no key: K2 and K3 over the short tile in both dtypes
    (32 rows of two (batch, head) pairs, the second missing at BH = 1),
    K1's 64 rows in both dtypes. Their long tiles, two tiles and more head
    dims are test_torch_kernel_emulation_wide.py's."""
    for cases, suffix in ((BF16_CASES, ""), (CASES + PADDED_CASES, "_f32")):
        wide = [c for c in cases if fa.kernel_head_dim(c[4]) > fa.KERNEL_HEAD_DIMS[-1]]
        assert len(wide) == 1 and wide[0][6] == "key0" and wide[0][5]
        for kernel in fa.KERNELS:
            name = kernel + fa.WIDE + suffix
            assert _reached(cases, name) == {(fa.WIDE_TILES[name][0], 512)}
    for kernel in ("flash_dq", "flash_dkv"):
        for suffix in ("", "_f32"):
            assert fa.WIDE_TILES[kernel + fa.WIDE + suffix][0] == 32
            assert fa.launch_config(17, 17, 512, kernel + fa.WIDE + suffix) == 32
    assert fa.WIDE_TILES["flash_fwd_wide"][:2] == fa.WIDE_TILES["flash_fwd_wide_f32"][:2] == (64, 64)
