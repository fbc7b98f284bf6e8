"""`profiling/fwd_wide_ab.py`, the A/B tool of the wide kernels, on the
CPU: its case table and tolerances against chip_smoke.py's, and one case
through `run_case`, where the wrappers take the plain versions (the card
alone runs the kernels and the timer).
"""
import importlib.util
import math
import os
import types

import pytest
import torch

from shockwave_tpu_torch.ops import flash_attention as fa
from shockwave_tpu_torch.profiling import fwd_wide_ab as ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py as a module (it imports only torch at the top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cases_are_chip_smokes_wide_cases():
    """Each case is the chip_smoke.py kernel case of the same name (its B,
    T, H, D, causal and mask), the main and bench shapes at D = 512 and a
    ragged causal case at D = 768, and the bench shape at D = 64, 128 and
    256 and the main shape, in both dtypes."""
    smoke = _chip_smoke()
    table = {c[0]: c for c in smoke.CASES + smoke.F32_CASES}
    for name, b, t, h, d, causal, mask, dt in ab.CASES:
        assert table[name][1:] == (b, t, t, h, d, causal, mask), name
        assert name.endswith("_f32") == (dt == "f32")
    names = {c[0] for c in ab.CASES}
    for dt in ("", "_f32"):
        assert {"d512_main_enc_self" + dt, "d512_bench_causal" + dt,
                "d768_ragged_causal" + dt} <= names
    # The long tile at D = 64, 128 and 256 and the main shape, in both dtypes.
    for dt in ("", "_f32"):
        assert {"bench_causal" + dt, "d128_bench_causal" + dt, "d256_bench_causal" + dt,
                "main_enc_self" + dt} <= names
    assert smoke.D512_CASES == {"": ("d512_main_enc_self", "d512_bench_causal"),
                                "_f32": ("d512_main_enc_self_f32", "d512_bench_causal_f32")}


def test_tolerances_are_chip_smokes():
    smoke = _chip_smoke()
    assert ab.TOLS == {"bf16": (smoke.FWD_TOL, smoke.LSE_TOL, smoke.GRAD_TOL),
                       "f32": (smoke.F32_TOL,) * 3}


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_a_case_runs_every_kernel_against_its_plain_version(dt):
    """A small ragged causal case: errors of all five outputs within the
    tolerances (0 here, where both sides are the plain version), and each
    kernel, its plain version and SDPA's forward and forward + backward
    timed once, SDPA's backward as their difference."""
    timed = []

    def time_fn(fn):
        timed.append(fn)
        fn()
        return float(len(timed))

    case = ("tiny", 2, 17, 2, 64, True, "tail", dt)
    record = ab.run_case(fa, case, 0, torch.device("cpu"), ab.KERNELS, time_fn)
    assert record["ok"] and record["shape"] == [2, 17, 2, 64] and record["dtype"] == dt
    for key in ("fwd_max_abs", "lse_max_abs", "dq_max_rel", "dk_max_rel", "dv_max_rel"):
        assert record[key] == 0.0
    assert [record[k]["ms"] for k in ab.KERNELS] == [1.0, 3.0, 5.0]
    assert [record[k]["plain_ms"] for k in ab.KERNELS] == [2.0, 4.0, 6.0]
    assert record["library_bwd_ms"] == record["library_fwd_bwd_ms"] - record["library_fwd_ms"]
    assert record["library_bwd_by"] == "fwd_bwd - fwd" and len(timed) == 8
    # Without a timer: the errors alone, and only the kernels asked for.
    record = ab.run_case(fa, case, 0, torch.device("cpu"), ("dq",))
    assert record["ok"] and "dq_max_rel" in record and "fwd_max_abs" not in record
    assert "dq" not in record and "library_bwd_ms" not in record


@pytest.mark.parametrize("kernel,grad", [("dq", "dq"), ("dkv", "dk"), ("dkv", "dv")])
def test_a_gradient_past_its_tolerance_fails_the_case(kernel, grad):
    """A wrapper whose gradient is off by 2e-4 of its largest entry (twice
    the f32 tolerance) fails the case and names its error."""
    def off(x):
        return x + 2e-4 * x.abs().max()

    def attention_dq(*args):
        dq = fa.attention_dq(*args)
        return off(dq) if grad == "dq" else dq

    def attention_dkv(*args):
        dk, dv = fa.attention_dkv(*args)
        return (off(dk) if grad == "dk" else dk), (off(dv) if grad == "dv" else dv)

    wrong = types.SimpleNamespace(**{n: getattr(fa, n) for n in dir(fa) if not n.startswith("__")})
    wrong.attention_dq, wrong.attention_dkv = attention_dq, attention_dkv
    case = ("tiny", 1, 24, 2, 32, False, None, "f32")
    record = ab.run_case(wrong, case, 1, torch.device("cpu"), (kernel,))
    assert not record["ok"]
    assert math.isclose(record[f"{grad}_max_rel"], 2e-4, rel_tol=1e-2)


def test_without_a_card_it_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab.main(["--trees", "."]) == 2
    assert "no CUDA device" in capsys.readouterr().err
