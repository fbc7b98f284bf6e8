"""The port's profilers (`shockwave_tpu_torch/profiling/`) and the core
modules they need, against the JAX package's, on the CPU.

- The copied `core/constants.py`, `core/job_table.py` and
  `core/oracle.py` equal the reference's: every table, every
  `oracle_job_type`, every `JobTemplate` field, and `read_oracle` on the
  committed oracle files. Exact equality: they are copies.
- The port's `marginal_step_time` equals the reference's under one fake
  `perf_counter`: the same result and the same sequence of windows, over
  step costs that reach the adaptive growth branch and the step cap.
- `measure_throughput --device cpu` writes a file the JAX package's
  `read_throughputs` reads, skips the sf = 2 rows, writes symmetric pair
  entries, builds A3C and CycleGAN through their mains and skips their
  sf > 1 rows (one-card families, as in the reference), writes
  `--trace_out`'s `profile-measure` span and histogram, and refuses a
  gang's rate (which needs as many cards as ranks).
- `extrapolate_sf` and the reference's write equal files from the same
  input, apart from the time stamp.
- `measure_startup` spawns the trace's LM command (the CPU asked for) and
  writes the reference's `__meta__` keys.
- `bench_gpu` at small widths on the CPU returns the reference bench's
  keys, and its FLOP count of a 2-layer model is the closed form.
- The committed `data/h100_throughputs.json` holds the 25 measured
  sf = 1 rows of every family, its provenance, and the sf 2 and 4
  priors `extrapolate_sf` derives from them, marked as estimated; the
  JAX package's simulator plans all 120 canonical jobs on an `h100`
  cluster from it, and its physical scheduler seeds a gang job from the
  prior, not from its default rate.

Timing windows run at `min_marginal_s` 0.05 s here (the tools' default is
1 s): these tests check what is written, not the CPU's rates.
"""
import ast
import dataclasses
import functools
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from shockwave_tpu.core import constants as ref_constants
from shockwave_tpu.core import job_table as ref_job_table
from shockwave_tpu.core import oracle as ref_oracle
from shockwave_tpu.core import timing as ref_timing
from shockwave_tpu_torch.core import constants, job_table, oracle, timing
from shockwave_tpu_torch.obs import names as port_names
from shockwave_tpu_torch.profiling import (bench_gpu, device, extrapolate_sf,
                                           measure_startup, measure_throughput)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
H100_FILE = os.path.join(REPO, "data", "h100_throughputs.json")
PORTED = ("ResNet-18", "ResNet-50", "Transformer", "LM", "Recommendation")


def reference_script(name):
    """The JAX package's scripts/profiling/<name>.py as a module."""
    path = os.path.join(REPO, "scripts", "profiling", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The copied core modules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["DATASET_SIZES", "MODEL_DATASET", "MAX_BS", "DEFAULT_BS"])
def test_constant_tables_are_the_references(table):
    assert getattr(constants, table) == getattr(ref_constants, table)


def test_profiled_batch_sizes_are_the_references():
    assert measure_throughput.FAMILY_BATCH_SIZES == \
        reference_script("measure_throughput").FAMILY_BATCH_SIZES


@pytest.mark.parametrize("family", sorted(measure_throughput.FAMILY_BATCH_SIZES))
def test_job_types_and_epochs_are_the_references(family):
    for bs in measure_throughput.FAMILY_BATCH_SIZES[family] + [1, 3, 1000]:
        assert constants.oracle_job_type(family, bs) == ref_constants.oracle_job_type(family, bs)
        assert constants.steps_per_epoch(family, bs) == ref_constants.steps_per_epoch(family, bs)
        for steps in (1, 1000, 123457):
            assert constants.num_epochs_for(family, bs, steps) == \
                ref_constants.num_epochs_for(family, bs, steps)


@pytest.mark.parametrize("factory", ["resnet18", "resnet50", "transformer", "lm",
                                     "recommendation", "a3c", "cyclegan", "JOB_TABLE"])
def test_job_templates_are_the_references(factory):
    ours, ref = getattr(job_table, factory), getattr(ref_job_table, factory)
    if factory == "JOB_TABLE":
        pairs = list(zip(ours, ref, strict=True))
    elif factory in ("a3c", "cyclegan"):
        pairs = [(ours(), ref())]
    else:
        pairs = [(ours(bs), ref(bs)) for bs in (5, 16, 32, 64, 128, 256, 512, 8192)]
    for a, b in pairs:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("name", ["v5e_throughputs.json", "tacc_throughputs.json"])
def test_read_oracle_is_the_references(name, tmp_path):
    path = os.path.join(REPO, "data", name)
    assert oracle.read_oracle(path) == ref_oracle.read_oracle(path)
    assert oracle.read_throughputs(path) == ref_oracle.read_throughputs(path)
    assert oracle.read_oracle_meta(path) == ref_oracle.read_oracle_meta(path)
    throughputs = ref_oracle.read_throughputs(path)
    oracle.write_throughputs(str(tmp_path / "port.json"), throughputs)
    ref_oracle.write_throughputs(str(tmp_path / "ref.json"), throughputs)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


def test_parse_job_type_tuple_is_the_references():
    for s in ("('LM (batch size 5)', 1)", "('A3C', 8)", "('x', y)", "null", ""):
        assert oracle.parse_job_type_tuple(s) == ref_oracle.parse_job_type_tuple(s)


# ---------------------------------------------------------------------------
# Two-point timing under one fake clock.
# ---------------------------------------------------------------------------

class FakeClock:
    """perf_counter() returns a time that only the steps advance; every
    read is recorded with the number of steps run so far."""

    def __init__(self, cost):
        self.now, self.steps, self.reads, self._cost = 0.0, 0, [], cost

    def perf_counter(self):
        self.reads.append((self.steps, self.now))
        return self.now

    def step(self):
        self.now += self._cost(self.steps)
        self.steps += 1


COSTS = {
    "1ns (the step cap)": lambda i: 1e-9,
    "10us (growth)": lambda i: 1e-5,
    "1ms (growth)": lambda i: 1e-3,
    "varying 0.3-1.5ms (growth)": lambda i: 3e-4 * (1 + i % 5),
    "20ms (one growth)": lambda i: 0.02,
    "50ms (no growth)": lambda i: 0.05,
}


@pytest.mark.parametrize("cost", sorted(COSTS))
@pytest.mark.parametrize("windows", [(10, 40, 5), (2, 8, 1), (3, 3, 0)])
def test_marginal_step_time_is_the_references(cost, windows, monkeypatch):
    n1, n2, warmup = windows
    results = {}
    for name, module, to_loss in (("port", timing, torch.tensor),
                                  ("ref", ref_timing, np.float32)):
        clock = FakeClock(COSTS[cost])
        monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))

        def step(state, batch, clock=clock, to_loss=to_loss):
            clock.step()
            return state + 1, to_loss(float(state))

        dt = module.marginal_step_time(step, 0, None, n1=n1, n2=n2, warmup=warmup)
        results[name] = (dt, clock.reads)
    # The same result, and the clock read at the same step counts: the
    # same windows in the same order.
    assert results["port"] == results["ref"]
    assert len(results["port"][1]) >= 4


def test_fetch_scalar_reads_one_element():
    assert timing.fetch_scalar(torch.tensor([[2.5, 3.0]])) == 2.5
    assert timing.fetch_scalar(torch.tensor(4.0, requires_grad=True) * 2) == 8.0
    assert timing.fetch_scalar(None) is None


# ---------------------------------------------------------------------------
# The card's table.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,variant", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "H100 SXM"),
    ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL"),
])
def test_peaks_of_the_h100_parts(name, variant):
    assert device.peaks(name) == (variant, device.PEAKS[variant])


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "TPU v5 lite", "cpu"])
def test_peaks_of_another_card_raise(name):
    with pytest.raises(ValueError, match="no published peaks"):
        device.peaks(name)


def test_tf32_peaks_and_the_f32_product_rate():
    """The dense TF32 peaks are the data sheets' (half of each part's bf16
    entry), and the f32-accurate product rate is a third of them: 3xTF32
    runs three TF32 products for each f32 one."""
    assert device.TF32_FLOPS == {"H100 SXM": 494.5e12, "H100 PCIe": 378e12,
                                 "H100 NVL": 417.5e12}
    for variant, (_, bf16) in device.PEAKS.items():
        assert device.TF32_FLOPS[variant] == bf16 / 2
        # The SIMT figure stays beside it; the tensor cores' f32 rate is above it.
        assert device.F32_FLOPS[variant] < device.TF32_FLOPS[variant] / 3
    for name, variant in (("NVIDIA H100 80GB HBM3, 700.00 W", "H100 SXM"),
                          ("NVIDIA H100 PCIe", "H100 PCIe"), ("NVIDIA H100 NVL", "H100 NVL")):
        assert device.f32_product_flops(name) == device.TF32_FLOPS[variant] / 3
    assert device.f32_product_flops("NVIDIA H100 80GB HBM3, 700.00 W") == pytest.approx(164.833e12,
                                                                                        rel=1e-5)
    for name in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", "cpu"):
        with pytest.raises(ValueError, match="no published peaks"):
            device.f32_product_flops(name)


# ---------------------------------------------------------------------------
# The mains' build_trainer: a trainer built, not trained.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", PORTED)
def test_build_family_builds_the_trace_commands_trainer(family, one_thread):
    """The trace command's trainer, built by its main's `build_trainer`
    and not trained; one step of it through the step function."""
    trainer, step, batch = measure_throughput.build_family(family, 2, device="cpu")
    assert trainer.step == 0 and trainer.device == torch.device("cpu")
    assert trainer.initial_bs == 2 and trainer.max_bs == constants.MAX_BS[family]
    assert batch[0].shape[0] == 2 and batch[0].device == torch.device("cpu")
    state, loss = step(trainer, batch)
    assert state is trainer and trainer.step == 1 and torch.isfinite(loss)


# ---------------------------------------------------------------------------
# measure_throughput.
# ---------------------------------------------------------------------------

@pytest.fixture
def short_windows(monkeypatch):
    fast = functools.partial(timing.marginal_step_time, min_marginal_s=0.05)
    monkeypatch.setattr(measure_throughput, "marginal_step_time", fast)
    monkeypatch.setattr(bench_gpu, "marginal_step_time", fast)


def test_measure_throughput_writes_an_oracle_the_scheduler_reads(
        tmp_path, capsys, short_windows, one_thread):
    out = tmp_path / "h100.json"
    measure_throughput.main(["--device", "cpu", "--output", str(out), "--only", "LM:5",
                             "Recommendation:512", "--scale_factors", "1", "2",
                             "--steps", "3", "--warmup", "1", "--packed"])
    err = capsys.readouterr().err
    assert "skip LM bs=5 sf=2: only 1 devices" in err
    assert "skip Recommendation bs=512 sf=2: only 1 devices" in err

    throughputs, meta = ref_oracle.read_oracle(str(out))
    assert list(throughputs) == ["h100"]
    rows = throughputs["h100"]
    lm, rec = ("LM (batch size 5)", 1), ("Recommendation (batch size 512)", 1)
    assert set(rows) == {lm, rec}  # no sf = 2 row
    for key in (lm, rec):
        assert rows[key]["null"] > 0
    for a in (lm, rec):
        for b in (lm, rec):
            assert rows[a][b] == rows[b][a][::-1]
            assert all(r > 0 for r in rows[a][b])
    detail = meta["throughput_detail"]["h100"]
    assert detail["device"] == "cpu" and detail["nvidia_smi"] is None
    assert detail["torch"] == torch.__version__ and detail["measured_at"]
    assert detail["rows"] == ["LM:5", "Recommendation:512"]


def test_measure_throughput_traces_each_row(tmp_path, short_windows, one_thread):
    """`--trace_out` with one small row: the Chrome trace holds one
    `profile-measure` span with the reference's args, and the row's wall
    time is one observation of `swtpu_profile_measure_seconds`."""
    trace = tmp_path / "trace.json"
    obs = measure_throughput.main(["--device", "cpu", "--output", str(tmp_path / "o.json"),
                                   "--only", "LM:5", "--scale_factors", "1",
                                   "--steps", "3", "--warmup", "1",
                                   "--trace_out", str(trace)])
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    [span] = [e for e in events if e["name"] == "profile-measure"]
    assert span["ph"] == "X" and span["dur"] > 0
    assert {k: span["args"][k] for k in ("family", "bs", "sf")} == {
        "family": "LM", "bs": 5, "sf": 1}
    count, total = obs.registry.histogram_stats(
        port_names.PROFILE_MEASURE_SECONDS, family="LM")
    assert count == 1 and total > 0
    assert "swtpu_profile_measure_seconds_count{family=\"LM\"} 1" in (
        obs.registry.render_prometheus())


@pytest.mark.parametrize("argv", [["--only", "A3C:4"], ["--only", "CycleGAN:1"],
                                  ["--families", "A3C", "CycleGAN"]])
def test_measure_throughput_refuses_a3c_and_cyclegan(argv, tmp_path, monkeypatch):
    """A3C and CycleGAN are one-card families: a scale factor above 1 is
    refused for them, as the reference skips it, even where the devices
    would allow a gang; nothing is built and no row is written."""
    monkeypatch.setattr(measure_throughput, "device_count", lambda device: 2)
    monkeypatch.setattr(measure_throughput, "build_family",
                        lambda *a, **kw: pytest.fail("built a one-card family at sf 2"))
    out = tmp_path / "o.json"
    measure_throughput.main(["--device", "cpu", "--output", str(out), "--scale_factors", "2"]
                            + argv)
    assert json.loads(out.read_text())["h100"] == {}


@pytest.mark.parametrize("family", ["A3C", "CycleGAN"])
def test_build_family_builds_a3c_and_cyclegan(family, one_thread, monkeypatch):
    """A3C (4 environments) and CycleGAN (batch 1, 128 x 128, small
    widths here) from their trace commands through their mains'
    `build_job`; one step each through the step function."""
    from shockwave_tpu_torch.models.cyclegan import Discriminator, Generator
    from shockwave_tpu_torch.workloads.cyclegan import cyclegan
    monkeypatch.setattr(cyclegan, "Generator",
                        functools.partial(Generator, base_features=4, num_blocks=1))
    monkeypatch.setattr(cyclegan, "Discriminator", functools.partial(Discriminator, base_features=4))
    bs = measure_throughput.FAMILY_BATCH_SIZES[family][0]
    job, step, batch = measure_throughput.build_family(family, bs, device="cpu")
    assert job.step == 0 and job.device == torch.device("cpu")
    if family == "A3C":
        assert batch == () and job.env_state.ball_x.shape == (bs,)
    else:
        assert [b.shape for b in batch] == [(bs, 128, 128, 3)] * 2
    state, loss = step(job, batch)
    assert state is job and job.step == 1 and torch.isfinite(loss)


def test_measure_throughput_refuses_a_gang_the_devices_allow(monkeypatch):
    monkeypatch.setattr(measure_throughput, "device_count", lambda device: 2)
    with pytest.raises(NotImplementedError, match="Queue 1, item 12"):
        measure_throughput.measure("LM", 5, 2, 3, 1, device="cpu")
    assert measure_throughput.measure("LM", 5, 4, 3, 1, device="cpu") is None


def test_measure_throughput_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        measure_throughput.main(["--output", str(tmp_path / "o.json")])


# ---------------------------------------------------------------------------
# extrapolate_sf.
# ---------------------------------------------------------------------------

def test_extrapolate_sf_writes_the_references_file(tmp_path, monkeypatch):
    with open(os.path.join(REPO, "data", "v5e_throughputs.json")) as f:
        measured = json.load(f)
    # Only the measured sf = 1 rows, as a profiler writes them.
    measured["v5e"] = {k: v for k, v in measured["v5e"].items()
                       if oracle.parse_job_type_tuple(k)[1] == 1}
    for key in ("estimated_rows", "estimated_rows_note", "estimated_rows_updated_at"):
        measured["__meta__"].pop(key)
    paths = {}
    for side in ("port", "ref"):
        paths[side] = str(tmp_path / f"{side}.json")
        with open(paths[side], "w") as f:
            json.dump(measured, f)
    extrapolate_sf.main(["--oracle", paths["port"], "--worker_type", "v5e"])
    monkeypatch.setattr(sys, "argv", ["extrapolate_sf.py", "--oracle", paths["ref"],
                                      "--worker_type", "v5e"])
    reference_script("extrapolate_sf").main()
    written = {}
    for side, path in paths.items():
        with open(path) as f:
            written[side] = json.load(f)
        written[side]["__meta__"].pop("estimated_rows_updated_at")
    assert written["port"] == written["ref"]
    assert len(written["port"]["v5e"]) > len(measured["v5e"])


def test_extrapolate_sf_writes_nothing_by_default():
    with pytest.raises(SystemExit):
        extrapolate_sf.main([])


# ---------------------------------------------------------------------------
# measure_startup.
# ---------------------------------------------------------------------------

def test_run_once_spawns_the_trace_command_on_the_cpu(tmp_path):
    template = job_table.lm(5)
    template = dataclasses.replace(template, command=f"{template.command} --device cpu")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    assert measure_startup.run_once(template, str(tmp_path / "data"), str(ckpt), 300) > 0
    assert (ckpt / "model.ckpt").exists()  # the exit-path save of a 1-step run


def test_measure_startup_writes_the_references_meta(tmp_path, monkeypatch):
    families = ["LM (batch size 20)", "Recommendation (batch size 512)"]
    written = {}
    for side in ("port", "ref"):
        path = tmp_path / f"{side}.json"
        path.write_text(json.dumps({"h100": {}}))
        module = measure_startup if side == "port" else reference_script("measure_startup")
        spawned = iter([7.0, 5.0, 6.0, 9.0, 4.0, 5.0])
        monkeypatch.setattr(module, "run_once", lambda *a, it=spawned: next(it))
        argv = ["--worker_type", "h100", "--oracle", str(path), "--families", *families]
        if side == "port":
            module.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["measure_startup.py"] + argv)
            module.main()
        written[side] = json.loads(path.read_text())["__meta__"]
    port, ref = written["port"], written["ref"]
    assert port.keys() == ref.keys() == {"dispatch_overhead_s", "dispatch_overhead_detail"}
    assert port["dispatch_overhead_s"] == ref["dispatch_overhead_s"] == {"h100": 5.0}
    assert port["dispatch_overhead_detail"]["h100"].keys() == \
        ref["dispatch_overhead_detail"]["h100"].keys()
    assert port["dispatch_overhead_detail"]["h100"]["per_family"] == \
        ref["dispatch_overhead_detail"]["h100"]["per_family"]


@pytest.mark.parametrize("family", ["A3C", "CycleGAN"])
def test_measure_startup_refuses_a3c_and_cyclegan(family, tmp_path, monkeypatch):
    """A3C and CycleGAN are no longer refused: their trace commands are
    spawned under their run dirs (`rl`, `cyclegan`), the CPU asked for."""
    path = tmp_path / "o.json"
    path.write_text("{}")
    spawned = []
    monkeypatch.setattr(measure_startup, "run_once",
                        lambda template, *a: spawned.append(template) or 2.0)
    measure_startup.main(["--oracle", str(path), "--families", family, "--device", "cpu",
                          "--repeats", "1"])
    template = {"A3C": job_table.a3c, "CycleGAN": job_table.cyclegan}[family]()
    assert [t.command for t in spawned] == [f"{template.command} --device cpu"] * 2
    assert {t.working_directory for t in spawned} == {template.working_directory}
    meta = json.loads(path.read_text())["__meta__"]
    assert meta["dispatch_overhead_s"]["h100"] == 2.0


# ---------------------------------------------------------------------------
# bench_gpu.
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=37, dim=32, num_heads=2, num_layers=2, mlp_dim=64)


def reference_bench_keys(function):
    """The keys of the dict bench_tpu.py's `function` returns, with the
    `{prefix}` of an f-string key left as the empty string."""
    path = os.path.join(REPO, "scripts", "profiling", "bench_tpu.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    keys = set()
    for key in ret[-1].value.keys:
        if isinstance(key, ast.JoinedStr):
            keys.add("".join(v.value for v in key.values if isinstance(v, ast.Constant)))
        else:
            keys.add(key.value)
    return keys


def closed_form_flops(batch, seq, vocab_size, dim, num_heads, num_layers, mlp_dim):
    """One training step of the flash-off model: forward + backward, where
    every product's backward is two products of its size. Per layer, the
    four attention projections (8·B·T·D²), the MLP (4·B·T·D·F) and the two
    attention products at the full T² (4·B·T²·D); the decoder has a second
    attention; then the tied logits (2·B·T·D·V)."""
    b, t, d, f, v, n = batch, seq, dim, mlp_dim, vocab_size, num_layers
    enc = 8 * b * t * d * d + 4 * b * t * d * f + 4 * b * t * t * d
    dec = 16 * b * t * d * d + 4 * b * t * d * f + 8 * b * t * t * d
    return 3 * (n * (enc + dec) + 2 * b * t * d * v)


def test_transformer_train_bench_returns_the_references_keys(short_windows, one_thread):
    result = bench_gpu.transformer_train_bench(batch=2, steps=4, warmup=1, seq=32,
                                               prefix="transformer_long", device="cpu",
                                               widths=SMALL)
    expected = {f"transformer_long{k}" for k in reference_bench_keys("transformer_train_bench")}
    assert expected <= set(result)
    assert result["transformer_long_flops_per_step"] == closed_form_flops(2, 32, **SMALL)
    assert result["transformer_long_mfu"] is None  # no published peak for a CPU
    assert result["transformer_long_steps_per_s"] > 0
    assert result["transformer_long_steps_run"] >= 1 + 4
    assert result["transformer_long_loss_last"] < result["transformer_long_loss_first"]


@pytest.mark.parametrize("batch,seq", [(1, 16), (3, 48)])
def test_flop_count_is_the_closed_form(batch, seq):
    assert bench_gpu.count_flops(SMALL, batch, seq) == closed_form_flops(batch, seq, **SMALL)


def test_attention_bench_returns_the_references_keys(short_windows, one_thread):
    result = bench_gpu.attention_bench(b=1, t=64, h=2, d=32, device="cpu")
    assert set(result) == reference_bench_keys("attention_bench")
    assert result["attn_shape"] == [1, 64, 2, 32]
    assert result["flash_attn_ms"] > 0 and result["einsum_attn_ms"] > 0


def test_einsum_attention_is_the_plain_causal_attention():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 2, 32, generator=gen) for _ in range(3))
    from shockwave_tpu_torch.ops.flash_attention import flash_attention
    ours = bench_gpu.einsum_attention(q, k, v)
    plain = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(ours, plain, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The committed H100 oracle and the scheduler.
# ---------------------------------------------------------------------------

def test_the_h100_file_holds_the_ported_rows_and_their_provenance():
    throughputs, meta = ref_oracle.read_oracle(H100_FILE)
    assert list(throughputs) == ["h100"]
    expected = {(ref_constants.oracle_job_type(family, bs), 1)
                for family, sizes in measure_throughput.FAMILY_BATCH_SIZES.items()
                for bs in sizes}
    assert len(expected) == 25
    measured = {key for key in throughputs["h100"] if key[1] == 1}
    assert measured == expected
    # Every other row is an sf 2 or 4 prior, listed as estimated with the
    # measured sf = 1 rate it scales.
    estimated = {ref_oracle.parse_job_type_tuple(key): entry
                 for key, entry in meta["estimated_rows"]["h100"].items()}
    assert set(throughputs["h100"]) - measured == set(estimated)
    assert {sf for _, sf in estimated} == {2, 4} and len(estimated) == 36
    for (job_type, sf), entry in estimated.items():
        assert entry["from_sf1"] == throughputs["h100"][(job_type, 1)]["null"]
        assert 0 < entry["reference_efficiency"] <= 1
    for key, entry in throughputs["h100"].items():
        assert list(entry) == ["null"] and entry["null"] > 0, key
    detail = meta["throughput_detail"]["h100"]
    assert "H100" in detail["nvidia_smi"] and " W" in detail["nvidia_smi"]
    assert "H100" in detail["device"] and detail["torch"] and detail["measured_at"]
    assert meta["dispatch_overhead_s"]["h100"] > 0
    assert set(meta["dispatch_overhead_detail"]["h100"]["per_family"]) == {
        "ResNet-18 (batch size 32)", "LM (batch size 20)", "Recommendation (batch size 512)"}


def test_the_h100_file_covers_every_job_type_of_the_canonical_trace():
    with open(os.path.join(REPO, "data", "canonical_120job.trace")) as f:
        job_types = {line.split("\t")[0] for line in f if line.strip()}
    rows = ref_oracle.read_throughputs(H100_FILE)["h100"]
    assert {(job_type, 1) for job_type in job_types} <= set(rows)
    # Accordion and GNS move a job's batch up to its family's MAX_BS.
    for family, max_bs in ref_constants.MAX_BS.items():
        assert (ref_constants.oracle_job_type(family, max_bs), 1) in rows


def simulate(trace, throughputs, cluster_spec, out):
    """The JAX package's simulator, max_min_fairness, 120 s rounds;
    returns (exit code, stderr, the metrics pickle or None)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    done = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "drivers", "simulate.py"),
         "--trace", str(trace), "--policy", "max_min_fairness",
         "--throughputs", str(throughputs), "--cluster_spec", cluster_spec,
         "--round_duration", "120", "--output", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if done.returncode:
        return done.returncode, done.stderr, None
    with open(out, "rb") as f:
        return 0, done.stderr, pickle.load(f)


def test_the_simulator_plans_an_h100_cluster_from_the_port_rates(tmp_path):
    """The first jobs of the canonical trace (all sf = 1) on h100:4."""
    with open(os.path.join(REPO, "data", "canonical_120job.trace")) as f:
        head = [next(f) for _ in range(11)]
    assert all(line.split("\t")[6] == "1" for line in head)
    trace = tmp_path / "head.trace"
    trace.write_text("".join(head))
    rc, err, metrics = simulate(trace, H100_FILE, "h100:4", tmp_path / "sim.pkl")
    assert rc == 0, err[-3000:]
    assert len(metrics["jct_list"]) == len(head)


def test_the_canonical_trace_needs_sf_rows_the_port_cannot_measure_yet(tmp_path):
    """28 of the 120 canonical jobs have scale factor 2 or 4, whose rates
    need as many cards as ranks. The committed file carries their priors:
    exactly what `extrapolate_sf` writes from its measured sf = 1 rows,
    and the simulator plans all 120 jobs on it."""
    with open(H100_FILE) as f:
        committed = json.load(f)
    measured = json.loads(json.dumps(committed))
    measured["h100"] = {k: v for k, v in measured["h100"].items()
                        if oracle.parse_job_type_tuple(k)[1] == 1}
    for key in ("estimated_rows", "estimated_rows_note", "estimated_rows_updated_at"):
        measured["__meta__"].pop(key)
    rewritten = tmp_path / "h100_rewritten.json"
    rewritten.write_text(json.dumps(measured))
    extrapolate_sf.main(["--oracle", str(rewritten), "--worker_type", "h100",
                         "--sfs", "2", "4"])
    again = json.loads(rewritten.read_text())
    assert again["h100"] == committed["h100"]
    assert again["__meta__"]["estimated_rows"] == committed["__meta__"]["estimated_rows"]
    trace = os.path.join(REPO, "data", "canonical_120job.trace")
    rc, err, metrics = simulate(trace, H100_FILE, "h100:32", tmp_path / "sim.pkl")
    assert rc == 0, err[-3000:]
    assert len(metrics["jct_list"]) == 120


def test_gang_job_seeds_from_estimated_sf_row_h100():
    """The twin of the JAX package's `test_gang_job_seeds_from_estimated_
    sf_row` on the committed H100 file: the physical scheduler starts an
    sf = 2 job on `h100` workers from the file's prior, not from its
    default rate."""
    import socket

    from shockwave_tpu.core.job import Job
    from shockwave_tpu.sched.physical import PhysicalScheduler
    from shockwave_tpu.sched.scheduler import DEFAULT_THROUGHPUT, SchedulerConfig
    from shockwave_tpu.solver import get_policy
    with socket.socket() as sock:
        sock.bind(("", 0))
        port = sock.getsockname()[1]
    sched = PhysicalScheduler(get_policy("max_min_fairness"), throughputs_file=H100_FILE,
                              config=SchedulerConfig(time_per_iteration=100.0),
                              expected_num_workers=1, port=port)
    try:
        sched.register_worker("h100", num_chips=2)
        job = Job(None, "ResNet-18 (batch size 128)", "python3 main.py --batch_size 128",
                  "image_classification/cifar10", "--num_steps", total_steps=1000,
                  duration=1000, scale_factor=2)
        job_id = sched.add_job(job)
        got = sched._throughputs[job_id]["h100"]
        want = ref_oracle.read_throughputs(H100_FILE)["h100"][
            ("ResNet-18 (batch size 128)", 2)]["null"]
        assert got == want and got != DEFAULT_THROUGHPUT
    finally:
        sched._done_event.set()
        sched._server.stop(grace=0)
