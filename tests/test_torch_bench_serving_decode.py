"""The port's bench line on the CPU: `profiling/bench_serving_decode.py`
against the JAX package's `scripts/microbenchmarks/bench_serving_decode.py`,
and `profiling/headline.py`.

- On a small decoder (dim 32, 1 layer, 2 heads; batch 2, prompt 3, 4
  tokens) with the reference's weights (`convert.decoder_flax_to_state_dict`)
  and prompt, the port's request batch (`build_decode`, over the serving
  replica's own code) generates the replica's greedy tokens, and the
  reference's `build_decode`, whose jitted batch returns the token after
  its last decode step, gives the port's next greedy token.
- Both scripts, at tiny widths on the CPU, print one JSON line with the
  same keys; `--smoke` with an unreachable floor exits 1.
- The headline runs the simulator (`--max_rounds 2`) and the card phases
  on the CPU at tiny widths and prints every key; a simulator that fails
  makes the line carry the error and the process exit 1.
"""
import argparse
import importlib.util
import json
import os
import shlex
import sys

import numpy as np
import pytest
import torch

import jax

from shockwave_tpu_torch import convert
from shockwave_tpu_torch.models.decoder import greedy_decode
from shockwave_tpu_torch.profiling import bench_serving_decode as bench
from shockwave_tpu_torch.profiling import headline

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY = dict(batch_size=2, prompt_len=3, tokens_per_request=4, model_dim=32, model_layers=1,
            model_heads=2)
TINY_ARGV = [a for k, v in TINY.items() for a in (f"--{k}", str(v))] + [
    "--steps", "1", "--warmup", "1"]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in the headline's subprocesses: the
    tensors are tiny and the suite's other workers share the machine."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_script():
    path = os.path.join(REPO, "scripts", "microbenchmarks", "bench_serving_decode.py")
    spec = importlib.util.spec_from_file_location("ref_bench_serving_decode", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_greedy_tokens_follow_the_reference_decode():
    ref = reference_script()
    serve_request_batch, params, prompt = ref.build_decode(argparse.Namespace(**TINY))
    # The reference's batch: prefill, then tokens_per_request decode
    # steps; it returns the argmax after the last one, greedy token 5.
    last = np.asarray(serve_request_batch(params, prompt))
    run, model, _ = bench.build_decode(argparse.Namespace(**TINY), torch.device("cpu"))
    model.load_state_dict(convert.decoder_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    prompt = torch.from_numpy(np.array(prompt)).long()
    tokens = run(prompt)
    greedy = greedy_decode(model, prompt, TINY["tokens_per_request"] + 1)
    assert tokens.shape == (TINY["batch_size"], TINY["tokens_per_request"])
    assert torch.equal(tokens, greedy[:, :-1])
    np.testing.assert_array_equal(greedy[:, -1:].numpy(), last)


def json_line(out):
    lines = out.strip().splitlines()
    assert lines, out
    return json.loads(lines[-1])


def test_both_scripts_print_the_same_keys(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench_serving_decode.py"] + TINY_ARGV)
    assert reference_script().main() == 0
    want = json_line(capsys.readouterr().out)
    assert bench.main(TINY_ARGV + ["--device", "cpu"]) == 0
    got = json_line(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["backend"] == want["backend"] == "cpu" and got["device_kind"] == "cpu"
    for key in ("batch_size", "tokens_per_request", "model_dim", "model_layers", "steps"):
        assert got[key] == want[key]
    assert got["tokens_per_s"] == got["tokens_per_s_per_chip"] > 0


def test_smoke_under_the_floor_exits_1(capsys):
    assert bench.main(TINY_ARGV + ["--device", "cpu", "--smoke",
                                   "--min_tokens_per_s", "1e12"]) == 1
    captured = capsys.readouterr()
    assert json_line(captured.out)["tokens_per_s"] > 0
    assert "SMOKE FAIL" in captured.err


def test_bench_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(TINY_ARGV)


SMALL_FLAGSHIP = dict(vocab_size=37, dim=32, num_heads=2, num_layers=2, mlp_dim=64)
HEADLINE_CPU = ["--device", "cpu", "--max_rounds", "2",
                "--bench_gpu_args", shlex.join([
                    "--batch", "2", "--steps", "2", "--long_seq", "32", "--long_batch", "1",
                    "--widths", json.dumps(SMALL_FLAGSHIP), "--attn_shape", "1,32,2,32",
                    "--min_marginal_s", "0.05"]),
                "--decode_args", shlex.join(TINY_ARGV)]


def test_headline_prints_every_key(capsys):
    assert headline.main(HEADLINE_CPU) == 0
    line = json_line(capsys.readouterr().out)
    assert set(line) == set(headline.KEYS)
    assert line["policy"] == "shockwave" and line["cluster_spec"] == "h100:32"
    assert line["rounds"] == 2 and line["value"] == line["makespan"] > 0
    assert line["sim_wall_s"] > 0 and line["unfair_fraction"] is not None
    assert line["flagship_steps_per_s"] > 0 and line["flagship_batch"] == 2
    assert line["long_seq_len"] == 32 and line["long_mfu"] is None  # no peak for a CPU
    assert line["attn_flash_ms"] > 0 and line["attn_shape"] == [1, 32, 2, 32]
    assert line["serving_tokens_per_s_per_chip"] > 0
    assert line["serving_decode_backend"] == "cpu" and line["card"] == "cpu"


def test_headline_exits_1_when_the_simulator_fails(monkeypatch, capsys):
    for name in ("bench_gpu", "decode"):
        monkeypatch.setitem(headline.PHASES, name, lambda args: {})
    assert headline.main(["--device", "cpu", "--policy", "no_such_policy",
                          "--max_rounds", "2"]) == 1
    line = json_line(capsys.readouterr().out)
    assert "simulation_error" in line and line["makespan"] is None and line["value"] is None
    assert set(headline.KEYS) <= set(line)
