"""The port's serving replica against the JAX package's, on the CPU.

- The copied request clock: the port's `QuantileSketch`, `ArrivalClock`
  and `ReplicaMeter`, on the same seeded clock and step times, give
  deltas whose `encode_report` lines are byte-identical to the
  reference's.
- The decoder, with the weights carried by
  `convert.decoder_flax_to_state_dict`: the full forward's logits
  against the JAX `DecoderLM`'s in f32, with flash off and with flash on
  (the JAX side's Pallas K1 interpreted); cached decode against the
  port's own full forward; greedy decode teacher-forced with the JAX
  run's tokens; the bf16 flash path (K1's plain version on the CPU)
  against the einsum path.
- `serve.py` as a subprocess under a stub scheduler (`--device cpu`):
  exactly the granted request batches, and measured reports on a
  renewal.
- The loopback: the JAX package's real `PhysicalScheduler` with a
  serving service, whose tier spawns a replica that the port's
  `WorkerDaemon` runs (the port's `serve.main` through a stand-in
  `serving/serve.py` that asks for the CPU and small widths); the
  replica reports progress and the service's measured state gets
  samples.

Its `cuda` twin runs the loopback with the trace's serving command at
its width on the card: `python -m pytest --noconftest -m cuda
tests/test_torch_serving.py -s`.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

try:  # the card's machine runs only the `cuda` test, and need not have JAX
    import jax
    import jax.numpy as jnp

    from shockwave_tpu.models.decoder import DecoderLM as FlaxDecoderLM
except ImportError:
    jax = None
from shockwave_tpu.obs import quantiles as ref_quantiles
from shockwave_tpu.serving import load as ref_load
from shockwave_tpu.serving import measured as ref_measured
from shockwave_tpu_torch import convert
from shockwave_tpu_torch.models.decoder import DecoderLM, greedy_decode
from shockwave_tpu_torch.obs import quantiles
from shockwave_tpu_torch.ops import flash_attention as fa
from shockwave_tpu_torch.serving import load, measured
from shockwave_tpu_torch.workloads.serving import serve

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WIDTHS = dict(dim=32, num_heads=2, num_layers=2, mlp_dim=64, max_len=24)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The request clock.
# ---------------------------------------------------------------------------

def report_lines(load_mod, measured_mod, step_times):
    """encode_report lines of one replica's meter over `step_times`, a
    delta every 50 steps, stamped (round, seq) as serve.py stamps them."""
    spikes = load_mod.seeded_spikes(7, 3600.0, 2, 10.0, 120.0) + (load_mod.Spike(100.0, 50.0, 3.0),)
    curve = load_mod.DiurnalLoad(base_rps=5.0, peak_rps=40.0, period_s=600.0, phase_s=30.0,
                                 spikes=spikes)
    clock = measured_mod.ArrivalClock(curve, measured_mod.derive_arrival_seed(7, 2), 3600.0,
                                      replica_index=2, num_replicas=3, phase_s=10.0)
    meter = measured_mod.ReplicaMeter(clock, batch_size=4, tokens_per_request=64)
    lines = []
    for i, step_s in enumerate(step_times, 1):
        meter.step(float(step_s))
        if i % 50 == 0:
            delta = meter.take_delta()
            if delta is not None:
                delta.update(round=3, seq=len(lines) + 1)
                lines.append(measured_mod.encode_report(delta))
    return lines


def test_sketch_deltas_are_byte_identical_to_the_references():
    step_times = np.random.RandomState(0).exponential(0.05, 3000)
    ours = report_lines(load, measured, step_times)
    ref = report_lines(ref_load, ref_measured, step_times)
    assert len(ours) > 10 and ours == ref
    assert measured.find_reports("\n".join(ours)) == ref_measured.find_reports(ref)
    # The sketch itself: the same buckets, quantiles and canonical bytes.
    values = np.random.RandomState(1).lognormal(-2.0, 1.5, 500)
    sketch, ref_sketch = quantiles.QuantileSketch(), ref_quantiles.QuantileSketch()
    for v in values:
        sketch.add(float(v))
        ref_sketch.add(float(v))
    assert sketch.encode() == ref_sketch.encode()
    assert quantiles.quantiles(sketch, (0.5, 0.9, 0.99)) == \
        ref_quantiles.quantiles(ref_sketch, (0.5, 0.9, 0.99))


# ---------------------------------------------------------------------------
# The decoder.
# ---------------------------------------------------------------------------

def flax_decoder(seed=0, **kw):
    model = FlaxDecoderLM(**{**WIDTHS, **kw})
    tokens = np.zeros((1, 4), np.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), tokens)
    ours = DecoderLM(**WIDTHS)
    ours.load_state_dict(convert.decoder_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    return model, params, ours


def test_full_forward_matches_the_jax_decoder_in_f32():
    """Logits within 1e-5 (f32 on both sides; LayerNorm's fast variance
    is taken alike)."""
    model, params, ours = flax_decoder()
    tokens = np.random.RandomState(0).randint(0, 256, (3, 16)).astype(np.int32)
    want = np.asarray(jax.jit(model.apply)(params, tokens))
    with torch.no_grad():
        got = ours(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cached_decode_equals_the_full_forward():
    """Step-by-step cached decode (caches written in place) against the
    port's own full forward, within 1e-5."""
    _, _, ours = flax_decoder(seed=1)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 20))).long()
    caches = ours.init_cache(2)
    with torch.no_grad():
        full = ours(tokens)
        steps = torch.cat([ours.decode_step(tokens[:, i:i + 1], caches, i)
                           for i in range(tokens.shape[1])], dim=1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), atol=1e-5)


def test_greedy_decode_follows_the_jax_run():
    """The JAX decoder's `decode_step` run greedily for 12 tokens past the
    prompt, and the port's `decode_step` fed the JAX run's tokens
    (teacher-forced, so an argmax tie cannot cascade): each step's
    logits within 1e-4 of the reference's. The port's own
    `greedy_decode` tokens equal the JAX run's up to the first step
    whose top-two margin is within that tolerance."""
    model, params, ours = flax_decoder(seed=2)
    prompt = np.random.RandomState(2).randint(0, 256, (2, 5)).astype(np.int32)
    step = jax.jit(lambda p, t, c, pos: model.apply(p, t, c, pos, method=FlaxDecoderLM.decode_step))
    caches = model.init_cache(2)
    torch_caches = ours.init_cache(2)
    fed = [prompt[:, i:i + 1] for i in range(prompt.shape[1])]
    jax_tokens, margins = [], []
    for pos in range(prompt.shape[1] + 12):
        logits, caches = step(params, jnp.asarray(fed[pos]), caches, jnp.int32(pos))
        logits = np.asarray(logits)[:, -1]
        with torch.no_grad():
            ours_logits = ours.decode_step(torch.from_numpy(fed[pos]).long(), torch_caches,
                                           pos)[:, -1].numpy()
        np.testing.assert_allclose(ours_logits, logits, atol=1e-4)
        if pos >= prompt.shape[1] - 1:
            top2 = np.sort(logits, axis=-1)[:, -2:]
            margins.append(float((top2[:, 1] - top2[:, 0]).min()))
            jax_tokens.append(logits.argmax(-1).astype(np.int32)[:, None])
            fed.append(jax_tokens[-1])
    jax_tokens = np.concatenate(jax_tokens[:12], axis=1)
    ours_tokens = greedy_decode(ours, torch.from_numpy(prompt).long(), 12).numpy()
    clear = next((i for i, m in enumerate(margins[:12]) if m <= 1e-4), 12)
    assert clear > 0
    np.testing.assert_array_equal(ours_tokens[:, :clear], jax_tokens[:, :clear])


def test_flash_path_in_f32_matches_the_jax_decoders_pallas_path():
    """`use_flash` in f32 (the decoder's default dtype) on both sides: the
    JAX decoder runs its Pallas K1 (interpreted on the CPU), the port's
    its K1's plain f32 version (the f32 kernel's on the card); logits
    within 1e-5, as the einsum paths agree."""
    model, params, base = flax_decoder(seed=4, use_flash=True)
    ours = DecoderLM(**WIDTHS, use_flash=True)
    ours.load_state_dict(base.state_dict())
    tokens = np.random.RandomState(4).randint(0, 256, (2, 16)).astype(np.int32)
    want = np.asarray(jax.jit(model.apply)(params, tokens))
    fa.reset_launch_counts()
    with torch.no_grad():
        got = ours(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not any(fa.LAUNCHES.values())


def test_flash_path_at_head_dim_16_matches_the_jax_decoder():
    """dim 64 with 4 heads (head dim 16, which the port's flash_attention
    pads to 32 and the JAX package's to its sublane multiple 8) and
    `use_flash` on both sides, f32, converted weights: the logits within
    1e-5, as the einsum paths agree, and the gradient of a next-token loss
    (the JAX tree carried by the same converter) within 5e-4 of its
    largest entry, test_ops.py's gradient tolerance. Both packages go
    through their flash paths' own backward (the JAX side's Pallas K2
    and K3 interpreted)."""
    widths = dict(WIDTHS, dim=64, num_heads=4)
    model = FlaxDecoderLM(**widths, use_flash=True)
    tokens = np.random.RandomState(6).randint(0, 256, (2, 16)).astype(np.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(6), tokens[:, :4])

    def loss(p):
        logits = model.apply(p, tokens)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1).mean(), logits
    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    ours = DecoderLM(**widths, use_flash=True)
    ours.load_state_dict(convert.decoder_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    fa.reset_launch_counts()
    got = ours(torch.from_numpy(tokens).long())
    torch.nn.functional.cross_entropy(got[:, :-1].reshape(-1, got.shape[-1]),
                                      torch.from_numpy(tokens[:, 1:]).long().reshape(-1)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    want_grads = convert.decoder_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads["params"]))
    top = max(float(g.abs().max()) for g in want_grads.values())
    for name, param in ours.named_parameters():
        assert float((param.grad - want_grads[name]).abs().max()) <= 5e-4 * top, name
    assert not any(fa.LAUNCHES.values())


def test_flash_path_in_bf16_matches_the_einsum_path_on_the_cpu():
    """`use_flash` in bf16 at T = 16 runs K1's plain version on the CPU
    (no kernel launch): logits within 2e-2 of the einsum path's (the
    einsum path rounds the scores to bf16 before its softmax, K1 keeps
    them in f32)."""
    _, _, base = flax_decoder(seed=3)
    models = {}
    for flash in (True, False):
        models[flash] = DecoderLM(**WIDTHS, dtype=torch.bfloat16, use_flash=flash)
        models[flash].load_state_dict(base.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 16))).long()
    fa.reset_launch_counts()
    with torch.no_grad():
        err = (models[True](tokens) - models[False](tokens)).abs().max().item()
    assert err <= 2e-2 and not any(fa.LAUNCHES.values())


# ---------------------------------------------------------------------------
# serve.py.
# ---------------------------------------------------------------------------

SMALL_REPLICA = ["--model_dim", "32", "--model_layers", "1", "--model_heads", "2",
                 "--prompt_len", "4", "--tokens_per_request", "8"]


def test_serve_py_serves_exactly_the_grant_and_ships_reports(tmp_path):
    """serve.py as a subprocess on the CPU (one thread) against a stub
    scheduler that grants 80 request batches and keeps the grant on
    renewal: SERVED 80 exactly, and the renewal at 75% of the grant (step
    60) carries the measured delta queued after 50 batches."""
    from conftest import cpu_subprocess_env
    from shockwave_tpu.runtime.servers import serve_scheduler
    granted, reports = 80, []

    def update_lease(job_id, worker_id, steps, duration, max_steps, max_duration,
                     measured_reports=None):
        reports.extend(measured_reports or [])
        return int(max_steps), float(max_duration), 0.0, 1e9

    port = free_port()
    server = serve_scheduler(port, {
        "RegisterWorker": lambda **kw: ([0], 60.0), "Done": lambda *a: None,
        "InitJob": lambda job_id: (granted, 1e6, 0.0), "UpdateLease": update_lease,
        "UpdateResourceRequirement": lambda *a: None})
    env = cpu_subprocess_env()
    env.update(SWTPU_JOB_ID="0", SWTPU_WORKER_ID="0", SWTPU_ROUND_ID="4",
               SWTPU_SCHED_ADDR="localhost", SWTPU_SCHED_PORT=str(port), OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "shockwave_tpu_torch", "workloads", "serving", "serve.py")
    try:
        out = subprocess.run(
            [sys.executable, script, "--batch_size", "2", "--base_rps", "400",
             "--peak_rps", "400", *SMALL_REPLICA, "--device", "cpu",
             "--checkpoint_dir", str(tmp_path), "--enable_lease_iterator"],
            capture_output=True, text=True, timeout=150, env=env)
    finally:
        server.stop(grace=0)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"SERVED {granted} request batches" in out.stdout, out.stdout[-2000:]
    assert "[REPLICA]\tcpu\teager" in out.stdout
    deltas = measured.find_reports(reports)
    assert deltas and deltas[0]["round"] == 4 and deltas[0]["seq"] == 1
    assert deltas[0]["requests"] > 0 and deltas[0]["sketch"]["n"] == deltas[0]["requests"]
    # What no renewal shipped arrived in the iterator log.
    log = (tmp_path / ".swtpu" / "round=4" / "worker=0.log").read_text()
    assert measured.find_reports(log), log[-2000:]


def test_serve_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--num_steps", "1"] + SMALL_REPLICA)


def test_eager_request_batch_is_greedy_decode():
    args = serve.build_parser().parse_args(SMALL_REPLICA + ["--batch_size", "3",
                                                            "--replica_index", "2"])
    model, prompt = serve.build_model_and_prompt(args, torch.device("cpu"))
    tokens = serve.eager_request_batch(model, prompt, args.tokens_per_request)
    assert tokens.shape == (3, 8)
    assert torch.equal(tokens, greedy_decode(model, prompt, 8))
    again, prompt_again = serve.build_model_and_prompt(args, torch.device("cpu"))
    assert torch.equal(prompt, prompt_again)  # the replica index seeds both


# ---------------------------------------------------------------------------
# The loopback with the real scheduler.
# ---------------------------------------------------------------------------

STAND_IN = """import os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from shockwave_tpu_torch.workloads.serving import serve
serve.main(sys.argv[1:] + {extra!r})
"""


def drive_serving(tmp_path, run_dir, worker_type, throughputs, service, round_s, limit_s):
    """The JAX package's PhysicalScheduler with one serving service and
    the port's daemon (one card); runs until a replica has reported
    served batches (on a renewal or in Done) and the service's measured
    state has samples.
    Returns (steps served, the service's measured requests, the sample
    count of its merged sketch, read together, and the service)."""
    from shockwave_tpu.sched.physical import PhysicalScheduler
    from shockwave_tpu.sched.scheduler import SchedulerConfig
    from shockwave_tpu.solver import get_policy
    from shockwave_tpu_torch.runtime.worker import WorkerDaemon

    sched_port, worker_port = free_port(), free_port()
    sched = PhysicalScheduler(
        get_policy("max_min_fairness"),
        throughputs_file=os.path.join(REPO, "data", throughputs),
        config=SchedulerConfig(time_per_iteration=round_s, max_rounds=60),
        expected_num_workers=1, port=sched_port)
    daemon = WorkerDaemon(
        worker_type=worker_type, sched_addr="127.0.0.1", sched_port=sched_port,
        worker_port=worker_port, num_chips=1,
        run_dirs={mode: run_dir for mode in ("static", "accordion", "gns", "serving")},
        data_dir=str(tmp_path / "data"), checkpoint_dir=str(tmp_path / "ckpt"))
    sched.add_job(service)
    runner = threading.Thread(target=sched.run, daemon=True)
    runner.start()
    served = requests = samples = 0
    try:
        deadline = time.time() + limit_s
        while time.time() < deadline:
            with sched._lock:
                # A sticky replica holds one extended lease and reports
                # its progress on the renewals.
                served = max([served] + [
                    max(sched.acct.total_steps_run.get(j, 0),
                        sched._steps_run_in_current_lease.get(j, 0))
                    for j in sched._serving_job_ids])
                svc = next(iter(sched._serving_tier.services.values()))
                requests = svc.measured.requests_total
                samples = svc.measured.sketch_total.count
            if served > 0 and requests > 0:
                break
            time.sleep(0.3)
    finally:
        sched._done_event.set()
        daemon._shutdown()
        daemon.join()
        sched.shutdown()
        sched._server.stop(grace=0)
    return served, requests, samples, svc


@pytest.mark.runtime
@pytest.mark.timeout(150)
def test_scheduler_serving_tier_runs_a_port_replica(tmp_path):
    from shockwave_tpu.core.trace import make_serving_job
    serving = tmp_path / "run" / "serving"
    serving.mkdir(parents=True)
    (serving / "serve.py").write_text(STAND_IN.format(
        repo=REPO, extra=["--device", "cpu"] + SMALL_REPLICA))
    service = make_serving_job(base_rps=200.0, peak_rps=200.0, period_s=0.0,
                               lifetime_s=3600.0, slo_p99_s=0.5, tokens_per_request=8,
                               decode_tokens_per_s=1600.0, max_replicas=1)
    served, requests, samples, _ = drive_serving(tmp_path, str(tmp_path / "run"), "v100",
                                                 "tacc_throughputs.json", service, 4.0, 120)
    assert served > 0, "the replica reported no served request batches"
    assert requests > 0 and samples == requests, "no measured samples reached the tier"


@pytest.mark.cuda
def test_h100_serving_tier_runs_the_trace_replica(tmp_path):
    """The same loopback on the card with data/serving_mixed.trace's first
    service (batch 1, 64 tokens, the default widths), the port's own
    serve.py under the port's run dir, planned from the h100 rates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from shockwave_tpu.core.trace import parse_trace
    jobs, _ = parse_trace(os.path.join(REPO, "data", "serving_mixed.trace"))
    services = [j for j in jobs if j.mode == "serving"]
    served, requests, _, svc = drive_serving(
        tmp_path, os.path.join(REPO, "shockwave_tpu_torch", "workloads"), "h100",
        "h100_throughputs.json", services[0], 20.0, 300)
    assert served > 0 and requests > 0
    print("h100_serving_loopback:", {"served": served, "requests": requests,
                                     "p99_s": svc.measured.sketch_total.quantile(0.99)},
          file=sys.stderr)
