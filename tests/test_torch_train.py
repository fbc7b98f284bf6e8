"""The port's trainer against the JAX package's, on the CPU.

Two SGD-momentum steps on one batch are compared with
`jax.value_and_grad` of the JAX trainer's loss plus
`optax.sgd(1e-3, momentum=0.9)`, with weights carried across by
`convert.py`; then the data pipeline, the checkpoints and the entry
point.
"""
import functools
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shockwave_tpu.core import durable_io as jax_durable_io
from shockwave_tpu.models import data as jax_data
from shockwave_tpu.models.transformer import Seq2SeqTransformer as FlaxSeq2Seq
from shockwave_tpu_torch.convert import flax_to_state_dict
from shockwave_tpu_torch.core import durable_io
from shockwave_tpu_torch.models import data, train_common
from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer
from shockwave_tpu_torch.ops import flash_attention as fa
from shockwave_tpu_torch.workloads.translation import train

KW = dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, mlp_dim=128,
          max_len=32)
# f32 on both sides; the sums run in another order. Loss: ~1e-7 relative
# is f32 rounding over 2 layers, 2e-6 leaves room. grad_norm_sq sums the
# squares of ~10^5 gradient entries: 1e-5 relative. Parameters move by
# lr * momentum trace (~1e-3 * |g|): 1e-6 absolute covers f32 rounding of
# the gradients feeding them.
LOSS_RTOL, GSQ_RTOL, PARAM_ATOL = 2e-6, 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests share the machine with the rest of the suite's workers
    (some of them timing-sensitive loopbacks); their tensors are tiny, so
    one intra-op thread is enough."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(1, 64, (4, 32)).astype(np.int32)
    tgt = rng.randint(1, 64, (4, 33)).astype(np.int32)
    src[1, 24:] = 0
    tgt[2, 20:] = 0
    return src, tgt


def jax_steps(params, src, tgt, use_flash, n=2):
    """The JAX trainer's step (workloads/translation/train.py's loss_fn,
    train_common's value_and_grad + global_norm + optax.sgd)."""
    model = FlaxSeq2Seq(**KW, dtype=jnp.float32, use_flash=use_flash)

    def loss_fn(params, src_tokens, tgt_tokens):
        logits = model.apply({"params": params}, src_tokens, tgt_tokens[:, :-1])
        targets = tgt_tokens[:, 1:]
        mask = (targets != 0).astype(jnp.float32)
        losses = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        return (losses * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    tx = optax.sgd(1e-3, momentum=0.9)
    opt = tx.init(params)
    metrics = []
    for _ in range(n):
        loss, grads = value_and_grad(params, src, tgt)
        metrics.append((float(loss), float(optax.global_norm(grads) ** 2)))
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return params, metrics


@pytest.mark.parametrize("use_flash", [False, True])
def test_two_sgd_steps_match_jax(use_flash):
    src, tgt = batch()
    params = FlaxSeq2Seq(**KW, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), src, tgt[:, :-1])["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = Seq2SeqTransformer(**KW, dtype=torch.float32, use_flash=use_flash)
    model.load_state_dict(flax_to_state_dict(params))
    trainer = train_common.Trainer(types.SimpleNamespace(), train.loss_fn,
                                   model, None, torch.device("cpu"),
                                   learning_rate=1e-3)
    src_t, tgt_t = (torch.from_numpy(x).long() for x in (src, tgt))
    port_metrics = [trainer.train_step(src_t, tgt_t) for _ in range(2)]

    ref_params, ref_metrics = jax_steps(params, src, tgt, use_flash)
    for got, (loss, gsq) in zip(port_metrics, ref_metrics):
        assert got["loss"].item() == pytest.approx(loss, rel=LOSS_RTOL)
        assert got["grad_norm_sq"].item() == pytest.approx(gsq, rel=GSQ_RTOL)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_params))
    state = model.state_dict()
    moved = 0.0
    for name, value in ref.items():
        assert (state[name] - value).abs().max().item() < PARAM_ATOL, name
        moved = max(moved, (value - flax_to_state_dict(params)[name]).abs().max().item())
    assert moved > 10 * PARAM_ATOL  # the steps did move the weights
    assert trainer.step == 2


@pytest.mark.parametrize("batch_size", [2, 64])
def test_synthetic_batches_are_the_jax_packages(batch_size):
    ours = next(iter(data.multi30k(batch_size, tgt_len=33)))
    ref = next(iter(jax_data.multi30k(batch_size, tgt_len=33)))
    assert ours[0].shape == (batch_size, 32) and ours[1].shape == (batch_size, 33)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_multi30k_files_load_as_the_jax_package_does(tmp_path):
    (tmp_path / "train.de").write_text("ein hund läuft\n\nzwei katzen\nein ball\n")
    (tmp_path / "train.en").write_text("a dog runs\nblank\ntwo cats\na ball\n")
    ours = data.multi30k(2, tgt_len=33, data_dir=str(tmp_path), seed=3)
    ref = jax_data.multi30k(2, tgt_len=33, data_dir=str(tmp_path), seed=3)
    assert not ours.synthetic
    for got, want in zip(ours, ref):
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_checkpoint_round_trip_and_prev_fallback(tmp_path):
    path = train_common.checkpoint_path(str(tmp_path))
    first = {"params": {"w": torch.arange(4.0)}, "step": 1}
    second = {"params": {"w": torch.arange(4.0) * 2}, "step": 2}
    train_common.save_checkpoint(path, first)
    train_common.save_checkpoint(path, second)
    loaded = train_common.load_checkpoint(path, torch.device("cpu"))
    assert loaded["step"] == 2 and torch.equal(loaded["params"]["w"], second["params"]["w"])
    # The footer is the JAX package's format.
    with open(path, "rb") as f:
        status, _ = jax_durable_io.verify_footer(f.read(), b"SWCKPT1\n")
    assert status == jax_durable_io.FOOTER_OK
    with open(path, "r+b") as f:  # corrupt the current generation
        f.seek(10)
        f.write(b"\xff\xfe\xfd")
    with open(path, "rb") as f:
        assert durable_io.verify_footer(f.read(), b"SWCKPT1\n")[0] == durable_io.FOOTER_CORRUPT
    loaded = train_common.load_checkpoint(path, torch.device("cpu"))
    assert loaded["step"] == 1 and torch.equal(loaded["params"]["w"], first["params"]["w"])


@pytest.fixture(autouse=True)
def _keep_sigterm_handler():
    """train.main installs the trainer's SIGTERM handler; give the test
    process its own back."""
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


SMALL = functools.partial(Seq2SeqTransformer, dim=32, num_heads=2,
                          num_layers=1, mlp_dim=64)


def test_main_trains_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(train, "Seq2SeqTransformer", SMALL)
    fa.reset_launch_counts()
    argv = ["-batch_size", "2", "-step", "2", "--device", "cpu",
            "-proj_share_weight", "--checkpoint_dir", str(tmp_path)]
    trainer = train.main(argv)
    assert "TRAINED 2 steps (cumulative 2)" in capsys.readouterr().out
    assert trainer.step == 2 and np.isfinite(trainer.last_metrics["loss"].item())
    assert not trainer.model.enc[0].self_attn.use_flash  # off by default on the CPU
    argv[3] = "3"
    resumed = train.main(argv + ["--use_flash"])
    assert "TRAINED 1 steps (cumulative 3)" in capsys.readouterr().out
    assert resumed.step == 3 and resumed.model.enc[0].self_attn.use_flash
    assert not any(fa.LAUNCHES.values())


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["-step", "1"])


@pytest.mark.parametrize("argv,env", [
    (["--num_processes", "2", "--process_id", "0"], {}),
])
def test_unported_paths_raise(argv, env, monkeypatch, tmp_path):
    """A gang member without its rendezvous address fails at once, naming
    the flag, instead of waiting for peers (`tests/test_torch_gang.py`
    trains real gangs)."""
    monkeypatch.setattr(train, "Seq2SeqTransformer", SMALL)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="--coordinator"):
        train.main(["-step", "1", "--device", "cpu",
                    "--checkpoint_dir", str(tmp_path)] + argv)


def record_monitor(monkeypatch, cls, **init_kwargs):
    """Patches `cls` (and the lease-free iterator) to record each observed
    norm as the host reads it, each epoch end, each request and the
    monitor's arguments; `init_kwargs` override its own."""
    rec = types.SimpleNamespace(events=[], requests=[], args=None)
    init, observe = cls.__init__, cls.observe_step

    def recording_init(self, iterator, *args, **kwargs):
        rec.args = args
        init(self, iterator, *args, **{**kwargs, **init_kwargs})

    def recording_observe(self, *norms):
        rec.events.append(tuple(float(n) for n in norms))
        observe(self, *norms)

    monkeypatch.setattr(cls, "__init__", recording_init)
    monkeypatch.setattr(cls, "observe_step", recording_observe)
    if cls is train_common.AccordionMonitor:
        end_epoch = cls.end_epoch
        monkeypatch.setattr(cls, "end_epoch",
                            lambda self: rec.events.append("epoch") or end_epoch(self))
    request = train_common._PlainIterator.update_resource_requirement
    monkeypatch.setattr(train_common._PlainIterator, "update_resource_requirement",
                        lambda self, big_bs, small_bs: rec.requests.append((big_bs, small_bs))
                        or request(self, big_bs, small_bs))
    return rec


@pytest.mark.parametrize("mode", ["accordion", "gns"])
def test_main_adapts_as_the_reference_does(mode, tmp_path, monkeypatch, capsys):
    """The translation main trains in `accordion` and `gns` mode (batch
    4, two-step epochs) and its monitor's requests are the reference
    monitor's on the same norms. The port trains on one device, so its
    GNS small batch is the whole batch; with n_dev = 2 the two sizes
    differ and the estimator runs (a window of 3)."""
    from shockwave_tpu.models import train_common as ref
    monkeypatch.setattr(train, "Seq2SeqTransformer", SMALL)
    monkeypatch.setenv("SWTPU_MODE", mode)
    monkeypatch.setenv("SWTPU_SYNTH_EPOCH_BATCHES", "2")
    if mode == "accordion":
        rec = record_monitor(monkeypatch, train_common.AccordionMonitor)
    else:
        rec = record_monitor(monkeypatch, train_common.GNSMonitor, window=3)
        monkeypatch.setattr(train, "Trainer", functools.partial(train_common.Trainer, n_dev=2))
    trainer = train.main(["-batch_size", "4", "-step", "8", "--device", "cpu",
                          "--checkpoint_dir", str(tmp_path)])
    steps = sum(1 for e in rec.events if e != "epoch")
    assert f"TRAINED {steps} steps" in capsys.readouterr().out
    assert steps > 0 and trainer.initial_bs == 4 and trainer.max_bs == 128

    ref_iterator = types.SimpleNamespace(requests=[])
    ref_iterator.update_resource_requirement = (
        lambda big_bs, small_bs: ref_iterator.requests.append((big_bs, small_bs)))
    if mode == "accordion":
        monitor = ref.AccordionMonitor(ref_iterator, *rec.args)
        for event in rec.events:
            if event == "epoch":
                monitor.end_epoch()
            else:
                monitor.observe_step(*event)
    else:
        assert rec.args[:2] == (2, 4)  # (small, big) batch sizes
        assert "grad_norm_sq_small" in trainer.last_metrics
        monitor = ref.GNSMonitor(ref_iterator, *rec.args, window=3)
        for event in rec.events:
            monitor.observe_step(*event)
            if monitor.maybe_request_double(4):
                break
    assert rec.requests == ref_iterator.requests
    if mode == "accordion":  # two stable epochs at 4 < 128: the big batch
        assert rec.requests == [(True, False)] and trainer.step == 4


def test_main_trains_under_a_lease(tmp_path, monkeypatch, capsys):
    """The lease branch of Trainer.run against a stub scheduler: expiry
    at the granted step with a checkpoint, resume in the next dispatch
    to the budget, then a dispatch whose checkpoint is already at
    budget reports the grant instead of failing."""
    import re
    import socket

    from shockwave_tpu.runtime.servers import serve_scheduler
    monkeypatch.setattr(train, "Seq2SeqTransformer", SMALL)
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    grants = iter([3, 2, 2])
    server = serve_scheduler(port, {
        "RegisterWorker": lambda **kw: ([0], 60.0), "Done": lambda *a: None,
        "InitJob": lambda job_id: (next(grants), 1e6, 0.0),
        "UpdateLease": lambda job, w, steps, d, max_steps, md: (max_steps, md, 0.0, 1e9)})
    for key, value in {"SWTPU_JOB_ID": "0", "SWTPU_WORKER_ID": "0",
                       "SWTPU_SCHED_ADDR": "localhost",
                       "SWTPU_SCHED_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("SWTPU_SPAN_SHARD_DIR", raising=False)
    argv = ["-batch_size", "2", "-step", "5", "--device", "cpu",
            "--enable_lease_iterator", "--checkpoint_dir", str(tmp_path)]

    def dispatch(round_id):
        monkeypatch.setenv("SWTPU_ROUND_ID", str(round_id))
        trainer = train.main(argv)
        log = (tmp_path / ".swtpu" / f"round={round_id}" / "worker=0.log").read_text()
        return trainer, capsys.readouterr().out, re.findall(r"\[PROGRESS\] \[STEPS\] (\d+)", log)

    try:
        trainer, out, progress = dispatch(0)
        assert "TRAINED 3 steps (cumulative 3)" in out and progress[-1] == "3"
        assert train_common.load_checkpoint(
            train_common.checkpoint_path(str(tmp_path)), torch.device("cpu"))["step"] == 3
        trainer, out, progress = dispatch(1)
        assert "TRAINED 2 steps (cumulative 5)" in out and progress[-1] == "2"
        trainer, out, progress = dispatch(2)
        assert "TRAINED 0 steps (cumulative 5)" in out and progress[-1] == "2"
        assert "[LEASE] [CKPT_AHEAD]" in (tmp_path / ".swtpu" / "round=2" / "worker=0.log").read_text()
    finally:
        server.stop(grace=0)
