"""The port's LM, Recommendation and ResNet workloads against the JAX
package's, on the CPU.

Per family, at a small width: the same seeded batch and the same weights
(carried by `convert.py`) go through two SGD-momentum steps of the port's
`Trainer` and of the JAX package's `Trainer` (its jit'd step over the 8
virtual CPU devices), both in `gns` mode with the port's `n_dev = 8`, so
that each also reports the squared gradient norm over the first B // 8
rows. Compared: the loss, the gradient norm^2, the small-batch gradient
norm^2, the parameters after the two steps (by how far they moved), and
for ResNet the BatchNorm running mean and variance. Then the loaders
(real formats on tiny files the tests write, and the synthetic batches)
and the entry points.
"""
import functools
import pickle
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from shockwave_tpu.models import data as jax_data
from shockwave_tpu.models import train_common as jax_train_common
from shockwave_tpu.models.lm import LSTMLanguageModel as FlaxLM
from shockwave_tpu.models.recommendation import AutoEncoder as FlaxAutoEncoder
from shockwave_tpu.models.recommendation import multinomial_nll as jax_nll
from shockwave_tpu.models.resnet import BottleneckBlock as FlaxBottleneck
from shockwave_tpu.models.resnet import ResNet as FlaxResNet
from shockwave_tpu.models.resnet import ResNet18 as FlaxResNet18
from shockwave_tpu_torch import convert
from shockwave_tpu_torch.models import data, lm, recommendation, resnet, train_common
from shockwave_tpu_torch.workloads.image_classification.cifar10 import main as cifar10_main
from shockwave_tpu_torch.workloads.image_classification.imagenet import main as imagenet_main
from shockwave_tpu_torch.workloads.language_modeling import main as lm_main
from shockwave_tpu_torch.workloads.recommendation import train as rec_main

BATCH = 16  # two rows per virtual device on the JAX side: GNS's small batch
N_DEV = 8

# Tolerances, on the same inputs. `move` bounds each parameter tensor's
# error after two steps against how far the step moved it (max-abs over
# max-abs), `whole` the same over all parameters at once (2-norms).
# - LM, all f32: the sums run in another order (an LSTM scan against fused
#   gates), so the loss agrees to f32 rounding (rel 1e-5), the gradient
#   norms^2 to 1e-4 and each tensor's movement to 1e-4.
# - Recommendation, bf16 dense layers: a bf16 value is rounded to 2^-9
#   relative and the two sides round different partial sums, so an
#   activation can flip by one bf16 ulp: loss 1e-2, norms^2 5e-2,
#   movement 5e-2.
# - ResNet in f32 (convolutions in f32 on both sides) pins the structure:
#   the JAX package's BatchNorm differentiates the fast variance
#   E[x^2] - E[x]^2, whose f32 cancellation moves its ResNet-18 gradients
#   by up to 7% of a tensor's largest element against a float64 run of the
#   same step (the port's stay within 1e-5 of it). Loss 1e-5, norms^2
#   1e-2, each tensor's movement 0.15, whole 0.05, running statistics 1e-3
#   of their scale.
# - ResNet in bf16, the workloads' dtype: that cancellation acts on
#   bf16-rounded convolution outputs; the JAX package's own bf16 run ends
#   up to 41% of a tensor's movement away from its f32 run, and the first
#   step's rounding differences feed the second step's inputs. Loss 5e-2,
#   norms^2 0.2, whole movement 0.4, running statistics 5e-2 of their
#   scale; no per-tensor bound.
F32_TOL = dict(loss=1e-5, gsq=1e-4, move=1e-4, whole=1e-4, stats=None)
BF16_DENSE_TOL = dict(loss=1e-2, gsq=5e-2, move=5e-2, whole=5e-2, stats=None)
RESNET_F32_TOL = dict(loss=1e-5, gsq=1e-2, move=0.15, whole=0.05, stats=1e-3)
RESNET_BF16_TOL = dict(loss=5e-2, gsq=0.2, move=None, whole=0.4, stats=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _keep_sigterm_handler():
    """The mains install the trainer's SIGTERM handler; give the test
    process its own back."""
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


def ce_loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def lm_case(rng):
    flax_model = FlaxLM(vocab_size=64, embed_dim=16, hidden_size=32)
    tokens = rng.randint(1, 64, (BATCH, 13)).astype(np.int32)
    batch = (tokens[:, :-1], tokens[:, 1:])
    variables = flax_model.init(jax.random.PRNGKey(0), batch[0])

    def jax_loss(params, state, x, y):
        return ce_loss(flax_model.apply({"params": params}, x), y), {}

    model = lm.LSTMLanguageModel(vocab_size=64, embed_dim=16, hidden_size=32)
    return dict(variables=variables, batch=batch, jax_loss=jax_loss, model=model,
                loss_fn=lm_main.loss_fn, lr=1.0, tol=F32_TOL,
                to_sd=lambda v: convert.lm_flax_to_state_dict(v["params"]))


def recoder_case(rng):
    flax_model = FlaxAutoEncoder(num_items=128)
    rows = (rng.rand(BATCH, 128) < 0.1).astype(np.float32)
    rows[:, 0] = 1.0  # every user has an interaction
    variables = flax_model.init(jax.random.PRNGKey(0), rows)

    def jax_loss(params, state, x):
        return jax_nll(flax_model.apply({"params": params}, x), x), {}

    return dict(variables=variables, batch=(rows,), jax_loss=jax_loss,
                model=recommendation.AutoEncoder(num_items=128), loss_fn=rec_main.loss_fn,
                lr=1e-3, tol=BF16_DENSE_TOL,
                to_sd=lambda v: convert.recoder_flax_to_state_dict(v["params"]))


def resnet_case(rng, flax_model, model, size, tol):
    images = rng.rand(BATCH, size, size, 3).astype(np.float32)
    labels = rng.randint(0, 10, (BATCH,)).astype(np.int32)
    variables = flax_model.init(jax.random.PRNGKey(0), images, train=True)
    # Non-zero last-norm scales, so that every branch carries gradient.
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.5 if "scale" in jax.tree_util.keystr(path) else x,
        variables)

    def jax_loss(params, state, x, y):
        logits, mutated = flax_model.apply(
            {"params": params, "batch_stats": state["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return ce_loss(logits, y), {"batch_stats": mutated["batch_stats"]}

    return dict(variables=variables, batch=(images, labels), jax_loss=jax_loss,
                model=model, loss_fn=cifar10_main.loss_fn, lr=0.1, tol=tol,
                to_sd=lambda v: convert.resnet_flax_to_state_dict(
                    v["params"], v["batch_stats"]))


RESNET_DTYPES = {"f32": (jnp.float32, torch.float32, RESNET_F32_TOL),
                 "bf16": (jnp.bfloat16, torch.bfloat16, RESNET_BF16_TOL)}


def resnet18_case(rng, dtype):
    jdt, tdt, tol = RESNET_DTYPES[dtype]
    return resnet_case(rng, FlaxResNet18(num_filters=8, dtype=jdt),
                       resnet.ResNet18(num_filters=8, dtype=tdt), 32, tol)


def bottleneck_case(rng, dtype):
    """The ImageNet stem (7x7 stride 2, SAME max-pool) and strided 3x3
    bottlenecks: both SAME-padding traps at once. 64x64 images leave 2x2
    maps in the last stage, so that BatchNorm over GNS's 2-row small batch
    still averages 8 values (over 2 values of a 1x1 map the batch variance
    is a rounding residue, and its gradient is noise on both sides)."""
    jdt, tdt, tol = RESNET_DTYPES[dtype]
    return resnet_case(
        rng, FlaxResNet(stage_sizes=(1, 1, 1, 1), block_cls=FlaxBottleneck,
                        num_classes=10, num_filters=8, dtype=jdt),
        resnet.ResNet((1, 1, 1, 1), resnet.BottleneckBlock, 10, num_filters=8, dtype=tdt),
        64, tol)


CASES = {
    "lm": lm_case,
    "recommendation": recoder_case,
    "resnet18_f32": functools.partial(resnet18_case, dtype="f32"),
    "resnet18_bf16": functools.partial(resnet18_case, dtype="bf16"),
    "bottleneck_f32": functools.partial(bottleneck_case, dtype="f32"),
    "bottleneck_bf16": functools.partial(bottleneck_case, dtype="bf16"),
}


def jax_trainer(case, monkeypatch, mode="gns"):
    """The JAX package's Trainer (no compile cache) on the case's state."""
    monkeypatch.setattr(jax_train_common, "enable_compile_cache", lambda *a: None)
    args = types.SimpleNamespace(coordinator=None, num_processes=None, process_id=None)
    # A copy: the jit'd step donates the state's buffers.
    init_state = jax.tree_util.tree_map(jnp.array, dict(case["variables"]))
    return jax_train_common.Trainer(args, case["jax_loss"], init_state, None, mode=mode,
                                    initial_bs=BATCH, learning_rate=case["lr"])


def jax_steps(trainer, batch, n=2):
    state, metrics = trainer.state, []
    for _ in range(n):
        state, m = trainer.train_step(state, *jax.device_put(batch, trainer.batch_sharding))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree_util.tree_map(np.asarray, jax.device_get(state)), metrics


def port_trainer(case, mode="gns", n_dev=N_DEV):
    model = case["model"]
    as_numpy = jax.tree_util.tree_map(np.asarray, case["variables"])
    model.load_state_dict(case["to_sd"](as_numpy))
    return train_common.Trainer(types.SimpleNamespace(), case["loss_fn"], model, None,
                                torch.device("cpu"), learning_rate=case["lr"], mode=mode,
                                initial_bs=BATCH, n_dev=n_dev)


@pytest.mark.parametrize("family", sorted(CASES))
def test_two_sgd_steps_match_jax(family, monkeypatch):
    case = CASES[family](np.random.RandomState(0))
    tol = case["tol"]
    before = case["to_sd"](jax.tree_util.tree_map(np.asarray, case["variables"]))
    trainer = port_trainer(case)
    batch = tuple(train_common.upload(b, torch.device("cpu")) for b in case["batch"])
    got = [trainer.train_step(*batch) for _ in range(2)]
    ref_state, ref = jax_steps(jax_trainer(case, monkeypatch), case["batch"])

    for mine, want in zip(got, ref):
        assert mine["loss"].item() == pytest.approx(want["loss"], rel=tol["loss"])
        for key in ("grad_norm_sq", "grad_norm_sq_small"):
            assert mine[key].item() == pytest.approx(want[key], rel=tol["gsq"]), key
        assert want["grad_norm_sq_small"] != pytest.approx(want["grad_norm_sq"], rel=0.1)
    after = case["to_sd"](ref_state)
    state = trainer.model.state_dict()
    moves, errs = [], []
    for name, want in after.items():
        err = (state[name] - want).abs()
        if "running" in name:
            assert err.max().item() <= tol["stats"] * max(want.abs().max().item(), 1.0), name
            continue
        move = (want - before[name]).abs()
        if tol["move"] is not None:
            assert err.max().item() <= tol["move"] * move.max().item(), name
        moves.append(move.flatten())
        errs.append(err.flatten())
    moved = torch.cat(moves).norm().item()
    assert moved > 0 and torch.cat(errs).norm().item() <= tol["whole"] * moved
    assert trainer.step == 2


def test_gns_on_one_card_skips_the_second_backward(monkeypatch):
    """n_dev = 1: the small batch is the whole batch, so the small norm is
    the step's own norm, and one forward runs per step."""
    case = CASES["resnet18_bf16"](np.random.RandomState(1))
    calls = []
    loss_fn = case["loss_fn"]
    case["loss_fn"] = lambda *a: calls.append(1) or loss_fn(*a)
    trainer = port_trainer(case, n_dev=1)
    batch = tuple(train_common.upload(b, torch.device("cpu")) for b in case["batch"])
    metrics = trainer.train_step(*batch)
    assert metrics["grad_norm_sq_small"] is metrics["grad_norm_sq"]
    assert len(calls) == 1


def test_batchnorm_running_variance_is_the_biased_one():
    """flax: running = 0.9 * running + 0.1 * var(ddof=0); nn.BatchNorm2d
    would take ddof=1, which differs by n/(n-1) on small maps."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 2, 2).astype(np.float32))
    bn = resnet.BatchNorm(3)
    out = bn(x)
    flat = x.permute(1, 0, 2, 3).reshape(3, -1).double()
    mean, var = flat.mean(1), flat.var(1, unbiased=False)
    assert torch.allclose(bn.running_mean.double(), 0.1 * mean, atol=1e-7)
    assert torch.allclose(bn.running_var.double(), 0.9 + 0.1 * var, atol=1e-6)
    ref = (x.double() - mean[None, :, None, None]) / torch.sqrt(var + 1e-5)[None, :, None, None]
    assert torch.allclose(out.double(), ref, atol=1e-5)


@pytest.mark.parametrize("size,stride,pads", [(32, 2, (0, 1)), (16, 1, (1, 1)),
                                              (7, 2, (1, 1)), (224, 2, (0, 1))])
def test_same_pads_are_xla_s(size, stride, pads):
    assert resnet.same_pads(size, 3, stride) == pads
    assert tuple(jax.lax.padtype_to_pads((size,), (3,), (stride,), "SAME")[0]) == pads


# -- loaders -----------------------------------------------------------------


def batches(loader):
    return [tuple(np.asarray(a) for a in b) for b in loader]


def assert_same_batches(ours, ref):
    assert ours.synthetic == ref.synthetic
    a, b = batches(ours), batches(ref)
    assert len(a) == len(b) > 0
    for got, want in zip(a, b):
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


SYNTHETIC = {
    "cifar10": lambda d: d.cifar10(4),
    "imagenet": lambda d: d.imagenet(2),
    "wikitext2": lambda d: d.wikitext2(3),
    "ml20m": lambda d: d.ml20m(2),
}


@pytest.mark.parametrize("family", sorted(SYNTHETIC))
def test_synthetic_batches_are_the_jax_packages(family, monkeypatch):
    monkeypatch.setenv("SWTPU_SYNTH_EPOCH_BATCHES", "2")
    assert_same_batches(SYNTHETIC[family](data), SYNTHETIC[family](jax_data))


def write_cifar(root, n=64, npz=False):
    if npz:
        rng = np.random.RandomState(0)
        np.savez(root / "cifar10.npz", images=rng.randint(0, 255, (n, 32, 32, 3)),
                 labels=rng.randint(0, 10, n))
        return
    d = root / "cifar-10-batches-py"
    d.mkdir()
    per = n // 5
    for i in range(1, 6):
        batch = {b"data": (np.arange(per * 3072) * i % 255).astype(np.uint8).reshape(per, 3072),
                 b"labels": [(i + j) % 10 for j in range(per)]}
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump(batch, f)


def write_imagenet(root):
    from PIL import Image
    for ci, cls in enumerate(("n01440764", "n01443537")):
        d = root / "train" / cls
        d.mkdir(parents=True)
        for i in range(3):
            arr = np.random.RandomState(10 * ci + i).randint(0, 255, (30, 40, 3)).astype("uint8")
            Image.fromarray(arr).save(d / f"im{i}.png")


def write_ml20m(root, frequent_item=False):
    d = root / "pro_sg"
    d.mkdir()
    if frequent_item:
        lines = ["uid,sid"] + [f"{u},500" for u in range(8)] + ["0,900"]
    else:
        lines = ["uid,sid"] + [f"{uid},{sid * 7 % 19}" for uid in range(12)
                               for sid in range(uid % 4 + 1)]
    (d / "train.csv").write_text("\n".join(lines))


LOADERS = {
    "cifar10_batches": (write_cifar, lambda d, p: d.cifar10(4, data_dir=p, seed=3)),
    "cifar10_npz": (functools.partial(write_cifar, npz=True),
                    lambda d, p: d.cifar10(8, data_dir=p, seed=1)),
    "cifar10_missing": (lambda root: None, lambda d, p: d.cifar10(4, data_dir=p + "/nope")),
    "imagenet_folder": (write_imagenet, lambda d, p: d.imagenet(2, data_dir=p, seed=2)),
    "imagenet_missing": (lambda root: None, lambda d, p: d.imagenet(2, data_dir=p + "/nope")),
    "wikitext2": (lambda root: (root / "wiki.train.tokens").write_text(
        " ".join(f"word{i * 7 % 50}" for i in range(3000))),
        lambda d, p: d.wikitext2(2, seq_len=10, vocab=40, data_dir=p, seed=4)),
    "ml20m": (write_ml20m, lambda d, p: d.ml20m(4, num_items=19, data_dir=p, seed=5)),
    "ml20m_capped": (functools.partial(write_ml20m, frequent_item=True),
                     lambda d, p: d.ml20m(2, num_items=1, data_dir=p)),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loaders_read_files_as_the_jax_package_does(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SWTPU_SYNTH_EPOCH_BATCHES", "2")
    write, make = LOADERS[name]
    write(tmp_path)
    ours, ref = make(data, str(tmp_path)), make(jax_data, str(tmp_path))
    assert ours.synthetic == name.endswith("_missing")
    assert_same_batches(ours, ref)


# -- entry points --------------------------------------------------------------


SMALL_MODELS = {
    "lm": (lm_main, "LSTMLanguageModel",
           functools.partial(lm.LSTMLanguageModel, embed_dim=16, hidden_size=16),
           ["--cuda", "--batch_size", "2", "--steps"]),
    "recommendation": (rec_main, "AutoEncoder",
                       functools.partial(recommendation.AutoEncoder, hidden_dims=(16,)),
                       ["--data_dir", "x", "--batch_size", "4", "-n"]),
    "cifar10": (cifar10_main, "ResNet18",
                functools.partial(resnet.ResNet18, num_filters=4),
                ["--data_dir=x", "--batch_size", "2", "--num_steps"]),
    "imagenet": (imagenet_main, "ResNet50",
                 lambda generator: resnet.ResNet((1, 1, 1, 1), resnet.BottleneckBlock, 1000,
                                                 num_filters=4, generator=generator),
                 ["-j", "4", "-a", "resnet50", "-b", "2", "x/", "--num_minibatches"]),
}


@pytest.mark.parametrize("family", sorted(SMALL_MODELS))
def test_main_trains_and_resumes(family, tmp_path, monkeypatch, capsys):
    module, attr, small, argv = SMALL_MODELS[family]
    monkeypatch.setattr(module, attr, small)
    common = ["--device", "cpu", "--checkpoint_dir", str(tmp_path)]
    trainer = module.main(argv + ["2"] + common)
    assert "TRAINED 2 steps (cumulative 2)" in capsys.readouterr().out
    assert trainer.step == 2 and np.isfinite(trainer.last_metrics["loss"].item())
    assert trainer.initial_bs == (4 if family == "recommendation" else 2)
    assert trainer.max_bs == module.MAX_BS
    resumed = module.main(argv + ["3"] + common)
    assert "TRAINED 1 steps (cumulative 3)" in capsys.readouterr().out
    for name, value in trainer.model.state_dict().items():
        assert value.dtype == resumed.model.state_dict()[name].dtype


@pytest.mark.parametrize("family", sorted(SMALL_MODELS))
def test_cuda_without_a_card_raises(family, monkeypatch):
    module, _, _, argv = SMALL_MODELS[family]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv + ["1"])


def test_upload_keeps_float_batches_float():
    images = np.random.RandomState(0).rand(2, 4, 4, 3).astype(np.float32)
    labels = np.array([1, 2], np.int32)
    up = [train_common.upload(a, torch.device("cpu")) for a in (images, labels)]
    assert up[0].dtype == torch.float32 and torch.equal(up[0], torch.from_numpy(images))
    assert up[1].dtype == torch.int64
    assert F.cross_entropy(torch.zeros(2, 3), up[1]).item() > 0
