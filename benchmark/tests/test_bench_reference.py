"""The plain references against the port's CPU path at tiny widths, both
in float32, from the same weights on the same batch; and the reference
importing nothing of the port."""
import os
import subprocess
import sys

import torch

from benchmark import generator
from benchmark.reference import resnet as ref_resnet
from benchmark.reference import train as ref_train
from benchmark.reference import transformer as ref_transformer
from benchmark.weights import make_weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"d_model": 16, "d_ff": 24, "num_heads": 2, "num_layers": 2, "vocab_size": 50,
        "max_len": 32, "layer_norm_eps": 1e-6}
MIX = {"kind": "token_pairs", "buckets": [[16, 3]], "sizes_seed": 0, "population": 6,
       "pool_batches": 2, "source_length": {"law": "uniform", "low": 4, "high": 16},
       "target_ratio": {"mean": 1.0, "std": 0.2}}


def port_transformer(use_flash):
    from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer
    return Seq2SeqTransformer(vocab_size=50, dim=16, num_heads=2, num_layers=2, mlp_dim=24,
                              max_len=32, dtype=torch.float32, use_flash=use_flash)


def test_transformer_matches_the_port_in_f32():
    from shockwave_tpu_torch.workloads.translation.train import loss_fn
    spec = ref_transformer.param_spec(TINY)
    weights = make_weights(spec, 3, "cpu")
    batch = generator.make(MIX, TINY, 4, "cpu")[0].tensors
    ref = ref_transformer.Transformer(TINY)
    want = ref.logits(weights, batch[0], batch[1][:, :-1])
    want_loss = ref.loss_sum(weights, batch, slice(None)) / ref.count(batch)
    for use_flash in (False, True):  # einsum, and K1-K3's plain versions
        model = port_transformer(use_flash)
        model.load_state_dict(weights, strict=True)
        got = model(batch[0], batch[1][:, :-1])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(loss_fn(model, *batch)[0], want_loss, rtol=1e-6, atol=1e-6)


def test_reference_steps_match_the_port_in_f32():
    """Three SGD steps: the reference's readings against an f32 port
    model under `torch.optim.SGD`, as the trainer steps it."""
    from shockwave_tpu_torch.workloads.translation.train import loss_fn
    spec = ref_transformer.param_spec(TINY)
    weights = make_weights(spec, 5, "cpu")
    batches = [b.tensors for b in generator.make(MIX, TINY, 6, "cpu")] * 2
    opt = {"lr": 0.05, "momentum": 0.9}
    readings = ref_train.train(ref_transformer.Transformer(TINY), spec, weights, batches[:3], opt)
    model = port_transformer(False)
    model.load_state_dict(weights)
    sgd = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    for step, batch in enumerate(batches[:3]):
        sgd.zero_grad()
        loss, _ = loss_fn(model, *batch)
        loss.backward()
        sgd.step()
        assert abs(float(loss.detach()) - readings["losses"][step]) < 1e-5
        if step == 0:
            for name, p in model.named_parameters():
                g = float(sgd.state[p]["momentum_buffer"].norm())
                assert abs(g - readings["grad_norms"][name]) <= 1e-4 * max(g, 1e-3)
    for name, t in model.state_dict().items():
        change = float((t - weights[name]).norm())
        assert abs(change - readings["change_norms"][name]) <= 1e-4 * max(change, 1e-4)


def test_resnet_matches_the_port_in_f32():
    from shockwave_tpu_torch.models.resnet import BottleneckBlock, ResNet
    cfg = {"stage_sizes": [1, 1, 1, 1], "num_filters": 4, "channels": 3, "num_classes": 7,
           "bn_momentum": 0.9, "bn_eps": 1e-5}
    spec = ref_resnet.param_spec(cfg)
    weights = make_weights(spec, 8, "cpu")
    images = torch.rand(3, 33, 32, 3, generator=torch.Generator().manual_seed(1))
    port = ResNet([1, 1, 1, 1], BottleneckBlock, 7, num_filters=4, dtype=torch.float32)
    port.load_state_dict(weights, strict=True)
    got = port(images)
    state = {n: weights[n].clone() for n, _, _, train in spec if not train}
    want = ref_resnet.ResNet(cfg).logits(weights, state, images)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for name, t in state.items():  # running statistics after one batch
        torch.testing.assert_close(port.state_dict()[name], t, rtol=1e-5, atol=1e-6)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import benchmark.reference.transformer, benchmark.reference.resnet, "
            "benchmark.reference.train, benchmark.reference.products; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"shockwave_tpu_torch", "shockwave_tpu", "jax", "jaxlib", "flax", "optax"}


def test_resnet_steps_match_the_port_in_f32():
    """Three SGD steps of a narrow ResNet in f32: the reference's readings
    against the port's model under `torch.optim.SGD`, running statistics
    included. At lr 0.1 on six images the loss jumps from step to step,
    which makes the later steps sensitive to the order of float32 sums:
    hence 1e-3 there and 1e-5 for the first gradient."""
    from shockwave_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from shockwave_tpu_torch.workloads.image_classification.cifar10.main import loss_fn
    cfg = {"stage_sizes": [1, 1, 1, 1], "num_filters": 4, "channels": 3, "num_classes": 7,
           "bn_momentum": 0.9, "bn_eps": 1e-5}
    spec = ref_resnet.param_spec(cfg)
    weights = make_weights(spec, 9, "cpu")
    gen = torch.Generator().manual_seed(2)
    batches = [(torch.rand(6, 32, 32, 3, generator=gen), torch.randint(0, 7, (6,), generator=gen))
               for _ in range(3)]
    opt = {"lr": 0.1, "momentum": 0.9}
    readings = ref_train.train(ref_resnet.ResNet(cfg), spec, weights, batches, opt)
    port = ResNet([1, 1, 1, 1], BottleneckBlock, 7, num_filters=4, dtype=torch.float32)
    port.load_state_dict(weights)
    sgd = torch.optim.SGD(port.parameters(), lr=0.1, momentum=0.9)
    for step, batch in enumerate(batches):
        sgd.zero_grad()
        loss, _ = loss_fn(port, *batch)
        loss.backward()
        sgd.step()
        assert abs(float(loss.detach()) - readings["losses"][step]) < 1e-3
        if step == 0:
            for name, p in port.named_parameters():
                g = float(sgd.state[p]["momentum_buffer"].norm())
                assert abs(g - readings["grad_norms"][name]) <= 1e-5 * max(g, 1e-3), name
    for name, t in port.state_dict().items():
        change = float((t - weights[name]).norm())
        assert abs(change - readings["change_norms"][name]) <= 1e-3 * max(change, 1e-3), name
