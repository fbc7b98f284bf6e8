#!/usr/bin/env python3
"""ResNet-18 / CIFAR-10 workload (trace: "ResNet-18 (batch size N)"), on
PyTorch.

The port of `shockwave_tpu/workloads/image_classification/cifar10/main.py`,
with the same CLI: the trace command is `python3 main.py
--data_dir=%s/cifar10 --batch_size N` with `--num_steps` appended by the
dispatcher. `--device` (default `cuda`) chooses the card or the CPU.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), *[".."] * 4))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from shockwave_tpu_torch.models import data  # noqa: E402
from shockwave_tpu_torch.models.resnet import ResNet18  # noqa: E402
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    Trainer, common_parser, parse_args, resolve_device)

MAX_BS = 256


def loss_fn(model, images, labels):
    """Mean cross-entropy over the images; BatchNorm's running statistics
    update in place."""
    return F.cross_entropy(model(images), labels), {"count": labels.shape[0]}


def build_trainer(argv=None):
    """The job's `Trainer` from the trace's CLI, built but not trained."""
    p = common_parser("ResNet-18 on CIFAR-10", steps_args=("--num_steps",))
    p.add_argument("--data_dir", default=None)
    p.add_argument("--batch_size", type=int, default=128)
    args = parse_args(p, argv)
    device = resolve_device(args.device)
    return Trainer(
        args, loss_fn, ResNet18(generator=torch.Generator().manual_seed(0)),
        data.cifar10(args.batch_size, data_dir=args.data_dir), device=device,
        learning_rate=0.1, initial_bs=args.batch_size, max_bs=MAX_BS)


def main(argv=None):
    trainer = build_trainer(argv)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
