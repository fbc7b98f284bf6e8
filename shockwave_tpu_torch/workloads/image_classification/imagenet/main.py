#!/usr/bin/env python3
"""ResNet-50 / ImageNet workload (trace: "ResNet-50 (batch size N)"), on
PyTorch.

The port of `shockwave_tpu/workloads/image_classification/imagenet/main.py`,
with the same CLI: the trace command is `python3 main.py -j 4 -a
resnet50 -b N %s/imagenet/` with `--num_minibatches` appended by the
dispatcher. `--device` (default `cuda`) chooses the card or the CPU.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), *[".."] * 4))

import torch  # noqa: E402

from shockwave_tpu_torch.models import data  # noqa: E402
from shockwave_tpu_torch.models.resnet import ResNet50  # noqa: E402
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    Trainer, common_parser, parse_args, resolve_device)
from shockwave_tpu_torch.workloads.image_classification.cifar10.main import (  # noqa: E402
    loss_fn)

MAX_BS = 128


def build_trainer(argv=None):
    """The job's `Trainer` from the trace's CLI, built but not trained."""
    p = common_parser("ResNet-50 on ImageNet", steps_args=("--num_minibatches",))
    p.add_argument("data", nargs="?", default=None)
    p.add_argument("-j", "--workers", type=int, default=4)
    p.add_argument("-a", "--arch", default="resnet50")
    p.add_argument("-b", "--batch_size", type=int, default=64)
    args = parse_args(p, argv)
    device = resolve_device(args.device)
    return Trainer(
        args, loss_fn, ResNet50(generator=torch.Generator().manual_seed(0)),
        data.imagenet(args.batch_size, data_dir=args.data), device=device,
        learning_rate=0.1, initial_bs=args.batch_size, max_bs=MAX_BS)


def main(argv=None):
    trainer = build_trainer(argv)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
