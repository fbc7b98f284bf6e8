#!/usr/bin/env python3
"""Autoencoder recommender / ML-20M workload
(trace: "Recommendation (batch size N)"), on PyTorch.

The port of `shockwave_tpu/workloads/recommendation/train.py`, with the
same CLI: the trace command is `python3 train.py --data_dir
%s/ml-20m/pro_sg/ --batch_size N` with `-n` (steps) appended by the
dispatcher. `--device` (default `cuda`) chooses the card or the CPU.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), *[".."] * 3))

import torch  # noqa: E402

from shockwave_tpu_torch.models import data  # noqa: E402
from shockwave_tpu_torch.models.recommendation import (  # noqa: E402
    AutoEncoder, multinomial_nll)
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    Trainer, common_parser, parse_args, resolve_device)

MAX_BS = 8192


def loss_fn(model, interactions):
    """Multinomial NLL, a mean over the users (rows)."""
    return multinomial_nll(model(interactions), interactions), {"count": interactions.shape[0]}


def build_trainer(argv=None):
    """The job's `Trainer` from the trace's CLI, built but not trained."""
    p = common_parser("AutoEncoder on ML-20M", steps_args=("-n", "--num_steps"))
    p.add_argument("--data_dir", default=None)
    p.add_argument("--batch_size", type=int, default=2048)
    args = parse_args(p, argv)
    device = resolve_device(args.device)
    model = AutoEncoder(generator=torch.Generator().manual_seed(0))
    return Trainer(
        args, loss_fn, model,
        data.ml20m(args.batch_size, num_items=model.num_items, data_dir=args.data_dir),
        device=device, learning_rate=1e-3, initial_bs=args.batch_size, max_bs=MAX_BS)


def main(argv=None):
    trainer = build_trainer(argv)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
