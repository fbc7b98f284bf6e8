"""Faults planted under the timed path, for the checks that `correct`
must catch: each patches a built `Trainer` in place.

- `unchanged`: the step returns its state unchanged (no update);
- `half_batch`: half of the batch left out, the mean taken over the rest;
- `altered`: an answer altered where it is produced: after each update,
  one element of the model's first tensor is written wrong.

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

import torch


def unchanged(trainer) -> None:
    trainer.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer) -> None:
    loss_fn = trainer._loss_fn

    def halved(model, *batch):
        return loss_fn(model, *(b[: b.shape[0] // 2] for b in batch))

    trainer._loss_fn = halved


def altered(trainer) -> None:
    step = trainer.optimizer.step
    first = next(trainer.model.parameters())

    def wrong(*args, **kwargs):
        out = step(*args, **kwargs)
        with torch.no_grad():
            first.view(-1)[0] += 1.0
        return out

    trainer.optimizer.step = wrong


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
