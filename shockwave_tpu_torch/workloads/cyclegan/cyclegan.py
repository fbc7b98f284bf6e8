#!/usr/bin/env python3
"""CycleGAN monet2photo workload (trace: "CycleGAN"), on PyTorch.

The port of `shockwave_tpu/workloads/cyclegan/cyclegan.py`, with its CLI:
the trace command is `python3 cyclegan.py --dataset_path %s/monet2photo
--decay_epoch 0` with `--n_steps` appended by the dispatcher. `--device`
(default `cuda`) chooses the card or, when asked, the CPU.

GAN training has two optimizers, so this main drives the lease iterator
itself (`train_common.run_loop`) instead of the shared `Trainer`: one
step updates G_AB and G_BA on the generators' loss, then D_A and D_B on
the discriminators' loss against the step's fakes, each with
Adam(lr, b1=0.5). As in the reference, both generators start from one
draw, and so do both discriminators (the reference initialises each pair
from one key): the port builds one of each pair and copies it.
CycleGAN is a one-card family (the reference's mesh is trivial at
scale factor 1).
"""
import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), *[".."] * 3))

import torch  # noqa: E402

from shockwave_tpu_torch.models import data  # noqa: E402
from shockwave_tpu_torch.models.cyclegan import Discriminator, Generator  # noqa: E402
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    LoopJob, common_parser, parse_args, resolve_device, run_loop)


def build_step(models, g_opt, d_opt, lambda_cyc: float = 10.0, lambda_id: float = 5.0):
    """`step(real_a, real_b) -> metrics`: the reference's fused step, on
    `models = (g_ab, g_ba, d_a, d_b)`. The generators' gradients are
    taken through the discriminators, whose own parameters the
    generator step leaves alone. Metrics stay on the device; `loss` is
    the generators' loss, the step's sync ref."""
    g_ab, g_ba, d_a, d_b = models
    g_params = [*g_ab.parameters(), *g_ba.parameters()]

    def mse(x, target):
        return ((x - target) ** 2).mean()

    def l1(x, y):
        return (x - y).abs().mean()

    def step(real_a, real_b):
        fake_b, fake_a = g_ab(real_a), g_ba(real_b)
        rec_a, rec_b = g_ba(fake_b), g_ab(fake_a)
        id_a, id_b = g_ba(real_a), g_ab(real_b)
        adv = mse(d_b(fake_b), 1.0) + mse(d_a(fake_a), 1.0)
        cyc = l1(rec_a, real_a) + l1(rec_b, real_b)
        ident = l1(id_a, real_a) + l1(id_b, real_b)
        g_loss = adv + lambda_cyc * cyc + lambda_id * ident
        for p, grad in zip(g_params, torch.autograd.grad(g_loss, g_params)):
            p.grad = grad
        g_opt.step()

        fake_a, fake_b = fake_a.detach(), fake_b.detach()
        d_opt.zero_grad(set_to_none=True)
        loss_a = mse(d_a(real_a), 1.0) + mse(d_a(fake_a), 0.0)
        loss_b = mse(d_b(real_b), 1.0) + mse(d_b(fake_b), 0.0)
        d_loss = 0.5 * (loss_a + loss_b)
        d_loss.backward()
        d_opt.step()
        g_loss = g_loss.detach()
        return {"loss": g_loss, "g_loss": g_loss, "d_loss": d_loss.detach()}

    return step


class CycleGANJob(LoopJob):
    """The two generators, the two discriminators and their optimizers."""

    def __init__(self, args, device):
        super().__init__(device)
        g = Generator(generator=torch.Generator().manual_seed(0))
        d = Discriminator(generator=torch.Generator().manual_seed(0))
        self.models = {"g_ab": g, "g_ba": copy.deepcopy(g),
                       "d_a": d, "d_b": copy.deepcopy(d)}
        for model in self.models.values():
            model.to(device)
        g_ab, g_ba, d_a, d_b = self.models.values()
        self.g_opt = torch.optim.Adam([*g_ab.parameters(), *g_ba.parameters()],
                                      lr=args.lr, betas=(0.5, 0.999))
        self.d_opt = torch.optim.Adam([*d_a.parameters(), *d_b.parameters()],
                                      lr=args.lr, betas=(0.5, 0.999))
        self._step = build_step((g_ab, g_ba, d_a, d_b), self.g_opt, self.d_opt)

    def train_step(self, real_a, real_b):
        metrics = self._step(real_a, real_b)
        self.step += 1
        return metrics

    def state(self) -> dict:
        return {"params": {name: m.state_dict() for name, m in self.models.items()},
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
                "step": self.step}

    def restore(self, state: dict) -> None:
        for name, model in self.models.items():
            model.load_state_dict(state["params"][name])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
        self.step = int(state["step"])


def build_job(argv=None):
    """(job, data loader, args) from the trace's CLI, built but not run."""
    p = common_parser("CycleGAN monet2photo", steps_args=("--n_steps",))
    p.add_argument("--dataset_path", default=None)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--img_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--decay_epoch", type=int, default=0)
    args = parse_args(p, argv)
    job = CycleGANJob(args, resolve_device(args.device))
    loader = data.monet2photo(args.batch_size, args.img_size, data_dir=args.dataset_path)
    return job, loader, args


def main(argv=None):
    job, loader, args = build_job(argv)
    run_loop(job, args, loader)
    return job


if __name__ == "__main__":
    main()
