"""Shared training scaffold for the port's workload entry points.

The port of `shockwave_tpu/models/train_common.py`: the same CLI,
SIGTERM -> SystemExit, the `Trainer` loop with its
`[THROUGHPUT_ESTIMATION]` and `TRAINED` lines, CRC-footered checkpoints
with the `.prev` fallback and resume from `step`, and the lease branch
(`--enable_lease_iterator`, which the dispatcher appends to every job):
the job trains under `runtime.iterator.LeaseIterator`, checkpoints when
the lease expires and reconciles a checkpoint that is already at budget.

PyTorch runs eagerly, so there is no jit'd step: one `train_step` runs
forward, backward and `torch.optim.SGD(lr, momentum=0.9)`, which matches
`optax.sgd(lr, momentum=0.9)` (both start the momentum trace at the first
gradient). Its metrics (`loss`, `grad_norm_sq`) stay on the device; the
host waits for the device only at each throughput interval and at exit.

Not ported yet, each raising NotImplementedError that names its
ROADMAP.md item: gangs (`--num_processes > 1`) and the Accordion/GNS
adaptation monitors (`SWTPU_MODE`).
"""
from __future__ import annotations

import argparse
import io
import logging
import os
import signal
import sys
import tempfile
import time
from typing import Callable, Optional

import torch

THROUGHPUT_LOG_INTERVAL = 100

_GANG_ITEM = "ROADMAP.md Queue 1, item 4 (gangs over torch.distributed)"
_MONITOR_ITEM = "ROADMAP.md Queue 1, item 4 (the Accordion/GNS monitors)"


def common_parser(description: str, steps_args=("--num_steps",)) -> argparse.ArgumentParser:
    """Arguments every dispatched workload receives."""
    p = argparse.ArgumentParser(description=description, allow_abbrev=False)
    for name in steps_args:
        p.add_argument(name, dest="num_steps", type=int, default=None)
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--checkpoint_dir",
                   default=os.path.join(tempfile.gettempdir(), "swtpu_ckpt"))
    p.add_argument("--enable_lease_iterator", "--enable_gavel_iterator",
                   dest="enable_lease_iterator", action="store_true")
    p.add_argument("--throughput_estimation_interval", type=int,
                   default=THROUGHPUT_LOG_INTERVAL)
    # Multi-chip gang rendezvous (appended by the scheduler for sf > 1).
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--cuda", action="store_true",
                   help="accepted for trace parity; --device chooses")
    p.add_argument("--synthetic_data", action="store_true", default=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train (default: the CUDA card)")
    return p


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """Parse workload CLI args; refuse what this slice does not port."""
    args = parser.parse_args(argv)
    # The dispatcher kills with SIGTERM-then-SIGKILL; converting SIGTERM
    # to SystemExit lets the mains' finally blocks (checkpoint save) run.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args.num_processes is not None and args.num_processes > 1:
        raise NotImplementedError(f"gangs are not ported yet: {_GANG_ITEM}")
    return args


def resolve_device(name: str) -> torch.device:
    """The device a run asked for; `cuda` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device "
                           "is available (pass --device cpu to run on the CPU)")
    return device


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def checkpoint_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "model.ckpt")


# Integrity footer appended to every checkpoint: crc32(payload) + magic.
_CKPT_MAGIC = b"SWCKPT1\n"


def save_checkpoint(path: str, state: dict) -> None:
    """Durable checkpoint write: `torch.save` bytes behind the CRC footer,
    fsync'd file and directory, previous checkpoint retained as
    `<path>.prev` so a torn save never costs the job all its progress."""
    from ..core.durable_io import write_durable
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.BytesIO()
    torch.save(state, buf)
    write_durable(path, buf.getvalue(), _CKPT_MAGIC)


def _read_verified_payload(path: str) -> Optional[bytes]:
    """Checkpoint bytes with the footer verified and stripped; None if
    missing or corrupt. Footer-less files pass through unverified
    (torch.load is their only check)."""
    from ..core.durable_io import FOOTER_CORRUPT, FOOTER_OK, verify_footer
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    status, payload = verify_footer(blob, _CKPT_MAGIC)
    if status == FOOTER_OK:
        return payload
    if status == FOOTER_CORRUPT:
        logging.getLogger(__name__).warning(
            "checkpoint %s fails CRC; ignoring it", path)
        return None
    return blob or None


def load_checkpoint(path: str, device: torch.device) -> Optional[dict]:
    """Load `path`, falling back to `<path>.prev` and then to a fresh
    start (None) on corruption instead of crashing the trainer."""
    log = logging.getLogger(__name__)
    for candidate in (path, path + ".prev"):
        if not os.path.exists(candidate):
            continue
        payload = _read_verified_payload(candidate)
        if payload is None:
            continue
        try:
            restored = torch.load(io.BytesIO(payload), map_location=device,
                                  weights_only=True)
        except Exception as e:  # noqa: BLE001 - any decode failure means
            # the file is unusable; the fallback chain continues.
            log.warning("checkpoint %s unreadable (%s: %s); trying "
                        "fallback", candidate, type(e).__name__, e)
            continue
        if candidate != path:
            log.warning("restored from previous checkpoint %s (current "
                        "was missing or corrupt)", candidate)
        return restored
    return None


class Trainer:
    """Drives the standard training loop for one workload.

    `loss_fn(model, *batch)` returns `(loss, aux)`. The model is moved to
    `device`; batches (numpy) are uploaded once per distinct host batch.
    """

    def __init__(self, args, loss_fn: Callable, model: torch.nn.Module,
                 data_loader, device: torch.device, learning_rate: float = 1e-2):
        self.args = args
        mode = os.environ.get("SWTPU_MODE", "static")
        if mode != "static":
            raise NotImplementedError(
                f"SWTPU_MODE={mode} is not ported yet: {_MONITOR_ITEM}")
        self.device = device
        self.model = model.to(device)
        self.optimizer = torch.optim.SGD(self.model.parameters(),
                                         lr=learning_rate, momentum=0.9)
        self.step = 0
        self._loss_fn = loss_fn
        self.data_loader = data_loader
        # Device-resident metrics of the first and the last step of run(),
        # and (wall time, cumulative step) at every throughput line.
        self.first_metrics: Optional[dict] = None
        self.last_metrics: Optional[dict] = None
        self.throughput_marks: list = []

    def train_step(self, *batch) -> dict:
        """One SGD step on device tensors; metrics stay on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self._loss_fn(self.model, *batch)
        loss.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm_sq = torch.nn.utils.get_total_norm(grads) ** 2
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm_sq": grad_norm_sq}

    def state(self) -> dict:
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(), "step": self.step}

    def restore(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])

    def _upload(self, batch):
        return tuple(torch.as_tensor(b, device=self.device).long() for b in batch)

    def run(self) -> int:
        args = self.args
        use_lease = args.enable_lease_iterator
        path = checkpoint_path(args.checkpoint_dir)
        if use_lease:
            # Imported here so that the lease-free path never loads grpc.
            from ..runtime.iterator import LeaseIterator
            iterator = LeaseIterator(
                self.data_loader, args.checkpoint_dir,
                load_checkpoint_func=self._load,
                save_checkpoint_func=self._save,
                synthetic_data=args.synthetic_data)
            restored = iterator.load_checkpoint(path)
        else:
            iterator = _PlainIterator(self.data_loader)
            restored = self._load(path)
        if restored is not None:
            self.restore(restored)
        start_step = self.step
        budget = args.num_steps
        if use_lease and budget is not None and start_step >= budget:
            # Checkpoint is ahead of the scheduler's accounting (previous
            # worker died post-checkpoint, pre-report): reconcile instead
            # of exiting (0, 0) — the micro-task-failure signal — which
            # would burn a failure attempt every round until the job is
            # dropped despite being fully trained.
            iterator.report_checkpoint_ahead()

        steps_done = 0
        window_steps = 0
        # Synthetic pipelines yield the same host batch object every step;
        # keep its device copy instead of uploading it each step (kept
        # strongly referenced, so its identity cannot be recycled).
        host_batch_ref, dev_batch = None, None
        try:
            while not iterator.done and (budget is None
                                         or start_step + steps_done < budget):
                for batch in iterator:
                    if batch is not host_batch_ref:
                        host_batch_ref = batch
                        dev_batch = self._upload(batch)
                    metrics = self.train_step(*dev_batch)
                    if use_lease:
                        iterator.set_sync_ref(metrics["loss"])
                    if self.first_metrics is None:
                        self.first_metrics = metrics
                    self.last_metrics = metrics
                    steps_done += 1
                    window_steps += 1
                    if window_steps >= args.throughput_estimation_interval:
                        sync(self.device)
                        now = time.time()
                        print(f"[THROUGHPUT_ESTIMATION]\t{now}\t"
                              f"{start_step + steps_done}", flush=True)
                        self.throughput_marks.append((now, start_step + steps_done))
                        window_steps = 0
                    if budget is not None and start_step + steps_done >= budget:
                        iterator.complete()
                        break
                if not use_lease and (budget is None
                                      or start_step + steps_done >= budget):
                    break
        finally:
            sync(self.device)
            if use_lease:
                try:
                    iterator.save_checkpoint(path)
                finally:
                    # The lease's final [PROGRESS] lines, which the
                    # dispatcher reads once this process has exited.
                    iterator.close()
            else:
                self._save(path)
        print(f"TRAINED {steps_done} steps (cumulative "
              f"{start_step + steps_done})", flush=True)
        return steps_done

    def _save(self, path):
        save_checkpoint(path, self.state())

    def _load(self, path):
        return load_checkpoint(path, self.device)


class _PlainIterator:
    """Lease-free iterator with the lease iterator's surface."""

    def __init__(self, loader):
        self._loader = loader
        self.done = False

    def __iter__(self):
        return iter(self._loader)

    def complete(self):
        self.done = True
