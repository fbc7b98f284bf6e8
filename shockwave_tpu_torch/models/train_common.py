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
gradient). Its metrics (`loss`, `grad_norm_sq`, and in `gns` mode
`grad_norm_sq_small`) stay on the device; the host waits for the device
only at each throughput interval, where a monitor needs its norms, and at
exit.

The dynamic-adaptation monitors (`SWTPU_MODE` accordion or gns) are the
reference's `AccordionMonitor` and `GNSMonitor` with the same arithmetic.
They hold the per-step norms as device scalars and read them, in step
order, only where their rule needs the values (Accordion at an epoch's
end, GNS once its window is full and its two batch sizes differ), so the
host sums are the same float64 sums of the same f32 values.

A job of scale factor N runs as a data-parallel gang of N processes
(`--coordinator`, `--num_processes`, `--process_id`; `parallel/mesh.py`),
and the gang computes what the reference's one jit over the dp-sharded
global batch computes: each rank trains on its slice of the global
batch; its loss is scaled by the loss's element count (`aux["count"]`)
before the backward pass, and the gradients are summed over the gang in
flat buckets and divided by the gang's total count, so a token-masked
mean gives the global batch's gradient even when the ranks' token counts
differ. The gang's loss and gradient norm are the global batch's; GNS's
small batch is rank 0's slice. Rank 0 alone writes the checkpoint, after
the lease iterator's exit barrier; every rank loads it.
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
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh

THROUGHPUT_LOG_INTERVAL = 100
#: Gradient bytes per all-reduce in a gang.
BUCKET_BYTES = 25 * 2**20


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
    """Parse workload CLI args and, for gang members, join the gang
    before the caller builds its model (as the reference joins its
    `jax.distributed` cluster here)."""
    args = parser.parse_args(argv)
    # The dispatcher kills with SIGTERM-then-SIGKILL; converting SIGTERM
    # to SystemExit lets the mains' finally blocks (checkpoint save) run.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args.num_processes is not None and args.num_processes > 1:
        mesh.maybe_initialize_distributed(args.coordinator, args.num_processes,
                                          args.process_id, resolve_device(args.device))
    return args


def resolve_device(name: str) -> torch.device:
    """The device a run asked for; `cuda` without a card raises. On the
    card TF32 is turned off for cuBLAS and cuDNN: the JAX package's f32
    products (tied logits, the LSTM, f32 dense heads) are full f32, and
    PyTorch's `cudnn.allow_tf32` defaults to True."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda was asked for but no CUDA device "
                               "is available (pass --device cpu to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(array, device: torch.device) -> torch.Tensor:
    """One host batch array on `device`: integers (tokens, labels) as
    int64, floats (images, multi-hot rows) as float32."""
    tensor = torch.as_tensor(array)
    tensor = tensor.float() if tensor.is_floating_point() else tensor.long()
    return tensor.to(device)


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


def _host_floats(values: Sequence) -> list:
    """Python floats of per-step norms, in order: device scalars are read
    with one transfer, numbers are taken as they are."""
    if values and isinstance(values[0], torch.Tensor):
        return torch.stack(list(values)).tolist()
    return [float(v) for v in values]


class AccordionMonitor:
    """Critical-regime detector (Agarwal et al.): compares successive
    epochs' accumulated gradient norms; a large relative swing means the
    gradient is changing fast -> critical regime -> train at the small
    batch size (the reference's `AccordionMonitor`, same arithmetic).

    The process only knows the batch size it was launched with; the
    scheduler owns the original/max sizes and applies the actual rescale
    on the next dispatch. `observe_step` keeps the norm as it comes (a
    device scalar stays on the device); `end_epoch` reads the epoch's
    norms and sums them in step order, as the reference's per-step
    `float()` accumulation does."""

    def __init__(self, iterator, launch_bs: int, max_bs: int,
                 threshold: float = 0.5):
        self._iterator = iterator
        self._launch_bs = launch_bs
        self._max_bs = max_bs
        self._threshold = threshold
        self._norms: list = []
        self.epoch_norms: list = []  # each finished epoch's mean norm

    def observe_step(self, grad_norm):
        self._norms.append(grad_norm)

    def end_epoch(self) -> bool:
        """Returns True if a resize request was issued (job must exit)."""
        if not self._norms:
            return False
        accum = 0.0
        for norm in _host_floats(self._norms):
            accum += norm
        epoch_norm = accum / len(self._norms)
        self._norms = []
        prev = self.epoch_norms[-1] if self.epoch_norms else None
        self.epoch_norms.append(epoch_norm)
        if prev is None:
            return False
        ratio = abs(prev - epoch_norm) / max(prev, 1e-12)
        in_critical = ratio > self._threshold
        if in_critical and self._launch_bs >= self._max_bs:
            self._iterator.update_resource_requirement(big_bs=False, small_bs=True)
            return True
        if not in_critical and self._launch_bs < self._max_bs:
            self._iterator.update_resource_requirement(big_bs=True, small_bs=False)
            return True
        return False


class GNSMonitor:
    """Gradient-noise-scale estimator (McCandlish et al.): compares the
    gradient norm at a small (per-device) batch vs the full global batch
    to estimate the noise scale B_noise = S / |G|^2; when the running
    noise scale clears the current batch size, request a doubling (the
    reference's `GNSMonitor`, same arithmetic). The window holds the
    norms as they come and is read only when the estimate is made."""

    def __init__(self, iterator, small_bs: int, big_bs: int, max_bs: int,
                 window: int = 50):
        self._iterator = iterator
        self._b_small = small_bs
        self._b_big = big_bs
        self._max_bs = max_bs
        self._window = window
        self._small_sq: list = []
        self._big_sq: list = []

    def observe_step(self, small_norm_sq, big_norm_sq):
        self._small_sq.append(small_norm_sq)
        self._big_sq.append(big_norm_sq)
        if len(self._small_sq) > self._window:
            self._small_sq.pop(0)
            self._big_sq.pop(0)

    def maybe_request_double(self, current_bs: int) -> bool:
        if len(self._small_sq) < self._window or self._b_big == self._b_small:
            return False
        small = float(np.mean(_host_floats(self._small_sq)))
        big = float(np.mean(_host_floats(self._big_sq)))
        # Unbiased |G|^2 and trace(Sigma) estimates from two batch sizes.
        g2 = (self._b_big * big - self._b_small * small) / (self._b_big - self._b_small)
        s = (small - big) / (1.0 / self._b_small - 1.0 / self._b_big)
        if g2 <= 0:
            return False
        noise_scale = s / g2
        if noise_scale > current_bs and current_bs < self._max_bs:
            self._iterator.update_resource_requirement(big_bs=True, small_bs=False)
            return True
        return False


class Trainer:
    """Drives the standard training loop for one workload.

    `loss_fn(model, *batch)` returns `(loss, aux)`. The model is moved to
    `device`; batches (numpy) are uploaded once per distinct host batch.
    `mode` (default `SWTPU_MODE`, else static) selects the adaptation
    monitor; `initial_bs` is the batch size the job was launched with and
    `max_bs` its family's largest. `n_dev` is the size of the job's
    data-parallel group, whose per-device slice of the batch is GNS's
    small batch: the gang's size in a gang (the default), 1 on one card;
    a single process may give more, to take GNS's small batch as the
    first of `n_dev` slices without a gang.

    In a gang, `run` feeds each rank its slice of the global batch, and
    `loss_fn`'s aux must hold `count`, the number of elements its loss
    averages (see the module docstring). `train_step` then takes the
    rank's slice and returns the global batch's loss and gradient norm.
    Its small-batch norm needs no second backward: rank 0's gradient
    before the all-reduce is its count times the gradient over its
    slice, and the all-reduce carries the norm to every rank. A model
    whose ranks are coupled in the forward pass (a gang's BatchNorm,
    whose statistics are the global batch's) is the exception: rank 0
    runs its slice again with its own statistics, as the reference's
    small-batch loss does.

    In `gns` mode with `n_dev == 1` the small batch is the whole batch, so
    `train_step` reports `grad_norm_sq` as `grad_norm_sq_small` instead of
    running a second backward pass over the same rows (an intended
    divergence from the reference, which runs it): `GNSMonitor` returns
    before it reads a norm when its two batch sizes are equal, so no
    request can change.
    """

    def __init__(self, args, loss_fn: Callable, model: torch.nn.Module,
                 data_loader, device: torch.device, learning_rate: float = 1e-2,
                 mode: Optional[str] = None, initial_bs: Optional[int] = None,
                 max_bs: Optional[int] = None, n_dev: Optional[int] = None):
        self.args = args
        self.mode = mode or os.environ.get("SWTPU_MODE", "static")
        self.initial_bs = initial_bs
        self.max_bs = max_bs or initial_bs
        self.gang = mesh.process_count() > 1
        if self.gang and n_dev not in (None, mesh.process_count()):
            raise ValueError(f"n_dev {n_dev} in a gang of {mesh.process_count()}")
        self.n_dev = n_dev or mesh.process_count()
        self.rank = mesh.process_index()
        self.monitor = None  # the adaptation monitor of the last run()
        self.device = device
        self.model = model.to(device)
        self.optimizer = torch.optim.SGD(self.model.parameters(),
                                         lr=learning_rate, momentum=0.9)
        self.step = 0
        self._loss_fn = loss_fn
        # Modules whose forward pass couples the ranks (a gang's BatchNorm).
        self._coupled = [m for m in self.model.modules() if hasattr(m, "local_statistics")]
        self.data_loader = data_loader
        # Device-resident metrics of the first and the last step of run(),
        # and (wall time, cumulative step) at every throughput line.
        self.first_metrics: Optional[dict] = None
        self.last_metrics: Optional[dict] = None
        self.throughput_marks: list = []

    def train_step(self, *batch) -> dict:
        """One SGD step on device tensors (this rank's slice in a gang);
        metrics stay on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self._loss_fn(self.model, *batch)
        if self.gang:
            return self._gang_step(batch, loss, aux)
        loss.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm_sq = torch.nn.utils.get_total_norm(grads) ** 2
        metrics = {"loss": loss.detach(), "grad_norm_sq": grad_norm_sq}
        if self.mode == "gns":
            metrics["grad_norm_sq_small"] = self._small_grad_norm_sq(batch, grad_norm_sq)
        self.optimizer.step()
        self.step += 1
        return metrics

    def _gang_step(self, batch, loss, aux) -> dict:
        """`train_step`'s gang branch (see the class docstring)."""
        count = aux["count"]  # a device tensor or a number: no host round trip
        count = (count.float() if isinstance(count, torch.Tensor)
                 else torch.full((), float(count), device=self.device))
        (loss * count).backward()
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:  # one bucket layout on every rank
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        small = torch.zeros((), device=self.device)
        if self.mode == "gns" and self.rank == 0:
            if self._coupled:  # rerun the slice with its own statistics
                for m in self._coupled:
                    m.local_statistics = True
                try:
                    small = self._grad_norm_sq_of(batch)
                finally:
                    for m in self._coupled:
                        m.local_statistics = False
            else:  # rank 0's gradient is count x its slice's gradient
                small = (torch.nn.utils.get_total_norm(grads) ** 2
                         / count.clamp_min(1.0) ** 2)
        extras = torch.stack([loss.detach().float() * count, count, small.float()])
        self.allreduce_gradients(grads, extras)
        metrics = {"loss": extras[0] / extras[1].clamp_min(1.0),
                   "grad_norm_sq": torch.nn.utils.get_total_norm(grads) ** 2}
        if self.mode == "gns":
            metrics["grad_norm_sq_small"] = extras[2]
        self.optimizer.step()
        self.step += 1
        return metrics

    def allreduce_gradients(self, grads, extras) -> None:
        """Sum `grads` and the 1-d f32 `extras` (whose element 1 is the
        rank's loss count) over the gang, in flat buckets of at most
        BUCKET_BYTES, then divide the gradients by the gang's count."""
        buckets, size = [], 0
        for g in grads:
            nbytes = g.numel() * g.element_size()
            if not buckets or size + nbytes > BUCKET_BYTES or g.dtype != buckets[-1][0].dtype:
                buckets.append([])
                size = 0
            buckets[-1].append(g)
            size += nbytes
        flats = [torch.cat([g.reshape(-1) for g in bucket]) for bucket in buckets]
        works = [mesh.all_reduce_sum(f, async_op=True) for f in flats + [extras]]
        for work in works:
            work.wait()
        total = extras[1].clamp_min(1.0)
        for bucket, flat in zip(buckets, flats):
            flat.div_(total.to(flat.dtype))
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def _small_grad_norm_sq(self, batch, grad_norm_sq):
        """Squared global gradient norm over the first max(1, B // n_dev)
        rows of each batch tensor, at the step's parameters. Running
        statistics (BatchNorm's buffers) keep the full batch's update, as
        the reference keeps the full batch's `batch_stats`."""
        small = tuple(b[: max(1, b.shape[0] // self.n_dev)] for b in batch)
        if all(s.shape[0] == b.shape[0] for s, b in zip(small, batch)):
            return grad_norm_sq  # the same rows: see the class docstring
        return self._grad_norm_sq_of(small)

    def _grad_norm_sq_of(self, small):
        """Squared gradient norm of the loss over `small` alone; the
        buffers are left as they were."""
        saved = [b.clone() for b in self.model.buffers()]
        params = [p for p in self.model.parameters() if p.requires_grad]
        loss, _ = self._loss_fn(self.model, *small)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for buf, value in zip(self.model.buffers(), saved):
                buf.copy_(value)
        return torch.nn.utils.get_total_norm(
            [g for g in grads if g is not None]) ** 2

    def state(self) -> dict:
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(), "step": self.step}

    def restore(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])

    def run(self) -> int:
        args = self.args
        use_lease = args.enable_lease_iterator
        path = checkpoint_path(args.checkpoint_dir)
        if use_lease:
            # Imported here so that the lease-free path never loads grpc.
            from ..runtime.iterator import LeaseIterator
            # A gang agrees its lease decisions and meets at a barrier
            # before rank 0 saves (the reference's multihost_utils hooks).
            gang_hooks = (dict(distributed_barrier=mesh.barrier,
                               gang_allreduce=mesh.gang_allreduce)
                          if self.gang else {})
            iterator = LeaseIterator(
                self.data_loader, args.checkpoint_dir,
                load_checkpoint_func=self._load,
                save_checkpoint_func=self._save,
                synthetic_data=args.synthetic_data, **gang_hooks)
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

        monitor = None
        if self.mode == "accordion" and self.initial_bs:
            monitor = AccordionMonitor(iterator, self.initial_bs, self.max_bs)
        elif self.mode == "gns" and self.initial_bs:
            monitor = GNSMonitor(iterator, max(1, self.initial_bs // self.n_dev),
                                 self.initial_bs, self.max_bs)
        self.monitor = monitor

        steps_done = 0
        window_steps = 0
        # Synthetic pipelines yield the same host batch object every step;
        # keep its device copy instead of uploading it each step (kept
        # strongly referenced, so its identity cannot be recycled).
        host_batch_ref, dev_batch = None, None
        try:
            while not iterator.done and (budget is None
                                         or start_step + steps_done < budget):
                epoch_resized = False
                for batch in iterator:
                    if batch is not host_batch_ref:
                        host_batch_ref = batch
                        # Every rank builds the same global batch and
                        # trains on its own rows of it.
                        rows = (mesh.local_batch_slice(len(batch[0]), self.rank, self.n_dev)
                                if self.gang else slice(None))
                        dev_batch = tuple(upload(b[rows], self.device) for b in batch)
                    metrics = self.train_step(*dev_batch)
                    if use_lease:
                        iterator.set_sync_ref(metrics["loss"])
                    if self.first_metrics is None:
                        self.first_metrics = metrics
                    self.last_metrics = metrics
                    steps_done += 1
                    window_steps += 1
                    if isinstance(monitor, AccordionMonitor):
                        monitor.observe_step(torch.sqrt(metrics["grad_norm_sq"]))
                    elif monitor is not None:
                        monitor.observe_step(metrics["grad_norm_sq_small"],
                                             metrics["grad_norm_sq"])
                        if monitor.maybe_request_double(self.initial_bs):
                            epoch_resized = True
                            break
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
                if (isinstance(monitor, AccordionMonitor) and not iterator.done
                        and not epoch_resized):
                    epoch_resized = monitor.end_epoch()
                if epoch_resized:
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
        # The ranks hold one state; two writers racing os.replace on one
        # path would lose a file. A lease's exit barrier has already
        # brought the gang to the same step.
        if self.rank == 0:
            save_checkpoint(path, self.state())

    def _load(self, path):
        return load_checkpoint(path, self.device)


class LoopJob:
    """A job whose main drives its own step (A3C and CycleGAN, which have
    no single loss and SGD step for `Trainer`): a subclass sets `device`,
    counts `step`, and gives `train_step(*batch) -> metrics` (metrics on
    the device, `loss` among them), `state()` and `restore(state)`.
    `run_loop` records the same run attributes `Trainer.run` does."""

    def __init__(self, device: torch.device):
        self.device = device
        self.step = 0
        self.first_metrics: Optional[dict] = None
        self.last_metrics: Optional[dict] = None
        self.throughput_marks: list = []


def run_loop(job: LoopJob, args, data_loader) -> int:
    """The loop of the mains that drive the lease iterator themselves
    (the reference's A3C and CycleGAN mains): one iterator step is one
    `job.train_step` on the batch moved to the job's device, up to the
    `args.num_steps` budget, with the `[THROUGHPUT_ESTIMATION]` lines, a
    checkpoint save when the loop ends and the `TRAINED` line, as in
    `Trainer.run` (whose checkpoint-ahead reconcile it keeps too).
    Returns the steps run."""
    use_lease = args.enable_lease_iterator
    path = checkpoint_path(args.checkpoint_dir)

    def load(p):
        return load_checkpoint(p, job.device)

    def save(p):
        save_checkpoint(p, job.state())

    if use_lease:
        from ..runtime.iterator import LeaseIterator
        iterator = LeaseIterator(data_loader, args.checkpoint_dir,
                                 load_checkpoint_func=load, save_checkpoint_func=save,
                                 synthetic_data=args.synthetic_data)
        restored = iterator.load_checkpoint(path)
    else:
        iterator = _PlainIterator(data_loader)
        restored = load(path)
    if restored is not None:
        job.restore(restored)
    start_step = job.step
    budget = args.num_steps
    if use_lease and budget is not None and start_step >= budget:
        iterator.report_checkpoint_ahead()

    steps_done = window_steps = 0
    host_batch_ref, dev_batch = None, None
    try:
        while not iterator.done and (budget is None or start_step + steps_done < budget):
            for batch in iterator:
                if batch is not host_batch_ref:
                    host_batch_ref = batch
                    dev_batch = tuple(upload(b, job.device) for b in batch)
                metrics = job.train_step(*dev_batch)
                if use_lease:
                    iterator.set_sync_ref(metrics["loss"])
                if job.first_metrics is None:
                    job.first_metrics = metrics
                job.last_metrics = metrics
                steps_done += 1
                window_steps += 1
                if window_steps >= args.throughput_estimation_interval:
                    sync(job.device)
                    now = time.time()
                    print(f"[THROUGHPUT_ESTIMATION]\t{now}\t{start_step + steps_done}",
                          flush=True)
                    job.throughput_marks.append((now, start_step + steps_done))
                    window_steps = 0
                if budget is not None and start_step + steps_done >= budget:
                    iterator.complete()
                    break
            if not use_lease and (budget is None or start_step + steps_done >= budget):
                break
    finally:
        sync(job.device)
        if use_lease:
            try:
                iterator.save_checkpoint(path)
            finally:
                iterator.close()
        else:
            save(path)
    print(f"TRAINED {steps_done} steps (cumulative {start_step + steps_done})", flush=True)
    return steps_done


class _PlainIterator:
    """Lease-free iterator with the lease iterator's surface."""

    def __init__(self, loader):
        self._loader = loader
        self.done = False

    def __iter__(self):
        return iter(self._loader)

    def complete(self):
        self.done = True

    def update_resource_requirement(self, big_bs, small_bs):
        self.done = True
