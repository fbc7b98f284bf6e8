#!/usr/bin/env python3
"""Serving replica workload (trace: "Serving (batch size N)"), on PyTorch.

The port of `shockwave_tpu/workloads/serving/serve.py`, with its CLI: the
serving tier dispatches the trace's `serving_command` plus its
`--replica_of`/`--replica_index` markers, and `--num_steps` comes from
the dispatcher. `--device` (default `cuda`) chooses the card or, when
asked, the CPU.

One replica greedily generates `tokens_per_request` tokens for a batch
of `batch_size` synthetic requests per step, through the KV-cached
decoder (`models/decoder.py`), under the lease iterator: one step is one
served request batch, and the replica exits at lease expiry. Weights
and prompts come from a generator seeded by the replica index (a
replica is stateless: every dispatch re-initialises them, and save and
load are no-ops).

On the card the request batch (zero the caches, prefill the prompt
token by token, decode `tokens_per_request` tokens) is captured once as
a CUDA graph and replayed: the reference compiles the same batch with
`jax.jit`. A capture that fails raises; the replica does not fall back
to eager mode. On the CPU the batch runs eagerly (`eager_request_batch`,
which the tests and `chip_smoke.py` also hold the graph against).

The measured request clock is the reference's: seeded Poisson arrivals
from the trace's load curve (`serving/measured.ArrivalClock`, split
round-robin across `max_replicas`) feed a virtual queue whose service
times are the measured decode-step walls. The walls are taken as the
reference takes them: the device is synced every
THROUGHPUT_LOG_INTERVAL batches and at exit, and each synced window is
spread evenly over its steps. Latency-sketch deltas ship on the lease
renewals; unsent ones flush to the iterator log at exit and ride Done.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), *[".."] * 3))

import torch  # noqa: E402

from shockwave_tpu_torch.models.decoder import DecoderLM, decode_tokens  # noqa: E402
from shockwave_tpu_torch.models.train_common import (  # noqa: E402
    common_parser, parse_args, resolve_device, sync)
from shockwave_tpu_torch.serving.load import DiurnalLoad, Spike, seeded_spikes  # noqa: E402
from shockwave_tpu_torch.serving.measured import (  # noqa: E402
    ArrivalClock, ReplicaMeter, derive_arrival_seed, encode_report)

THROUGHPUT_LOG_INTERVAL = 50
#: Cap on the synthetic arrival stream (arrivals are generated lazily,
#: so this only bounds a replica that outlives every realistic lease).
ARRIVAL_HORIZON_S = 7 * 86400.0


def build_parser():
    p = common_parser("Autoregressive serving replica")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--tokens_per_request", type=int, default=64)
    # Load-curve parameters: carried by the trace command so one line
    # parameterizes both the simulator's analytic model and this
    # process; the replica itself serves as fast as the card allows.
    p.add_argument("--base_rps", type=float, default=0.0)
    p.add_argument("--peak_rps", type=float, default=0.0)
    p.add_argument("--period_s", type=float, default=0.0)
    p.add_argument("--phase_s", type=float, default=0.0)
    p.add_argument("--decode_tokens_per_s", type=float, default=0.0)
    p.add_argument("--max_replicas", type=int, default=8)
    p.add_argument("--spike_at", action="append", default=[])
    p.add_argument("--spike_seed", type=int, default=None)
    p.add_argument("--num_spikes", type=int, default=0)
    p.add_argument("--spike_mult", type=float, default=10.0)
    p.add_argument("--spike_duration_s", type=float, default=1800.0)
    p.add_argument("--replica_of", type=int, default=None)
    p.add_argument("--replica_index", type=int, default=0)
    # Measured request clock: seed override for the synthetic arrival
    # stream (default derives from spike_seed + replica_index); the tier
    # appends the service lifetime and the service-relative spawn offset.
    p.add_argument("--arrival_seed", type=int, default=None)
    p.add_argument("--service_lifetime_s", type=float, default=None)
    p.add_argument("--arrival_phase_s", type=float, default=0.0)
    # Decode model shape (defaults sized for a single card).
    p.add_argument("--model_dim", type=int, default=128)
    p.add_argument("--model_layers", type=int, default=2)
    p.add_argument("--model_heads", type=int, default=4)
    p.add_argument("--prompt_len", type=int, default=8)
    return p


def build_model_and_prompt(args, device):
    """The replica's decoder and its prompt batch, drawn from a generator
    seeded by the replica index (weights first, then the prompt)."""
    gen = torch.Generator().manual_seed(args.replica_index or 0)
    model = DecoderLM(dim=args.model_dim, num_layers=args.model_layers,
                      num_heads=args.model_heads, mlp_dim=2 * args.model_dim,
                      max_len=args.prompt_len + args.tokens_per_request + 1,
                      generator=gen)
    prompt = torch.randint(0, model.vocab_size, (args.batch_size, args.prompt_len),
                           generator=gen)
    return model.to(device).eval(), prompt.to(device)


@torch.no_grad()
def eager_request_batch(model, prompt, tokens_per_request):
    """One request batch, op by op: (B, tokens_per_request) generated ids."""
    return decode_tokens(model, prompt, model.init_cache(prompt.shape[0]),
                         tokens_per_request)


class GraphedRequestBatch:
    """One request batch as a CUDA graph, captured at construction on
    static buffers (the prompt, the caches, the generated ids) and
    replayed per call. The caches are zeroed inside the graph."""

    def __init__(self, model, prompt, tokens_per_request):
        self.prompt = prompt.clone()
        self.caches = model.init_cache(prompt.shape[0])
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad():
            # Warm up on a side stream (cuBLAS workspaces, allocator
            # pools), as graph capture requires.
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                decode_tokens(model, self.prompt, self.caches, tokens_per_request)
            torch.cuda.current_stream().wait_stream(side)
            try:
                with torch.cuda.graph(self.graph):
                    self.tokens = decode_tokens(model, self.prompt, self.caches,
                                                tokens_per_request)
            except RuntimeError as e:
                raise RuntimeError("CUDA graph capture of the request batch failed; "
                                   "the replica does not run eagerly on the card") from e

    def __call__(self, prompt):
        if prompt is not self.prompt:
            self.prompt.copy_(prompt)
        self.graph.replay()
        # A fresh tensor per batch: the lease iterator bounds run-ahead by
        # the identity of its sync refs.
        return self.tokens.clone()


def build_meter(args):
    """The measured request clock over the trace's load curve."""
    spikes = tuple(Spike(*(float(x) for x in entry.split(":")))
                   for entry in args.spike_at)
    lifetime_s = (float(args.service_lifetime_s)
                  if args.service_lifetime_s else ARRIVAL_HORIZON_S)
    if args.spike_seed is not None and args.num_spikes > 0:
        # Same draw the tier/simulator make (over the service LIFETIME,
        # not the horizon): the measured stream and the analytic model
        # must place the seeded spikes identically.
        spikes = spikes + seeded_spikes(
            int(args.spike_seed), lifetime_s, int(args.num_spikes),
            float(args.spike_mult), float(args.spike_duration_s))
    load = DiurnalLoad(base_rps=args.base_rps,
                       peak_rps=max(args.peak_rps, args.base_rps),
                       period_s=args.period_s, phase_s=args.phase_s,
                       spikes=spikes)
    arrival_seed = (args.arrival_seed if args.arrival_seed is not None
                    else derive_arrival_seed(args.spike_seed, args.replica_index))
    horizon_s = max(min(lifetime_s, ARRIVAL_HORIZON_S)
                    - float(args.arrival_phase_s), 0.0)
    return ReplicaMeter(
        ArrivalClock(load, arrival_seed, horizon_s,
                     replica_index=args.replica_index,
                     num_replicas=max(args.max_replicas, 1),
                     phase_s=float(args.arrival_phase_s)),
        batch_size=args.batch_size,
        tokens_per_request=args.tokens_per_request)


def main(argv=None):
    """Serve until the lease (or `--num_steps`) ends; returns the number
    of request batches served."""
    args = parse_args(build_parser(), argv)
    device = resolve_device(args.device)
    model, prompt = build_model_and_prompt(args, device)
    # The request batch: one CUDA graph on the card, eager on the CPU.
    if device.type == "cuda":
        serve_request_batch = GraphedRequestBatch(model, prompt, args.tokens_per_request)
    else:
        def serve_request_batch(batch):
            return eager_request_batch(model, batch, args.tokens_per_request)
    print(f"[REPLICA]\t{device.type}\t"
          f"{'cuda_graph' if device.type == 'cuda' else 'eager'}", flush=True)

    # Synthetic request stream: a small ring of the same prompt batch.
    # The LEASE bounds how long we serve, not the loader length: the loop
    # below re-enters the iterator at each synthetic "epoch" boundary.
    request_ring = [prompt] * 1024
    if args.enable_lease_iterator:
        # Imported here so that the lease-free path never loads grpc.
        from shockwave_tpu_torch.runtime.iterator import LeaseIterator
        iterator = LeaseIterator(
            data_loader=request_ring, checkpoint_dir=args.checkpoint_dir,
            # Replicas are stateless (weights re-init from the replica
            # seed); there is no state to checkpoint.
            load_checkpoint_func=lambda path: None,
            save_checkpoint_func=lambda path, state: None,
            synthetic_data=True)
    else:
        iterator = None
    meter = build_meter(args)

    served = 0
    window_start = time.time()
    window_steps = 0
    budget = args.num_steps
    report_seq = 0
    dispatch_round = int(os.environ.get("SWTPU_ROUND_ID", "0") or 0)

    def meter_window() -> None:
        """Account the just-synced window: spread its synced wall evenly
        over its steps, then queue the sketch delta for the next lease
        renewal, stamped (round, seq) for the tier's dedupe."""
        nonlocal window_start, window_steps, report_seq
        now = time.time()
        if window_steps > 0:
            per_step = max(now - window_start, 0.0) / window_steps
            for _ in range(window_steps):
                meter.step(per_step)
        window_start, window_steps = now, 0
        delta = meter.take_delta()
        if delta is not None and iterator is not None:
            report_seq += 1
            delta["round"] = dispatch_round
            delta["seq"] = report_seq
            iterator.queue_measurement(encode_report(delta))

    def serve_one(batch):
        nonlocal served, window_steps
        last = serve_request_batch(batch)
        if iterator is not None:
            iterator.set_sync_ref(last)
        served += 1
        window_steps += 1
        if window_steps >= THROUGHPUT_LOG_INTERVAL:
            sync(device)
            print(f"[THROUGHPUT_ESTIMATION]\t{time.time()}\t{served}", flush=True)
            meter_window()

    try:
        if iterator is not None:
            while not iterator.done and (budget is None or served < budget):
                for batch in iterator:
                    serve_one(batch)
                    if budget is not None and served >= budget:
                        iterator.complete()
                        break
        else:
            for _ in range(budget or 100):
                serve_one(prompt)
    finally:
        sync(device)
        meter_window()                   # final partial-window delta
        if iterator is not None:
            # Unsent deltas and the final [PROGRESS] lines go to the
            # iterator log, which the dispatcher reads at exit.
            iterator.close()
    print(f"SERVED {served} request batches "
          f"(x{args.batch_size} requests, {args.tokens_per_request} "
          f"tokens each)", flush=True)
    return served


if __name__ == "__main__":
    main()
