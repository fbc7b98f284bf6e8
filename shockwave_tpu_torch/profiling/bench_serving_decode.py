#!/usr/bin/env python3
"""Serving decode-throughput microbenchmark: tokens/s per card.

The port of the JAX package's `scripts/microbenchmarks/bench_serving_decode.py`,
with its CLI, its defaults and its JSON keys. It times the request batch
the serving replica runs (`workloads/serving/serve.py`: greedy decode
through `models/decoder.py`'s KV cache, the prompt prefilled token by
token), built by the replica's own code: `serve.build_model_and_prompt`
(weights and prompt seeded by replica index 0) and, on the card,
`serve.GraphedRequestBatch`, the request batch captured once as a CUDA
graph and replayed, as the replica serves it (the reference times its
`jax.jit` of the same batch). On the CPU, when asked, the batch runs
eagerly (`serve.eager_request_batch`).

    python -m shockwave_tpu_torch.profiling.bench_serving_decode [--smoke]

Prints ONE JSON line: `tokens_per_s` is generated tokens (steps x batch x
tokens_per_request) over the host clock of `--steps` request batches,
synced at the end, after `--warmup` batches. `backend` is "gpu" on the
card, as JAX names the platform, and `device_kind` the card's name.
`--smoke` exits 1 when tokens/s falls under `--min_tokens_per_s`. Runs on
the card unless `--device cpu` is given; with no card it raises.
"""
import argparse
import json
import sys
import time

import torch

from ..models.train_common import resolve_device, sync
from ..workloads.serving import serve


def build_decode(args, device):
    """(serve_request_batch, model, prompt): the replica's decoder and
    prompt batch at the bench's widths, and its request batch (the CUDA
    graph on the card, eager on the CPU), a function of the prompt that
    returns the (batch, tokens_per_request) generated ids."""
    replica = argparse.Namespace(
        model_dim=args.model_dim, model_layers=args.model_layers,
        model_heads=args.model_heads, prompt_len=args.prompt_len,
        tokens_per_request=args.tokens_per_request, batch_size=args.batch_size,
        replica_index=0)
    model, prompt = serve.build_model_and_prompt(replica, device)
    if device.type == "cuda":
        return (serve.GraphedRequestBatch(model, prompt, args.tokens_per_request),
                model, prompt)

    def eager(batch):
        return serve.eager_request_batch(model, batch, args.tokens_per_request)
    return eager, model, prompt


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--tokens_per_request", type=int, default=32)
    p.add_argument("--prompt_len", type=int, default=8)
    p.add_argument("--model_dim", type=int, default=128)
    p.add_argument("--model_layers", type=int, default=2)
    p.add_argument("--model_heads", type=int, default=4)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--steps", type=int, default=8, help="timed request batches")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--min_tokens_per_s", type=float, default=200.0,
                   help="--smoke: fail below this decode throughput")
    p.add_argument("--output", default=None, help="also write the JSON")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the CUDA card)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # raises on "cuda" without a card
    serve_request_batch, _, prompt = build_decode(args, device)
    for _ in range(max(args.warmup, 1)):  # the graph was captured at build
        serve_request_batch(prompt)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        serve_request_batch(prompt)
    sync(device)
    wall = time.perf_counter() - t0

    tokens = args.steps * args.batch_size * args.tokens_per_request
    tokens_per_s = tokens / wall
    row = {
        "bench": "serving_decode",
        "backend": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else device.type),
        "batch_size": args.batch_size,
        "tokens_per_request": args.tokens_per_request,
        "model_dim": args.model_dim,
        "model_layers": args.model_layers,
        "steps": args.steps,
        "wall_s": round(wall, 4),
        "tokens_per_s": round(tokens_per_s, 1),
        # One replica owns one card (CUDA_VISIBLE_DEVICES pinning in the
        # dispatcher), so per-card == per-replica here.
        "tokens_per_s_per_chip": round(tokens_per_s, 1),
        "requests_per_s": round(tokens_per_s / args.tokens_per_request, 2),
    }
    print(json.dumps(row), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(row, f)
    if args.smoke and row["tokens_per_s"] < args.min_tokens_per_s:
        print(f"SMOKE FAIL: {row['tokens_per_s']} tokens/s < "
              f"{args.min_tokens_per_s}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
