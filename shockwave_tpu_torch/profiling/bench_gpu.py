#!/usr/bin/env python3
"""Single-card GPU benchmark: the flagship's training rate and MFU, and
flash attention against the einsum path at long sequence length.

The port of the JAX package's `scripts/profiling/bench_tpu.py`, with its
keys. It measures, on the CUDA card:

  1. The flagship Seq2SeqTransformer (dim 512, 8 heads, 6 + 6 layers,
     vocab 9521, flash on) training under Adam 1e-3 on the unshifted
     cross-entropy of constant batches: steps/s by two-point marginal
     timing (`core/timing.py`), FLOPs per step, and MFU against the
     card's dense bf16 peak (`profiling/device.py`). At batch 128 x T 64,
     then batch 4 and 16 x T 2048, where the CUDA kernels K1-K3 run in
     the encoder's key-padded self-attention, the decoder's causal
     self-attention and the cross-attention, 18 launches each per step.
  2. K1 through the port's `flash_attention` against the plain einsum
     attention at (4, 2048, 8, 64), causal, per call.

FLOPs per step: there is no XLA cost analysis here. One step of the same
model with flash off is counted with `torch.utils.flop_counter` on the
meta device (shapes only, no memory); there the attention products are
einsums the counter sees, so the count is the same work whatever
implements it, and like XLA's it takes causal attention at the full T^2.
`6 * parameters * tokens` is printed beside it as a cross-check.

    python -m shockwave_tpu_torch.profiling.bench_gpu [--save_dir DIR]

`--widths` (a JSON object), `--attn_shape` and `--min_marginal_s` shrink
both parts for a small run on the CPU; by default they are the
flagship's published widths, (4, 2048, 8, 64) and 1 s timing windows.

Prints one JSON line and saves it through `core/artifacts.py` under
`reproduce/h100/` ('' disables). Runs on the card unless `--device cpu`
is given (then there is no peak and no MFU); with no card it raises.
"""
import argparse
import json
import math
import os
import sys

import torch
import torch.nn.functional as F

from ..core.timing import marginal_step_time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def card_peak(device: str):
    """(card name, dense bf16 FLOP/s) of the card, or ("cpu", None)."""
    if device != "cuda":
        return "cpu", None
    from .device import nvidia_smi, peaks
    return torch.cuda.get_device_name(0), peaks(nvidia_smi())[1][1]


def timed_op(fn, q, k, v, n1=8, n2=32, warmup=3, **timing):
    """Marginal per-call time for an attention op, chained through q so
    the closing scalar fetch waits for the whole window (two-point
    timing). Output feeds back as q — shapes match (b, t, h, d).
    `timing` goes to `marginal_step_time` (`min_marginal_s`)."""

    def step(q, _batch):
        out = fn(q, k, v)
        return out.to(q.dtype), out

    return marginal_step_time(step, q, None, n1=n1, n2=n2, warmup=warmup, **timing)


def unshifted_loss(model, src, tgt):
    """The reference bench's loss: cross-entropy of the logits against
    tgt itself (not shifted)."""
    logits = model(src, tgt)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1))


def count_flops(widths: dict, batch: int, seq: int) -> float:
    """FLOPs of one training step (forward + backward) of the model with
    flash off, counted by `FlopCounterMode` on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.transformer import Seq2SeqTransformer
    model = Seq2SeqTransformer(use_flash=False, max_len=seq, **widths).to("meta")
    src = torch.ones(batch, seq, dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        unshifted_loss(model, src, src).backward()
    return float(counter.get_total_flops())


def flagship(batch, seq, device="cuda", widths=None):
    """(model, step): the bench's flagship (flash on, seed 0) on `device`
    and one Adam step of it on constant (batch, seq) batches, which
    returns the step's loss on the device."""
    from ..models.transformer import Seq2SeqTransformer

    model = Seq2SeqTransformer(use_flash=True, max_len=seq,
                               generator=torch.Generator().manual_seed(0),
                               **(widths or {})).to(device)
    src = torch.ones(batch, seq, dtype=torch.long, device=device)
    tgt = torch.ones(batch, seq, dtype=torch.long, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = unshifted_loss(model, src, tgt)
        loss.backward()
        opt.step()
        return loss.detach()

    return model, step


def transformer_train_bench(batch=64, steps=30, warmup=5, seq=None,
                            prefix="transformer", device="cuda", widths=None, **timing):
    """Flagship Seq2SeqTransformer train step at a given sequence length.

    seq=None is the model's trace-parity max_len of 64; a long seq (e.g.
    2048) is the flash kernels' regime. `widths` overrides the model's
    widths (vocab_size, dim, num_heads, num_layers, mlp_dim) for a small
    run. Besides the reference's keys it returns the steps run (warm-up
    and timing windows), the first and last loss, and 6 * N * tokens."""
    widths = dict(widths or {})
    seq = seq or 64
    model, step = flagship(batch, seq, device, widths)
    losses = []

    def chained(state, _batch):
        losses.append(step())
        return state, losses[-1]

    dt = marginal_step_time(chained, None, None,
                            n1=max(steps // 4, 2), n2=steps, warmup=warmup, **timing)
    flops = count_flops(widths, batch, seq)
    n_params = sum(p.numel() for p in model.parameters())
    _, peak = card_peak(device)
    return {
        f"{prefix}_steps_per_s": round(1.0 / dt, 2),
        f"{prefix}_batch": batch,
        f"{prefix}_seq_len": seq,
        f"{prefix}_flops_per_step": flops,
        f"{prefix}_mfu": None if peak is None else round(flops / dt / peak, 4),
        f"{prefix}_flops_6n_tokens": 6.0 * n_params * batch * seq,
        f"{prefix}_steps_run": len(losses),
        f"{prefix}_loss_first": losses[0].item(),
        f"{prefix}_loss_last": losses[-1].item(),
    }


def einsum_attention(q, k, v):
    """The reference bench's einsum attention, causal, (b, t, h, d): the
    scores in q's dtype, masked to the f32 minimum and softmaxed in f32
    (on the card the minimum does not fit bf16, so the mask is applied
    to the scores in f32; the unmasked scores are the same values)."""
    t, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(1.0 * d)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()[None, None]
    s = torch.where(mask, s.float(), torch.finfo(torch.float32).min)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention_bench(b=4, t=2048, h=8, d=64, device="cuda", **timing):
    """Flash kernel vs einsum attention at long sequence length."""
    from ..ops.flash_attention import flash_attention

    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    t_flash = timed_op(lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v,
                       **timing)
    t_ein = timed_op(einsum_attention, q, k, v, **timing)
    return {
        "flash_attn_ms": round(t_flash * 1e3, 3),
        "einsum_attn_ms": round(t_ein * 1e3, 3),
        "flash_speedup": round(t_ein / t_flash, 3),
        "attn_shape": [b, t, h, d],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=128,
                   help="the Transformer family's largest trace batch "
                        "size (core/job_table.py)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--long_seq", type=int, default=2048,
                   help="sequence length for the compute-bound config "
                        "(0 disables the long-seq phase)")
    p.add_argument("--long_batch", type=int, default=4)
    p.add_argument("--save_dir", default=os.path.join(REPO, "reproduce", "h100"),
                   help="directory for the timestamped raw artifact "
                        "('' disables persisting)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the CUDA card)")
    p.add_argument("--widths", type=json.loads, default=None,
                   help="JSON object of the flagship's widths to override (vocab_size, "
                        "dim, num_heads, num_layers, mlp_dim), for a small run")
    p.add_argument("--attn_shape", type=lambda s: [int(x) for x in s.split(",")],
                   default=[4, 2048, 8, 64], help="B,T,H,D of the attention part")
    p.add_argument("--min_marginal_s", type=float, default=1.0,
                   help="the least marginal timing window, s (core/timing.py)")
    args = p.parse_args(argv)
    timing = {"min_marginal_s": args.min_marginal_s}

    if args.device == "cuda":
        from ..models.train_common import resolve_device
        resolve_device("cuda")  # raises without a card; TF32 off for the f32 logits
    name, peak = card_peak(args.device)
    result = {"device": name, "peak_bf16_flops": peak}
    result.update(transformer_train_bench(batch=args.batch, steps=args.steps,
                                          device=args.device, widths=args.widths, **timing))
    if args.long_seq:
        result.update(transformer_train_bench(
            batch=args.long_batch, steps=max(args.steps // 3, 5),
            seq=args.long_seq, prefix="transformer_long", device=args.device,
            widths=args.widths, **timing))
        # Same regime at 4x the batch: separates small-batch
        # underutilization from kernel cost in the MFU number.
        big = args.long_batch * 4
        result.update(transformer_train_bench(
            batch=big, steps=max(args.steps // 3, 5),
            seq=args.long_seq, prefix=f"transformer_long_b{big}", device=args.device,
            widths=args.widths, **timing))
    result.update(attention_bench(*args.attn_shape, device=args.device, **timing))

    if args.save_dir:
        from ..core.artifacts import save_measurement
        path, result = save_measurement(args.save_dir, "bench", result,
                                        device_kind=result["device"])
        print(f"saved {path}", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
