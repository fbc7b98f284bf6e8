#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device: the card's name, its `nvidia-smi` name and power limit, and
   the torch and CUDA versions.
2. build: nvcc compiles `shockwave_tpu_torch/csrc/*.cu` (timed); the
   instantiations that spill registers, named from ptxas's report
   (`spills:`; the TMA-fed f32 K1-K3 and the TMA-fed bf16 K1 and K3 at D
   = 32 must spill none); the HMMA instructions of each instantiation in
   the library's SASS, by mnemonic, with the TMA loads (`sass:`; the
   3xTF32 kernels must hold TF32 ones, the wgmma kernels, K1-K3 wide in
   both dtypes, HGMMA ones of their dtype and no HMMA, the TMA-fed K1-K3
   in bf16 at D = 64, 128 and 256, and K1 and K3 at D = 32, bf16 HGMMA,
   UTMALDG and no HMMA, and no long-tile mma.sync K1 or K3 instance at D
   = 32, the TMA-fed K1-K3 in f32 at D = 64-256 TF32 HGMMA, UTMALDG and
   no HMMA, and no long-tile mma.sync f32 instance there);
   then each kernel instantiation's
   resident CTAs per SM, threads, shared memory and registers, and at the
   main shape each
   kernel's resident CTA slots (CTAs per SM x SMs) against its grid
   (`occupancy:`).
3. kernels: each of the three flash-attention kernels (forward, dQ,
   dK/dV) against its plain PyTorch version on the card. In bf16, at the
   main path's three attention variants (B=64, T=32, H=8, D=64),
   cross-attention with Tq != Tk, head dim 32, the bench shape
   (4, 2048, 8, 64) causal, a causal row that sees no key, and the edges
   of the kernels' two tile widths (32, and past T = 32 the TMA-fed K1's
   and K2's 128 rows and K3's 128 keys, chosen by `launch_config`):
   ragged T=17, Tq=32 against Tk=48, T=33, D=32 at T=32 (both tiles 64
   there) and the key-0 row at T=32. Then each kernel's f32 instance
   (3xTF32 on the tensor cores) against the plain f32 version, at the
   main shape key-padded and causal, the decoder's full forward (8 x 64,
   4 heads of 32, causal), the bench shape, and the edges of the f32
   instances' tiles (16 up to T = 64, 64 beyond; at D = 64, 128 and 256
   K1's-K3's long tile is the TMA-fed f32 kernels'): ragged T=17, T=65,
   Tq=32 against Tk=48, Tq=64 against Tk=128, D=32 at T=32 and T=128,
   and the key-0 row at T=48 and T=128; its library time is SDPA's in
   f32. The f32 bound's operations are reckoned at the card's
   f32-accurate product rate, a third of its dense TF32 rate (3xTF32).
   Both dtypes also run their D = 128 and D = 256 instances (`d128_`
   and `d256_` cases): the main shape at that D, the bench shape (4,
   2048, 8, D) causal, Tq != Tk key-padded, ragged causal, and the key-0
   row at both tiles, and in f32 T = 65 at both D.
   The wide instances (any multiple of 256 above 256, all on wgmma: K1 in
   64-row tiles of up to 512 output columns; K2 and K3 in 64-row tiles,
   or 32 rows of each of two (batch, head) pairs up to T = 32, of up to
   512 dQ and 256 dK and dV columns) run the same six at D = 512 (`d512_`
   cases) and the short f32 tile causal with a missing pair and the key-0
   row, and D = 768 (`d768_`: a 512- and a 256-column slice; f32's K1
   streams Q there, bf16 K2's and K3's their A tiles) ragged causal and
   Tq != Tk key-padded, bf16 also at D = 1280 (its K1 streams Q). Then head dims the kernels are not
   built for (`PADDED_CASES`: d = 16, 48, 80, 96, 160, 200, 264 and 320,
   bf16 and f32), forward + backward through `flash_attention`, which
   zero-pads them to 32, 64, 128, 256 and 512 and slices the output back,
   against the plain versions at the original d, with the same shape's
   time at the padded width beside; and head dim 257 (`wide_head_dim:`),
   the narrowest past the template instances, the same way. Times are medians of CUDA-event timings of CUDA-graph
   replays (device time, no host launch cost), beside the bound and the
   PyTorch library call (`scaled_dot_product_attention`, a yardstick the
   port never calls, with the backend its dispatch picked; its backward,
   the yardstick of K2 + K3 together, as its forward + backward less its
   forward). Every kernel case also runs its inputs in the model's layout
   ((B, T, H, D) tensors handed over as their (B, H, T, D) views, as
   `flash_attention` hands them): out, lse, dQ, dK and dV must come out
   bit for bit as from the packed tensors, and the backward's delta
   kernel (`flash_bwd_delta`) the same bits on both and within DELTA_TOL
   of its plain version; it is timed at the shapes of its rows
   (DELTA_TIMED). The bench shape at head dim 32 (`d32_bench_causal`, both
   dtypes) times the long tile there: in bf16 the TMA-fed K1 and K3 on
   64-byte rows and K2's mma.sync tile, in f32 the mma.sync instances.
   Each kernel's bound is the largest of its bytes, its operations and
   its exponentials (one per visible score in each of K1-K3, at 16 a
   clock on each SM at the card's highest SM clock; `bound_by` "exp"
   where they set it).
   model_layout: `flash_attention`'s forward + backward on the model's
   own (B, T, H, D) tensors at the main shape and the bench shape at D =
   32, 64, 128 and 256 (bf16), beside SDPA's on the same tensors' views
   and the packed-layout time above; at the main shape and the bench
   shape at D 64 and 32 its device kernels, counted under
   torch.profiler, must be K1, delta, K2 and K3, one each, and nothing
   else.
4. slice: the translation trainer at full width (dim 512, 8 heads,
   6 + 6 layers, batch 64) for 30 steps through
   `shockwave_tpu_torch.workloads.translation.train.main`, with the
   launch counters set to 0 just before and read just after; then a
   resume from its checkpoint, and the logits with flash on against the
   einsum path on the same weights and batch.
5. lease: the same trainer under the scheduler's lease protocol, against
   a stand-in scheduler on loopback built from the port's
   `rpc.generic_handler` (the JAX package's scheduler is not imported
   here). In process: `train.main(... -step 30 --enable_lease_iterator)`
   under a lease of 10 steps that one renewal extends to 20 and no
   further must expire at exactly step 20, write its checkpoint and its
   last `[PROGRESS] [STEPS] 20` line, and launch each kernel 18 x 20
   times; a second dispatch granted the remaining 10 must resume at step
   20 and end at 30 with 18 x 10 launches each. Then the port's
   `WorkerDaemon`, in process, takes a `RunJob` for the trace's own
   Transformer command with a 10-step budget and runs the trainer as a
   subprocess on the card: it must see CUDA_VISIBLE_DEVICES=0, exit 0,
   and its `Done` must report exactly 10 steps. That daemon runs with
   fleet tracing (`trace_dir`) and `obs_port` 0, and the stand-in sends
   its RunJob with a traceparent in the metadata: the trace directory
   must hold a worker and a trainer span shard, whose runjob -> launch ->
   trainer -> ckpt-save chain and done-report hang off the stand-in's
   context across the process boundary; `/metrics` must count the one
   RunJob and `/healthz` return the daemon's JSON (`trace:` line: the
   trainer's start-up inside the dispatch, trainer.ts - launch.ts, the
   save's and the trainer span's lengths).

6. families: the LM, Recommendation, ResNet-18 and ResNet-50 trainers
   through their mains at their largest batch (`MAX_BS`: 80, 8192, 256,
   128), 20 steps each on the repeated synthetic batch with the launch
   counters set to 0 (these paths reach none of the kernels): the loss
   must be finite and fall, and a resume from the checkpoint must train
   exactly one more step. Per family: steps/s from the throughput marks,
   samples/s, peak device memory and checkpoint bytes. Then the two mains
   that drive the lease iterator themselves: A3C (`--workers 4`, 50
   ticks) and CycleGAN (the trace's command, batch 1, 128 x 128, 10
   steps): finite losses (a GAN's need not fall), every model's
   parameters moved, a resume of exactly one more step; steps/s, peak
   memory, checkpoint bytes, and CycleGAN's FLOPs per step (counted from
   its convolutions' shapes) and MFU against the card's bf16 peak.
7. adapt: the dynamic-adaptation monitors under the stand-in scheduler,
   which now records `UpdateResourceRequirement`. ResNet-18 at batch 128
   in `accordion` mode with 10-batch epochs: the per-epoch mean gradient
   norms, and the port's request must be the one `AccordionMonitor`'s
   rule gives on them; when the rule asks for the big batch, the
   stand-in must receive `big_bs=True` and a second dispatch at
   `--batch_size 256` must resume from the saved step and complete its
   grant. Then one dispatch in `gns` mode, past GNS's 50-step window,
   must train and issue no request (on one card the small batch is the
   whole batch).
8. serving: the serving replica. `workloads/serving/serve.py`'s main, in
   process, with `data/serving_mixed.trace`'s first service command as
   the tier dispatches its first replica, under a lease of 100 request
   batches from the stand-in scheduler (which now also records each
   renewal's measured reports): it must serve exactly 100 batches on
   `cuda` through its CUDA graph, and its renewal must carry a measured
   latency delta with samples. Then the request batch through the CUDA
   graph against eager mode on the same weights and prompt, at batch 1
   and 8: the tokens must be equal; decode tokens/s of each (generated
   tokens over the host clock, synced). Then `DecoderLM`'s full forward
   in bf16 with flash on (K1, one launch per layer) against its einsum
   path at (8, 64), within the profile phase's logits tolerance, and the
   same in bf16 forward + backward (head dim 32: the TMA-fed K1 and K3,
   K2's mma.sync tile), logits and gradients. Then
   the decoder in f32 (its default) with flash on: its logits against
   the einsum path's and the gradient of a next-token loss through K1-K3's
   f32 instances against the einsum path's, one launch of each per
   layer. Then the same at dim 64, 4 heads (head dim 16, which
   `flash_attention` pads to 32), at dim 512, 4 heads (head dim 128), and
   at dim 1024, 4 heads (head dim 256) and at dim 2048, 4 heads (head dim
   512, the wide instances), in bf16 and in f32. Then the f32 decoder past
   the f32 short tile, (8, 128) at head dims 64, 128 and 256 (dim 256, 512
   and 1024, 4 heads): the TMA-fed K1-K3 in f32, one launch of each per
   layer.
   bench_line: `profiling/bench_serving_decode.py` at its defaults (batch
   8, 32 tokens, prompt 8, dim 128, 2 layers, 4 heads) through its
   `--smoke` gate at 200 tokens/s, its CUDA graph's tokens equal to the
   eager batch's; then `profiling/headline.py --max_rounds 20` as a
   subprocess (the canonical trace's simulation on the h100 oracle,
   bench_gpu, the decode bench, nvidia-smi): exit 0, every key filled.
9. profile: the profilers of `shockwave_tpu_torch/profiling/`. First
   `bench_gpu`'s long path: the full-width flagship with flash on at
   batch 4 x T 2048 under Adam, timed by two-point marginal timing, with
   the launch counters set to 0 just before and read just after: each
   kernel must launch exactly 18 times per step run (the encoder's
   key-padded self-attention, the decoder's causal self-attention and
   the cross-attention, in the kernels' 64-wide tile), and the loss must
   be finite and fall; steps/s, FLOPs per step (counted with flash off)
   and MFU against the card's bf16 peak. Then one forward of the flash
   model against the einsum path with the same weights, on sources
   padded at ragged lengths, so that the key-padded tile-64 path runs.
   Then `measure_throughput --only` with one row per family into
   a temporary oracle file: every rate must be > 0 and the port's
   `core/oracle.read_throughputs` must read the file back. Then
   `measure_startup` for one job type with one measured run: its
   dispatch overhead must be > 0.
10. gang: data-parallel gangs of two ranks that share the one card (the
   port's `Dispatcher` with `chip_ids=[0, 0]`, so the ranks pick gloo;
   a gang of one card per rank takes NCCL, which this card alone cannot
   show), under the stand-in scheduler, each rank a subprocess of the
   trace's main run through this script's `--gang-member` mode, which
   reports the rank's result as a `GANG_MEMBER` line. The Transformer at
   global batch 64 in `gns` mode, sf = 2: a lease of 10 steps renewed to
   20, then a resume dispatch granted 5; ResNet-18 at global batch 128 in
   `accordion` mode, sf = 2, for 6 steps (the BatchNorm statistics
   all-reduced on the card). Checked: both ranks print backend gloo on
   `cuda`, stop at the same step, report exactly the granted steps in
   `Done` (the scheduler sums the ranks' steps), rank 0 alone writes the
   checkpoint and both ranks resume from it, the ranks' states are equal
   bit for bit, each kernel launches exactly 18 times per rank per step,
   and each job's loss and parameters are within the stated tolerance of
   a one-process run of the same main on the global batch on the card.
   Printed: the gang's steps/s beside that one-process run's, and the
   gradient all-reduce's ms per call. Two ranks on one card over gloo
   measure nothing of a two-card NCCL gang's speed.
11. deployed: `profiling/measure_deployed.py` on the LM (batch 20) for
   three rounds of 30 s, against a temporary copy of
   `data/h100_throughputs.json`: the unchanged `run_physical.py` and the
   port's worker as subprocesses, two jobs alternating. Its keys must be
   written, a lease after round 0 parsed, the deployed rate > 0 and the
   lease shortfall within [0, round): the deployed and solo rates, the
   shortfall and the round drain.
12. parallel: the model-parallel axes. `parallel/dryrun.py`'s
   `dryrun_multichip(4)` on the card (four ranks sharing it over gloo,
   one step of each of the reference's meshes, dp x tp x sp and dp x pp
   x ep) against the same four ranks on the CPU: losses, the gathered
   updated parameters and the MoE routing; each rank's launches must be
   the f32 K1-K3's, one each per ring step its causal schedule runs (sp
   rank i: i + 1). Then ring attention at (4, 2048, 8, 64) bf16, causal,
   over two sp ranks on the card (this script's `--ring-member` mode)
   against one process's `flash_attention` on the whole sequence, at the
   bf16 kernel tolerances, with one launch of each bf16 kernel per ring
   step; its forward + backward ms beside the one-process kernels' and
   SDPA's. Two ranks on one card over gloo measure the host copies of
   every hop, not an NVLink ring.

Output: `device:`, `build:`, `ptxas:`, `spills:`, `sass:` and
`occupancy:` lines, one `kernel_case:` JSON line per shape and dtype, one
`padded_case:` line per padded head dim and dtype, `wide_head_dim:`,
`model_layout:`,
`slice:`, `lease:`, `trace:`, `families:`, `adapt:`, `serving:`,
`bench_line:`, `profile:`, `gang:`, `deployed:` and `parallel:` lines,
then the
`{"kernels": [...]}` line (the six kernel instances, each with its D =
128 and D = 256 times beside, the six wide instances at D = 512, and the
two delta kernels, bf16 and f32, at their main-path shape and their
bench shape, the six TMA-fed ones, K1-K3 in bf16 and in f32 on the long
tile, at
their dtype's bench shape with its D = 128 and 256 times beside and, on
K2's and K3's rows, K2 + K3 against SDPA's backward at each D, their
launches the profile phase's T = 2048 steps' (bf16) and the f32 decoder's
at (8, 128) (f32); the
main case's forward + backward through the port's autograd path and
through `scaled_dot_product_attention`, the model layout's, the same at D = 256 and 512, the
bench line's decode rate and headline, and the ring's and dryrun's
numbers), the
`nvidia-smi` name and power limit, and as the last line `{"ok": true,
"device": {...}}`. Copied alone into a directory without the port beside
it, the script exits 2 and prints no result.
"""
import contextlib
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# (name, B, Tq, Tk, H, D, causal, mask): mask "tail" pads each sequence's
# tail at a random length, "key0" pads key 0 only, None attends to all.
CASES = (
    ("main_enc_self", 64, 32, 32, 8, 64, False, "tail"),
    ("main_dec_self", 64, 32, 32, 8, 64, True, "tail"),
    ("main_cross", 64, 32, 32, 8, 64, False, "tail"),
    ("cross_64x128", 1, 64, 128, 2, 64, False, None),
    ("head_dim_32", 2, 128, 128, 4, 32, True, "tail"),
    ("d32_bench_causal", 4, 2048, 2048, 8, 32, True, None),
    # D = 32, where K1's and K3's long tile is TMA-fed on 64-byte rows:
    # Tq != Tk key-padded, ragged causal, and the row that sees no key.
    ("d32_cross_48x96", 2, 48, 96, 4, 32, False, "tail"),
    ("d32_ragged_causal", 2, 100, 100, 4, 32, True, "tail"),
    ("d32_masked_row0", 1, 128, 128, 2, 32, True, "key0"),
    ("bench_causal", 4, 2048, 2048, 8, 64, True, None),
    ("masked_row0", 1, 128, 128, 2, 64, True, "key0"),
    ("short_ragged", 3, 17, 17, 2, 64, True, "tail"),
    ("cross_32x48", 4, 32, 48, 2, 64, False, "tail"),
    ("one_past_short", 2, 33, 33, 2, 64, True, "tail"),
    ("short_head_dim_32", 2, 32, 32, 4, 32, True, "tail"),
    ("short_masked_row0", 1, 32, 32, 2, 64, True, "key0"),
    # D = 128: the main shape (the short tile, key-padded), the bench
    # shape, the long tile key-padded and causal, and the row that sees
    # no key at both tiles.
    ("d128_main_enc_self", 64, 32, 32, 8, 128, False, "tail"),
    ("d128_bench_causal", 4, 2048, 2048, 8, 128, True, None),
    ("d128_cross_48x96", 2, 48, 96, 4, 128, False, "tail"),
    ("d128_ragged_causal", 2, 100, 100, 4, 128, True, "tail"),
    ("d128_masked_row0", 1, 128, 128, 2, 128, True, "key0"),
    ("d128_short_masked_row0", 1, 32, 32, 2, 128, True, "key0"),
    # D = 256, the same six: K1 and K2 read their Q and dO fragments from
    # shared memory, K3 runs two warps per 16 keys.
    ("d256_main_enc_self", 64, 32, 32, 8, 256, False, "tail"),
    ("d256_bench_causal", 4, 2048, 2048, 8, 256, True, None),
    ("d256_cross_48x96", 2, 48, 96, 4, 256, False, "tail"),
    ("d256_ragged_causal", 2, 100, 100, 4, 256, True, "tail"),
    ("d256_masked_row0", 1, 128, 128, 2, 256, True, "key0"),
    ("d256_short_masked_row0", 1, 32, 32, 2, 256, True, "key0"),
    # D = 512, the same six on the wide instances (all on wgmma; K1:
    # 64-row tiles of 512 columns; K2, K3: 64-row tiles, or 32 rows of two
    # pairs up to T = 32, of 512 dQ and 256 dK and dV columns, their A
    # tiles resident): the main shape, the bench shape, Tq != Tk
    # key-padded, ragged causal, the key-0 row at a short and a long
    # sequence, and the short tile with a missing pair at BH = 3.
    ("d512_main_enc_self", 64, 32, 32, 8, 512, False, "tail"),
    ("d512_bench_causal", 4, 2048, 2048, 8, 512, True, None),
    ("d512_cross_48x96", 2, 48, 96, 4, 512, False, "tail"),
    ("d512_ragged_causal", 2, 100, 100, 4, 512, True, "tail"),
    ("d512_masked_row0", 1, 128, 128, 2, 512, True, "key0"),
    ("d512_short_masked_row0", 1, 32, 32, 2, 512, True, "key0"),
    ("d512_short32_masked_row0", 1, 32, 32, 3, 512, True, "key0"),
    # D = 768: K1's and K2's CTAs of 512 and 256 output columns (grid z =
    # 2), K3's three slices, K2 and K3 streaming their A tiles; D = 1280,
    # where K1 streams Q's chunks.
    ("d768_ragged_causal", 2, 100, 100, 4, 768, True, "tail"),
    ("d768_cross_48x96", 2, 48, 96, 4, 768, False, "tail"),
    ("d1280_ragged_causal", 1, 100, 100, 2, 1280, True, "tail"),
)
MAIN_CASE = "main_enc_self"  # 12 of the 18 launches per step are key-padded, non-causal
# The f32 instances of K1-K3, in the same form: the main shape key-padded
# and causal, the decoder's full forward in the serving phase (8 x 64,
# 4 heads of 32, causal), the bench shape, and the edges of every f32
# tile (16 up to T = 64, 64 beyond): ragged T = 17 and T = 65, Tq != Tk
# inside each width, D = 32 at each width, and the row that sees no key
# at each width.
F32_CASES = (
    ("main_enc_self_f32", 64, 32, 32, 8, 64, False, "tail"),
    ("main_dec_self_f32", 64, 32, 32, 8, 64, True, "tail"),
    ("decoder_f32", 8, 64, 64, 4, 32, True, None),
    ("bench_causal_f32", 4, 2048, 2048, 8, 64, True, None),
    ("masked_row0_f32", 1, 128, 128, 2, 64, True, "key0"),
    ("short_ragged_f32", 3, 17, 17, 2, 64, True, "tail"),
    ("cross_32x48_f32", 4, 32, 48, 2, 64, False, "tail"),
    ("short_head_dim_32_f32", 2, 32, 32, 4, 32, True, "tail"),
    ("head_dim_32_f32", 2, 128, 128, 4, 32, True, "tail"),
    ("d32_bench_causal_f32", 4, 2048, 2048, 8, 32, True, None),
    ("one_past_short_f32", 2, 65, 65, 2, 64, True, "tail"),
    ("cross_64x128_f32", 1, 64, 128, 2, 64, False, None),
    ("short_masked_row0_f32", 1, 48, 48, 2, 64, True, "key0"),
    # D = 128, as in CASES: the one-warp tile at the main shape, the bench
    # shape, the long tile key-padded and causal, the key-0 row at both.
    ("d128_main_enc_self_f32", 64, 32, 32, 8, 128, False, "tail"),
    ("d128_bench_causal_f32", 4, 2048, 2048, 8, 128, True, None),
    ("d128_cross_48x96_f32", 2, 48, 96, 4, 128, False, "tail"),
    ("d128_ragged_causal_f32", 2, 100, 100, 4, 128, True, "tail"),
    ("d128_masked_row0_f32", 1, 128, 128, 2, 128, True, "key0"),
    ("d128_short_masked_row0_f32", 1, 48, 48, 2, 128, True, "key0"),
    ("d128_one_past_short_f32", 2, 65, 65, 2, 128, True, "tail"),
    # D = 256, the same six; the bench shape, the cross case, the ragged
    # case and the long key-0 row run the TMA-fed f32 instances.
    ("d256_main_enc_self_f32", 64, 32, 32, 8, 256, False, "tail"),
    ("d256_bench_causal_f32", 4, 2048, 2048, 8, 256, True, None),
    ("d256_cross_48x96_f32", 2, 48, 96, 4, 256, False, "tail"),
    ("d256_ragged_causal_f32", 2, 100, 100, 4, 256, True, "tail"),
    ("d256_masked_row0_f32", 1, 128, 128, 2, 256, True, "key0"),
    ("d256_short_masked_row0_f32", 1, 48, 48, 2, 256, True, "key0"),
    ("d256_one_past_short_f32", 2, 65, 65, 2, 256, True, "tail"),
    # D = 512 on the wide f32 instances (64-row tiles; K2 and K3 32 rows
    # of two pairs up to T = 32: the main shape), the same six, and the
    # short tile causal with the key-0 row and, at BH = 3, a missing pair.
    ("d512_main_enc_self_f32", 64, 32, 32, 8, 512, False, "tail"),
    ("d512_bench_causal_f32", 4, 2048, 2048, 8, 512, True, None),
    ("d512_cross_48x96_f32", 2, 48, 96, 4, 512, False, "tail"),
    ("d512_ragged_causal_f32", 2, 100, 100, 4, 512, True, "tail"),
    ("d512_masked_row0_f32", 1, 128, 128, 2, 512, True, "key0"),
    ("d512_short_masked_row0_f32", 1, 48, 48, 2, 512, True, "key0"),
    ("d512_short32_masked_row0_f32", 1, 32, 32, 3, 512, True, "key0"),
    # D = 768, where K1 in f32 streams Q's chunks: ragged causal, Tq != Tk.
    ("d768_ragged_causal_f32", 2, 100, 100, 4, 768, True, "tail"),
    ("d768_cross_48x96_f32", 2, 48, 96, 4, 768, False, "tail"),
)
MAIN_CASE_F32 = "main_enc_self_f32"
# The D = 128 instances' rows of the kernels line are timed at these
# cases (the main shape and the bench shape at D = 128), by dtype.
D128_CASES = {"": ("d128_main_enc_self", "d128_bench_causal"),
              "_f32": ("d128_main_enc_self_f32", "d128_bench_causal_f32")}
# The same for the D = 256 instances.
D256_CASES = {"": ("d256_main_enc_self", "d256_bench_causal"),
              "_f32": ("d256_main_enc_self_f32", "d256_bench_causal_f32")}
# The same for the wide instances, at D = 512.
D512_CASES = {"": ("d512_main_enc_self", "d512_bench_causal"),
              "_f32": ("d512_main_enc_self_f32", "d512_bench_causal_f32")}
# Head dims the kernels are not built for, in the same form, through
# `flash_attention`, which zero-pads them to `kernel_head_dim` (16 -> 32,
# 48 -> 64, 80 and 96 -> 128, 160 and 200 -> 256, 264 and 320 -> 512, on
# the wide instances) and slices the output back; "_f32" names the f32
# instances. d = 16 at the d = 16 decoder's shape (8 x 64, 4 heads,
# causal), d = 48, 96, 160 and 320 key-padded at T = 128, which takes the
# long tiles, d = 80, 200 and 264 causal at T = 64.
PADDED_CASES = (
    ("head_dim_16", 8, 64, 64, 4, 16, True, None),
    ("head_dim_48", 2, 128, 128, 4, 48, False, "tail"),
    ("head_dim_96", 2, 128, 128, 4, 96, False, "tail"),
    ("head_dim_80", 8, 64, 64, 4, 80, True, None),
    ("head_dim_160", 2, 128, 128, 4, 160, False, "tail"),
    ("head_dim_200", 8, 64, 64, 4, 200, True, None),
    ("head_dim_320", 2, 128, 128, 4, 320, False, "tail"),
    ("head_dim_264", 8, 64, 64, 4, 264, True, None),
    ("head_dim_16_f32", 8, 64, 64, 4, 16, True, None),
    ("head_dim_48_f32", 2, 128, 128, 4, 48, False, "tail"),
    ("head_dim_96_f32", 2, 128, 128, 4, 96, False, "tail"),
    ("head_dim_80_f32", 8, 64, 64, 4, 80, True, None),
    ("head_dim_160_f32", 2, 128, 128, 4, 160, False, "tail"),
    ("head_dim_200_f32", 8, 64, 64, 4, 200, True, None),
    ("head_dim_320_f32", 2, 128, 128, 4, 320, False, "tail"),
    ("head_dim_264_f32", 8, 64, 64, 4, 264, True, None),
)
# The narrowest head dim past the widest template instance, 257, through
# `flash_attention` on the card (padded to 512, the wide instances), in
# both dtypes, against the plain versions at d = 257.
WIDE_HEAD_DIM_CASES = (("head_dim_257", 2, 64, 64, 4, 257, True, "tail"),
                       ("head_dim_257_f32", 2, 64, 64, 4, 257, True, "tail"))

# Tolerances, against the plain version on the same bf16 inputs:
# - forward output: max abs error 2e-2, on rows that see a key (a row that
#   sees none is a uniform average whose extent depends on the tiling, as
#   in the JAX package). The output is rounded to bf16 (half an ulp is
#   3.9e-3 below 2), p is rounded to bf16 before p.V in both, and the
#   sums run in another order; 2e-2 leaves room for one ulp at |o| < 4.
# - lse: max abs error 1e-3; both are f32 from the same bf16 products.
# - dQ, dK, dV: max|kernel - plain| / max|plain| <= 5e-2; dS and p are
#   rounded to bf16 in both, so a rounding flip moves a term by 2^-8.
# - the row that sees no key: dQ, dK and dV of row/key 0 exactly 0.
FWD_TOL, LSE_TOL, GRAD_TOL = 2e-2, 1e-3, 5e-2
# The f32 instances against the plain f32 versions (cuBLAS with TF32 off)
# on unit-normal inputs: every term is f32 in both and only the order of
# the sums differs (the kernels' online softmax rescales as it goes), a
# few f32 ulps of values of order 1. Output and lse: max abs error 1e-4;
# dQ, dK, dV: max|kernel - plain| / max|plain| <= 1e-4.
F32_TOL = 1e-4
# Flash against einsum logits of the full-width model in bf16, max abs
# (the slice at T = 32, the profile phase at T = 2048): the einsum path
# rounds the scores to bf16 before its softmax, the kernels keep them in
# f32, and the difference travels through 12 bf16 layers.
LOGITS_TOL = 5e-2

# The Pallas kernel each CUDA kernel replaces (both of its instances), and
# the errors of the kernel cases that the kernels line reports for it.
REPLACES = {"flash_fwd": "shockwave_tpu/ops/flash_attention.py:40",
            "flash_dq": "shockwave_tpu/ops/flash_attention.py:167",
            "flash_dkv": "shockwave_tpu/ops/flash_attention.py:222"}
# delta = rowsum(dO * O) replaces no Pallas kernel: the JAX package's
# plain jnp, which XLA fuses on the TPU.
DELTA_REPLACES = "shockwave_tpu/ops/flash_attention.py:290"
# The delta kernel against the plain version: f32 sums of the same
# products in another order, max abs error relative to the largest row
# sum of |dO O|.
DELTA_TOL = 1e-5
# The kernel cases whose delta kernel is timed (the rows' shapes), and the
# forward + backward in the model's layout: (B, T, H, D) tensors handed
# over as their (B, H, T, D) views, timed beside SDPA on the same views;
# those of MODEL_LAYOUT_COUNTED also counted under torch.profiler (K1,
# delta, K2 and K3, one launch each, nothing else).
DELTA_TIMED = ("main_enc_self", "bench_causal", "decoder_f32", "bench_causal_f32")
MODEL_LAYOUT_CASES = ("main_enc_self", "bench_causal", "d128_bench_causal", "d256_bench_causal",
                      "d32_bench_causal")
MODEL_LAYOUT_COUNTED = ("main_enc_self", "bench_causal", "d32_bench_causal")
ERR_KEYS = {"flash_fwd": ("fwd_max_abs",), "flash_dq": ("dq_max_abs",),
            "flash_dkv": ("dkv_max_abs",)}

STEPS = 30
BATCH = 64
# The lease phase: a first lease of 10 steps, renewed once to 20, on a
# 30-step job; the second dispatch is granted the remaining 10; the
# daemon's dispatch has a budget of its own.
LEASE_GRANT, LEASE_CAP, DAEMON_STEPS = 10, 20, 10
TGT_TOKENS_PER_STEP = BATCH * 32  # tgt[:, 1:] of (B, 33); no pads in the synthetic data

# The families phase: (main module under shockwave_tpu_torch.workloads,
# the CLI before the steps' count at batch b); each runs at its MAX_BS.
FAMILIES = {
    "lm": ("language_modeling.main", lambda b: ["--cuda", "--batch_size", b, "--steps"]),
    "recommendation": ("recommendation.train", lambda b: ["--batch_size", b, "-n"]),
    "resnet18": ("image_classification.cifar10.main", lambda b: ["--batch_size", b, "--num_steps"]),
    "resnet50": ("image_classification.imagenet.main",
                 lambda b: ["-j", "4", "-a", "resnet50", "-b", b, "--num_minibatches"]),
}
FAMILY_STEPS = 20
# The adapt phase: ResNet-18 in accordion mode at batch 128 with 10-batch
# epochs and a budget of 6 epochs; the resumed dispatch at 256 is granted
# 10 steps; the gns dispatch runs past the 50-step GNS window.
ADAPT_BATCH, ADAPT_EPOCH, ADAPT_STEPS, ADAPT_RESUME, GNS_STEPS = 128, 10, 60, 10, 55
# The profile phase: the bench's long path, one oracle row per ported
# family at few steps, and one job type's cold dispatch.
LONG_BATCH, LONG_SEQ, LONG_STEPS = 4, 2048, 10
PROFILE_ROWS = ("ResNet-18:16", "ResNet-50:16", "Transformer:16", "LM:5", "Recommendation:512",
                "A3C:4", "CycleGAN:1")
PROFILE_STEPS, PROFILE_WARMUP = 8, 2
STARTUP_JOB = "LM (batch size 20)"
# The families phase's two mains that drive their own loop: A3C with 4
# environments for 50 ticks, CycleGAN at the trace's batch 1 x 128 x 128
# for 10 steps; each resumes for one more.
OWN_LOOP_FAMILIES = {
    "a3c": ("rl.main", ["--env", "PongDeterministic-v4", "--workers", "4", "--amsgrad", "True",
                        "--max-steps"], 50),
    "cyclegan": ("cyclegan.cyclegan", ["--dataset_path", "%s/monet2photo", "--decay_epoch", "0",
                                       "--n_steps"], 10),
}
# The serving phase: data/serving_mixed.trace's first service as the
# tier dispatches its first replica (index 0, spawned at the service's
# start), under a lease of 100 request batches; then decode tokens/s at
# batch 1 and 8, eager and through the CUDA graph, and the decoder's
# flash path at T = 64 in bf16 against its einsum path.
SERVING_COMMAND = ("--batch_size 1 --base_rps 8 --peak_rps 16 --period_s 14400 --phase_s 0 "
                   "--tokens_per_request 64 --decode_tokens_per_s 1600 --max_replicas 12 "
                   "--spike_seed 7 --num_spikes 1 --spike_mult 10 --spike_duration_s 1800 "
                   "--replica_of 0 --replica_index 0 --service_lifetime_s 14400 "
                   "--arrival_phase_s 0").split()
SERVING_LEASE = 100
DECODE_BATCHES = {"eager": 10, "graph": 100}
DECODER_FLASH_SHAPE = (8, 64)
# The decoder in f32 with flash (K1-K3's f32 instances) against its
# einsum path: logits max abs, and the parameter gradients' max abs error
# over their largest entry. Both are f32 throughout with TF32 off; the kernels sum in another
# order and the einsum path's softmax masks with f32's minimum where the
# kernels use -1e30, which gives the same zeros.
DECODER_F32_TOL = 1e-4
# The decoder at head dim 16 (dim 64, 4 heads): the route through the
# head-dim pad. In bf16 its logits are held to LOGITS_TOL and its
# gradients to GRAD_TOL relative to the largest entry (the einsum path
# rounds the scores and the softmax weights to bf16, flash keeps the
# scores in f32 and rounds p and dS); in f32 to DECODER_F32_TOL.
DECODER_PADDED_WIDTHS = dict(dim=64, num_heads=4)
# The decoder at head dim 128 (dim 512, 4 heads) and at head dim 256
# (dim 1024, 4 heads), the widest kernel width, at the same tolerances.
DECODER_D128_WIDTHS = dict(dim=512, num_heads=4)
DECODER_D256_WIDTHS = dict(dim=1024, num_heads=4)
# The f32 decoder past the f32 short tile, (8, 128) at head dims 64, 128
# and 256: its flash forward + backward runs the TMA-fed K1-K3 in f32, at
# DECODER_F32_TOL.
DECODER_LONG_SHAPE = (8, 128)
DECODER_LONG_WIDTHS = {64: dict(dim=256, num_heads=4), 128: DECODER_D128_WIDTHS,
                       256: DECODER_D256_WIDTHS}
# The decoder at head dim 512 (dim 2048, 4 heads): the wide instances, at
# the same tolerances.
DECODER_D512_WIDTHS = dict(dim=2048, num_heads=4)
# The bench line: `bench_serving_decode` at its defaults must pass its
# `--smoke` floor (tokens/s); the headline runs its simulation for this
# many rounds.
BENCH_DECODE_FLOOR, HEADLINE_ROUNDS = 200.0, 20
# The deployed phase: `measure_deployed` on one family, three rounds of
# 30 s, against a temporary copy of the committed h100 oracle. Three is
# the fewest that parse a lease: round 0 is skipped (its cold start) and
# the last round's lease is cut when the scheduler stops.
DEPLOYED_FAMILY, DEPLOYED_ROUNDS, DEPLOYED_ROUND_S = "LM (batch size 20)", 3, 30.0
DEPLOYED_KEYS = ("lease_shortfall_s", "lease_shortfall_s_by_type", "round_drain_s",
                 "round_drain_s_by_type", "deployed_calibration")
# The gang phase: two ranks on the one card. The Transformer (global
# batch 64, gns) under a lease of 10 steps renewed to 20, then a resume
# granted 5; ResNet-18 (global batch 128, accordion) for 6 steps.
GANG_RANKS = 2
GANG_LEASE, GANG_CAP, GANG_RESUME = 10, 20, 5
GANG_RESNET_BATCH, GANG_RESNET_STEPS = 128, 6
ALLREDUCE_CALLS = 5
# The gang against a one-process run of the same main on the global
# batch, on the card, after the same steps. Each rank rounds its bf16
# weight gradients (a half-batch sum, 2^-9 relative) before the f32 sum
# where the one process rounds the whole sum, and cuBLAS may pick other
# kernels for half the rows: a bf16 ulp here and there, carried through
# the steps. The Transformer: loss within 1e-2 relative, the parameters'
# error within 0.05 of how far the steps moved them (2-norms over all
# parameters). ResNet-18 in bf16: test_torch_families.py's stated bf16
# ResNet tolerance (loss 5e-2, movement 0.4, running statistics 5e-2 of
# their scale).
GANG_TOL = {"transformer": {"loss": 1e-2, "whole": 0.05, "stats": None},
            "resnet18": {"loss": 5e-2, "whole": 0.4, "stats": 5e-2}}
# The parallel phase. (a) `dryrun_multichip(4)`: four ranks sharing the
# card over gloo against the same four ranks on the CPU. Both run f32
# with TF32 off; the card's ring attention runs K1-K3's 3xTF32 instances
# (about 1e-6 relative to the plain f32 versions) and cuBLAS sums in
# other orders, so the losses agree to DRYRUN_LOSS_TOL relative and each
# updated parameter (initial scale 0.02, moved by lr 1e-2 times its
# gradient) to DRYRUN_PARAM_TOL abs. (b) Ring attention at RING_SHAPE
# (B, T, H, D) in bf16, causal, over RING_RANKS sp ranks on the card,
# against one process's `flash_attention` on the whole sequence, at the
# bf16 kernel tolerances (FWD_TOL on the output, GRAD_TOL relative on
# dQ, dK and dV); its forward + backward on the host clock, RING_REPS
# times after a warm-up.
DRYRUN_RANKS, DRYRUN_LOSS_TOL, DRYRUN_PARAM_TOL = 4, 1e-5, 1e-6
RING_SHAPE, RING_RANKS, RING_REPS = (4, 2048, 8, 64), 2, 5


class Failure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


def check_launches(fa, launches, per_kernel, where, dtype=torch.bfloat16, kernels=None,
                   width=64, t=32):
    """The instance of each of `kernels` (default: K1-K3 and the backward's
    delta, as `flash_attention`'s forward + backward launches them) for
    `dtype` at kernel head dim `width` (the wide ones above 256) and
    sequences of length `t` (the TMA-fed K1-K3 past the short tile)
    launched exactly `per_kernel` times and every other instance never."""
    wanted = {fa.instance(kname, dtype, width, t, t) for kname in kernels or fa.KERNELS}
    if kernels is None:
        wanted.add(fa.DELTA + fa.KERNEL_DTYPES[dtype])
    want = {name: per_kernel if name in wanted else 0 for name in fa.LAUNCHES}
    check(launches == want, f"{where}: launched {launches}, not {want}")


def emit(tag: str, obj) -> None:
    print(f"{tag}: {json.dumps(obj, sort_keys=True)}", flush=True)


def kernel_name(mangled: str) -> str:
    """"flash_..._kernel<D, tile>" (a wide instance: K1's
    "flash_fwd_wide_kernel<type, Q resident>" or "..., Q streamed>"; bf16
    K2's and K3's "flash_dq_wide_kernel<bf16, rows, A resident>" or "...,
    A streamed>"; f32 K3's "flash_dkv_wide_f32_kernel<rows>", K2's
    "flash_dq_wide_f32_kernel<rows, 512-column CTAs>" or "..., any D>") of a
    kernel's mangled name."""
    k = re.search(r"(flash_(?:fwd|dq|dkv)(?:_f32)?_kernel)ILi(\d+)ELi(\d+)E", mangled)
    if k:
        return f"{k.group(1)}<{k.group(2)}, {k.group(3)}>"
    k = re.search(r"(flash_(?:fwd|dq|dkv)_tma(?:_f32)?_kernel)ILi(\d+)E", mangled)
    if k:
        return f"{k.group(1)}<{k.group(2)}>"
    k = re.search(r"(flash_(?:dq|dkv)_wide_f32_kernel)ILi(\d+)E(?:Lb([01])E)?", mangled)
    if k:
        whole = {"1": ", 512-column CTAs", "0": ", any D", None: ""}[k.group(3)]
        return f"{k.group(1)}<{k.group(2)}{whole}>"
    k = re.search(r"(flash_(?:dq|dkv)_wide_kernel)ILi(\d+)ELb([01])E", mangled)
    if k:
        return f"{k.group(1)}<bf16, {k.group(2)}, A {('streamed', 'resident')[int(k.group(3))]}>"
    k = re.search(r"(flash_fwd_wide_kernel)I(f|13__nv_bfloat16)Lb([01])E", mangled)
    if k:
        dtype = "float" if k.group(2) == "f" else "bf16"
        return f"{k.group(1)}<{dtype}, Q {('streamed', 'resident')[int(k.group(3))]}>"
    return mangled


def spills(log: str):
    """{"kernel<D, tile>": spill store bytes} of every instantiation
    that spills, from ptxas's -v report."""
    found, entry = {}, None
    for line in log.splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        if props:
            entry = props.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and int(spill.group(1)) and entry:
            found[kernel_name(entry)] = int(spill.group(1))
    return found


def sass_hmma(library: str):
    """{"kernel<D, tile>": {HMMA, HGMMA or UTMALDG mnemonic: count}} of every
    kernel instantiation in the library's SASS (`cuobjdump --dump-sass`):
    mma.sync compiles to HMMA, wgmma to HGMMA, a TMA load to UTMALDG."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", library], capture_output=True, text=True,
                          check=True).stdout
    found, entry = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            entry = kernel_name(fn.group(1))
            if entry.startswith("flash_"):
                found[entry] = {}
            continue
        op = re.search(r"\b(H(?:G)?MMA\S*|UTMALDG\S*)", line)
        if op and entry in found:
            found[entry][op.group(1)] = found[entry].get(op.group(1), 0) + 1
    return found


def main_shape_slots(fa, occupancy, sms):
    """Resident CTA slots (CTAs per SM x SMs) of each kernel at the main
    case's shape and tile, against its grid."""
    _, b, tq, tk, h, d, _, _ = next(c for c in CASES if c[0] == MAIN_CASE)
    per_sm = {(r["kernel"], r["d"], r["tile"]): r["ctas_per_sm"] for r in occupancy}
    rows = []
    for kname in fa.INSTANCES:
        tile = fa.launch_config(tq, tk, d, kname)
        length = tk if kname.startswith("flash_dkv") else tq  # K3 tiles the keys
        rows.append({"kernel": kname, "d": d, "tile": tile,
                     "slots": per_sm[(kname, d, tile)] * sms,
                     "grid": b * h * -(-length // tile)})
    return rows


def graph_ms(fn) -> float:
    """Median device ms of one call of `fn`: the port's one CUDA-graph timer,
    `profiling.device.graph_ms`, which profiling/fwd_wide_ab.py times with
    too (imported here, once main() has put the port on the path)."""
    from shockwave_tpu_torch.profiling.device import graph_ms as timer
    return timer(fn)


def make_mask(kind, b, tk, gen, device):
    if kind is None:
        return None
    mask = torch.ones(b, tk, dtype=torch.bool, device=device)
    if kind == "key0":
        mask[:, 0] = False
    else:  # "tail": keep a random prefix of at least half the keys
        lengths = torch.randint(tk // 2, tk + 1, (b,), generator=gen, device=device)
        mask = torch.arange(tk, device=device)[None, :] < lengths[:, None]
    return mask


def visible_rows(mask, b, h, tq, tk, causal, device):
    """(BH, Tq) bool: rows that see at least one key."""
    keys = mask if mask is not None else torch.ones(b, tk, dtype=torch.bool, device=device)
    keys = keys.repeat_interleave(h, dim=0)
    if causal:
        seen = torch.cumsum(keys.int(), dim=1) > 0  # row i sees a key <= i
        return seen[:, :tq]
    return keys.any(dim=1, keepdim=True).expand(-1, tq)


def visible_scores(mask, b, h, tq, tk, causal, device):
    """The (q, k) scores that this mask and causality leave visible, over
    all (batch, head) pairs: the exponentials K1, K2 and K3 each need."""
    keys = mask if mask is not None else torch.ones(b, tk, dtype=torch.bool, device=device)
    if causal:  # row i sees the unmasked keys <= i
        return h * int(torch.cumsum(keys.int(), dim=1)[:, :tq].sum())
    return h * tq * int(keys.sum())


def work(b, tq, tk, h, d, causal, esize=2, visible=None):
    """Bytes each kernel must move (each input read once, each output
    written once; q, k, v, dO and the outputs of `esize` bytes), the FLOPs
    it must do at this shape (the causal kernels need only the (q, k)
    pairs with k <= q), and the exponentials it must take: one per visible
    score (`visible`, from the mask; by default every causal or full
    pair) in each of K1, K2 and K3, none in delta."""
    bh = b * h
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    exps = bh * pairs if visible is None else visible
    q_bytes, kv_bytes = bh * tq * d * esize, bh * tk * d * esize
    row_bytes, mask_bytes = bh * tq * 4, b * tk
    return {
        "flash_bwd_delta": (2 * q_bytes + row_bytes, 2 * bh * tq * d, 0),
        "flash_fwd": (2 * q_bytes + 2 * kv_bytes + row_bytes + mask_bytes,
                      4 * bh * pairs * d, exps),
        "flash_dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes + mask_bytes,
                     6 * bh * pairs * d, exps),
        "flash_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes + mask_bytes,
                      8 * bh * pairs * d, exps),
    }


def max_abs(a, b, rows=None):
    diff = (a.float() - b.float()).abs()
    if rows is not None:
        diff = diff[rows]
    return float(diff.max()) if diff.numel() else 0.0


def max_rel(a, b):
    return max_abs(a, b) / max(float(b.float().abs().max()), 1e-30)


def kernel_case(fa, case, seed, device, rates, dtype=torch.bfloat16):
    """One shape through K1-K3's `dtype` instance against the plain
    versions on the same inputs: errors (checked against the dtype's
    tolerances), the time of each kernel and of its plain version, its
    bound at `rates` (bytes/s, FLOP/s of the dtype's products, the name
    the operations bound goes by, and exponentials/s), and the
    library's."""
    name, b, tq, tk, h, d, causal, mask_kind = case
    gen = torch.Generator(device=device).manual_seed(seed)
    bh, scale = b * h, 1.0 / math.sqrt(d)
    f32 = dtype == torch.float32

    def randn(t):
        return torch.randn(bh, t, d, generator=gen, device=device).to(dtype)

    q, k, v, g = randn(tq), randn(tk), randn(tk), randn(tq)
    mask = make_mask(mask_kind, b, tk, gen, device)
    args = (mask, h, scale, causal)

    out, lse = fa.attention_forward(q, k, v, *args)
    out_p, lse_p = fa.attention_forward_plain(q, k, v, *args)
    delta = (out.float() * g.float()).sum(dim=-1)
    bwd = (g, lse, delta) + args
    dq = fa.attention_dq(q, k, v, *bwd)
    dq_p = fa.attention_dq_plain(q, k, v, *bwd)
    dk, dv = fa.attention_dkv(q, k, v, *bwd)
    dk_p, dv_p = fa.attention_dkv_plain(q, k, v, *bwd)
    torch.cuda.synchronize()

    # The model's layout: the same numbers as (B, T, H, D) tensors, handed
    # over as their (B, H, T, D) views as `flash_attention` hands them;
    # every output must come out bit for bit as from the packed tensors.
    def model(x):
        return x.view(b, h, -1, d).transpose(1, 2).contiguous().transpose(1, 2)

    qm, km, vm, gm = map(model, (q, k, v, g))
    out_m, lse_m = fa.attention_forward(qm, km, vm, *args)
    dq_m = fa.attention_dq(qm, km, vm, gm, lse, delta, *args)
    dk_m, dv_m = fa.attention_dkv(qm, km, vm, gm, lse, delta, *args)
    delta_k = fa.attention_delta(out, g, h)
    delta_m = fa.attention_delta(model(out), gm, h)
    torch.cuda.synchronize()
    same = torch.equal(lse_m, lse) and torch.equal(delta_m, delta_k) and all(
        torch.equal(x.reshape(bh, -1, d), y)
        for x, y in ((out_m, out), (dq_m, dq), (dk_m, dk), (dv_m, dv)))
    check(same, f"{name}: the model's layout gives other bits than packed tensors")
    delta_scale = float((out.float() * g.float()).abs().sum(-1).max())
    delta_err = max_abs(delta_k, delta) / max(delta_scale, 1e-30)
    check(delta_err <= DELTA_TOL, f"{name}: delta kernel error {delta_err} (relative)")

    rows = visible_rows(mask, b, h, tq, tk, causal, device)
    errs = {"fwd_max_abs": max_abs(out, out_p, rows), "lse_max_abs": max_abs(lse, lse_p, rows),
            "dq_max_rel": max_rel(dq, dq_p), "dk_max_rel": max_rel(dk, dk_p),
            "dv_max_rel": max_rel(dv, dv_p), "dq_max_abs": max_abs(dq, dq_p),
            "dkv_max_abs": max(max_abs(dk, dk_p), max_abs(dv, dv_p)),
            "delta_max_abs": max_abs(delta_k, delta), "delta_max_rel": delta_err,
            "layouts_bit_identical": same}
    for t in (out, lse, dq, dk, dv):
        check(bool(torch.isfinite(t.float()).all()), f"{name}: non-finite kernel output")
    fwd_tol, lse_tol, grad_tol = (F32_TOL,) * 3 if f32 else (FWD_TOL, LSE_TOL, GRAD_TOL)
    check(errs["fwd_max_abs"] <= fwd_tol, f"{name}: forward error {errs['fwd_max_abs']}")
    check(errs["lse_max_abs"] <= lse_tol, f"{name}: lse error {errs['lse_max_abs']}")
    for key in ("dq_max_rel", "dk_max_rel", "dv_max_rel"):
        check(errs[key] <= grad_tol, f"{name}: {key} {errs[key]}")
    if mask_kind == "key0":
        zero = all(float(t[:, 0].abs().max()) == 0.0 for t in (dq, dk, dv))
        check(zero, f"{name}: the row that sees no key leaks gradient")
        errs["row0_grads_zero"] = zero

    bw, flops_peak, ops_name, exps_peak = rates
    times = {
        "flash_fwd": (graph_ms(lambda: fa.attention_forward(q, k, v, *args)),
                      graph_ms(lambda: fa.attention_forward_plain(q, k, v, *args))),
        "flash_dq": (graph_ms(lambda: fa.attention_dq(q, k, v, *bwd)),
                     graph_ms(lambda: fa.attention_dq_plain(q, k, v, *bwd))),
        "flash_dkv": (graph_ms(lambda: fa.attention_dkv(q, k, v, *bwd)),
                      graph_ms(lambda: fa.attention_dkv_plain(q, k, v, *bwd))),
    }
    record = {"case": name, "shape": [b, tq, tk, h, d], "causal": causal, "dtype": str(dtype),
              "mask": mask_kind, **errs, "kernels": {}, "by_kernel": {}}
    if name in DELTA_TIMED:  # in the model's layout, as the backward runs it
        times["flash_bwd_delta"] = (graph_ms(lambda: fa.attention_delta(out_m, gm, h)),
                                    graph_ms(lambda: fa.attention_delta_plain(out_m, gm)))
    seen = visible_scores(mask, b, h, tq, tk, causal, device)
    for kname, (nbytes, flops, exps) in work(b, tq, tk, h, d, causal, q.element_size(),
                                             seen).items():
        if kname not in times:
            continue
        bounds = {"bytes": nbytes / bw * 1e3, ops_name: flops / flops_peak * 1e3,
                  "exp": exps / exps_peak * 1e3}
        iname = (fa.DELTA + fa.KERNEL_DTYPES[dtype] if kname == fa.DELTA
                 else fa.instance(kname, dtype, d, tq, tk))
        record["by_kernel"][kname] = iname
        record["kernels"][iname] = {
            "ms": times[kname][0], "plain_ms": times[kname][1],
            "bound_ms": max(bounds.values()), "bound_by": max(bounds, key=bounds.get),
            "ops_bound_ms": bounds[ops_name], "exp_bound_ms": bounds["exp"],
            "bytes": nbytes, "flops": flops, "exps": exps,
            "tile": None if kname == fa.DELTA else fa.launch_config(tq, tk, d, iname)}
    if name in DELTA_TIMED:
        # torch.linalg.vecdot computes the same row sums in one call, in
        # f32 for f32 inputs (in bf16 its sums come out rounded to bf16,
        # not the same function).
        record["delta_library_ms"] = (graph_ms(lambda: torch.linalg.vecdot(out_m, gm)) if f32
                                      else None)
    (record["library_fwd_ms"], record["library_fwd_bwd_ms"],
     record["library_backend"]) = library_ms(q, k, v, g, mask, b, h, tq, tk, d, causal)
    # SDPA's backward, the one call that computes dQ, dK and dV: the
    # yardstick of K2 + K3 together.
    record["library_bwd_ms"] = record["library_fwd_bwd_ms"] - record["library_fwd_ms"]
    record["library_bwd_by"] = "fwd_bwd - fwd"
    record["flash_fwd_bwd_ms"] = flash_fwd_bwd_ms(fa, q, k, v, g, mask, b, h, tq, tk, d, causal)
    return record


def library_ms(q, k, v, g, mask, b, h, tq, tk, d, causal):
    """`scaled_dot_product_attention` forward, and forward + backward, on
    the same inputs in (B, H, T, D) layout, and the backend its own
    dispatch picks for them (`torch._fused_sdp_choice`, with inputs that
    need gradients)."""
    return sdpa_ms(*(t.view(b, h, -1, d) for t in (q, k, v, g)), mask, causal)


def sdpa_ms(q4, k4, v4, g4, mask, causal):
    """`library_ms` on (B, H, T, D) tensors or views as they are."""
    from torch.nn.attention import SDPBackend
    import torch.nn.functional as F
    b, _, tq, _ = q4.shape
    tk = k4.shape[2]
    attn_mask = None
    if mask is not None:
        attn_mask = mask[:, None, None, :].expand(b, 1, tq, tk)
        if causal:
            attn_mask = attn_mask & torch.ones(tq, tk, dtype=torch.bool,
                                               device=q4.device).tril()
    is_causal = causal and mask is None

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask,
                                              is_causal=is_causal)

    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask,
                                             is_causal=is_causal)
        return torch.autograd.grad(out, (qg, kg, vg), g4)

    names = {int(getattr(SDPBackend, n)): n for n in dir(SDPBackend) if n.isupper()}
    backend = names.get(torch._fused_sdp_choice(qg, kg, vg, attn_mask, 0.0, is_causal),
                        "unknown")
    return graph_ms(fwd), graph_ms(fwd_bwd), backend


def flash_fwd_bwd_ms(fa, q, k, v, g, mask, b, h, tq, tk, d, causal):
    """The port's autograd path (K1, delta, K2, K3) in (B, T, H, D) layout."""
    q4, k4, v4, g4 = (t.view(b, h, -1, d).transpose(1, 2) for t in (q, k, v, g))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

    def fwd_bwd():
        out = fa.flash_attention(qg, kg, vg, causal=causal, key_padding_mask=mask)
        return torch.autograd.grad(out, (qg, kg, vg), g4)

    return graph_ms(fwd_bwd)


def model_layout_case(fa, case, seed, device):
    """Forward + backward of `case` (bf16) through `flash_attention` on the
    model's own (B, T, H, D) tensors, as the Transformer calls it: its
    device kernels counted under torch.profiler (MODEL_LAYOUT_COUNTED:
    exactly K1, delta, K2 and K3, one launch each, nothing else), and its
    time beside SDPA's forward + backward on the same tensors' (B, H, T,
    D) views."""
    from torch.autograd import DeviceType
    name, b, tq, tk, h, d, causal, mask_kind = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=device).to(torch.bfloat16)
                  for t in (tq, tk, tk, tq))
    mask = make_mask(mask_kind, b, tk, gen, device)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        out = fa.flash_attention(qg, kg, vg, causal=causal, key_padding_mask=mask)
        return torch.autograd.grad(out, (qg, kg, vg), g)

    fwd_bwd()
    torch.cuda.synchronize()
    record = {"case": name, "shape": [b, tq, tk, h, d], "causal": causal, "mask": mask_kind}
    if name in MODEL_LAYOUT_COUNTED:
        fa.reset_launch_counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fwd_bwd()
            torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        check_launches(fa, launches, 1, f"model layout: {name}", width=d, t=max(tq, tk))
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        families = sorted(next((f for f in ("flash_bwd_delta", "flash_fwd", "flash_dq",
                                             "flash_dkv") if f in n), n) for n in kernels)
        check(families == ["flash_bwd_delta", "flash_dkv", "flash_dq", "flash_fwd"],
              f"model layout: {name} ran {len(kernels)} device kernels, not K1, delta, K2 "
              f"and K3 once each: {kernels}")
        record.update({"device_kernels": len(kernels), "kernel_names": kernels})
    fwd, fwd_bwd_lib, backend = sdpa_ms(*(t.transpose(1, 2) for t in (q, k, v, g)), mask, causal)
    record.update({"fwd_bwd_ms": graph_ms(fwd_bwd), "library_fwd_bwd_ms": fwd_bwd_lib,
                   "library_fwd_ms": fwd, "library_backend": backend})
    return record


def padded_case(fa, case, seed, device):
    """One head dim that the kernels are not built for (a `PADDED_CASES`
    entry), forward + backward through `flash_attention`, which pads it
    to `kernel_head_dim(d)` and slices the output back: one launch of each
    kernel of the dtype's instance, and the output and gradients against
    the plain versions at the original d on the same inputs, with the
    dtype's tolerances. Times: the port's forward + backward at d, at the
    padded width on inputs of that width, and SDPA's at d."""
    name, b, tq, tk, h, d, causal, mask_kind = case
    dtype = torch.float32 if name.endswith("_f32") else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=device).to(dtype)
                  for t in (tq, tk, tk, tq))
    mask = make_mask(mask_kind, b, tk, gen, device)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    width = fa.kernel_head_dim(d)
    fa.reset_launch_counts()
    out = fa.flash_attention(qg, kg, vg, causal=causal, key_padding_mask=mask)
    dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), g)
    launches = dict(fa.LAUNCHES)
    torch.cuda.synchronize()
    check_launches(fa, launches, 1, name, dtype, width=width, t=max(tq, tk))
    out = out.detach()

    def bhtd(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d).contiguous()

    args = (mask, h, 1.0 / math.sqrt(d), causal)
    qp, kp, vp, gp = map(bhtd, (q, k, v, g))
    out_p, lse_p = fa.attention_forward_plain(qp, kp, vp, *args)
    # delta from the port's own output, as its backward forms it.
    bwd = (gp, lse_p, (bhtd(out).float() * gp.float()).sum(-1)) + args
    dq_p = fa.attention_dq_plain(qp, kp, vp, *bwd)
    dk_p, dv_p = fa.attention_dkv_plain(qp, kp, vp, *bwd)
    rows = visible_rows(mask, b, h, tq, tk, causal, device)
    errs = {"fwd_max_abs": max_abs(bhtd(out), out_p, rows), "dq_max_rel": max_rel(bhtd(dq), dq_p),
            "dk_max_rel": max_rel(bhtd(dk), dk_p), "dv_max_rel": max_rel(bhtd(dv), dv_p)}
    for t in (out, dq, dk, dv):
        check(bool(torch.isfinite(t.float()).all()), f"{name}: non-finite output")
    fwd_tol, grad_tol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (FWD_TOL, GRAD_TOL)
    check(errs["fwd_max_abs"] <= fwd_tol, f"{name}: forward error {errs['fwd_max_abs']}")
    for key in ("dq_max_rel", "dk_max_rel", "dv_max_rel"):
        check(errs[key] <= grad_tol, f"{name}: {key} {errs[key]}")

    wide = [torch.randn(b * h, t, width, generator=gen, device=device).to(dtype)
            for t in (tq, tk, tk, tq)]
    library_fwd, library_fwd_bwd, _ = library_ms(qp, kp, vp, gp, mask, b, h, tq, tk, d, causal)
    return {"case": name, "shape": [b, tq, tk, h, d], "padded_to": width, "causal": causal,
            "dtype": str(dtype), "mask": mask_kind, **errs, "launches": launches,
            "flash_fwd_bwd_ms": flash_fwd_bwd_ms(fa, qp, kp, vp, gp, mask, b, h, tq, tk, d,
                                                 causal),
            "padded_width_fwd_bwd_ms": flash_fwd_bwd_ms(fa, *wide, mask, b, h, tq, tk, width,
                                                        causal),
            "library_fwd_ms": library_fwd, "library_fwd_bwd_ms": library_fwd_bwd}


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self._streams = streams

    def write(self, s):
        for stream in self._streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self._streams:
            stream.flush()


def run_main(module, argv):
    """`module.main(argv)` with its stdout teed; returns (trainer, stdout)."""
    captured = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
        trainer = module.main(argv)
    return trainer, captured.getvalue()


def steps_per_s(trainer):
    (t_a, s_a), (t_b, s_b) = trainer.throughput_marks[0], trainer.throughput_marks[-1]
    return (s_b - s_a) / (t_b - t_a)


def slice_phase(fa, train, device):
    from shockwave_tpu_torch.models import data
    from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer
    ckpt = tempfile.mkdtemp(prefix="swt_chip_smoke_")
    try:
        argv = ["-batch_size", str(BATCH), "-step", str(STEPS), "-proj_share_weight", "--use_flash",
                "--checkpoint_dir", ckpt, "--throughput_estimation_interval", "10"]
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.time()
        trainer = train.main(argv)
        wall = time.time() - t0
        launches = dict(fa.LAUNCHES)
        check_launches(fa, launches, 18 * STEPS, "slice")
        first = float(trainer.first_metrics["loss"])
        last = float(trainer.last_metrics["loss"])
        check(math.isfinite(first) and math.isfinite(last), "slice: non-finite loss")
        check(last < first, f"slice: loss did not fall ({first} -> {last})")
        gsq = float(trainer.last_metrics["grad_norm_sq"])
        check(math.isfinite(gsq), "slice: non-finite grad_norm_sq")
        rate = steps_per_s(trainer)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        resumed, out = run_main(train, argv[:3] + [str(STEPS + 1)] + argv[4:])
        check(f"TRAINED 1 steps (cumulative {STEPS + 1})" in out,
              "slice: the resume did not train exactly one step from the checkpoint")

        src, tgt = next(iter(data.multi30k(BATCH, tgt_len=33)))
        src = torch.as_tensor(src, device=device).long()
        tgt = torch.as_tensor(tgt, device=device).long()[:, :-1]
        einsum = Seq2SeqTransformer(use_flash=False).to(device)
        einsum.load_state_dict(resumed.model.state_dict())
        with torch.no_grad():
            logits_flash = resumed.model(src, tgt)
            logits_einsum = einsum(src, tgt)
        logits_err = max_abs(logits_flash, logits_einsum)
        check(bool(torch.isfinite(logits_flash).all()), "slice: non-finite logits")
        check(logits_err <= LOGITS_TOL, f"slice: flash vs einsum logits differ by {logits_err}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"steps": STEPS, "batch": BATCH, "wall_s": wall, "loss_first": first,
            "loss_last": last, "grad_norm_sq_last": gsq, "steps_per_s": rate,
            "tgt_tokens_per_s": rate * TGT_TOKENS_PER_STEP,
            "peak_mem_gib": peak_gib, "launches": launches,
            "logits_flash_vs_einsum_max_abs": logits_err}


class StandInScheduler:
    """The scheduler's side of WorkerToScheduler and IteratorToScheduler
    on loopback, from the port's `rpc.generic_handler`: it grants each
    job `grants[job_id] = (first lease, cap)` in steps, extends a lease
    by 10 steps per renewal up to the cap, takes batch-size requests, and
    records every call with its arrival time."""

    def __init__(self, rpc, pb, grants):
        import grpc
        from concurrent import futures
        self._pb, self.grants, self.calls = pb, grants, []
        self.done = {}
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self.server.add_generic_rpc_handlers((
            rpc.generic_handler("shockwave_tpu.IteratorToScheduler", {
                "InitJob": self._init_job, "UpdateLease": self._update_lease,
                "UpdateResourceRequirement": self._update_resource_requirement}),
            rpc.generic_handler("shockwave_tpu.WorkerToScheduler", {
                "RegisterWorker": self._register, "Done": self._done}),
        ))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def _init_job(self, req, ctx):
        self.calls.append((time.time(), "InitJob", req.job_id))
        return self._pb.InitJobResponse(max_steps=self.grants[req.job_id][0],
                                        max_duration=1e6, extra_time=0.0)

    def _update_lease(self, req, ctx):
        self.calls.append((time.time(), "UpdateLease", req.job_id, req.steps,
                           req.max_steps, list(req.measured_reports)))
        return self._pb.UpdateLeaseResponse(
            max_steps=min(req.max_steps + 10, self.grants[req.job_id][1]),
            max_duration=req.max_duration, run_time_so_far=0.0, deadline=1e9)

    def _update_resource_requirement(self, req, ctx):
        self.calls.append((time.time(), "UpdateResourceRequirement", req.job_id,
                           req.big_bs, req.small_bs))
        return self._pb.Empty()

    def _register(self, req, ctx):
        return self._pb.RegisterWorkerResponse(success=True, worker_ids=[0],
                                               round_duration=60.0)

    def _done(self, req, ctx):
        self.calls.append((time.time(), "Done", list(req.job_ids), req.worker_id,
                           list(req.num_steps)))
        self.done[req.job_ids[0]] = (time.time(), list(req.num_steps),
                                     list(req.execution_times))
        return self._pb.Empty()

    def dones(self, job_id):
        """(worker id, steps) of every Done for `job_id`, in arrival order."""
        return [(c[3], c[4][0]) for c in self.calls if c[1] == "Done" and c[2] == [job_id]]

    def first(self, method, job_id):
        return next(c for c in self.calls if c[1] == method and c[2] == job_id)


def lease_dispatch(fa, train, standin, ckpt, round_id, steps):
    """One in-process dispatch of the full-width trainer under a lease;
    returns (trainer, stdout, the iterator log, launches)."""
    os.environ.update(SWTPU_JOB_ID="0", SWTPU_WORKER_ID="0",
                      SWTPU_ROUND_ID=str(round_id), SWTPU_SCHED_ADDR="127.0.0.1",
                      SWTPU_SCHED_PORT=str(standin.port))
    argv = ["-batch_size", str(BATCH), "-step", str(steps), "-proj_share_weight",
            "--use_flash", "--enable_lease_iterator", "--checkpoint_dir", ckpt,
            "--throughput_estimation_interval", "5"]
    fa.reset_launch_counts()
    trainer, out = run_main(train, argv)
    launches = dict(fa.LAUNCHES)
    with open(os.path.join(ckpt, ".swtpu", f"round={round_id}", "worker=0.log")) as f:
        log = f.read()
    return trainer, out, log, launches


def http_get(port, path):
    """(status, body) of a GET on the loopback."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read().decode()


def trace_readings(trace_dir, sender):
    """The daemon leg's fleet trace: the worker's and the trainer's span
    shards in `trace_dir`, read with the port's copy of the reference's
    shard reader. The chain runjob -> launch -> trainer -> ckpt-save must
    hang off the stand-in scheduler's RunJob context `sender`, with a
    done-report under the runjob span. Returns the trainer's start-up
    inside the dispatch (trainer.ts - launch.ts), the save's and the
    trainer span's lengths."""
    from shockwave_tpu_torch.obs.shard import discover_shards, load_shard
    shards = [load_shard(path) for path in discover_shards(trace_dir)]
    roles = sorted(s["role"] for s in shards if s is not None)
    check(roles == ["trainer", "worker"], f"trace: shards of roles {roles}")
    events = [dict(span, role=s["role"]) for s in shards for span in s["spans"]]
    named = {}
    for e in events:
        named.setdefault(e["name"], []).append(e)
    counts = {name: len(named.get(name, [])) for name in
              ("runjob", "launch", "trainer", "ckpt-load", "ckpt-save", "done-report")}
    check(all(counts[n] == 1 for n in ("runjob", "launch", "trainer", "done-report"))
          and counts["ckpt-save"] >= 1, f"trace: spans {counts}")
    runjob, launch, trainer, done = (named[n][0] for n in
                                     ("runjob", "launch", "trainer", "done-report"))
    save = named["ckpt-save"][-1]
    links = {"runjob": (runjob["parent_id"], sender.span_id),
             "launch": (launch["parent_id"], runjob["span_id"]),
             "trainer": (trainer["parent_id"], launch["span_id"]),
             "ckpt-save": (save["parent_id"], trainer["span_id"]),
             "done-report": (done["parent_id"], runjob["span_id"])}
    broken = {name: link for name, link in links.items() if link[0] != link[1]}
    check(not broken, f"trace: broken parent links {broken}")
    traces = {e["trace_id"] for e in (runjob, launch, trainer, save, done)}
    check(traces == {sender.trace_id}, f"trace: trace ids {traces}, not {sender.trace_id}")
    check(trainer["role"] == "trainer" and launch["role"] == "worker",
          "trace: the trainer span is not in the trainer's shard")
    check(trainer["args"]["steps"] == DAEMON_STEPS and launch["args"]["steps"] == DAEMON_STEPS,
          f"trace: the spans count {trainer['args']['steps']} / {launch['args']['steps']} "
          f"steps, not {DAEMON_STEPS}")
    return {"shards": roles, "spans": counts, "chain": ["runjob", "launch", "trainer",
                                                        "ckpt-save"],
            "trainer_start_s": trainer["ts"] - launch["ts"],
            "ckpt_save_ms": save["dur"] * 1e3, "trainer_ms": trainer["dur"] * 1e3,
            "launch_ms": launch["dur"] * 1e3, "send_to_runjob_ms":
            (runjob["ts"] - runjob["args"]["send_ts"]) * 1e3}


def lease_phase(fa, train):
    import atexit

    import grpc
    from shockwave_tpu_torch.models import train_common
    from shockwave_tpu_torch.obs import names as obs_names
    from shockwave_tpu_torch.obs import propagation
    from shockwave_tpu_torch.runtime import clients, rpc
    from shockwave_tpu_torch.runtime.proto import control_pb2 as pb
    from shockwave_tpu_torch.runtime.worker import WorkerDaemon

    standin = StandInScheduler(rpc, pb, {0: (LEASE_GRANT, LEASE_CAP),
                                         1: (DAEMON_STEPS, DAEMON_STEPS)})
    renewal_s, save_s = [], []
    real_update_lease = clients.IteratorToSchedulerClient.update_lease
    real_save = train_common.save_checkpoint

    def timed_update_lease(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = real_update_lease(self, *args, **kwargs)
        renewal_s.append(time.perf_counter() - t0)
        return out

    def timed_save(path, state):
        t0 = time.perf_counter()
        real_save(path, state)
        save_s.append(time.perf_counter() - t0)

    ckpt = tempfile.mkdtemp(prefix="swt_chip_lease_")
    work = tempfile.mkdtemp(prefix="swt_chip_daemon_")
    # The daemon binds this process's span shard, which flushes at exit
    # (LIFO: before this removal runs).
    trace_dir = tempfile.mkdtemp(prefix="swt_chip_trace_")
    atexit.register(shutil.rmtree, trace_dir, True)
    launched = []
    real_popen = subprocess.Popen

    class RecordingPopen(real_popen):
        def __init__(self, args, **kwargs):
            super().__init__(args, **kwargs)
            launched.append((self, kwargs.get("env") or {}))

    clients.IteratorToSchedulerClient.update_lease = timed_update_lease
    train_common.save_checkpoint = timed_save
    saved_env = dict(os.environ)
    try:
        # 1. In process: expiry at the renewed lease's end, then a resume.
        trainer, out, log, launches = lease_dispatch(fa, train, standin, ckpt, 0, STEPS)
        renewals = [c for c in standin.calls if c[1] == "UpdateLease"]
        check(any(c[4] == LEASE_GRANT for c in renewals),
              f"lease: no renewal of the {LEASE_GRANT}-step lease arrived: {standin.calls}")
        check(trainer.step == LEASE_CAP and f"TRAINED {LEASE_CAP} steps (cumulative {LEASE_CAP})" in out,
              f"lease: the lease did not stop the job at exactly step {LEASE_CAP}")
        check(f"[LEASE] [EXPIRED] {LEASE_CAP} / {LEASE_CAP} steps" in log,
              "lease: the iterator did not log its expiry at the granted step")
        progress = re.findall(r"\[PROGRESS\] \[STEPS\] (\d+)", log)
        check(progress and int(progress[-1]) == LEASE_CAP,
              f"lease: last [PROGRESS] [STEPS] is {progress[-1:]}, not {LEASE_CAP}")
        path = train_common.checkpoint_path(ckpt)
        check(os.path.exists(path), "lease: no checkpoint at lease expiry")
        ckpt_bytes = os.path.getsize(path)
        check_launches(fa, launches, 18 * LEASE_CAP, "lease")
        lease_steps_per_s = steps_per_s(trainer)
        check(math.isfinite(float(trainer.last_metrics["loss"])), "lease: non-finite loss")

        rest = STEPS - LEASE_CAP
        standin.grants[0] = (rest, rest)
        resumed, out, log, resumed_launches = lease_dispatch(fa, train, standin, ckpt, 1, STEPS)
        check(f"TRAINED {rest} steps (cumulative {STEPS})" in out and resumed.step == STEPS,
              f"lease: the second dispatch did not resume at {LEASE_CAP} and end at {STEPS}")
        check_launches(fa, resumed_launches, 18 * rest, "lease: the resumed dispatch")
        del trainer, resumed
        torch.cuda.empty_cache()

        # 2. The worker daemon dispatches the trace's command to the
        # card, with fleet tracing and /metrics on: the stand-in sends
        # its RunJob under a span context of its own.
        subprocess.Popen = RecordingPopen
        for key in list(os.environ):
            if key.startswith("SWTPU_"):
                del os.environ[key]
        workloads = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "shockwave_tpu_torch", "workloads")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            worker_port = sock.getsockname()[1]
        daemon = WorkerDaemon(
            worker_type="h100", sched_addr="127.0.0.1", sched_port=standin.port,
            worker_port=worker_port, num_chips=1,
            run_dirs={mode: workloads for mode in ("static", "accordion", "gns", "serving")},
            data_dir=os.path.join(work, "data"), checkpoint_dir=os.path.join(work, "ckpt"),
            trace_dir=trace_dir, obs_port=0)
        sender = propagation.new_root_context()
        try:
            job = pb.JobDescription(
                job_id=1, command=("python3 train.py -data %s/translation/"
                                   f"multi30k.atok.low.pt -batch_size {BATCH} -proj_share_weight"),
                working_directory="translation", needs_data_dir=True,
                num_steps_arg="-step", num_steps=DAEMON_STEPS, mode="static")
            with grpc.insecure_channel(f"127.0.0.1:{worker_port}") as channel:
                t_runjob = time.time()
                rpc.Stub(channel, "shockwave_tpu.SchedulerToWorker").RunJob(
                    pb.RunJobRequest(jobs=[job], worker_id=0, round_id=0), timeout=30,
                    metadata=propagation.rpc_metadata(sender, send_ts=t_runjob))
            deadline = time.time() + 600
            while 1 not in standin.done and time.time() < deadline:
                time.sleep(0.2)
            obs_port = daemon._obs_server.port
            metrics = http_get(obs_port, "/metrics")
            health = http_get(obs_port, "/healthz")
        finally:
            daemon._shutdown()
            daemon.join()
        check(1 in standin.done, "lease: the daemon's job reported no Done in 600 s")
        t_done, done_steps, done_times = standin.done[1]
        trainers = [(p, env) for p, env in launched if "train.py" in str(p.args)]
        check(len(trainers) == 1, f"lease: {len(trainers)} trainer processes launched, not 1")
        proc, env = trainers[0]
        check(env.get("CUDA_VISIBLE_DEVICES") == "0",
              f"lease: the trainer ran with CUDA_VISIBLE_DEVICES={env.get('CUDA_VISIBLE_DEVICES')}")
        check(proc.returncode == 0, f"lease: the trainer exited {proc.returncode}")
        check(done_steps == [DAEMON_STEPS] and done_times[0] > 0,
              f"lease: Done reported {done_steps} steps in {done_times} s, not {DAEMON_STEPS}")
        t_init = standin.first("InitJob", 1)[0]
        sample = f"{obs_names.WORKER_JOBS_DISPATCHED_TOTAL.name} 1"
        check(metrics[0] == 200 and sample in metrics[1].splitlines(),
              f"trace: /metrics answered {metrics[0]} without '{sample}'")
        health_json = json.loads(health[1])
        check(health[0] == 200 and health_json["status"] == "ok"
              and health_json["worker_type"] == "h100" and health_json["worker_ids"] == [0],
              f"trace: /healthz answered {health}")
        traced = trace_readings(trace_dir, sender)
        traced.update(runjobs_sent=1, metrics_sample=sample, healthz=health_json)
    finally:
        subprocess.Popen = real_popen
        clients.IteratorToSchedulerClient.update_lease = real_update_lease
        train_common.save_checkpoint = real_save
        os.environ.clear()
        os.environ.update(saved_env)
        standin.server.stop(grace=0)
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    return {"expired_at": LEASE_CAP, "resumed_to": STEPS, "renewals": len(renewals),
            "launches": launches, "resumed_launches": resumed_launches,
            "steps_per_s": lease_steps_per_s, "renewal_rtt_s": renewal_s,
            "checkpoint_save_s": save_s, "checkpoint_bytes": ckpt_bytes,
            "daemon_job": {"steps": done_steps[0], "execution_time_s": done_times[0],
                           "cuda_visible_devices": env["CUDA_VISIBLE_DEVICES"],
                           "returncode": proc.returncode,
                           "runjob_to_initjob_s": t_init - t_runjob,
                           "runjob_to_done_s": t_done - t_runjob},
            "trace": traced}


def families_phase(fa):
    import importlib
    from shockwave_tpu_torch.models import train_common
    results = {}
    for family, (module_name, head) in FAMILIES.items():
        module = importlib.import_module(f"shockwave_tpu_torch.workloads.{module_name}")
        batch = module.MAX_BS
        ckpt = tempfile.mkdtemp(prefix=f"swt_chip_{family}_")
        try:
            argv = head(str(batch))
            tail = ["--checkpoint_dir", ckpt, "--throughput_estimation_interval", "5"]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            t0 = time.time()
            trainer, _ = run_main(module, argv + [str(FAMILY_STEPS)] + tail)
            wall = time.time() - t0
            launches = dict(fa.LAUNCHES)
            check(not any(launches.values()),
                  f"families: {family} launched flash kernels {launches}")
            first = float(trainer.first_metrics["loss"])
            last = float(trainer.last_metrics["loss"])
            check(math.isfinite(first) and math.isfinite(last), f"families: {family} non-finite loss")
            check(last < first, f"families: {family} loss did not fall ({first} -> {last})")
            rate = steps_per_s(trainer)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            ckpt_bytes = os.path.getsize(train_common.checkpoint_path(ckpt))
            del trainer
            resumed, out = run_main(module, argv + [str(FAMILY_STEPS + 1)] + tail)
            check(f"TRAINED 1 steps (cumulative {FAMILY_STEPS + 1})" in out
                  and resumed.step == FAMILY_STEPS + 1,
                  f"families: {family} resume did not train exactly one step")
            del resumed
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        results[family] = {"batch": batch, "steps": FAMILY_STEPS, "wall_s": wall,
                           "steps_per_s": rate, "samples_per_s": rate * batch,
                           "peak_mem_gib": peak_gib, "checkpoint_bytes": ckpt_bytes,
                           "loss_first": first, "loss_last": last, "resumed_to": FAMILY_STEPS + 1}
    torch.cuda.empty_cache()
    for family in OWN_LOOP_FAMILIES:
        results[family] = own_loop_family(fa, family)
    return results


def conv_macs(model, images):
    """Multiply-accumulates of one forward of a CycleGAN model on
    `images`, counted from its convolutions' shapes."""
    from shockwave_tpu_torch.models.cyclegan import Conv, ConvTranspose
    macs = [0]

    def count(module, inputs, out):
        if isinstance(module, ConvTranspose):
            b, cin, h, w = inputs[0].shape
            macs[0] += b * h * w * cin * module.weight.shape[1] * 9
        else:
            b, cout, h, w = out.shape
            macs[0] += b * h * w * cout * module.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, ConvTranspose))]
    with torch.no_grad():
        model(images)
    for hook in hooks:
        hook.remove()
    return macs[0]


def cyclegan_step_flops(job, batch, size):
    """FLOPs of one CycleGAN step: the generator step runs 6 generator
    forwards and their backward (input and weight gradients, twice a
    forward), 2 discriminator forwards and their input-gradient backward;
    the discriminator step runs 4 discriminator forwards and their
    backward: 18 generator and 16 discriminator forward-equivalents."""
    images = torch.zeros(batch, size, size, 3, device=job.device)
    g_macs, d_macs = (conv_macs(job.models[name], images) for name in ("g_ab", "d_a"))
    return 2 * (18 * g_macs + 16 * d_macs)


def own_loop_family(fa, family):
    """A3C or CycleGAN through its main (which drives the lease iterator
    itself), then a resume: finite losses, every model's parameters
    moved, exactly one more step; steps/s, peak memory, checkpoint bytes
    (and CycleGAN's FLOPs and MFU)."""
    import importlib
    from shockwave_tpu_torch.models import train_common
    from shockwave_tpu_torch.profiling.device import nvidia_smi, peaks
    module_name, head, steps = OWN_LOOP_FAMILIES[family]
    module = importlib.import_module(f"shockwave_tpu_torch.workloads.{module_name}")
    ckpt = tempfile.mkdtemp(prefix=f"swt_chip_{family}_")
    try:
        argv = [a.replace("%s", os.path.join(ckpt, "data")) for a in head]
        tail = ["--checkpoint_dir", ckpt, "--throughput_estimation_interval", "2"]
        fresh = module.build_job(argv + [str(steps)])[0]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.time()
        job, _ = run_main(module, argv + [str(steps)] + tail)
        wall = time.time() - t0
        launches = dict(fa.LAUNCHES)
        check(not any(launches.values()), f"families: {family} launched flash kernels {launches}")
        keys = ("loss",) if family == "a3c" else ("g_loss", "d_loss")
        losses = {f"{key}_{when}": float(metrics[key]) for key in keys
                  for when, metrics in (("first", job.first_metrics), ("last", job.last_metrics))}
        check(all(math.isfinite(v) for v in losses.values()), f"families: {family} losses {losses}")
        models = {"model": (job.model, fresh.model)} if family == "a3c" else {
            name: (job.models[name], fresh.models[name]) for name in job.models}
        moved = {name: max(float((p - q).abs().max()) for p, q in
                           zip(trained.state_dict().values(), start.state_dict().values()))
                 for name, (trained, start) in models.items()}
        check(all(m > 0 for m in moved.values()), f"families: {family} parameters did not move {moved}")
        rate = steps_per_s(job)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ckpt_bytes = os.path.getsize(train_common.checkpoint_path(ckpt))
        result = {"steps": steps, "wall_s": wall, "steps_per_s": rate, "peak_mem_gib": peak_gib,
                  "checkpoint_bytes": ckpt_bytes, "max_param_move": moved, **losses}
        if family == "cyclegan":
            flops = cyclegan_step_flops(fresh, 1, 128)
            result.update(batch=1, image=128, flops_per_step=flops,
                          mfu=flops * rate / peaks(nvidia_smi())[1][1])
        else:
            result.update(workers=4)
        del job, fresh
        resumed, out = run_main(module, argv + [str(steps + 1)] + tail)
        check(f"TRAINED 1 steps (cumulative {steps + 1})" in out and resumed.step == steps + 1,
              f"families: {family} resume did not train exactly one step")
        result["resumed_to"] = resumed.step
        del resumed
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return result


def decode_rate(fn, prompt, batches, tokens_per_request):
    """Generated tokens/s of `batches` request batches through `fn`,
    host clock, synced at the end, after one warm call."""
    fn(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        fn(prompt)
    torch.cuda.synchronize()
    return batches * prompt.shape[0] * tokens_per_request / (time.perf_counter() - t0)


def serving_phase(fa, device):
    from shockwave_tpu_torch.models.decoder import DecoderLM
    from shockwave_tpu_torch.runtime import rpc
    from shockwave_tpu_torch.runtime.proto import control_pb2 as pb
    from shockwave_tpu_torch.serving.measured import find_reports
    from shockwave_tpu_torch.workloads.serving import serve

    # 1. The trace's replica under a lease of SERVING_LEASE request batches.
    job_id = 6
    standin = StandInScheduler(rpc, pb, {job_id: (SERVING_LEASE, SERVING_LEASE)})
    ckpt = tempfile.mkdtemp(prefix="swt_chip_serving_")
    saved_env = dict(os.environ)
    try:
        os.environ.update(SWTPU_JOB_ID=str(job_id), SWTPU_WORKER_ID="0", SWTPU_ROUND_ID="0",
                          SWTPU_SCHED_ADDR="127.0.0.1", SWTPU_SCHED_PORT=str(standin.port))
        t0 = time.time()
        served, out = run_main(serve, SERVING_COMMAND + [
            "--num_steps", str(10**9), "--enable_lease_iterator", "--checkpoint_dir", ckpt])
        lease_s = time.time() - t0
        renewals = [c for c in standin.calls if c[1] == "UpdateLease" and c[2] == job_id]
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        standin.server.stop(grace=0)
        shutil.rmtree(ckpt, ignore_errors=True)
    check(served == SERVING_LEASE and f"SERVED {SERVING_LEASE} request batches" in out,
          f"serving: served {served} request batches under a lease of {SERVING_LEASE}")
    check("[REPLICA]\tcuda\tcuda_graph" in out, "serving: the replica did not run on cuda")
    deltas = find_reports([line for c in renewals for line in c[5]])
    samples = sum(d["sketch"]["n"] for d in deltas)
    check(bool(deltas) and samples > 0,
          f"serving: the renewals carried {len(deltas)} measured deltas, {samples} samples")

    # 2. The CUDA graph against eager mode, and decode tokens/s.
    decode, equal = {}, {}
    for batch in (1, 8):
        args = serve.build_parser().parse_args(SERVING_COMMAND + ["--batch_size", str(batch)])
        model, prompt = serve.build_model_and_prompt(args, device)
        tokens = args.tokens_per_request
        graphed = serve.GraphedRequestBatch(model, prompt, tokens)
        eager = serve.eager_request_batch(model, prompt, tokens)
        equal[batch] = bool(torch.equal(graphed(prompt), eager))
        check(equal[batch], f"serving: the CUDA graph's tokens differ from eager mode's at "
                            f"batch {batch}")
        for mode, fn in (("eager", lambda p: serve.eager_request_batch(model, p, tokens)),
                         ("graph", graphed)):
            decode[f"{mode}_b{batch}"] = decode_rate(fn, prompt, DECODE_BATCHES[mode], tokens)
        del graphed, model
    torch.cuda.empty_cache()

    # 3. The decoder's full forward with flash (K1) against its einsum path.
    b, t = DECODER_FLASH_SHAPE
    flash = DecoderLM(max_len=t, dtype=torch.bfloat16, use_flash=True).to(device)
    einsum = DecoderLM(max_len=t, dtype=torch.bfloat16).to(device)
    einsum.load_state_dict(flash.state_dict())
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, flash.vocab_size, (b, t), generator=gen, device=device)
    with torch.no_grad():
        fa.reset_launch_counts()
        logits_flash = flash(tokens)
        launches = dict(fa.LAUNCHES)
        logits_einsum = einsum(tokens)
    err = max_abs(logits_flash, logits_einsum)
    check(bool(torch.isfinite(logits_flash).all()) and err <= LOGITS_TOL,
          f"serving: decoder flash vs einsum logits differ by {err}")
    layers = len(flash.blocks)
    check_launches(fa, launches, layers, "serving: the decoder's bf16 flash forward",
                   kernels=("flash_fwd",), width=fa.kernel_head_dim(flash.dim // flash.num_heads),
                   t=t)
    long_tokens = torch.randint(0, flash.vocab_size, DECODER_LONG_SHAPE, generator=gen,
                                device=device)
    del flash, einsum
    return {"lease": {"served": served, "renewals": len(renewals), "deltas": len(deltas),
                      "samples": samples, "wall_s": lease_s},
            "graph_equals_eager": equal, "decode_tokens_per_s": decode,
            "tokens_per_request": SERVING_COMMAND[SERVING_COMMAND.index("--tokens_per_request") + 1],
            "decoder_flash": {"shape": [b, t], "logits_max_abs": err, "launches": launches},
            "decoder_flash_bf16": decoder_flash_grads(fa, device, tokens, torch.bfloat16),
            "decoder_flash_f32": decoder_flash_grads(fa, device, tokens),
            "decoder_flash_head_dim_16": {
                "bf16": decoder_flash_grads(fa, device, tokens, torch.bfloat16,
                                            **DECODER_PADDED_WIDTHS),
                "f32": decoder_flash_grads(fa, device, tokens, **DECODER_PADDED_WIDTHS)},
            "decoder_flash_head_dim_128": {
                "bf16": decoder_flash_grads(fa, device, tokens, torch.bfloat16,
                                            **DECODER_D128_WIDTHS),
                "f32": decoder_flash_grads(fa, device, tokens, **DECODER_D128_WIDTHS)},
            "decoder_flash_head_dim_256": {
                "bf16": decoder_flash_grads(fa, device, tokens, torch.bfloat16,
                                            **DECODER_D256_WIDTHS),
                "f32": decoder_flash_grads(fa, device, tokens, **DECODER_D256_WIDTHS)},
            "decoder_flash_head_dim_512": {
                "bf16": decoder_flash_grads(fa, device, tokens, torch.bfloat16,
                                            **DECODER_D512_WIDTHS),
                "f32": decoder_flash_grads(fa, device, tokens, **DECODER_D512_WIDTHS)},
            "decoder_flash_f32_long": {
                f"head_dim_{d}": decoder_flash_grads(fa, device, long_tokens, **widths)
                for d, widths in DECODER_LONG_WIDTHS.items()}}


def bench_line_phase(here, device):
    """The port's bench line on the card. `bench_serving_decode` at its
    defaults, in process, through its `--smoke` gate (BENCH_DECODE_FLOOR
    tokens/s, its default): exit 0, backend "gpu"; then its request batch
    (the replica's CUDA graph) against the eager batch on the same
    weights and prompt: the tokens must be equal. Then the headline as a
    subprocess with `--max_rounds HEADLINE_ROUNDS`: exit 0, no phase
    error, and the simulator's, bench_gpu's, the decode bench's and
    nvidia-smi's keys filled."""
    from shockwave_tpu_torch.profiling import bench_serving_decode, headline
    from shockwave_tpu_torch.workloads.serving import serve
    torch.cuda.empty_cache()
    t0 = time.time()
    captured = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
        rc = bench_serving_decode.main(["--smoke"])
    decode = json.loads(captured.getvalue().strip().splitlines()[-1])
    check(rc == 0 and decode["tokens_per_s"] >= BENCH_DECODE_FLOOR
          and decode["backend"] == "gpu",
          f"bench_line: bench_serving_decode --smoke exited {rc}: {decode}")
    args = bench_serving_decode.build_parser().parse_args([])
    graphed, model, prompt = bench_serving_decode.build_decode(args, device)
    equal = bool(torch.equal(graphed(prompt),
                             serve.eager_request_batch(model, prompt, args.tokens_per_request)))
    check(equal, "bench_line: the decode bench's graph tokens differ from the eager batch's")
    del graphed, model
    torch.cuda.empty_cache()
    decode_s = time.time() - t0

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "shockwave_tpu_torch.profiling.headline",
                           "--max_rounds", str(HEADLINE_ROUNDS)],
                          cwd=here, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else {}
    errors = {k: v for k, v in line.items() if k.endswith("_error")}
    check(proc.returncode == 0 and not errors and set(headline.KEYS) <= set(line),
          f"bench_line: the headline exited {proc.returncode}: {errors or proc.stderr[-2000:]}")
    for key in ("makespan", "unfair_fraction", "flagship_steps_per_s", "long_mfu",
                "attn_flash_ms", "serving_tokens_per_s_per_chip", "nvidia_smi"):
        check(line[key] is not None, f"bench_line: the headline's {key} is null")
    return {"decode": decode, "decode_graph_equals_eager": equal, "decode_s": decode_s,
            "headline": line, "headline_s": time.time() - t0}


def decoder_flash_grads(fa, device, tokens, dtype=torch.float32, **widths):
    """`DecoderLM` in `dtype` (f32, its default, unless given) at its
    default widths unless `widths` are given, with flash on, against its
    einsum path on the same weights and tokens: the logits, then the
    gradient of a next-token loss through K1-K3's `dtype` instances
    against the einsum path's. One launch of each per layer, and of no
    other instance."""
    from shockwave_tpu_torch.models.decoder import DecoderLM
    import torch.nn.functional as F
    t = tokens.shape[1]
    flash = DecoderLM(max_len=t, dtype=dtype, use_flash=True, **widths).to(device)
    einsum = DecoderLM(max_len=t, dtype=dtype, **widths).to(device)
    einsum.load_state_dict(flash.state_dict())

    def loss_and_grads(model):
        logits = model(tokens)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))
        loss.backward()
        return logits.detach(), {n: p.grad for n, p in model.named_parameters()}

    fa.reset_launch_counts()
    logits_flash, grads_flash = loss_and_grads(flash)
    launches = dict(fa.LAUNCHES)
    logits_einsum, grads_einsum = loss_and_grads(einsum)
    err = max_abs(logits_flash, logits_einsum)
    # Relative to the largest gradient entry of any parameter: the key
    # projections' biases have a zero gradient in exact arithmetic (a
    # softmax ignores a shift), so each path gives them rounding noise.
    scale = max(float(g.abs().max()) for g in grads_einsum.values())
    grad_err = max(max_abs(grads_flash[n], grads_einsum[n]) for n in grads_einsum) / scale
    logits_tol, grad_tol = ((DECODER_F32_TOL, DECODER_F32_TOL) if dtype == torch.float32
                            else (LOGITS_TOL, GRAD_TOL))
    what = f"serving: the {dtype} decoder {widths or ''}"
    check(bool(torch.isfinite(logits_flash).all()) and err <= logits_tol,
          f"{what}'s flash vs einsum logits differ by {err}")
    check(grad_err <= grad_tol,
          f"{what}'s flash vs einsum gradients differ by {grad_err} (relative)")
    head_dim = flash.dim // flash.num_heads
    check_launches(fa, launches, len(flash.blocks), f"{what}'s flash forward and backward",
                   dtype, width=fa.kernel_head_dim(head_dim), t=t)
    return {"shape": list(tokens.shape), "head_dim": head_dim,
            "logits_max_abs": err, "grad_max_rel": grad_err, "launches": launches}


def accordion_rule(epoch_norms, launch_bs, max_bs, threshold=0.5):
    """The first request `AccordionMonitor`'s rule makes on these epoch
    norms, as (epoch, (big_bs, small_bs)), or None."""
    for epoch in range(1, len(epoch_norms)):
        prev, cur = epoch_norms[epoch - 1], epoch_norms[epoch]
        critical = abs(prev - cur) / max(prev, 1e-12) > threshold
        if critical and launch_bs >= max_bs:
            return epoch + 1, (False, True)
        if not critical and launch_bs < max_bs:
            return epoch + 1, (True, False)
    return None


def adapt_dispatch(module, standin, ckpt, job_id, round_id, mode, argv, epoch=10**6):
    """One in-process leased dispatch in `mode` with `epoch`-batch
    synthetic epochs (by default none ends within the run)."""
    os.environ.update(SWTPU_JOB_ID=str(job_id), SWTPU_WORKER_ID="0",
                      SWTPU_ROUND_ID=str(round_id), SWTPU_SCHED_ADDR="127.0.0.1",
                      SWTPU_SCHED_PORT=str(standin.port), SWTPU_MODE=mode,
                      SWTPU_SYNTH_EPOCH_BATCHES=str(epoch))
    return run_main(module, argv + ["--enable_lease_iterator", "--checkpoint_dir", ckpt,
                                    "--throughput_estimation_interval", "5"])


def adapt_phase():
    from shockwave_tpu_torch.runtime import rpc
    from shockwave_tpu_torch.runtime.proto import control_pb2 as pb
    from shockwave_tpu_torch.workloads.image_classification.cifar10 import main as cifar10

    acc_job, gns_job = 2, 3
    standin = StandInScheduler(rpc, pb, {acc_job: (ADAPT_STEPS, ADAPT_STEPS),
                                         gns_job: (GNS_STEPS, GNS_STEPS)})
    ckpt = tempfile.mkdtemp(prefix="swt_chip_adapt_")
    saved_env = dict(os.environ)
    try:
        argv = ["--batch_size", str(ADAPT_BATCH), "--num_steps", str(ADAPT_STEPS)]
        trainer, out = adapt_dispatch(cifar10, standin, ckpt, acc_job, 0, "accordion", argv,
                                      epoch=ADAPT_EPOCH)
        norms = list(trainer.monitor.epoch_norms)
        expected = accordion_rule(norms, ADAPT_BATCH, cifar10.MAX_BS)
        requests = [c[3:] for c in standin.calls
                    if c[1] == "UpdateResourceRequirement" and c[2] == acc_job]
        stopped_at = trainer.step
        check(all(math.isfinite(n) for n in norms), f"adapt: non-finite epoch norms {norms}")
        # The lease iterator (the reference's, kept) counts the call that
        # ends a synthetic epoch as a step and yields no batch there: an
        # epoch of 10 trains 9 steps, and the 60-step lease ends after 6.
        if expected is None:
            check(requests == [] and len(norms) == ADAPT_STEPS // ADAPT_EPOCH,
                  f"adapt: the rule asks nothing on {norms}, but the port sent {requests}")
        else:
            epoch, request = expected
            check(requests == [request] and stopped_at == epoch * (ADAPT_EPOCH - 1),
                  f"adapt: the rule asks {request} after epoch {epoch} on {norms}; the port "
                  f"sent {requests} and stopped at step {stopped_at}")
        resumed = None
        if expected is not None and expected[1] == (True, False):
            # The scheduler redispatches at MAX_BS with a grant of its own.
            standin.grants[acc_job] = (ADAPT_RESUME, ADAPT_RESUME)
            budget = stopped_at + ADAPT_RESUME
            resumed, out = adapt_dispatch(
                cifar10, standin, ckpt, acc_job, 1, "accordion",
                ["--batch_size", str(cifar10.MAX_BS), "--num_steps", str(budget)])
            check(f"TRAINED {ADAPT_RESUME} steps (cumulative {budget})" in out
                  and resumed.step == budget,
                  f"adapt: the dispatch at batch {cifar10.MAX_BS} did not resume at "
                  f"{stopped_at} and end at {budget}")
            check(math.isfinite(float(resumed.last_metrics["loss"])),
                  "adapt: non-finite loss at the big batch")
        acc_rate = steps_per_s(trainer)
        resumed_rate = None if resumed is None else steps_per_s(resumed)
        del trainer, resumed

        shutil.rmtree(ckpt, ignore_errors=True)
        os.makedirs(ckpt)
        gns, out = adapt_dispatch(cifar10, standin, ckpt, gns_job, 0, "gns",
                                  ["--batch_size", str(ADAPT_BATCH),
                                   "--num_steps", str(GNS_STEPS)])
        gns_requests = [c for c in standin.calls
                        if c[1] == "UpdateResourceRequirement" and c[2] == gns_job]
        check(f"TRAINED {GNS_STEPS} steps (cumulative {GNS_STEPS})" in out and not gns_requests,
              f"adapt: the gns dispatch sent {gns_requests} or did not train {GNS_STEPS} steps")
        metrics = gns.last_metrics
        check(metrics["grad_norm_sq_small"] is metrics["grad_norm_sq"],
              "adapt: on one card the GNS small batch is the whole batch")
        gns_rate = steps_per_s(gns)
        del gns
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        standin.server.stop(grace=0)
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"accordion": {"batch": ADAPT_BATCH, "epoch_batches": ADAPT_EPOCH,
                          "epoch_mean_norms": norms,
                          "rule": None if expected is None else
                          {"after_epoch": expected[0], "big_bs": expected[1][0],
                           "small_bs": expected[1][1]},
                          "requests": requests, "stopped_at": stopped_at,
                          "resumed_at_batch": None if resumed_rate is None else cifar10.MAX_BS,
                          "steps_per_s": acc_rate, "big_batch_steps_per_s": resumed_rate},
            "gns": {"batch": ADAPT_BATCH, "steps": GNS_STEPS, "requests": len(gns_requests),
                    "steps_per_s": gns_rate}}


def ragged_tokens(b, t, vocab, gen, device):
    """(b, t) token ids in [1, vocab), each row padded with 0 past a
    random length of at least t / 2."""
    tokens = torch.randint(1, vocab, (b, t), generator=gen, device=device)
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
    return torch.where(torch.arange(t, device=device)[None, :] < lengths[:, None], tokens, 0)


def profile_phase(fa, device):
    from shockwave_tpu_torch.core.oracle import read_oracle
    from shockwave_tpu_torch.models.transformer import Seq2SeqTransformer
    from shockwave_tpu_torch.profiling import bench_gpu, measure_startup, measure_throughput

    # 1. The bench's long path, at full width.
    prefix = "transformer_long"
    fa.reset_launch_counts()
    long = bench_gpu.transformer_train_bench(batch=LONG_BATCH, steps=LONG_STEPS,
                                             seq=LONG_SEQ, prefix=prefix)
    launches = dict(fa.LAUNCHES)
    steps = long[f"{prefix}_steps_run"]
    check_launches(fa, launches, 18 * steps, f"profile: {steps} bench steps", t=LONG_SEQ)
    first, last = long[f"{prefix}_loss_first"], long[f"{prefix}_loss_last"]
    check(math.isfinite(first) and math.isfinite(last), "profile: non-finite bench loss")
    check(last < first, f"profile: the bench loss did not fall ({first} -> {last})")
    check(long[f"{prefix}_mfu"] > 0, f"profile: MFU {long[f'{prefix}_mfu']}")
    torch.cuda.empty_cache()

    # 2. Flash against einsum logits at T = 2048, sources ragged-padded.
    gen = torch.Generator(device=device).manual_seed(0)
    flash = Seq2SeqTransformer(use_flash=True, max_len=LONG_SEQ).to(device)
    einsum = Seq2SeqTransformer(use_flash=False, max_len=LONG_SEQ).to(device)
    einsum.load_state_dict(flash.state_dict())
    vocab = flash.shared_embedding.num_embeddings
    src = ragged_tokens(LONG_BATCH, LONG_SEQ, vocab, gen, device)
    tgt = torch.randint(1, vocab, (LONG_BATCH, LONG_SEQ), generator=gen, device=device)
    with torch.no_grad():
        logits_flash = flash(src, tgt)
        logits_einsum = einsum(src, tgt)
    logits_err = max_abs(logits_flash, logits_einsum)
    check(bool(torch.isfinite(logits_flash).all()), "profile: non-finite T = 2048 logits")
    check(logits_err <= LOGITS_TOL,
          f"profile: flash vs einsum logits at T = {LONG_SEQ} differ by {logits_err}")
    padded = int((src == 0).sum())
    del flash, einsum, logits_flash, logits_einsum
    torch.cuda.empty_cache()

    # 3. The throughput oracle, one row per ported family; 4. one job
    # type's cold dispatch into the same file.
    work = tempfile.mkdtemp(prefix="swt_chip_profile_")
    try:
        oracle = os.path.join(work, "h100_throughputs.json")
        t0 = time.time()
        measure_throughput.main(["--output", oracle, "--only", *PROFILE_ROWS,
                                 "--scale_factors", "1", "--steps", str(PROFILE_STEPS),
                                 "--warmup", str(PROFILE_WARMUP)])
        oracle_s = time.time() - t0
        torch.cuda.empty_cache()
        t0 = time.time()
        measure_startup.main(["--oracle", oracle, "--families", STARTUP_JOB,
                              "--repeats", "1"])
        startup_s = time.time() - t0
        rows, meta = read_oracle(oracle)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rates = {key[0]: entry["null"] for key, entry in rows["h100"].items()}
    check(len(rates) == len(PROFILE_ROWS) and all(r > 0 for r in rates.values()),
          f"profile: oracle rates {rates}")
    overhead = meta["dispatch_overhead_s"]["h100"]
    check(overhead > 0, f"profile: dispatch overhead {overhead}")
    return {"bench_long": long, "launches": launches,
            "logits_flash_vs_einsum_max_abs": logits_err, "logits_shape": [LONG_BATCH, LONG_SEQ],
            "padded_src_tokens": padded, "oracle_rates": rates, "oracle_s": oracle_s,
            "dispatch_overhead_s": overhead,
            "dispatch_detail": meta["dispatch_overhead_detail"]["h100"]["per_family"],
            "startup_s": startup_s}


def gang_member(module_name, argv) -> int:
    """`--gang-member MODULE ARGS...`: one rank of a gang job, as the
    dispatcher launches it. The main (`shockwave_tpu_torch.workloads.
    MODULE`) builds its trainer from ARGS and runs its dispatch, with the
    launch counters set to 0 just before; then the rank prints one
    `GANG_MEMBER` JSON line: its backend and device, the steps it ran,
    its launches, its checkpoint writes, a SHA-256 of its model state,
    and the ms of one gradient all-reduce on its last gradients."""
    import hashlib
    import importlib
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shockwave_tpu_torch.models import train_common
    from shockwave_tpu_torch.ops import flash_attention as fa
    from shockwave_tpu_torch.parallel import mesh
    module = importlib.import_module(f"shockwave_tpu_torch.workloads.{module_name}")
    writes = []
    real_save = train_common.save_checkpoint
    train_common.save_checkpoint = lambda path, state: writes.append(path) or real_save(path, state)
    trainer = module.build_trainer(argv)
    fa.reset_launch_counts()
    steps = trainer.run()
    launches = dict(fa.LAUNCHES)
    digest = hashlib.sha256()
    for name, value in sorted(trainer.model.state_dict().items()):
        digest.update(name.encode())
        digest.update(value.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    grads = [p.grad for p in trainer.model.parameters() if p.requires_grad]
    extras = torch.tensor([0.0, 1.0, 0.0], device=trainer.device)
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_CALLS):
        trainer.allreduce_gradients(grads, extras.clone())
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) / ALLREDUCE_CALLS * 1e3
    metrics = trainer.last_metrics
    print("GANG_MEMBER " + json.dumps({
        "rank": trainer.rank, "n_dev": trainer.n_dev, "backend": mesh.backend(),
        "device": str(trainer.device), "steps": steps, "step": trainer.step,
        "launches": launches, "writes": len(writes), "state_sha256": digest.hexdigest(),
        "allreduce_ms": allreduce_ms,
        "grad_mb": sum(g.numel() * g.element_size() for g in grads) / 2**20,
        "steps_per_s": (steps_per_s(trainer) if len(trainer.throughput_marks) > 1 else None),
        "loss_last": float(metrics["loss"]),
        "grad_norm_sq_small": (float(metrics["grad_norm_sq_small"])
                               if "grad_norm_sq_small" in metrics else None)}), flush=True)
    return 0


def ring_inputs(device):
    """The ring check's global bf16 q, k, v and dO (B, T, H, D), from a
    seed on `device`."""
    gen = torch.Generator(device=device).manual_seed(7)
    return [torch.randn(*RING_SHAPE, generator=gen, device=device).to(torch.bfloat16)
            for _ in range(4)]


def ring_member(rank: int, port: int, path: str) -> int:
    """`--ring-member RANK PORT OUT`: one of RING_RANKS sp ranks on the
    card. It makes the global inputs from the seed, runs ring attention
    (causal) on its sequence shard forward and backward with the launch
    counters set to 0 just before, then RING_REPS timed repetitions, and
    saves its blocks of the output and gradients, its launches and the
    median ms."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from shockwave_tpu_torch.ops import flash_attention as fa
    from shockwave_tpu_torch.parallel.mesh import make_mesh, shard
    from shockwave_tpu_torch.parallel.ring_attention import ring_attention
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=RING_RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(sp=RING_RANKS)
        q, k, v, g = (shard(mesh, x, (None, "sp")).contiguous() for x in ring_inputs(device))

        def fwd_bwd():
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            out = ring_attention(qg, kg, vg, mesh, causal=True)
            grads = torch.autograd.grad(out, (qg, kg, vg), g)
            torch.cuda.synchronize()
            return out.detach(), grads

        fa.reset_launch_counts()
        out, (dq, dk, dv) = fwd_bwd()
        launches = {n: c for n, c in fa.LAUNCHES.items() if c}
        times = []
        for _ in range(RING_REPS):
            dist.barrier()
            t0 = time.perf_counter()
            fwd_bwd()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.save({"sp": mesh.index("sp"), "launches": launches,
                    "ms": statistics.median(times),
                    **{n: t.cpu() for n, t in (("out", out), ("dq", dq), ("dk", dk),
                                               ("dv", dv))}}, path)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(argv_of_rank, n, timeout):
    """n copies of this script, rank r with `argv_of_rank(r)`; waits for
    all, kills any left on a failure, and fails with a failed rank's
    output."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv_of_rank(r)],
                              cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, proc in enumerate(procs):
        check(proc.returncode == 0, f"rank {r} exited {proc.returncode}:\n{outs[r][-3000:]}")
    return outs


def parallel_phase(fa, device):
    """(a) `dryrun_multichip(DRYRUN_RANKS)` on the card (its ranks share
    it over gloo) against the same ranks on the CPU: the losses and the
    gathered updated parameters of both meshes' steps, and each rank's
    launches, which must be the f32 K1-K3's, one of each per ring step
    its schedule runs (sp rank i of n: i + 1, causal). (b) Ring
    attention over RING_RANKS sp ranks on the card at RING_SHAPE in bf16,
    causal, against one process's `flash_attention` on the whole
    sequence, and its forward + backward ms beside the one-process
    kernels' and SDPA's."""
    from shockwave_tpu_torch.parallel import dryrun
    t0 = time.time()
    card = dryrun.dryrun_multichip(DRYRUN_RANKS, device="cuda")
    card_s = time.time() - t0
    cpu = dryrun.dryrun_multichip(DRYRUN_RANKS, device="cpu")
    meshes = []
    for index in range(2):
        ref = cpu[0][index]
        loss_err = max(abs(r[index]["loss"] - ref["loss"]) / abs(ref["loss"]) for r in card)
        param_err = max(float(abs(r[index]["params"][n] - ref["params"][n]).max())
                        for r in card for n in ref["params"])
        check(loss_err <= DRYRUN_LOSS_TOL, f"parallel: mesh {index} loss differs by {loss_err}")
        check(param_err <= DRYRUN_PARAM_TOL,
              f"parallel: mesh {index} parameters differ by {param_err}")
        routed = all((r[index]["routing"][k] == ref["routing"][k]).all()
                     for r in card for k in ref["routing"])
        check(routed, f"parallel: mesh {index}'s MoE routing differs between card and CPU")
        sp = ref["mesh"]["sp"]
        launches = []
        for r in card:
            i = r[index]["coords"]["sp"]
            want = {n + "_f32": i + 1 for n in fa.KERNELS}  # causal: the blocks at or before i
            check(r[index]["launches"] == want,
                  f"parallel: mesh {index} sp rank {i} of {sp} launched "
                  f"{r[index]['launches']}, not {want}")
            launches.append({"coords": r[index]["coords"], "launches": r[index]["launches"]})
        meshes.append({"mesh": ref["mesh"], "loss": card[0][index]["loss"],
                       "cpu_loss": ref["loss"], "loss_rel_err": loss_err,
                       "param_max_abs_err": param_err, "launches": launches})

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    work = tempfile.mkdtemp(prefix="swt_chip_ring_")
    try:
        spawn_ranks(lambda r: ["--ring-member", str(r), str(port), os.path.join(work, f"{r}.pt")],
                    RING_RANKS, timeout=300)
        parts = sorted((torch.load(os.path.join(work, f"{r}.pt")) for r in range(RING_RANKS)),
                       key=lambda p: p["sp"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    b, t, h, d = RING_SHAPE
    for i, part in enumerate(parts):  # each rank's chunk of T / sp rows
        want = {fa.instance(n, torch.bfloat16, d, t // RING_RANKS, t // RING_RANKS): i + 1
                for n in fa.KERNELS}
        check(part["launches"] == want,
              f"parallel: ring sp rank {i} launched {part['launches']}, not {want}")
    got = {n: torch.cat([p[n] for p in parts], dim=1).to(device) for n in ("out", "dq", "dk", "dv")}
    q, k, v, g = ring_inputs(device)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), g)
    out = out.detach()
    errs = {"fwd_max_abs": max_abs(got["out"], out), "dq_max_rel": max_rel(got["dq"], dq),
            "dk_max_rel": max_rel(got["dk"], dk), "dv_max_rel": max_rel(got["dv"], dv)}
    check(errs["fwd_max_abs"] <= FWD_TOL, f"parallel: ring output error {errs['fwd_max_abs']}")
    for key in ("dq_max_rel", "dk_max_rel", "dv_max_rel"):
        check(errs[key] <= GRAD_TOL, f"parallel: ring {key} {errs[key]}")

    def bhtd(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    qb, kb, vb, gb = map(bhtd, (q, k, v, g))
    _, library_fwd_bwd, backend = library_ms(qb, kb, vb, gb, None, b, h, t, t, d, True)
    return {"dryrun": {"ranks": DRYRUN_RANKS, "card_s": card_s, "meshes": meshes},
            "ring": {"shape": list(RING_SHAPE), "sp": RING_RANKS, "dtype": "bf16",
                     "causal": True, **errs,
                     "launches": [p["launches"] for p in parts],
                     "fwd_bwd_ms": max(p["ms"] for p in parts),
                     "rank_fwd_bwd_ms": [p["ms"] for p in parts],
                     "one_process_fwd_bwd_ms": flash_fwd_bwd_ms(fa, qb, kb, vb, gb, None, b, h,
                                                                t, t, d, True),
                     "library_fwd_bwd_ms": library_fwd_bwd, "library_backend": backend}}


def gang_dispatch(dispatcher, standin, outputs, job, round_id):
    """Both ranks of `job` (a dispatcher job dict whose command lacks the
    rendezvous flags) through the dispatcher; waits for both `Done`s.
    Returns (the ranks' GANG_MEMBER records by rank, {worker id: Done
    steps}, the ranks' output)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    seen = len(standin.dones(job["job_id"]))
    outputs.clear()
    for rank in range(GANG_RANKS):
        command = (f"{job['command']} --coordinator 127.0.0.1:{port} "
                   f"--num_processes {GANG_RANKS} --process_id {rank}")
        dispatcher.dispatch_jobs([dict(job, command=command)], worker_id=rank,
                                 round_id=round_id)
    deadline = time.time() + 600
    while len(standin.dones(job["job_id"])) < seen + GANG_RANKS and time.time() < deadline:
        time.sleep(0.2)
    dones = dict(standin.dones(job["job_id"])[seen:])
    text = "\n".join(outputs)
    check(len(dones) == GANG_RANKS, f"gang: job {job['job_id']} reported {dones}:\n{text[-4000:]}")
    members = sorted((json.loads(line.split(" ", 1)[1]) for line in text.splitlines()
                      if line.startswith("GANG_MEMBER ")), key=lambda m: m["rank"])
    check([m["rank"] for m in members] == list(range(GANG_RANKS)),
          f"gang: job {job['job_id']}: no result from every rank:\n{text[-4000:]}")
    return members, dones, text


def check_gang_dispatch(fa, name, members, dones, text, steps, step, launches_per_step):
    """The checks every gang dispatch must pass (see the module docstring)."""
    for m in members:
        check(f"[GANG] rank {m['rank']} of {GANG_RANKS}: backend gloo, device cuda" in text
              and m["backend"] == "gloo" and m["device"].startswith("cuda"),
              f"gang: {name} rank {m['rank']} ran on {m['backend']} / {m['device']}")
        check(m["steps"] == steps and m["step"] == step,
              f"gang: {name} rank {m['rank']} ran {m['steps']} steps to {m['step']}, "
              f"not {steps} to {step}")
        check_launches(fa, m["launches"], launches_per_step * steps,
                       f"gang: {name} rank {m['rank']}")
    check(dones == {r: steps for r in range(GANG_RANKS)},
          f"gang: {name} Done reported {dones}, not {steps} from each rank")
    check([m["writes"] for m in members] == [1] + [0] * (GANG_RANKS - 1),
          f"gang: {name} checkpoint writes by rank {[m['writes'] for m in members]}")
    check(len({m["state_sha256"] for m in members}) == 1,
          f"gang: {name} ranks' states differ after {step} steps")


def gang_against_one_process(name, gang_ckpt, one, fresh, tol, gang_loss):
    """The gang's checkpoint against a one-process trainer `one` after the
    same steps; `fresh` is the model's initial state. Returns the errors."""
    from shockwave_tpu_torch.models import train_common
    state = train_common.load_checkpoint(gang_ckpt, torch.device("cuda"))["params"]
    want = one.model.state_dict()
    errs, moves, stats = [], [], 0.0
    for key, value in want.items():
        diff = (state[key].float() - value.float())
        if "running" in key:
            stats = max(stats, float(diff.abs().max()) / max(float(value.abs().max()), 1.0))
            continue
        errs.append(diff.flatten())
        moves.append((value.float() - fresh[key].to(value.device).float()).flatten())
    whole = float(torch.cat(errs).norm()) / float(torch.cat(moves).norm())
    loss = float(one.last_metrics["loss"])
    loss_rel = abs(gang_loss - loss) / abs(loss)
    check(math.isfinite(gang_loss) and loss_rel <= tol["loss"],
          f"gang: {name} loss {gang_loss} against one process's {loss}")
    check(whole <= tol["whole"], f"gang: {name} parameters {whole} of their movement "
                                 f"from the one-process run")
    if tol["stats"] is not None:
        check(stats <= tol["stats"], f"gang: {name} running statistics off by {stats}")
    return {"loss_rel": loss_rel, "whole_move_rel": whole, "stats_rel": stats,
            "one_process_steps_per_s": steps_per_s(one)}


def gang_phase(fa):
    from shockwave_tpu_torch.runtime import rpc
    from shockwave_tpu_torch.runtime.clients import WorkerToSchedulerClient
    from shockwave_tpu_torch.runtime.dispatcher import Dispatcher
    from shockwave_tpu_torch.runtime.proto import control_pb2 as pb
    from shockwave_tpu_torch.workloads.image_classification.cifar10 import main as cifar10
    from shockwave_tpu_torch.workloads.translation import train

    tr_job, rn_job = 4, 5
    total = GANG_CAP + GANG_RESUME
    standin = StandInScheduler(rpc, pb, {tr_job: (GANG_LEASE, GANG_CAP),
                                         rn_job: (GANG_RESNET_STEPS, GANG_RESNET_STEPS)})
    here = os.path.dirname(os.path.abspath(__file__))
    workloads = os.path.join(here, "shockwave_tpu_torch", "workloads")
    member = f"{sys.executable} {os.path.join(here, 'chip_smoke.py')} --gang-member"
    work = tempfile.mkdtemp(prefix="swt_chip_gang_")
    outputs = []
    real_popen = subprocess.Popen

    class RecordingPopen(real_popen):
        def communicate(self, *args, **kwargs):
            out, err = super().communicate(*args, **kwargs)
            outputs.append(out.decode(errors="replace"))
            return out, err

    # Two "chips" that are the one card: the smoke's own arrangement.
    dispatcher = Dispatcher(
        60.0, chip_ids=[0] * GANG_RANKS,
        worker_rpc_client=WorkerToSchedulerClient("127.0.0.1", standin.port),
        sched_addr="127.0.0.1", sched_port=standin.port,
        run_dirs={mode: workloads for mode in ("static", "accordion", "gns", "serving")},
        data_dir=os.path.join(work, "data"), checkpoint_dir=os.path.join(work, "ckpt"))
    saved_env = dict(os.environ)
    subprocess.Popen = RecordingPopen
    try:
        for key in list(os.environ):
            if key.startswith("SWTPU_"):
                del os.environ[key]
        transformer = dict(
            job_id=tr_job, working_directory="translation", needs_data_dir=True,
            command=(f"{member} translation.train -data %s/translation/multi30k.atok.low.pt "
                     f"-batch_size {BATCH} -proj_share_weight --throughput_estimation_interval 5"),
            num_steps_arg="-step", num_steps=total, mode="gns")
        t0 = time.time()
        first, dones, text = gang_dispatch(dispatcher, standin, outputs, transformer, 0)
        first_s = time.time() - t0
        check_gang_dispatch(fa, "transformer", first, dones, text, GANG_CAP, GANG_CAP, 18)
        check(all(m["grad_norm_sq_small"] is not None for m in first)
              and len({m["grad_norm_sq_small"] for m in first}) == 1,
              f"gang: the ranks' GNS small norms differ: {first}")
        standin.grants[tr_job] = (GANG_RESUME, GANG_RESUME)
        t0 = time.time()
        resumed, dones, text = gang_dispatch(dispatcher, standin, outputs, transformer, 1)
        resume_s = time.time() - t0
        check_gang_dispatch(fa, "transformer resume", resumed, dones, text, GANG_RESUME, total, 18)
        resnet = dict(
            job_id=rn_job, working_directory="image_classification/cifar10",
            needs_data_dir=True,
            command=(f"{member} image_classification.cifar10.main --data_dir=%s/cifar10 "
                     f"--batch_size {GANG_RESNET_BATCH} --throughput_estimation_interval 2"),
            num_steps_arg="--num_steps", num_steps=GANG_RESNET_STEPS, mode="accordion")
        t0 = time.time()
        rn, dones, text = gang_dispatch(dispatcher, standin, outputs, resnet, 0)
        resnet_s = time.time() - t0
        check_gang_dispatch(fa, "resnet18", rn, dones, text, GANG_RESNET_STEPS, GANG_RESNET_STEPS, 0)

        # One process on the global batch, the same main and mode.
        ckpt = os.path.join(work, "one")
        os.environ["SWTPU_MODE"] = "gns"
        one, _ = run_main(train, ["-batch_size", str(BATCH), "-step", str(total),
                                  "-proj_share_weight", "--checkpoint_dir", ckpt,
                                  "--throughput_estimation_interval", "5"])
        fresh = train.Seq2SeqTransformer(generator=torch.Generator().manual_seed(0)).state_dict()
        tr_cmp = gang_against_one_process(
            "transformer", os.path.join(work, "ckpt", f"job_id={tr_job}", "model.ckpt"), one,
            fresh, GANG_TOL["transformer"], resumed[0]["loss_last"])
        del one
        torch.cuda.empty_cache()
        shutil.rmtree(ckpt, ignore_errors=True)
        os.environ["SWTPU_MODE"] = "accordion"
        one, _ = run_main(cifar10, ["--batch_size", str(GANG_RESNET_BATCH), "--num_steps",
                                    str(GANG_RESNET_STEPS), "--checkpoint_dir", ckpt,
                                    "--throughput_estimation_interval", "2"])
        fresh = cifar10.ResNet18(generator=torch.Generator().manual_seed(0)).state_dict()
        rn_cmp = gang_against_one_process(
            "resnet18", os.path.join(work, "ckpt", f"job_id={rn_job}", "model.ckpt"), one,
            fresh, GANG_TOL["resnet18"], rn[0]["loss_last"])
        del one
    finally:
        subprocess.Popen = real_popen
        os.environ.clear()
        os.environ.update(saved_env)
        dispatcher.shutdown()
        standin.server.stop(grace=0)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"ranks": GANG_RANKS, "backend": first[0]["backend"],
            "note": "two ranks share one card over gloo: nothing here measures a "
                    "two-card NCCL gang's speed",
            "transformer": {"global_batch": BATCH, "mode": "gns", "expired_at": GANG_CAP,
                            "resumed_to": total, "gang_steps_per_s": first[0]["steps_per_s"],
                            "allreduce_ms": [m["allreduce_ms"] for m in first],
                            "grad_mb": first[0]["grad_mb"], "launches": first[0]["launches"],
                            "dispatch_s": first_s, "resume_dispatch_s": resume_s,
                            "state_sha256": resumed[0]["state_sha256"], **tr_cmp},
            "resnet18": {"global_batch": GANG_RESNET_BATCH, "mode": "accordion",
                         "steps": GANG_RESNET_STEPS, "gang_steps_per_s": rn[0]["steps_per_s"],
                         "allreduce_ms": [m["allreduce_ms"] for m in rn],
                         "grad_mb": rn[0]["grad_mb"], "dispatch_s": resnet_s, **rn_cmp}}


def deployed_phase(here):
    """`measure_deployed` on DEPLOYED_FAMILY for DEPLOYED_ROUNDS rounds of
    DEPLOYED_ROUND_S against a temporary copy of the committed h100
    oracle, whose h100 shortfall and drain entries are removed first (its
    calibration record stays: it keeps the family's solo rate): the keys
    must come back with a new calibration record, at least one lease
    after round 0 must have been parsed, the deployed rate must be > 0
    and the lease shortfall within [0, round)."""
    from shockwave_tpu_torch.profiling import measure_deployed
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="swt_chip_deployed_")
    try:
        oracle = os.path.join(work, "h100_throughputs.json")
        with open(os.path.join(here, "data", "h100_throughputs.json")) as f:
            committed = json.load(f)
        for key in DEPLOYED_KEYS[:-1]:
            committed["__meta__"].get(key, {}).pop("h100", None)
        before = (committed["__meta__"].get("deployed_calibration", {}).get("h100", {})
                  .get("sf=1", {}).get("measured_at"))
        with open(oracle, "w") as f:
            json.dump(committed, f)
        measure_deployed.main(["--worker_type", "h100", "--oracle", oracle,
                               "--families", DEPLOYED_FAMILY,
                               "--round_duration", str(DEPLOYED_ROUND_S),
                               "--rounds", str(DEPLOYED_ROUNDS), "--timeout", "600"])
        with open(oracle) as f:
            written = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    meta = written["__meta__"]
    missing = [key for key in DEPLOYED_KEYS if "h100" not in meta.get(key, {})]
    check(not missing, f"deployed: measure_deployed did not write {missing}")
    record = meta["deployed_calibration"]["h100"]["sf=1"]
    detail = record["per_family"][DEPLOYED_FAMILY]
    rate = written["h100"][f"('{DEPLOYED_FAMILY}', 1)"]["null"]
    check(record["measured_at"] != before and detail["deployed_steps_per_s"] == rate,
          f"deployed: no new calibration record ({record['measured_at']}, {detail})")
    shortfall = meta["lease_shortfall_s_by_type"]["h100"][DEPLOYED_FAMILY]
    drain = meta["round_drain_s_by_type"]["h100"][DEPLOYED_FAMILY]
    check(detail["leases"] >= 1, f"deployed: no lease after round 0 was parsed ({detail})")
    check(rate > 0, f"deployed: rate {rate}")
    check(0 <= shortfall < DEPLOYED_ROUND_S,
          f"deployed: lease shortfall {shortfall} s outside [0, {DEPLOYED_ROUND_S})")
    return {"family": DEPLOYED_FAMILY, "rounds": DEPLOYED_ROUNDS,
            "round_s": DEPLOYED_ROUND_S, "deployed_steps_per_s": rate,
            "solo_steps_per_s": detail["solo_steps_per_s"], "leases": detail["leases"],
            "mean_lease_s": detail["mean_lease_s"], "lease_shortfall_s": shortfall,
            "round_drain_s": drain}


def kernel_rows(fa, cases, sliced, served, profiled):
    """The rows of the `{"kernels": [...]}` line: every kernel instance with
    its main-path launches, errors, times, bound and library time (see the
    module docstring), from the kernel cases' records (`cases`) and the
    slice's, serving phase's and profile phase's results."""
    kernels = []

    def ran(case, kname):
        """The record of the instance of kernel `kname` that ran at `case`."""
        return case["kernels"][case["by_kernel"][kname]]

    # Each dtype's row is timed at the shape its main-path launches come
    # from: the trainer's (bf16) and the f32 decoder's (f32), which runs
    # no f32 launch at the trainer's shape; the f32 rows give that shape
    # beside it. A row's bench and D = 128 / 256 bench fields are there
    # where the row's instance ran those cases (in bf16 K1-K3's long
    # tile is the TMA-fed instances', rows of their own below).
    for dtype, at_name, prefix, bench in (
            (torch.bfloat16, MAIN_CASE, "main_", "bench_causal"),
            (torch.float32, "decoder_f32", ("main_", "decoder_"), "bench_causal_f32")):
        suffix = fa.KERNEL_DTYPES[dtype]
        at_case = cases[at_name]
        main_cases = [c for n, c in cases.items()
                      if n.startswith(prefix) and c["dtype"] == str(dtype)]
        # The main path's launches: the slice (bf16), the f32 decoder's
        # forward and backward in the serving phase (f32).
        launched = (sliced["launches"] if dtype == torch.bfloat16
                    else served["decoder_flash_f32"]["launches"])
        widths = "bf16" if dtype == torch.bfloat16 else "f32"
        for kname, source_line in REPLACES.items():
            iname = kname + suffix
            k = at_case["kernels"][iname]
            row = {
                "name": iname, "route": "cuda",
                "source": "shockwave_tpu_torch/csrc/flash_attention.cu",
                "replaces": source_line, "launches": launched[iname],
                "max_abs_err": max(c[e] for c in main_cases for e in ERR_KEYS[kname]),
                "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"].split()[0],
                "library_ms": at_case["library_fwd_ms"] if kname == "flash_fwd" else None,
                "at": f"{at_name} {at_case['shape']}"}
            if cases[bench]["by_kernel"][kname] == iname:
                b64 = ran(cases[bench], kname)
                row.update({
                    "bench_ms": b64["ms"], "bench_bound_ms": b64["bound_ms"],
                    "bench_bound_by": b64["bound_by"],
                    "bench_library_ms": (cases[bench]["library_fwd_ms"] if kname == "flash_fwd"
                                         else None),
                    "bench_long_launches": profiled["launches"][iname]})
            if kname != "flash_fwd":  # K2 + K3's yardstick: SDPA's backward
                row.update({"library_bwd_ms": at_case["library_bwd_ms"],
                            "bench_library_bwd_ms": cases[bench]["library_bwd_ms"],
                            "library_bwd_of": "dQ, dK and dV (SDPA fwd_bwd - fwd)"})
            for dw, names in ((128, D128_CASES[suffix]), (256, D256_CASES[suffix])):
                main_w, bench_w = (cases[n] for n in names)
                kw = main_w["kernels"][iname]
                row.update({
                    f"d{dw}_at": f"{names[0]} {main_w['shape']}", f"d{dw}_tile": kw["tile"],
                    f"d{dw}_ms": kw["ms"], f"d{dw}_plain_ms": kw["plain_ms"],
                    f"d{dw}_bound_ms": kw["bound_ms"], f"d{dw}_bound_by": kw["bound_by"],
                    f"d{dw}_library_ms": (main_w["library_fwd_ms"] if kname == "flash_fwd"
                                          else None)})
                # The decoder at this head dim (serving phase), and the
                # instance its sequence length takes.
                dec = served[f"decoder_flash_head_dim_{dw}"][widths]
                dec_name = fa.instance(kname, dtype, dw, dec["shape"][1], dec["shape"][1])
                row.update({f"d{dw}_decoder_instance": dec_name,
                            f"d{dw}_decoder_launches": dec["launches"][dec_name]})
                if bench_w["by_kernel"][kname] == iname:
                    bw = ran(bench_w, kname)
                    row.update({
                        f"d{dw}_bench_tile": bw["tile"], f"d{dw}_bench_ms": bw["ms"],
                        f"d{dw}_bench_plain_ms": bw["plain_ms"],
                        f"d{dw}_bench_bound_ms": bw["bound_ms"],
                        f"d{dw}_bench_bound_by": bw["bound_by"],
                        f"d{dw}_bench_library_ms": (bench_w["library_fwd_ms"]
                                                    if kname == "flash_fwd" else None)})
            row["d256_library_backend"] = cases[D256_CASES[suffix][1]]["library_backend"]
            row["d256_max_abs_err"] = max(c[e] for n, c in cases.items()
                                          if n.startswith("d256_") and c["dtype"] == str(dtype)
                                          and c["by_kernel"][kname] == iname
                                          for e in ERR_KEYS[kname])
            d32 = cases["d32_bench_causal" + suffix]  # head dim 32's long tile
            k32 = ran(d32, kname)
            row.update({"d32_bench_at": f"d32_bench_causal{suffix} {d32['shape']}",
                        "d32_bench_instance": d32["by_kernel"][kname],
                        "d32_bench_tile": k32["tile"], "d32_bench_ms": k32["ms"],
                        "d32_bench_plain_ms": k32["plain_ms"],
                        "d32_bench_bound_ms": k32["bound_ms"],
                        "d32_bench_bound_by": k32["bound_by"],
                        "d32_bench_library_ms": (d32["library_fwd_ms"] if kname == "flash_fwd"
                                                 else None)})
            if kname != "flash_fwd":
                row["d32_bench_library_bwd_ms"] = d32["library_bwd_ms"]
            if dtype == torch.float32:
                main_case = cases[MAIN_CASE_F32]
                m = main_case["kernels"][kname + suffix]
                row.update({"main_at": f"{MAIN_CASE_F32} {main_case['shape']}",
                            "main_ms": m["ms"], "main_plain_ms": m["plain_ms"],
                            "main_bound_ms": m["bound_ms"],
                            "main_library_ms": (main_case["library_fwd_ms"]
                                                if kname == "flash_fwd" else None)})
            kernels.append(row)
    # The backward's delta kernel in bf16 and in f32: timed where its
    # dtype's main-path launches come from (the slice's trainer shape; the
    # f32 decoder's), and at its dtype's bench shape.
    for dtype, at_name, bench in ((torch.bfloat16, MAIN_CASE, "bench_causal"),
                                  (torch.float32, "decoder_f32", "bench_causal_f32")):
        iname = fa.DELTA + fa.KERNEL_DTYPES[dtype]
        at_case, bench_case = cases[at_name], cases[bench]
        k, b = at_case["kernels"][iname], bench_case["kernels"][iname]
        launched = (sliced["launches"] if dtype == torch.bfloat16
                    else served["decoder_flash_f32"]["launches"])
        kernels.append({
            "name": iname, "route": "cuda",
            "source": "shockwave_tpu_torch/csrc/flash_attention_delta.cu",
            "replaces": DELTA_REPLACES, "launches": launched[iname],
            "max_abs_err": max(c["delta_max_abs"] for c in cases.values()
                               if c["dtype"] == str(dtype)),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": at_case["delta_library_ms"],
            "library_of": "torch.linalg.vecdot (f32 in, f32 out)",
            "at": f"{at_name} {at_case['shape']}", "bench_ms": b["ms"],
            "bench_plain_ms": b["plain_ms"], "bench_bound_ms": b["bound_ms"],
            "bench_library_ms": bench_case["delta_library_ms"]})
    # The TMA-fed K1-K3 in bf16 and in f32: timed at the bench
    # shape of their dtype, and at the bench shape at D = 128 and 256; K2's
    # and K3's rows give K2 + K3 beside SDPA's backward at each D. Their
    # main-path launches: bf16, the profile phase's T = 2048 steps; f32, the
    # f32 decoder past the short tile at D = 64, 128 and 256 (serving phase).
    for name in fa.TMA_INSTANCES:
        f32 = name.endswith("_f32" + fa.TMA)
        sfx = "_f32" if f32 else ""
        kname = name.removesuffix(fa.TMA).removesuffix("_f32")
        bench = cases["bench_causal" + sfx]
        k = bench["kernels"][name]
        fwd = kname == "flash_fwd"
        launches = (sum(run["launches"][name]
                        for run in served["decoder_flash_f32_long"].values()) if f32
                    else profiled["launches"][name])
        row = {
            "name": name, "route": "cuda",
            "source": "shockwave_tpu_torch/csrc/flash_attention_tma" + sfx + ".cu",
            "replaces": REPLACES[kname], "launches": launches,
            "max_abs_err": max(c[e] for c in cases.values() if name in c["kernels"]
                               for e in ERR_KEYS[kname]),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"].split()[0],
            "library_ms": bench["library_fwd_ms"] if fwd else None,
            "at": f"bench_causal{sfx} {bench['shape']}", "tile": k["tile"],
            "cases": sorted(n for n, c in cases.items() if name in c["kernels"])}
        if not fwd:
            row.update({"library_bwd_ms": bench["library_bwd_ms"],
                        "library_bwd_of": "dQ, dK and dV (SDPA fwd_bwd - fwd)"})
        if f32:
            row["launches_by"] = "the f32 decoder at (8, 128), head dims 64, 128 and 256"
        if 32 in fa.TMA_HEAD_DIMS[name]:  # the bf16 decoder at head dim 32, forward + backward
            row["d32_decoder_launches"] = served["decoder_flash_bf16"]["launches"][name]
        for dw in (32, 64, 128, 256):
            if dw not in fa.TMA_HEAD_DIMS[name]:
                continue
            at = "" if dw == 64 else f"d{dw}_"
            bw_case = cases[at + "bench_causal" + sfx]
            if not fwd:
                bwd = [bw_case["kernels"][bw_case["by_kernel"][n]]["ms"]
                       for n in ("flash_dq", "flash_dkv")]
                row.update({at + "bench_k2_k3_ms": sum(bwd),
                            at + "bench_library_bwd_ms": bw_case["library_bwd_ms"]})
            if dw == 64:
                continue
            bw = bw_case["kernels"][name]
            row.update({f"d{dw}_bench_tile": bw["tile"], f"d{dw}_bench_ms": bw["ms"],
                        f"d{dw}_bench_plain_ms": bw["plain_ms"],
                        f"d{dw}_bench_bound_ms": bw["bound_ms"],
                        f"d{dw}_bench_bound_by": bw["bound_by"],
                        f"d{dw}_bench_library_ms": bw_case["library_fwd_ms"] if fwd else None})
        kernels.append(row)
    # The wide instances: timed at the main and bench shapes at D = 512;
    # their main-path launches are the d = 512 decoder's (serving phase).
    for dtype, widths in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        suffix = fa.KERNEL_DTYPES[dtype]
        at_case, bench_case = (cases[n] for n in D512_CASES[suffix])
        for kname, source_line in REPLACES.items():
            iname = fa.instance(kname, dtype, 512)
            k, b = at_case["kernels"][iname], bench_case["kernels"][iname]
            fwd = kname == "flash_fwd"
            kernels.append({
                "name": iname, "route": "cuda",
                "source": "shockwave_tpu_torch/csrc/flash_attention_wide.cu",
                "replaces": source_line,
                "launches": served["decoder_flash_head_dim_512"][widths]["launches"][iname],
                "max_abs_err": max(c[e] for n, c in cases.items()
                                   if n.startswith("d512_") and c["dtype"] == str(dtype)
                                   for e in ERR_KEYS[kname]),
                "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"].split()[0],
                "library_ms": at_case["library_fwd_ms"] if fwd else None,
                "at": f"{D512_CASES[suffix][0]} {at_case['shape']}", "tile": k["tile"],
                "bench_ms": b["ms"], "bench_plain_ms": b["plain_ms"],
                "bench_bound_ms": b["bound_ms"], "bench_bound_by": b["bound_by"],
                "bench_library_ms": bench_case["library_fwd_ms"] if fwd else None,
                "d768_max_abs_err": max(c[e] for n, c in cases.items()
                                        if n.startswith(("d768_", "d1280_"))
                                        and c["dtype"] == str(dtype) for e in ERR_KEYS[kname]),
                "library_backend": bench_case["library_backend"]})
            if not fwd:  # K2 + K3's yardstick: SDPA's backward
                kernels[-1].update({"library_bwd_ms": at_case["library_bwd_ms"],
                                    "bench_library_bwd_ms": bench_case["library_bwd_ms"],
                                    "library_bwd_of": "dQ, dK and dV (SDPA fwd_bwd - fwd)"})
    return kernels


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "shockwave_tpu_torch")):
        print(f"chip_smoke: the port (shockwave_tpu_torch/) is not beside this script in "
              f"{here}; run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from shockwave_tpu_torch.ops import _build
    from shockwave_tpu_torch.ops import flash_attention as fa
    from shockwave_tpu_torch.profiling.device import (F32_FLOPS, exp_rate, f32_product_flops,
                                                      max_sm_clock_hz, nvidia_smi, peaks)
    from shockwave_tpu_torch.workloads.translation import train

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    variant, rates = peaks(smi)
    f32_rate = f32_product_flops(smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()
    exps_rate = exp_rate(sms, clock_hz)
    emit("device", {"name": kind, "nvidia_smi": smi, "count": torch.cuda.device_count(),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "peaks_from": variant, "peak_bytes_per_s": rates[0],
                    "peak_bf16_flops": rates[1], "peak_f32_simt_flops": F32_FLOPS[variant],
                    "peak_f32_3xtf32_flops": f32_rate, "sms": sms, "max_sm_clock_hz": clock_hz,
                    "peak_exps_per_s": exps_rate})

    t0 = time.time()
    path = _build.build()
    _build.library()
    emit("build", {"seconds": time.time() - t0, "library": os.path.relpath(path)})
    log = _build.build_log()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    spilled = spills(log)
    emit("spills", spilled)
    for prefix in ("flash_fwd_tma_f32_kernel<", "flash_dq_tma_f32_kernel<",
                   "flash_dkv_tma_f32_kernel<", "flash_fwd_tma_kernel<32>",
                   "flash_dkv_tma_kernel<32>"):
        check(not any(name.startswith(prefix) for name in spilled),
              f"{prefix}: spills registers ({spilled})")
    hmma = sass_hmma(path)
    emit("sass", hmma)
    for kname in ("flash_fwd_f32_kernel", "flash_dq_f32_kernel", "flash_dkv_f32_kernel",
                  "flash_fwd_wide_kernel<float", "flash_dq_wide_f32_kernel",
                  "flash_dkv_wide_f32_kernel"):
        check(any(name.startswith(kname) for name in hmma), f"{kname}: not in the SASS")
        for name, ops in hmma.items():
            if name.startswith(kname):
                check(any("TF32" in op for op in ops), f"{name}: no TF32 HMMA in its SASS ({ops})")
    # Every wide kernel runs on wgmma: HGMMA, bf16 or TF32, in each of their
    # instances (K1's Q resident and streamed; K2's and K3's two tiles, in
    # bf16 the 64-row one with the A tiles resident and streamed, in f32
    # K2's for D a multiple of 512 and any D), and no HMMA.
    for prefix, operand, count in (("flash_fwd_wide_kernel<bf16", "BF16", 2),
                                   ("flash_fwd_wide_kernel<float", "TF32", 2),
                                   ("flash_dq_wide_kernel<bf16", "BF16", 3),
                                   ("flash_dkv_wide_kernel<bf16", "BF16", 3),
                                   ("flash_dq_wide_f32_kernel<", "TF32", 4),
                                   ("flash_dkv_wide_f32_kernel<", "TF32", 2)):
        found = {name: ops for name, ops in hmma.items() if name.startswith(prefix)}
        check(len(found) == count, f"{prefix}: {sorted(found)} in the SASS, not its {count} "
                                   f"instances")
        for name, ops in found.items():
            check(any(op.startswith("HGMMA") and operand in op for op in ops),
                  f"{name}: no {operand} HGMMA in its SASS ({ops})")
            check(not any(op.startswith("HMMA") for op in ops),
                  f"{name}: HMMA in its SASS ({ops})")
    # The TMA-fed K1-K3 in bf16, one instance per head dim of theirs (64,
    # 128 and 256; K1 and K3 at 32 too, on 64-byte rows): bf16 HGMMA fed
    # by UTMALDG, and no HMMA. The mma.sync K1-K3 keep only the short tile
    # there (K2 its long tile at D = 32).
    for kname in fa.KERNELS:
        prefix, dims = f"{kname}_tma_kernel<", fa.TMA_HEAD_DIMS[kname + fa.TMA]
        found = {name: ops for name, ops in hmma.items() if name.startswith(prefix)}
        check(sorted(found) == sorted(f"{prefix}{d}>" for d in dims),
              f"{prefix}: {sorted(found)} in the SASS, not one per head dim {dims}")
        for name, ops in found.items():
            check(any(op.startswith("HGMMA") and "F32.BF16" in op for op in ops)
                  and any(op.startswith("UTMALDG") for op in ops)
                  and not any(op.startswith("HMMA") for op in ops),
                  f"{name}: not bf16 HGMMA fed by UTMALDG without HMMA ({ops})")
        check(not any(f"{kname}_kernel<{d}, 64>" in hmma for d in dims),
              f"{kname}_kernel: a tile-64 instance at a TMA-fed head dim {dims} is still built")
    check("flash_dq_kernel<32, 64>" in hmma, "flash_dq_kernel<32, 64>: not in the SASS")
    # The TMA-fed K1-K3 in f32, one instance per head dim 64, 128 and 256:
    # TF32 HGMMA fed by UTMALDG, and no HMMA; the mma.sync K1-K3 in f32
    # keep only the short tile there (and D = 32).
    for kname in fa.KERNELS:
        prefix, dims = f"{kname}_tma_f32_kernel<", fa.TMA_HEAD_DIMS[kname + "_f32" + fa.TMA]
        found = {name: ops for name, ops in hmma.items() if name.startswith(prefix)}
        check(sorted(found) == sorted(f"{prefix}{d}>" for d in dims),
              f"{prefix}: {sorted(found)} in the SASS, not one per head dim {dims}")
        for name, ops in found.items():
            check(any(op.startswith("HGMMA") and "F32.TF32" in op for op in ops)
                  and any(op.startswith("UTMALDG") for op in ops)
                  and not any(op.startswith("HMMA") for op in ops),
                  f"{name}: not TF32 HGMMA fed by UTMALDG without HMMA ({ops})")
        check(not any(f"{kname}_f32_kernel<{d}, {tile}>" in hmma for d in dims
                      for tile in (32, 64)),
              f"{kname}_f32_kernel: a long-tile instance at D = 64-256 is still built")
    occupancy = fa.kernel_occupancy(torch.cuda.current_device())
    emit("occupancy", {"sms": sms, "kernels": occupancy,
                       "main_shape": main_shape_slots(fa, occupancy, sms)})
    for row in occupancy:
        check(row["ctas_per_sm"] > 0, f"{row['kernel']} d={row['d']} tile={row['tile']}: "
                                      f"no CTA fits on an SM")

    t0 = time.time()
    cases = {}
    for seed, case in enumerate(CASES):
        cases[case[0]] = kernel_case(fa, case, seed, device, (*rates, "operations", exps_rate))
        emit("kernel_case", cases[case[0]])
    for seed, case in enumerate(F32_CASES):
        cases[case[0]] = kernel_case(fa, case, seed, device,
                                     (rates[0], f32_rate, "operations (3xTF32)", exps_rate),
                                     torch.float32)
        emit("kernel_case", cases[case[0]])
    for seed, case in enumerate(PADDED_CASES):
        emit("padded_case", padded_case(fa, case, seed, device))
    emit("wide_head_dim", [padded_case(fa, case, seed, device)
                           for seed, case in enumerate(WIDE_HEAD_DIM_CASES)])
    kernel_s = time.time() - t0

    t0 = time.time()
    by_name = {c[0]: c for c in CASES}
    modeled = {name: model_layout_case(fa, by_name[name], seed, device)
               for seed, name in enumerate(MODEL_LAYOUT_CASES)}
    for name, record in modeled.items():
        record["packed_fwd_bwd_ms"] = cases[name]["flash_fwd_bwd_ms"]
    emit("model_layout", {"seconds": time.time() - t0, "nvidia_smi": smi, "cases": modeled})

    t0 = time.time()
    sliced = slice_phase(fa, train, device)
    sliced["seconds"] = time.time() - t0
    emit("slice", sliced)

    t0 = time.time()
    leased = lease_phase(fa, train)
    traced = leased.pop("trace")
    leased.update(seconds=time.time() - t0, slice_steps_per_s=sliced["steps_per_s"],
                  nvidia_smi=smi)
    emit("lease", leased)
    emit("trace", dict(traced, nvidia_smi=smi))

    t0 = time.time()
    fams = families_phase(fa)
    emit("families", {"seconds": time.time() - t0, "nvidia_smi": smi, **fams})

    t0 = time.time()
    adapted = adapt_phase()
    emit("adapt", {"seconds": time.time() - t0, "nvidia_smi": smi, **adapted})

    t0 = time.time()
    served = serving_phase(fa, device)
    emit("serving", {"seconds": time.time() - t0, "nvidia_smi": smi, **served})

    t0 = time.time()
    benched = bench_line_phase(here, device)
    emit("bench_line", {"seconds": time.time() - t0, "nvidia_smi": smi, **benched})

    t0 = time.time()
    profiled = profile_phase(fa, device)
    emit("profile", {"seconds": time.time() - t0, "nvidia_smi": smi, **profiled})

    t0 = time.time()
    ganged = gang_phase(fa)
    emit("gang", {"seconds": time.time() - t0, "nvidia_smi": smi, **ganged})

    t0 = time.time()
    deployed = deployed_phase(here)
    emit("deployed", {"seconds": time.time() - t0, "nvidia_smi": smi, **deployed})

    t0 = time.time()
    paralleled = parallel_phase(fa, device)
    emit("parallel", {"seconds": time.time() - t0, "nvidia_smi": smi, **paralleled})

    kernels = kernel_rows(fa, cases, sliced, served, profiled)
    main_case = cases[MAIN_CASE]
    # Forward + backward at D = 256 and 512 (the port's autograd path
    # against SDPA's, and the backend SDPA picked), by dtype and shape.
    wide_fwd_bwd = {
        name: {"fwd_bwd_ms": cases[name]["flash_fwd_bwd_ms"],
               "library_fwd_bwd_ms": cases[name]["library_fwd_bwd_ms"],
               "library_backend": cases[name]["library_backend"]}
        for cases_of in (D256_CASES, D512_CASES)
        for names in cases_of.values() for name in names}
    print(json.dumps({"kernels": kernels, "fwd_bwd_ms": main_case["flash_fwd_bwd_ms"],
                      "library_fwd_bwd_ms": main_case["library_fwd_bwd_ms"],
                      "model_layout_fwd_bwd": {
                          name: {key: r[key] for key in ("fwd_bwd_ms", "library_fwd_bwd_ms",
                                                         "packed_fwd_bwd_ms", "device_kernels")
                                 if key in r} for name, r in modeled.items()},
                      "d256_d512_fwd_bwd": wide_fwd_bwd,
                      "bench_line": {"decode_tokens_per_s_per_chip":
                                     benched["decode"]["tokens_per_s_per_chip"],
                                     "headline": benched["headline"]},
                      "parallel": {
                          "ring_fwd_bwd_ms": paralleled["ring"]["fwd_bwd_ms"],
                          "ring_one_process_fwd_bwd_ms":
                              paralleled["ring"]["one_process_fwd_bwd_ms"],
                          "ring_library_fwd_bwd_ms": paralleled["ring"]["library_fwd_bwd_ms"],
                          "ring_launches": paralleled["ring"]["launches"],
                          "dryrun_launches": [m["launches"]
                                              for m in paralleled["dryrun"]["meshes"]]},
                      "kernel_phase_s": kernel_s, "total_s": time.time() - t_start}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gang-member"]:
        sys.exit(gang_member(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--ring-member"]:
        sys.exit(ring_member(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
