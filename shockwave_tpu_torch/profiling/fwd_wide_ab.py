"""K1's wide instances (`flash_fwd_wide`, bf16 and f32) of several checkouts
of this repository, timed in turns on one card.

    python -m shockwave_tpu_torch.profiling.fwd_wide_ab \\
        --trees .archive_check/parent . . .archive_check/parent

The trees' kernel libraries are first built side by side, one process
per tree. Then each tree is run in a process of its own, in the order
given (parent, change, change, parent keeps a drift of the card out of
the comparison): the process imports that tree's `shockwave_tpu_torch.ops.flash_attention`,
builds its kernel library from the tree's sources, and runs each case
(`CASES`: the d = 512 main shape key-padded, the bench shape (4, 2048, 8,
512) causal, a ragged causal case at d = 768, in bf16 and f32) through
`attention_forward` against `attention_forward_plain` on the same inputs
(errors on the rows that see a key, checked against chip_smoke.py's
tolerances), timed as medians of CUDA-graph replays beside the plain
version and `scaled_dot_product_attention`'s forward. Only
`attention_forward` and `attention_forward_plain` are called, which every
checkout since the wide instances has. One JSON line per tree and case,
then the card's `nvidia-smi` name and power limit; with `--build_report`
also the compiler's lines and the SASS tensor-core mnemonics of each tree's
`flash_fwd_wide` instances. Exits 1 when a case misses its tolerance, 2
without a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys

# (name, B, T, H, D, causal, mask, dtype): mask "tail" keeps a random
# prefix of each sequence's keys.
CASES = (
    ("d512_main_enc_self", 64, 32, 8, 512, False, "tail", "bf16"),
    ("d512_bench_causal", 4, 2048, 8, 512, True, None, "bf16"),
    ("d768_ragged_causal", 2, 100, 4, 768, True, "tail", "bf16"),
    ("d512_main_enc_self_f32", 64, 32, 8, 512, False, "tail", "f32"),
    ("d512_bench_causal_f32", 4, 2048, 8, 512, True, None, "f32"),
    ("d768_ragged_causal_f32", 2, 100, 4, 768, True, "tail", "f32"),
)
# Builds the kernel library of the tree given as its argument.
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from shockwave_tpu_torch.ops import _build; _build.build()")
# Forward output and lse, max abs on the rows that see a key: chip_smoke.py's.
TOLS = {"bf16": (2e-2, 1e-3), "f32": (1e-4, 1e-4)}


def graph_ms(fn, inner: int = 20, reps: int = 7, replay_ms: float = 20.0) -> float:
    """Median device ms of one call of `fn` over CUDA-graph replays, as
    chip_smoke.py times its kernel cases."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    inner = max(1, min(inner, int(replay_ms / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times)


def sass_tensor_ops(library: str):
    """{"flash_fwd_wide_kernel<type>": {mnemonic: count}} of the HMMA and
    HGMMA instructions in the library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", library], capture_output=True, text=True,
                          check=True).stdout
    found, entry = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            k = re.search(r"flash_fwd_wide_kernelI(f|13__nv_bfloat16)", fn.group(1))
            entry = f"flash_fwd_wide_kernel<{'float' if k.group(1) == 'f' else 'bf16'}>" if k \
                else None
            if entry:
                found[entry] = {}
            continue
        op = re.search(r"\b(H(?:G)?MMA\S*)", line)
        if op and entry:
            found[entry][op.group(1)] = found[entry].get(op.group(1), 0) + 1
    return found


def run_tree(tree: str, build_report: bool, seed: int) -> int:
    """Every case on `tree`'s kernels; one JSON line each."""
    sys.path.insert(0, os.path.abspath(tree))
    import time

    import torch
    import torch.nn.functional as F
    from shockwave_tpu_torch.ops import _build
    from shockwave_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    path = _build.build()
    _build.library()
    if build_report:
        lines = [ln.strip() for ln in _build.build_log().splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln
                 or "arning" in ln]
        wide = [ln for i, ln in enumerate(lines) if "fwd_wide" in ln or "arning" in ln
                or (i and "fwd_wide" in lines[i - 1]) or (i > 1 and "fwd_wide" in lines[i - 2])]
        print(json.dumps({"tree": tree, "build_s": time.time() - t0, "ptxas": wide,
                          "sass": sass_tensor_ops(path)}), flush=True)
    device = torch.device("cuda")
    failed = 0
    for i, (name, b, t, h, d, causal, mask_kind, dt) in enumerate(CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device=device).manual_seed(seed + i)
        q, k, v = (torch.randn(b * h, t, d, generator=gen, device=device).to(dtype)
                   for _ in range(3))
        mask = None
        if mask_kind == "tail":
            lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
            mask = torch.arange(t, device=device)[None, :] < lengths[:, None]
        args = (mask, h, 1.0 / math.sqrt(d), causal)
        fa.reset_launch_counts()
        out, lse = fa.attention_forward(q, k, v, *args)
        launched = dict(fa.LAUNCHES)
        out_p, lse_p = fa.attention_forward_plain(q, k, v, *args)
        torch.cuda.synchronize()
        keys = mask if mask is not None else torch.ones(b, t, dtype=torch.bool, device=device)
        keys = keys.repeat_interleave(h, dim=0)
        rows = (torch.cumsum(keys.int(), 1) > 0) if causal else keys.any(1, keepdim=True).expand(
            -1, t)
        err = float((out.float() - out_p.float()).abs()[rows].max())
        lse_err = float((lse - lse_p).abs()[rows].max())
        tol, lse_tol = TOLS[dt]
        ok = (err <= tol and lse_err <= lse_tol and bool(torch.isfinite(out.float()).all())
              and launched.get(fa.instance("flash_fwd", dtype, d)) == 1)
        failed += not ok
        q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
        attn_mask = None
        if mask is not None:
            attn_mask = mask[:, None, None, :].expand(b, 1, t, t)
            if causal:
                attn_mask = attn_mask & torch.ones(t, t, dtype=torch.bool, device=device).tril()
        print(json.dumps({
            "tree": tree, "case": name, "shape": [b, t, h, d], "causal": causal, "dtype": dt,
            "ok": ok, "fwd_max_abs": err, "lse_max_abs": lse_err,
            "ms": graph_ms(lambda: fa.attention_forward(q, k, v, *args)),
            "plain_ms": graph_ms(lambda: fa.attention_forward_plain(q, k, v, *args)),
            "library_fwd_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=attn_mask, is_causal=causal and mask is None))}),
            flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", default=["."],
                        help="checkouts of the repository, run in this order")
    parser.add_argument("--build_report", action="store_true",
                        help="print each tree's ptxas lines and SASS tensor-core mnemonics "
                             "of flash_fwd_wide")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fwd_wide_ab: no CUDA device; this script times the card's kernels",
              file=sys.stderr)
        return 2
    if args.one:
        return run_tree(args.one, args.build_report, args.seed)
    builds = {tree: subprocess.Popen([sys.executable, "-c", BUILD, os.path.abspath(tree)])
              for tree in dict.fromkeys(args.trees)}
    rc = 0
    for tree, proc in builds.items():
        if proc.wait() != 0:
            print(f"fwd_wide_ab: {tree}'s kernels did not build", file=sys.stderr)
            rc = 1
    if rc:
        return rc
    for tree in args.trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree, "--seed",
               str(args.seed)] + (["--build_report"] if args.build_report else [])
        rc |= subprocess.run(cmd, check=False).returncode
    from shockwave_tpu_torch.profiling.device import nvidia_smi
    print(nvidia_smi(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
