"""The wide instances of K1-K3 (`flash_fwd_wide`, `flash_dq_wide`,
`flash_dkv_wide`, bf16 and f32) and the kernels at head dims 32-256 (the
TMA-fed K1-K3 in bf16 and in f32 on the long tile, where a tree has them)
of several checkouts of this repository, timed in turns on one card.

    python -m shockwave_tpu_torch.profiling.fwd_wide_ab \\
        --trees .archive_check/parent . . .archive_check/parent

K2's A/B at long sequences, K2 + K3 beside SDPA's backward:

    python -m shockwave_tpu_torch.profiling.fwd_wide_ab --kernels dq dkv \\
        --cases bench_causal d128_bench_causal d256_bench_causal main_enc_self \\
        --trees .archive_check/parent . . .archive_check/parent

At head dim 32, the bench shape and the main shape, with the model-layout
forward + backward (in f32: `d32_bench_causal_f32 head_dim_32_f32`):

    python -m shockwave_tpu_torch.profiling.fwd_wide_ab --kernels fwd dq dkv model \\
        --cases d32_bench_causal head_dim_32 \\
        --trees .archive_check/parent . . .archive_check/parent

The f32 K1-K3 at long sequences, K2 + K3 beside SDPA's backward (the f32
K3 alone: `--kernels dkv`):

    python -m shockwave_tpu_torch.profiling.fwd_wide_ab \\
        --cases bench_causal_f32 d128_bench_causal_f32 d256_bench_causal_f32 \\
        main_enc_self_f32 --trees .archive_check/parent . . .archive_check/parent

The port's attention as the model calls it (`--kernels model`):
`flash_attention`'s forward + backward on (B, T, H, D) tensors, beside
SDPA's on the same tensors' (B, H, T, D) views, with the device kernels one
such call runs, counted under torch.profiler; with K1-K3 alone beside:

    python -m shockwave_tpu_torch.profiling.fwd_wide_ab --kernels fwd dq dkv model \
        --cases main_enc_self bench_causal d128_bench_causal d256_bench_causal \
        --trees .archive_check/parent . . .archive_check/parent

The trees' kernel libraries are first built side by side, one process
per tree. Then each tree is run in a process of its own, in the order
given (parent, change, change, parent keeps a drift of the card out of
the comparison): the process imports that tree's
`shockwave_tpu_torch.ops.flash_attention`, builds its kernel library from
the tree's sources, and runs each case (`CASES`: the d = 512 main shape
key-padded, the bench shape (4, 2048, 8, 512) causal, a ragged causal
case at d = 768, in bf16 and f32; the bench shape (4, 2048, 8, D) causal at
D = 64, 128 and 256 and the main shape (64, 32, 8, 64) key-padded, in
bf16 and in f32; the bench shape and the main shape (2, 128, 4, 32)
key-padded causal at D = 32 in bf16 and in f32) through `attention_forward`,
`attention_dq` and `attention_dkv` (`--kernels`) against their plain
versions on the same inputs (the backward on the kernel's own lse and
delta = rowsum(dO * out), as chip_smoke.py runs it). Errors: the forward
on the rows that see a key, the gradients relative to the plain one's
largest entry, checked against chip_smoke.py's tolerances (`TOLS`). Each
kernel is timed with `profiling.device.graph_ms` (medians of CUDA-graph
replays, chip_smoke.py's timer) beside its plain version, and so are
`scaled_dot_product_attention`'s forward and its forward + backward;
their difference is reported as SDPA's backward (`library_bwd_ms`, "fwd_bwd
- fwd"), the one PyTorch call that computes dQ, dK and dV, the yardstick
of K2 + K3 together. Of the port it uses only those six functions,
`LAUNCHES` and `reset_launch_counts`, which every checkout since the wide
instances has: each kernel run must have launched one instance of its own
once. One JSON line
per tree and case, then the card's `nvidia-smi` name and power limit; with
`--build_report` also the compiler's lines and the SASS tensor-core
mnemonics and TMA loads of each tree's wide and TMA-fed kernels. Exits 1
when a case misses its tolerance, 2 without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
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
    ("bench_causal", 4, 2048, 8, 64, True, None, "bf16"),
    ("d32_bench_causal", 4, 2048, 8, 32, True, None, "bf16"),
    ("head_dim_32", 2, 128, 4, 32, True, "tail", "bf16"),
    ("d128_bench_causal", 4, 2048, 8, 128, True, None, "bf16"),
    ("d256_bench_causal", 4, 2048, 8, 256, True, None, "bf16"),
    ("main_enc_self", 64, 32, 8, 64, False, "tail", "bf16"),
    ("bench_causal_f32", 4, 2048, 8, 64, True, None, "f32"),
    ("d128_bench_causal_f32", 4, 2048, 8, 128, True, None, "f32"),
    ("d256_bench_causal_f32", 4, 2048, 8, 256, True, None, "f32"),
    ("main_enc_self_f32", 64, 32, 8, 64, False, "tail", "f32"),
    ("d32_bench_causal_f32", 4, 2048, 8, 32, True, None, "f32"),
    ("head_dim_32_f32", 2, 128, 4, 32, True, "tail", "f32"),
)
KERNELS = ("fwd", "dq", "dkv")
# flash_attention's forward + backward in the model's layout, a choice of
# --kernels beside K1-K3 (not a default).
MODEL = "model"
HERE = os.path.dirname(os.path.abspath(__file__))
# Builds the kernel library of the tree given as its argument.
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from shockwave_tpu_torch.ops import _build; _build.build()")
# chip_smoke.py's tolerances: forward output and lse, max abs on the rows
# that see a key; dQ, dK and dV, max abs relative to the plain one's
# largest entry.
TOLS = {"bf16": (2e-2, 1e-3, 5e-2), "f32": (1e-4, 1e-4, 1e-4)}


def sass_tensor_ops(library: str):
    """{kernel's mangled name: {mnemonic: count}} of the HMMA, HGMMA and
    UTMALDG instructions of every wide or TMA-fed kernel in the library's
    SASS."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", library], capture_output=True, text=True,
                          check=True).stdout
    found, entry = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            entry = fn.group(1) if "_wide" in fn.group(1) or "_tma" in fn.group(1) else None
            if entry:
                found[entry] = {}
            continue
        op = re.search(r"\b(H(?:G)?MMA\S*|UTMALDG\S*)", line)
        if op and entry:
            found[entry][op.group(1)] = found[entry].get(op.group(1), 0) + 1
    return found


def visible_rows(mask, b, h, t, causal, device):
    """(BH, T) bool: the rows that see at least one key."""
    import torch
    keys = mask if mask is not None else torch.ones(b, t, dtype=torch.bool, device=device)
    keys = keys.repeat_interleave(h, dim=0)
    if causal:
        return torch.cumsum(keys.int(), 1) > 0
    return keys.any(1, keepdim=True).expand(-1, t)


def run_case(fa, case, seed, device, kernels=KERNELS, time_fn=None):
    """One case through `kernels` of the port `fa` (its flash_attention
    module) against their plain versions: a JSON-able record of errors,
    `ok` and, with `time_fn` (a timer of a call, as `graph_ms`), each
    kernel's, plain version's and SDPA's ms. On the CPU the wrappers run
    their plain versions, which is how the tests run it."""
    import torch
    import torch.nn.functional as F
    name, b, t, h, d, causal, mask_kind, dt = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn(b * h, t, d, generator=gen, device=device).to(dtype)
                  for _ in range(4))
    mask = None
    if mask_kind == "tail":
        lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
        mask = torch.arange(t, device=device)[None, :] < lengths[:, None]
    args = (mask, h, 1.0 / math.sqrt(d), causal)
    model = MODEL in kernels
    kernels = tuple(kname for kname in kernels if kname != MODEL)
    fa.reset_launch_counts()
    out, lse = fa.attention_forward(q, k, v, *args)
    delta = (out.float() * g.float()).sum(dim=-1)
    bwd = (g, lse, delta) + args
    calls = {"fwd": (lambda: fa.attention_forward(q, k, v, *args),
                     lambda: fa.attention_forward_plain(q, k, v, *args)),
             "dq": (lambda: fa.attention_dq(q, k, v, *bwd),
                    lambda: fa.attention_dq_plain(q, k, v, *bwd)),
             "dkv": (lambda: fa.attention_dkv(q, k, v, *bwd),
                     lambda: fa.attention_dkv_plain(q, k, v, *bwd))}
    got = {kname: calls[kname][0]() for kname in kernels if kname != "fwd"}
    launched = dict(fa.LAUNCHES)
    want = {kname: calls[kname][1]() for kname in kernels}
    out_tol, lse_tol, grad_tol = TOLS[dt]
    errs, ok = {}, True
    if "fwd" in kernels:
        rows = visible_rows(mask, b, h, t, causal, device)
        out_p, lse_p = want["fwd"]
        errs["fwd_max_abs"] = float((out.float() - out_p.float()).abs()[rows].max())
        errs["lse_max_abs"] = float((lse - lse_p).abs()[rows].max())
        ok &= errs["fwd_max_abs"] <= out_tol and errs["lse_max_abs"] <= lse_tol
    for kname in got:
        pairs = zip(kname[1:], (got[kname],) if kname == "dq" else got[kname],
                    (want[kname],) if kname == "dq" else want[kname])
        for grad, x, x_p in pairs:
            err = float((x.float() - x_p.float()).abs().max() / x_p.float().abs().max())
            errs[f"d{grad}_max_rel"] = err
            ok &= err <= grad_tol and bool(torch.isfinite(x.float()).all())
    ok &= bool(torch.isfinite(out.float()).all())
    if device.type == "cuda":  # each kernel that ran launched one instance of its own once
        ran = {n: c for n, c in launched.items() if c}
        ok &= set(ran.values()) == {1} and sorted(
            kname for n in ran for kname in ("fwd", *got)
            if n == "flash_" + kname or n.startswith("flash_" + kname + "_")) == sorted(
            ("fwd", *got))
    record = {"case": name, "shape": [b, t, h, d], "causal": causal, "dtype": dt, "ok": ok,
              **errs}
    if time_fn is None:
        return record
    for kname in kernels:
        record[kname] = {"ms": time_fn(calls[kname][0]), "plain_ms": time_fn(calls[kname][1])}
    q4, k4, v4, g4 = (x.view(b, h, t, d) for x in (q, k, v, g))
    attn_mask = None
    if mask is not None:
        attn_mask = mask[:, None, None, :].expand(b, 1, t, t)
        if causal:
            attn_mask = attn_mask & torch.ones(t, t, dtype=torch.bool, device=device).tril()
    is_causal = causal and mask is None
    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))

    def library_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask, is_causal=is_causal)
        return torch.autograd.grad(o, (qg, kg, vg), g4)

    record["library_fwd_ms"] = time_fn(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=attn_mask, is_causal=is_causal))
    record["library_fwd_bwd_ms"] = time_fn(library_fwd_bwd)
    record["library_bwd_ms"] = record["library_fwd_bwd_ms"] - record["library_fwd_ms"]
    record["library_bwd_by"] = "fwd_bwd - fwd"
    if model:
        record[MODEL] = model_layout(fa, q, k, v, g, mask, b, h, t, d, causal, time_fn)
    return record


def model_layout(fa, q, k, v, g, mask, b, h, t, d, causal, time_fn):
    """`flash_attention`'s forward + backward on (B, T, H, D) tensors
    holding the case's numbers, as the model calls it, and SDPA's forward +
    backward on the same tensors' (B, H, T, D) views: ms of each and, on
    the card, the device kernels of one port call (torch.profiler, CUDA
    activity only)."""
    import torch
    import torch.nn.functional as F
    qm, km, vm, gm = (x.view(b, h, t, d).transpose(1, 2).contiguous() for x in (q, k, v, g))
    ours = [x.detach().requires_grad_() for x in (qm, km, vm)]
    theirs = [x.detach().requires_grad_() for x in (qm, km, vm)]
    attn_mask = None
    if mask is not None:
        attn_mask = mask[:, None, None, :].expand(b, 1, t, t)
        if causal:
            attn_mask = attn_mask & torch.ones(t, t, dtype=torch.bool, device=q.device).tril()

    def port():
        out = fa.flash_attention(*ours, causal=causal, key_padding_mask=mask)
        return torch.autograd.grad(out, ours, gm)

    def library():
        out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in theirs),
                                             attn_mask=attn_mask,
                                             is_causal=causal and mask is None)
        return torch.autograd.grad(out, theirs, gm.transpose(1, 2))

    record = {"fwd_bwd_ms": time_fn(port), "library_fwd_bwd_ms": time_fn(library)}
    if q.is_cuda:
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            port()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        record.update({"device_kernels": len(names),
                       "flash_kernels": sum("flash_" in n for n in names)})
    return record


def run_tree(tree: str, build_report: bool, seed: int, kernels, cases) -> int:
    """Every case of `cases` on `tree`'s kernels; one JSON line each."""
    sys.path.insert(0, os.path.abspath(tree))
    import time

    import torch
    from shockwave_tpu_torch.ops import _build
    from shockwave_tpu_torch.ops import flash_attention as fa
    # This checkout's timer, loaded by path, so that every tree is timed
    # alike (older trees have no profiling.device.graph_ms).
    spec = importlib.util.spec_from_file_location("swt_ab_device",
                                                  os.path.join(HERE, "device.py"))
    device_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(device_mod)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    path = _build.build()
    _build.library()
    if build_report:
        lines = [ln.strip() for ln in _build.build_log().splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln
                 or "arning" in ln]
        def ours(ln):
            return "_wide" in ln or "_tma" in ln
        wide = [ln for i, ln in enumerate(lines) if ours(ln) or "arning" in ln
                or (i and ours(lines[i - 1])) or (i > 1 and ours(lines[i - 2]))]
        print(json.dumps({"tree": tree, "build_s": time.time() - t0, "ptxas": wide,
                          "sass": sass_tensor_ops(path)}), flush=True)
    device = torch.device("cuda")
    failed = 0
    for i, case in enumerate(CASES):
        if case[0] not in cases:
            continue
        record = run_case(fa, case, seed + i, device, kernels, device_mod.graph_ms)
        failed += not record["ok"]
        print(json.dumps({"tree": tree, **record}), flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", default=["."],
                        help="checkouts of the repository, run in this order")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS + (MODEL,),
                        default=list(KERNELS),
                        help="the kernels each case runs (default: all three), and `model`: "
                             "flash_attention's forward + backward in the model's layout")
    parser.add_argument("--cases", nargs="+", choices=[c[0] for c in CASES],
                        default=[c[0] for c in CASES], help="the cases to run (default: all)")
    parser.add_argument("--build_report", action="store_true",
                        help="print each tree's ptxas lines and SASS tensor-core mnemonics "
                             "of its wide kernels")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fwd_wide_ab: no CUDA device; this script times the card's kernels",
              file=sys.stderr)
        return 2
    if args.one:
        return run_tree(args.one, args.build_report, args.seed, args.kernels, args.cases)
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
               str(args.seed), "--kernels", *args.kernels, "--cases", *args.cases]
        rc |= subprocess.run(cmd + (["--build_report"] if args.build_report else []),
                             check=False).returncode
    from shockwave_tpu_torch.profiling.device import nvidia_smi
    print(nvidia_smi(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
