"""One step of the multi-parallel training step on n ranks.

The port of `__graft_entry__.dryrun_multichip`:

    python -m shockwave_tpu_torch.parallel.dryrun --n 4 [--device cpu]

spawns n rank processes (this module with `--rank`), joined in a gloo
process group on localhost, and runs one training step on each of the
reference's two meshes, which between them cover all five axes: dp x tp
x sp (`seq_len = 16 sp`, `batch = 2 dp`, vocab 256, dim 64, 4 heads,
`mlp_dim = 128 tp`), then dp x pp x ep (`seq_len = 16`, `batch = 2 dp
pp`). It prints the reference's two lines. The ranks run on the card
unless `--device cpu` is given; with one card they all share it, and
gloo carries their collectives through the host. A rank that fails makes
the run exit non-zero.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import tempfile
from typing import Dict, List

import torch
import torch.distributed as dist

from ..ops import flash_attention as fa
from .mesh import make_mesh
from .moe import gather_batch
from .train_step import build_multi_parallel_train_step, gather_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 600.0


def mesh_plans(n: int):
    """[(mesh sizes, builder arguments)] of the reference's two meshes on
    n ranks."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % (tp * 2) == 0 else 1
    dp = n // (tp * sp)
    pp = 2 if n % 2 == 0 else 1
    ep = 2 if n % (pp * 2) == 0 else 1
    dp2 = n // (pp * ep)
    return [(dict(dp=dp, tp=tp, sp=sp),
             dict(seq_len=16 * sp, batch=2 * dp, vocab=256, dim=64, heads=4, mlp_dim=128 * tp)),
            (dict(dp=dp2, pp=pp, ep=ep),
             dict(seq_len=16, batch=2 * dp2 * pp, vocab=256, dim=64, heads=4, mlp_dim=128))]


def run_mesh(mesh_sizes: dict, build_args: dict, device) -> dict:
    """One step on this rank's mesh: the loss, this rank's launch counts,
    coordinates and routing of its tokens, and (on every rank, gathered)
    the updated global parameters and the global MoE routing."""
    mesh = make_mesh(**mesh_sizes)
    step, params, (tokens, targets) = build_multi_parallel_train_step(mesh, device=device,
                                                                      **build_args)
    fa.reset_launch_counts()
    new, loss = step(params, tokens, targets)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    return {"mesh": mesh.shape, "coords": mesh.coords, "loss": float(loss),
            "launches": launches, "params": gather_params(new, mesh),
            "routing": {k: gather_batch(v, mesh).cpu().numpy()
                        for k, v in step.routing.items()}}


def rank_main(rank: int, n: int, port: int, device: str, out: str) -> None:
    torch.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        results = [run_mesh(sizes, args, dev) for sizes, args in mesh_plans(n)]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device: str = "cuda") -> List[List[Dict]]:
    """Run both meshes' steps on n rank processes; prints the reference's
    two lines and returns each rank's `run_mesh` results. Raises with the
    failing ranks' output when a rank fails."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="swt_dryrun_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "shockwave_tpu_torch.parallel.dryrun", "--rank", str(r),
             "--n", str(n), "--port", str(port), "--device", device, "--out", outs[r]],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [r for r, proc in enumerate(procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("dryrun_multichip: ranks %s failed:\n%s" % (
                failed, "\n".join(logs[r][-3000:] for r in failed)))
        results = [torch.load(path, weights_only=False) for path in outs]
    first, second = results[0]
    m = first["mesh"]
    print(f"dryrun_multichip({n}): mesh dp={m['dp']} tp={m['tp']} sp={m['sp']}, "
          f"loss={first['loss']:.4f}", flush=True)
    m = second["mesh"]
    print(f"dryrun_multichip({n}): mesh dp={m['dp']} pp={m['pp']} ep={m['ep']}, "
          f"loss={second['loss']:.4f}", flush=True)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=4, help="ranks")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.n, args.port, args.device, args.out)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (give --device cpu for the CPU)", file=sys.stderr)
        return 2
    try:
        dryrun_multichip(args.n, args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
