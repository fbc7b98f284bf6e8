"""Builds the port's CUDA kernel sources for the CPU with the host C++
compiler, so that tests can run its kernels, bf16 and f32, on CPU
tensors.

`emulated_source` rewrites a `.cu` file of `shockwave_tpu_torch/csrc/`
(`flash_attention.cu`, the narrow kernels, `flash_attention_wide.cu`, the
wide ones, `flash_attention_tma.cu`, the TMA-fed K1-K3 in bf16,
`flash_attention_tma_f32.cu`, the TMA-fed K1-K3 in f32, and
`flash_attention_delta.cu`, the backward's delta, each with the `.cuh`
files it includes inlined) into host C++: the PTX helpers (cp.async,
ldmatrix, mma.sync, wgmma with its fence, commit and wait, named barriers,
the async-proxy fence, mbarriers with their phases and transaction bytes,
cp.async.bulk.tensor with the 128- and 64-byte swizzles and zero fill, setmaxnreg
as a no-op) get emulated bodies from `cuda_runtime.h` here, the
tensor-map encode call (`cuTensorMapEncodeTiled`) a host stand-in
(`cuda.h`), and each
`kernel<<<...>>>(...)` launch runs its grid on host threads, so a
producer warp and its consumer warpgroups really run side by side.
`build` compiles the five into one
shared library with the same C entry points as the CUDA one, which also
reports the tensor-core multiply-adds of the last launch
(`emu_tensor_products`) and the ranks of the tensor maps encoded since it
was last asked (`emu_tensor_map_ranks`, a bit per rank). The emulation holds the kernels' index math,
masking, tiles, shared-memory layout (the 128- and 64-byte swizzles and
wgmma's descriptors included, as the PTX ISA lays them out) and barrier
protocol; it shows no timing, no race between a `cp.async` copy and the
compute that should wait for it (copies land at once; a TMA copy lands in
the producer's thread before its barrier can complete), and none of the
tensor cores' own rounding of sums: those need the card
(`chip_smoke.py`).
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "shockwave_tpu_torch", "csrc")
SOURCES = tuple(os.path.join(CSRC, name) for name in ("flash_attention.cu",
                                                       "flash_attention_wide.cu",
                                                       "flash_attention_tma.cu",
                                                       "flash_attention_tma_f32.cu",
                                                       "flash_attention_delta.cu"))

# Emulated bodies of the helpers that hold inline PTX, by function name.
BODIES = {
    "smem_addr": "return (uint32_t)__cvta_generic_to_shared(p);",
    "cp_async16": "if (emu::shared_fits(dst, 16)) { if (valid) memcpy(dst, src, 16); "
                  "else memset(dst, 0, 16); }",
    "cp_async4": "if (emu::shared_fits(dst, 4)) { if (valid) memcpy(dst, src, 4); "
                 "else memset(dst, 0, 4); }",
    "cp_async_commit": "",
    "cp_async_wait": "",
    "ldmatrix_x4": "emu::ldmatrix_x4(r, p, false);",
    "ldmatrix_x4_trans": "emu::ldmatrix_x4(r, p, true);",
    "mma_bf16": "emu::mma_m16n8k16_bf16(c, a, b0, b1);",
    "mma_tf32": "emu::mma_m16n8k8_tf32(c, a, b0, b1);",
    "named_sync": "emu::named_sync(id, threads);",
    "named_arrive": "emu::named_arrive(id, threads);",
    "fence_async_shared": "",
    "wgmma_fence": "",
    "wgmma_commit": "emu::wgmma_commit();",
    "wgmma_wait": "emu::wgmma_wait(N);",
    "wgmma_hold": "",
    "compiler_fence": "",
    "wgmma_ss": "emu::wgmma_ss(&d[0][0], da, db);",
    "wgmma_ss_n128": "emu::wgmma_ss(&d[0][0], da, db, 128);",
    "wgmma_ss_n32": "emu::wgmma_ss(&d[0][0], da, db, 32);",
    "wgmma_rs": "emu::wgmma_rs(&d[0][0], a, db);",
    "wgmma_rs_n32": "emu::wgmma_rs(&d[0][0], a, db, 32);",
    "wgmma_tf32_n64": "emu::wgmma_tf32(&d[0][0], 64, a, db);",
    "wgmma_tf32_n32": "emu::wgmma_tf32(&d[0][0], 32, a, db);",
    "wgmma_tf32_n16": "emu::wgmma_tf32(&d[0][0], 16, a, db);",
    "wgmma_tf32_n8": "emu::wgmma_tf32(&d[0][0], 8, a, db);",
    "mbar_init": "emu::mbar_init(bar, count);",
    "mbar_fence_init": "",
    "mbar_arrive": "emu::mbar_arrive(bar);",
    "mbar_arrive_expect_tx": "emu::mbar_arrive(bar, bytes);",
    "mbar_try_wait": "return emu::mbar_try_wait(bar, parity);",
    "tma_load": "const int c[4] = {col, row, hb.h, hb.b}; emu::tma_load(dst, &map, bar, c);",
    "setmaxnreg_dec": "",
    "setmaxnreg_inc": "",
    "fast_exp2": "return exp2f(x);",
}


def _replace_body(src: str, name: str, body: str):
    """`src` with the body of function `name` replaced, or None when `src`
    does not define it."""
    match = re.search(r"\b" + name + r"\s*\([^;{]*\)\s*\{", src)
    if match is None:
        return None
    depth, end = 1, match.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    return src[:match.end()] + body + "\n}" + src[end:]


def _inline_includes(path: str, seen=None) -> str:
    """The text of `path` with each `#include "x"` of a file beside it
    replaced by that file's text, once (the headers are `#pragma once`)."""
    seen = set() if seen is None else seen
    with open(path) as f:
        src = f.read()

    def include(match):
        inc = os.path.join(os.path.dirname(path), match.group(1))
        if inc in seen:
            return ""
        seen.add(inc)
        return _inline_includes(inc, seen)
    return re.sub(r'^#include "([^"]+)"$', include, src, flags=re.M)


def emulated_source(path: str = SOURCES[0], exports: bool = False):
    """Host C++ for the `.cu` file at `path`; with `exports`, the one
    translation unit that defines the library's counters."""
    src = _inline_includes(path)
    for name, body in BODIES.items():
        src = _replace_body(src, name, body) or src
    src = re.sub(r"(\w+<[^<>;]*>)<<<([^;]*?)>>>\(", r"emu::launch(\1, \2)(", src)
    src = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char smem\[\];",
                 "unsigned char* smem = emu::smem();", src)
    code = re.sub(r"//.*", "", src)
    if re.search(r"\basm\b", code):
        raise ValueError(f"inline PTX left without an emulated body in {path}")
    return ("#define EMU_EXPORTS\n" if exports else "") + src


def _defined(name: str) -> bool:
    return any(_replace_body(_inline_includes(p), name, "") is not None for p in SOURCES)


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def cached_build() -> str:
    """`build` into a directory of the temporary directory keyed by a hash
    of the emulated source and the emulator's headers, once: test modules
    in several processes (the f32 and the bf16 emulation tests) share one
    build, a lock letting the first build it while the others wait."""
    missing = [name for name in BODIES if not _defined(name)]
    if missing:
        raise ValueError(f"{missing} are not defined in {SOURCES}")
    headers = "".join(open(os.path.join(HERE, name)).read()
                      for name in sorted(os.listdir(HERE)) if name.endswith(".h"))
    key = hashlib.sha256((headers + "".join(emulated_source(p, i == 0)
                                            for i, p in enumerate(SOURCES))).encode()
                         ).hexdigest()[:16]
    out_dir = os.path.join(tempfile.gettempdir(), f"swt_cuda_emu_{key}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        lib = os.path.join(out_dir, "libswt_kernels_emulated.so")
        if not os.path.exists(lib):
            tmp = os.path.join(out_dir, f"tmp{os.getpid()}")
            os.makedirs(tmp, exist_ok=True)
            os.replace(build(tmp), lib)
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build(out_dir: str, sources=SOURCES, name: str = "libswt_kernels_emulated.so") -> str:
    """Compile the emulated `sources` into one library in `out_dir`; returns
    its path. Raises with the compiler's output when it fails."""
    cpps = []
    for i, path in enumerate(sources):
        cpps.append(os.path.join(out_dir, os.path.basename(path) + ".emulated.cpp"))
        with open(cpps[-1], "w") as f:
            f.write(emulated_source(path, exports=i == 0))
    lib = os.path.join(out_dir, name)
    cmd = [compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-I", HERE, "-o", lib, *cpps,
           "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}\n{proc.stderr}")
    return lib
