"""Builds the port's CUDA kernel source for the CPU with the host C++
compiler, so that tests can run its f32 kernels on CPU tensors.

`emulated_source` rewrites `shockwave_tpu_torch/csrc/flash_attention.cu`
into host C++: the PTX helpers (cp.async, mma.sync) get emulated bodies
from `cuda_runtime.h` here, and each `kernel<<<...>>>(...)` launch runs
its grid on host threads. `build` compiles that into a shared library
with the same C entry points as the CUDA one. The emulation holds the
kernels' index math, masking, tiles and shared-memory layout; it shows
no timing, no race between a `cp.async` copy and the compute that should
wait for it (copies land at once), and none of the tensor cores' own
rounding of sums: those need the card (`chip_smoke.py`).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(HERE)), "shockwave_tpu_torch", "csrc",
                      "flash_attention.cu")

# Emulated bodies of the helpers that hold inline PTX, by function name.
BODIES = {
    "smem_addr": "return (uint32_t)__cvta_generic_to_shared(p);",
    "cp_async16": "if (emu::shared_fits(dst, 16)) { if (valid) memcpy(dst, src, 16); "
                  "else memset(dst, 0, 16); }",
    "cp_async4": "if (emu::shared_fits(dst, 4)) { if (valid) memcpy(dst, src, 4); "
                 "else memset(dst, 0, 4); }",
    "cp_async_commit": "",
    "cp_async_wait": "",
    "ldmatrix_x4": "abort();",
    "ldmatrix_x4_trans": "abort();",
    "mma_bf16": "abort();",
    "mma_tf32": "emu::mma_m16n8k8_tf32(c, a, b0, b1);",
}


def _replace_body(src: str, name: str, body: str) -> str:
    match = re.search(r"\b" + name + r"\s*\([^;{]*\)\s*\{", src)
    if match is None:
        raise ValueError(f"{name} is not defined in {SOURCE}")
    depth, end = 1, match.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    return src[:match.end()] + body + "\n}" + src[end:]


def emulated_source(path: str = SOURCE) -> str:
    with open(path) as f:
        src = f.read()
    for name, body in BODIES.items():
        src = _replace_body(src, name, body)
    src = re.sub(r"(\w+<[^<>;]*>)<<<([^;]*?)>>>\(", r"emu::launch(\1, \2)(", src)
    src = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char smem\[\];",
                 "unsigned char* smem = emu::smem();", src)
    code = re.sub(r"//.*", "", src)
    if re.search(r"\basm\b", code):
        raise ValueError("inline PTX left without an emulated body")
    return src


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def build(out_dir: str) -> str:
    """Compile the emulated source into `out_dir`; returns the library's
    path. Raises with the compiler's output when it fails."""
    cpp = os.path.join(out_dir, "flash_attention_emulated.cpp")
    lib = os.path.join(out_dir, "libswt_kernels_emulated.so")
    with open(cpp, "w") as f:
        f.write(emulated_source())
    cmd = [compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-I", HERE, "-o", lib, cpp,
           "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}\n{proc.stderr}")
    return lib
