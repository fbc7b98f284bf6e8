"""Fused flash attention: hand-written CUDA kernels for Hopper.

The port of `shockwave_tpu/ops/flash_attention.py`. Three kernels
(`csrc/flash_attention.cu`, and their wide instances in
`csrc/flash_attention_wide.cu`) replace its three Pallas kernels:

  flash_fwd  <- _fa_kernel   forward by online softmax, emits a per-row
                             logsumexp `lse` (BH, Tq) f32
  flash_dq   <- _dq_kernel   dQ, k-tiles innermost
  flash_dkv  <- _dkv_kernel  dK and dV, q-tiles innermost

Every kernel owns a square tile of rows of one (batch, head), 16 rows per
warp, and streams tiles of the same width; each takes its tile from
`launch_config`, which picks the width of that kernel instance's tile
from the sequence lengths (`KERNEL_TILES`), and the wrapper passes it to
the C entry point.

The kernels read q, k, v and dO and write out, dQ, dK and dV in place,
as (B, H, T, D) views with packed columns: each C entry point takes a
`View` per tensor (its base and its batch, head and row strides in
elements). `flash_attention` hands over the model's own (B, T, H, D)
tensors as `x.transpose(1, 2)` and allocates the output and the
gradients in that layout, so nothing is copied on the way in or out; a
view that breaks the 16-byte rule of cp.async and TMA reaches a kernel as
a packed copy (`_kernel_layout`), and an entry point refuses one that
does not. `attention_forward`, `attention_dq` and `attention_dkv` also
take packed (BH, T, D) tensors, viewed as (BH / heads, heads, T, D), and
give packed outputs then. lse and delta stay packed (BH, Tq) f32.

A `torch.autograd.Function` ties them together; its backward computes
`delta = rowsum(dO * O)` in f32 with a fourth hand-written kernel,
`flash_bwd_delta` (`csrc/flash_attention_delta.cu`: it reads O and dO
once through their strides; the JAX package forms delta in plain jnp,
which XLA fuses on the TPU), and then launches the two backward kernels,
kept as two passes so neither needs atomics. One forward + backward at a
kernel head dim is four device kernels: K1, delta, K2 and K3.

Beside each kernel sits its plain PyTorch version with the same masking
constants and casts (scores in f32, p cast to v's dtype before p.V, ds
cast to q's dtype, p = 0 where s <= -5e29 in the backward). A wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor
it launches its kernel or raises. `LAUNCHES` counts the kernel launches.

Each kernel has two instances on the card, chosen by the inputs' dtype:
bf16 (the trainer's type) and f32 (`flash_fwd_f32`, `flash_dq_f32`,
`flash_dkv_f32`, `flash_bwd_delta_f32`), to the plain f32 versions'
digits, as the Pallas kernels compute in f32: every f32 instance of K1-K3
runs 3xTF32 products on the tensor cores (each operand split into two
TF32 parts, three products summed in f32). One-pass TF32 is off, as the
port keeps it everywhere. Neither dtype is cast to the other. Any other
dtype raises on the card.
The narrow instances issue `mma.sync` (m16n8k16 in bf16, m16n8k8 in
TF32); the wide ones, K1-K3 in both dtypes, issue `wgmma` (m64nNk16 in
bf16, m64nNk8 in TF32) from two warpgroups over 64-row tiles. In bf16 at
head dims 64, 128 and 256, the long tile of K1-K3 runs the TMA-fed
kernels of `csrc/flash_attention_tma.cu` (`flash_fwd_tma`,
`flash_dq_tma`, `flash_dkv_tma`: a producer warp issues TMA loads
completed on mbarriers, two consumer warpgroups run `wgmma`), as does
that of K1 and K3 at 32 (rows of 64 bytes in the 64-byte swizzle;
`TMA_HEAD_DIMS` per instance), and in f32
there the long tile of K1-K3 runs those of
`csrc/flash_attention_tma_f32.cu` (`flash_fwd_f32_tma`,
`flash_dq_f32_tma`, `flash_dkv_f32_tma`: the same CTA shape on TF32
`wgmma` as 3xTF32), each reached through the same C entry point as its
base instance, with its own launch counter. Their tensor maps are 4-D
over (d, t, h, b) with the views' strides.

The kernels are built for head dims 32, 64, 128 and 256
(`KERNEL_HEAD_DIMS`); above 256 each kernel has a wide instance
(`flash_fwd_wide`, `flash_dq_wide`, `flash_dkv_wide`, each in bf16 and
f32) that takes any multiple of 256 at run time: K1's and K2's CTAs own
64 rows and up to 512 output columns, K3's 64 keys and a 256-column slice
of dK and dV. `flash_attention` zero-pads q, k and v
along the head dim to `kernel_head_dim(d)` (the smallest of
`KERNEL_HEAD_DIMS` that holds d; 257-512 to 512, wider ones to the next
multiple of 256) on every device, in their (B, T, H, D) layout, as the
reference pads to its sublane multiple, and slices the output back: zero
columns add nothing to q.k^T and give zero output columns. So every head
dim runs on the card; the plain versions take any dtype and head dim.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
# Head dims above the widest of them pad to a multiple of WIDE_SLICE (512
# at least) and run on the wide instances (K2's and K3's CTAs own
# WIDE_SLICE output columns each, K1's up to twice that).
WIDE_SLICE = 256
# The dtypes the kernels take, with the suffix of their instance's launch
# counter and C entry point.
KERNEL_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
WIDE = "_wide"
TMA = "_tma"
# Kernel instances in the C library's occupancy order: K1-K3 in bf16, in
# f32, then their wide instances in bf16 and in f32.
INSTANCES = tuple(name + suffix for suffix in KERNEL_DTYPES.values() for name in KERNELS)
WIDE_INSTANCES = tuple(name + WIDE + suffix for suffix in KERNEL_DTYPES.values()
                       for name in KERNELS)
# The TMA-fed K1-K3 in bf16 (csrc/flash_attention_tma.cu), which run the
# long tile of `flash_fwd`, `flash_dq` and `flash_dkv` at their
# TMA_HEAD_DIMS, and in f32 (csrc/flash_attention_tma_f32.cu), which run
# that of `flash_fwd_f32`, `flash_dq_f32` and `flash_dkv_f32`; their C
# entry points are those instances'.
TMA_INSTANCES = tuple(name + suffix + TMA for suffix in KERNEL_DTYPES.values()
                      for name in KERNELS)
# The head dims each TMA-fed instance is built for: 64, 128 and 256, and
# 32 for bf16 K1 and K3 (K2's long tile at 32 stays on mma.sync).
TMA_HEAD_DIMS = {name: (32, 64, 128, 256) if name in ("flash_fwd" + TMA, "flash_dkv" + TMA)
                 else (64, 128, 256) for name in TMA_INSTANCES}
# The backward's delta = rowsum(dO * O) kernel (csrc/flash_attention_delta.cu),
# in bf16 and in f32.
DELTA = "flash_bwd_delta"
DELTA_INSTANCES = tuple(DELTA + suffix for suffix in KERNEL_DTYPES.values())
# Launches of each kernel instance since the last reset; a wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {name: 0 for name in INSTANCES + WIDE_INSTANCES + TMA_INSTANCES + DELTA_INSTANCES}
# The square tiles each kernel instance is built for, by (instance, head
# dim) (rows per CTA = the width of the streamed tiles, 16 rows per warp):
# (short tile, long tile, the longest sequence that takes the short
# tile). The bf16 kernels take 32 at the trainer's T = 32; the 3xTF32
# instances take one warp per CTA up to T = 64, so that the f32 decoder's
# 32 (batch, head) pairs at T = 64 give 128 CTAs for the card's 132 SMs.
# Their long tile is 64 rows; at their TMA_HEAD_DIMS it is the TMA-fed
# f32 kernels': K1's and K2's 64 query rows (two consumer warpgroups),
# K3's 64 keys (one group forms P^T and owns dV, the other dS^T and dK).
# The bf16 instances keep 32 up to T = 32; their long tile is, at their
# TMA_HEAD_DIMS, the TMA-fed kernels': K1's and K2's 128 query rows (two
# consumer warpgroups of 64), K3's 128 keys (64 at D = 256, where one
# group owns dV and the other dK); K2's at D = 32 is 64 (mma.sync). The
# TMA instances' entries are their base instance's.
KERNEL_TILES = {(name + suffix, d): (16, 64, 64) if suffix else (32, 64, 32)
                for suffix in KERNEL_DTYPES.values() for name in KERNELS
                for d in KERNEL_HEAD_DIMS}
KERNEL_TILES.update({(name, d): (32, 64 if "dkv" in name and d == 256 else 128, 32)
                     for base in KERNELS for name in (base, base + TMA)
                     for d in TMA_HEAD_DIMS[base + TMA]})
KERNEL_TILES.update({(name + TMA, d): KERNEL_TILES[name, d]
                     for name in INSTANCES if name.endswith("_f32")
                     for d in TMA_HEAD_DIMS[name + TMA]})
# The wide instances' tiles in KERNEL_TILES' form (short, long, the
# longest sequence that takes the short tile). K1's is 64 rows in both
# dtypes (a wgmma's 64 rows; two warpgroups, csrc/flash_attention_wide.cu).
# K2 and K3 in both dtypes take 64 rows (64 queries of K2, 64 keys of K3,
# on wgmma like K1) and, up to T = 32, 32 rows of each of two (batch, head)
# pairs packed into one 64-row tile, so that a sequence of 32 fills it:
# half the CTAs of 64-row tiles there.
WIDE_TILES = {name: (64, 64, 64) if name.startswith("flash_fwd") else (32, 64, 32)
              for name in WIDE_INSTANCES}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions. q: (BH, Tq, D); k, v: (BH, Tk, D); kv_mask: (B, Tk) bool
# (True = attend) or None, its row for bh being bh // heads.
# ---------------------------------------------------------------------------

def _masked_scores(q, k, kv_mask, heads, scale, causal):
    """s = q.k^T * scale in f32, causal entries set to NEG_INF, then the
    key-padding bias (0 / NEG_INF) added, as _fa_kernel does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = s.shape[-2:]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, NEG_INF)
    if kv_mask is not None:
        bias = torch.where(kv_mask, 0.0, NEG_INF).to(torch.float32)
        s = s + bias.repeat_interleave(heads, dim=0)[:, None, :]
    return s


def _backward_terms(q, k, v, g, lse, delta, kv_mask, heads, scale, causal):
    """(p in f32, ds in q's dtype) of the backward kernels: p = exp(s - lse)
    and ds = p * (dO.v^T - delta) * scale."""
    s = _masked_scores(q, k, kv_mask, heads, scale, causal)
    # Masked entries sit at the NEG_INF floor; so does lse for a row that
    # sees no key, where exp(s - lse) would be O(1) garbage. Zero them.
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    return p, ds


def attention_forward_plain(q, k, v, kv_mask, heads: int, scale: float,
                            causal: bool):
    """(out in q's dtype, lse (BH, Tq) f32) of one k-block of _fa_kernel:
    the running max starts at NEG_INF, p is cast to v's dtype for p.V."""
    s = _masked_scores(q, k, kv_mask, heads, scale, causal)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return out, lse


def attention_dq_plain(q, k, v, g, lse, delta, kv_mask, heads: int,
                       scale: float, causal: bool):
    """dQ of _dq_kernel; g is dO in q's dtype, lse and delta (BH, Tq) f32."""
    _, ds = _backward_terms(q, k, v, g, lse, delta, kv_mask, heads, scale,
                            causal)
    return torch.matmul(ds.float(), k.float()).to(q.dtype)


def attention_dkv_plain(q, k, v, g, lse, delta, kv_mask, heads: int,
                        scale: float, causal: bool):
    """(dK, dV) of _dkv_kernel: dV = p^T.dO with p in q's dtype,
    dK = ds^T.q."""
    p, ds = _backward_terms(q, k, v, g, lse, delta, kv_mask, heads, scale,
                            causal)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), g.float())
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta_plain(out, g):
    """delta = rowsum(dO * O) in f32, as the JAX package's backward forms it
    in plain jnp (shockwave_tpu/ops/flash_attention.py:290-292): (..., T, D)
    in, (..., T) out."""
    return (out.float() * g.float()).sum(dim=-1)


# ---------------------------------------------------------------------------
# Kernel wrappers. q, k, v, dO and the outputs are packed (BH, T, D)
# tensors, or (B, H, T, D) views: the model's (B, T, H, D) tensors
# transposed, which the kernels read and write in place through their
# strides.
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    """True when the inputs lie on the CPU (plain version); False when
    they lie on one CUDA device (kernel). Anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) == 1:
        (device,) = devices
        if device.type in ("cpu", "cuda"):
            return device.type == "cpu"
    raise ValueError(f"flash attention needs all tensors on the CPU or on "
                     f"one CUDA device; got {sorted(map(str, devices))}")


def _as_bhtd(x: torch.Tensor, heads: int) -> torch.Tensor:
    """x as the kernels' (B, H, T, D) view: a packed (BH, T, D) tensor split
    into (BH / heads, heads, T, D) (a view), a 4-D one as it is."""
    if x.dim() == 4:
        return x
    if x.dim() != 3 or x.shape[0] % heads:
        raise ValueError(f"flash attention takes (BH, T, D) tensors with BH a multiple of "
                         f"heads={heads}, or (B, H, T, D) views; got {tuple(x.shape)}")
    return x.unflatten(0, (x.shape[0] // heads, heads))


def _packed(x: torch.Tensor) -> torch.Tensor:
    """x as (BH, T, D) for the plain versions (a copy of a strided view)."""
    return x.flatten(0, 1) if x.dim() == 4 else x


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A plain version's (BH, T, D) output in the form of the input x."""
    return y.unflatten(0, x.shape[:2]) if x.dim() == 4 else y


def instance(kernel: str, dtype, d: int, tq: int = 1, tk: int = 1) -> str:
    """The `LAUNCHES` name of `kernel`'s instance for `dtype` at the
    kernel head dim `d` and sequence lengths `tq`, `tk`: the wide one above
    `KERNEL_HEAD_DIMS`, the TMA-fed one (`TMA_INSTANCES`) where it takes
    the long tile."""
    name = kernel + (WIDE if d > KERNEL_HEAD_DIMS[-1] else "") + KERNEL_DTYPES[dtype]
    if d in TMA_HEAD_DIMS.get(name + TMA, ()) and max(tq, tk) > KERNEL_TILES[name, d][2]:
        return name + TMA
    return name


def tile_instance(name: str, d: int, tile: int) -> str:
    """The instance that runs tile `tile` of instance `name` at head dim
    `d`: `name`'s TMA-fed instance for its long tile at its
    `TMA_HEAD_DIMS`, else `name`."""
    if d in TMA_HEAD_DIMS.get(name + TMA, ()) and tile == KERNEL_TILES[name, d][1]:
        return name + TMA
    return name


def launch_config(tq: int, tk: int, d: int, instance: str = "flash_fwd") -> int:
    """The square tile of kernel instance `instance` (a key of `LAUNCHES`)
    for these lengths and head dim, from `WIDE_TILES` for a wide instance
    and `KERNEL_TILES` otherwise: the short tile when neither sequence is
    longer than the instance takes it for (the bf16 kernels' 32 at the
    trainer's T = 32: no padding rows and one tile per (batch, head); the
    K2 and K3 wide's two (batch, head) pairs of 32 rows a CTA), the
    long tile otherwise."""
    wide = WIDE in instance
    built = (d > KERNEL_HEAD_DIMS[-1] and d % WIDE_SLICE == 0) if wide else d in KERNEL_HEAD_DIMS
    if not built:
        raise ValueError(f"CUDA flash attention takes head dims {KERNEL_HEAD_DIMS} and, in "
                         f"its wide instances, multiples of {WIDE_SLICE} above "
                         f"{KERNEL_HEAD_DIMS[-1]} (flash_attention pads every head dim to "
                         f"one of them); {instance} got {d}")
    if tq < 1 or tk < 1:
        raise ValueError(f"CUDA flash attention takes non-empty sequences; "
                         f"got Tq={tq}, Tk={tk}")
    short, long, short_up_to = WIDE_TILES[instance] if wide else KERNEL_TILES[instance, d]
    return short if max(tq, tk) <= short_up_to else long


def kernel_head_dim(d: int) -> int:
    """The head dim a head dim `d` runs at: the smallest of
    `KERNEL_HEAD_DIMS` that holds it (1-32 -> 32, 33-64 -> 64, 65-128 ->
    128, 129-256 -> 256), 257-512 -> 512, and above that the next
    multiple of `WIDE_SLICE` (600 -> 768)."""
    for width in KERNEL_HEAD_DIMS:
        if d <= width:
            return width
    return max(2 * WIDE_SLICE, -(-d // WIDE_SLICE) * WIDE_SLICE)


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """`x` (..., d) zero-padded on its last axis to `width`: a new tensor
    (`x` itself when d == width)."""
    d = x.shape[-1]
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def _check_kernel_inputs(q, k, v, kv_mask, heads, kernel="flash_fwd"):
    """Raise on what the kernels do not take; q, k and v packed or 4-D."""
    q, k, v = (_as_bhtd(x, heads) for x in (q, k, v))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"CUDA flash attention takes torch.bfloat16 or "
                        f"torch.float32 (q, k and v alike); got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    launch_config(tq, tk, d, instance(kernel, q.dtype, d))
    if k.shape != (b, h, tk, d) or v.shape != (b, h, tk, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if h != heads:
        raise ValueError(f"(B, H, T, D) views with H={h} given heads={heads}")
    if kv_mask is not None and (kv_mask.dtype != torch.bool
                                or kv_mask.shape != (b, tk)):
        raise ValueError(f"kv_mask must be bool {(b, tk)}; got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")


def _fits(x: torch.Tensor) -> bool:
    """Whether the kernels can read or write (B, H, T, D) view x in place:
    packed columns, a base and strides (of dims longer than 1) that keep
    the 16-byte rule of cp.async and TMA, and a (batch, head)'s T rows
    within 2^31 elements, which the kernels address in 32 bits (csrc's
    rows_fit). The model's tensors do."""
    if x.stride(-1) != 1 or x.data_ptr() % 16 or x.shape[2] * x.stride(2) >= 2**31:
        return False
    return all(n == 1 or s * x.element_size() % 16 == 0
               for n, s in zip(x.shape[:-1], x.stride()[:-1]))


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) view x as a kernel takes it: x itself where it `_fits`,
    else a packed copy."""
    return x if _fits(x) else x.contiguous()


def _empty(b: int, h: int, t: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """A (B, H, T, D) output in the form of the input `like`: a packed
    tensor for a packed (BH, T, D) input, else a view of a new (B, T, H, D)
    tensor, the model's layout."""
    if like.dim() == 3:
        return like.new_empty(b, h, t, d)
    return like.new_empty(b, t, h, d).transpose(1, 2)


def _view(x: torch.Tensor) -> _build.View:
    """The C entry points' View of (B, H, T, D) view x: its base and the
    strides of its first three dims (a dim of length 1 given its packed
    stride, which no address uses)."""
    sizes = x.shape
    strides = [s if n > 1 else math.prod(sizes[i + 1:])
               for i, (n, s) in enumerate(zip(sizes[:3], x.stride()[:3]))]
    return _build.View(x.data_ptr(), _build.Strides(*strides))


def _ptr(t: Optional[torch.Tensor]):
    """The base of a packed tensor (the mask, lse, delta) or None."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("CUDA flash attention takes contiguous masks, lse and delta")
    if t.data_ptr() % 16:
        raise ValueError("CUDA flash attention takes 16-byte aligned tensors")
    return t.data_ptr()


def _device_and_stream(t: torch.Tensor):
    """The (device index, current stream) a kernel on `t` launches with."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _launch(name: str, *args) -> None:
    """Launch kernel instance `name` through its C entry point (a TMA
    instance's is its base instance's) and count it."""
    lib = _build.library()
    entry = "swt_" + name.removesuffix(TMA)
    _build.check(lib, getattr(lib, entry)(*args), name)
    LAUNCHES[name] += 1


def attention_forward(q, k, v, kv_mask, heads: int, scale: float,
                      causal: bool):
    """K1: (out, lse). Plain version on the CPU; on CUDA `instance`'s
    choice: `flash_fwd` (bf16; `flash_fwd_tma` on its long tile at D =
    32-256) or `flash_fwd_f32` (`flash_fwd_f32_tma` there), or above head
    dim 256 `flash_fwd_wide` or `flash_fwd_wide_f32`. out comes in q's
    form: packed (BH, Tq, D), or a (B, H, Tq, D) view of a new (B, Tq, H,
    D) tensor; lse (BH, Tq) f32."""
    if _on_cpu(q, k, v, kv_mask):
        out, lse = attention_forward_plain(_packed(q), _packed(k), _packed(v), kv_mask, heads,
                                           scale, causal)
        return _like(out, q), lse
    _check_kernel_inputs(q, k, v, kv_mask, heads, "flash_fwd")
    b, h, tq, d = _as_bhtd(q, heads).shape
    tk = k.shape[-2]
    name = instance("flash_fwd", q.dtype, d, tq, tk)
    qv, kv, vv = (_kernel_layout(_as_bhtd(x, heads)) for x in (q, k, v))
    out = _empty(b, h, tq, d, q)
    lse = torch.empty(b * h, tq, dtype=torch.float32, device=q.device)
    _launch(name, _view(qv), _view(kv), _view(vv), _ptr(kv_mask), _view(out), _ptr(lse), b * h,
            heads, tq, tk, d, launch_config(tq, tk, d, name), scale, int(causal),
            *_device_and_stream(q))
    return (out.flatten(0, 1) if q.dim() == 3 else out), lse


def _check_backward_inputs(q, g, lse, delta, heads):
    b, h, tq, _ = _as_bhtd(q, heads).shape
    bh = b * h
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError("dO must match q in shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (bh, tq):
            raise ValueError(f"{name} must be f32 {(bh, tq)}")


def attention_delta(out, g, heads: int):
    """delta (BH, Tq) f32 = rowsum(dO * O) of the backward; out and g
    packed (BH, Tq, D) or (B, H, Tq, D) views. Plain version on the CPU; on
    CUDA `flash_bwd_delta` (bf16) or `flash_bwd_delta_f32`."""
    if _on_cpu(out, g):
        return attention_delta_plain(_packed(out), _packed(g))
    if out.dtype not in KERNEL_DTYPES or g.dtype != out.dtype or g.shape != out.shape:
        raise TypeError(f"flash_bwd_delta takes out and dO alike in torch.bfloat16 or "
                        f"torch.float32; got {out.dtype} {tuple(out.shape)}, {g.dtype} "
                        f"{tuple(g.shape)}")
    ov, gv = (_kernel_layout(_as_bhtd(x, heads)) for x in (out, g))
    b, h, t, d = ov.shape
    delta = torch.empty(b * h, t, dtype=torch.float32, device=out.device)
    _launch(DELTA + KERNEL_DTYPES[out.dtype], _view(ov), _view(gv), _ptr(delta), b * h, h, t, d,
            *_device_and_stream(out))
    return delta


def attention_dq(q, k, v, g, lse, delta, kv_mask, heads: int, scale: float,
                 causal: bool):
    """K2: dQ, in q's form. Plain version on the CPU; on CUDA `instance`'s
    choice: `flash_dq` (bf16; `flash_dq_tma` on its long tile at D =
    64-256) or `flash_dq_f32` (`flash_dq_f32_tma` there), or above head dim
    256 `flash_dq_wide` or `flash_dq_wide_f32`."""
    if _on_cpu(q, k, v, g, lse, delta, kv_mask):
        dq = attention_dq_plain(_packed(q), _packed(k), _packed(v), _packed(g), lse, delta,
                                kv_mask, heads, scale, causal)
        return _like(dq, q)
    _check_kernel_inputs(q, k, v, kv_mask, heads, "flash_dq")
    _check_backward_inputs(q, g, lse, delta, heads)
    b, h, tq, d = _as_bhtd(q, heads).shape
    tk = k.shape[-2]
    name = instance("flash_dq", q.dtype, d, tq, tk)
    qv, kv, vv, gv = (_kernel_layout(_as_bhtd(x, heads)) for x in (q, k, v, g))
    dq = _empty(b, h, tq, d, q)
    _launch(name, _view(qv), _view(kv), _view(vv), _view(gv), _ptr(lse), _ptr(delta),
            _ptr(kv_mask), _view(dq), b * h, heads, tq, tk, d, launch_config(tq, tk, d, name),
            scale, int(causal), *_device_and_stream(q))
    return dq.flatten(0, 1) if q.dim() == 3 else dq


def attention_dkv(q, k, v, g, lse, delta, kv_mask, heads: int, scale: float,
                  causal: bool):
    """K3: (dK, dV), in k's form. Plain version on the CPU; on CUDA
    `instance`'s choice: `flash_dkv` (bf16; `flash_dkv_tma` on its long
    tile at D = 32-256) or `flash_dkv_f32` (`flash_dkv_f32_tma` there), or
    above head dim 256 `flash_dkv_wide` or `flash_dkv_wide_f32`."""
    if _on_cpu(q, k, v, g, lse, delta, kv_mask):
        dk, dv = attention_dkv_plain(_packed(q), _packed(k), _packed(v), _packed(g), lse, delta,
                                     kv_mask, heads, scale, causal)
        return _like(dk, k), _like(dv, v)
    _check_kernel_inputs(q, k, v, kv_mask, heads, "flash_dkv")
    _check_backward_inputs(q, g, lse, delta, heads)
    b, h, tq, d = _as_bhtd(q, heads).shape
    tk = k.shape[-2]
    name = instance("flash_dkv", q.dtype, d, tq, tk)
    qv, kv, vv, gv = (_kernel_layout(_as_bhtd(x, heads)) for x in (q, k, v, g))
    dk, dv = (_empty(b, h, tk, d, k) for _ in range(2))
    _launch(name, _view(qv), _view(kv), _view(vv), _view(gv), _ptr(lse), _ptr(delta),
            _ptr(kv_mask), _view(dk), _view(dv), b * h, heads, tq, tk, d,
            launch_config(tq, tk, d, name), scale, int(causal), *_device_and_stream(q))
    if k.dim() == 3:
        return dk.flatten(0, 1), dv.flatten(0, 1)
    return dk, dv


def kernel_occupancy(device: int = 0):
    """Resident CTAs per SM of every kernel instantiation on CUDA device
    `device` (cudaOccupancyMaxActiveBlocksPerMultiprocessor), with its
    threads, dynamic shared memory and registers, at each of its tiles; a
    wide instance's rows are at d = 512 (K1's and bf16 K2's and K3's
    shared memory depends on d). A tile that a TMA-fed instance runs is
    its row (`tile_instance`). Needs the card."""
    lib = _build.library()
    rows = []
    for kernel, name in enumerate(INSTANCES + WIDE_INSTANCES):  # the C library's order
        configs = ([(2 * WIDE_SLICE, tile) for tile in sorted(set(WIDE_TILES[name][:2]))]
                   if name in WIDE_TILES else
                   [(d, tile) for d in KERNEL_HEAD_DIMS for tile in KERNEL_TILES[name, d][:2]])
        for d, tile in configs:
            out = (ctypes.c_int * 4)()
            rc = lib.swt_flash_occupancy(kernel, d, tile, device, out)
            _build.check(lib, rc, f"{name} occupancy")
            rows.append({"kernel": tile_instance(name, d, tile), "d": d, "tile": tile,
                         "ctas_per_sm": out[0], "threads": out[1],
                         "smem_bytes": out[2], "registers": out[3]})
    return rows


class _FlashAttention(torch.autograd.Function):
    """Flash attention on (B, H, T, D) views, the counterpart of
    _flash_bhtd's custom_vjp: the kernels read q, k, v and dO in place and
    write the output and the gradients as views of new tensors in the
    model's (B, T, H, D) layout, so that nothing is copied on the way in or
    out; the backward forms delta with its own kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, heads, scale, causal):
        out, lse = attention_forward(q, k, v, kv_mask, heads, scale, causal)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.heads, ctx.scale, ctx.causal = heads, scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        if not g.is_cpu:
            g = _kernel_layout(g)  # once, for delta, K2 and K3
        delta = attention_delta(out, g, ctx.heads)
        args = (g, lse, delta, kv_mask, ctx.heads, ctx.scale, ctx.causal)
        dq = attention_dq(q, k, v, *args)
        dk, dv = attention_dkv(q, k, v, *args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None):
    """Fused attention for (batch, seq, heads, head_dim) inputs.

    key_padding_mask is (B, Tk) with True = attend. Cross-attention
    (Tq != Tk) is supported for causal=False. The output is in q's dtype.
    The JAX version's block_q/block_k are Mosaic tiling arguments; the
    CUDA kernels take their tiles from `launch_config` and mask ragged
    sequence edges themselves, so any lengths are taken. The kernels take
    q, k and v as they are, through their strides (`x.transpose(1, 2)`,
    no copy), and the output comes back in q's layout. The head dim is
    zero-padded to `kernel_head_dim(d)` on every device (one pad in the
    (B, T, H, D) layout), as the reference's `to_bhtd` pads it, and the
    output sliced back to `d`.
    """
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if causal and tq != tk:
        raise ValueError("causal flash attention requires Tq == Tk")
    if scale is None:
        scale = 1.0 / math.sqrt(d)  # the unpadded d
    width = kernel_head_dim(d)
    kv_mask = None
    if key_padding_mask is not None:
        kv_mask = key_padding_mask.to(torch.bool).contiguous()
    out = _FlashAttention.apply(*(pad_head_dim(x, width).transpose(1, 2) for x in (q, k, v)),
                                kv_mask, h, float(scale), causal)
    return out.transpose(1, 2)[..., :d].to(q.dtype)
