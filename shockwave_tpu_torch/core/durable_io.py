"""Crash-safe writes: a copy of the footer recipe of
`shockwave_tpu/core/durable_io.py` (`write_durable`, `verify_footer`) and
of its `write_text_atomic` (span shards).

The port keeps its own copy so that it imports nothing of the JAX
package. The bytes on disk are the same: payload, then crc32(payload)
little-endian, then the magic. A fix to the recipe there belongs here too.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

FOOTER_OK = "ok"            # footer present, CRC verified
FOOTER_MISSING = "missing"  # no footer (legacy / foreign / torn file)
FOOTER_CORRUPT = "corrupt"  # footer present but CRC mismatch


def fsync_dir(path: str) -> None:
    """Make a rename/create in `path` durable (POSIX requires fsyncing
    the directory, not just the file)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds; best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_durable(path: str, payload: bytes, magic: bytes,
                  keep_prev: bool = True) -> str:
    """Write `payload` + CRC footer to `path` crash-safely: tmp file,
    fsync, retain the existing generation as `<path>.prev`, atomic
    rename, directory fsync. A crash at any step leaves either the old
    file, the old file as .prev, or both generations intact."""
    tmp = path + ".tmp"
    footer = struct.pack("<I", zlib.crc32(payload)) + magic
    with open(tmp, "wb") as f:
        f.write(payload)
        f.write(footer)
        f.flush()
        os.fsync(f.fileno())
    if keep_prev and os.path.exists(path):
        os.replace(path, path + ".prev")
        # Make the .prev promotion durable before the new generation
        # lands at `path`: POSIX does not order two renames in one
        # directory across a crash.
        fsync_dir(os.path.dirname(path) or ".")
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")
    return path


def write_text_atomic(path: str, text: str) -> str:
    """Crash-safe plain-text artifact write: tmp file, fsync, atomic
    rename, directory fsync — the same replacement discipline as
    `write_durable` but without the CRC footer, for artifacts that must
    stay directly readable by external tools (the span shards the
    scheduler's merge reads): a crash leaves either whole-old or
    whole-new, never torn."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")
    return path


def verify_footer(blob: bytes, magic: bytes) -> Tuple[str, Optional[bytes]]:
    """Check `blob`'s integrity footer. Returns (status, payload):
    (FOOTER_OK, payload) with the footer stripped, (FOOTER_MISSING,
    None) when no footer is present, or (FOOTER_CORRUPT, None)."""
    trailer = 4 + len(magic)
    if len(blob) < trailer or not blob.endswith(magic):
        return (FOOTER_MISSING, None)
    payload = blob[:-trailer]
    (crc,) = struct.unpack("<I", blob[-trailer:-len(magic)])
    if zlib.crc32(payload) != crc:
        return (FOOTER_CORRUPT, None)
    return (FOOTER_OK, payload)
