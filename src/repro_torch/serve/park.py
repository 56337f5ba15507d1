"""Layer-2 host tier: serialize an idle session off the card, resume later.

The counterpart of ``src/repro/serve/park.py``. A park captures everything
a session needs to go on decoding once its device resources are gone:

  * the contents of every page its block-table row maps: KV codes and, for
    an int8 tier, the sibling per-page scales, moved verbatim, so the round
    trip is lossless at any codec (an int8 park restores the exact codes
    that were resident, never a requantization);
  * its per-slot rows (the walk is uniform; recurrent families never park);
  * the scheduler residue: prompt, emitted tokens, decode budget and KV
    frontier, enough for :meth:`Scheduler.submit_parked` to re-enter
    admission as a resume rather than a re-prefill.

The blob is NOT the reference's. The reference packs a msgpack header and
compresses each leaf with zstandard through its checkpoint codec, with
``ml_dtypes`` for bf16 and fp8 leaves; the port depends on none of the
three (its runtime is torch, numpy and the standard library), so this
format needs the standard library only::

    b"RTPARK" | u32 header length (little endian) | header JSON | leaves

The header holds ``format``, ``meta`` and one entry a leaf (key, shape,
torch dtype name, compressed length); each leaf follows as its raw bytes
(``tensor.view(torch.uint8)``, so bf16 and fp8 need no numpy dtype)
compressed by ``zlib`` at level 3, the reference's own fallback codec.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, Tuple

import torch

#: Bump when the blob layout changes: parked sessions may outlive
#: processes, so a loud version check beats a shape error mid-resume.
PARK_FORMAT = 1
MAGIC = b"RTPARK"
_LEN = struct.Struct("<I")
_ZLIB_LEVEL = 3


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"parked-session blob names unknown dtype {name!r}")
    return dtype


def pack_parked(meta: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> bytes:
    """Serialize one parked session: ``meta`` (the JSON-safe scheduler
    residue) and ``arrays`` (flat ``key -> tensor``, on the host or the
    card; each is read to the host here)."""
    leaves, payloads = [], []
    for key, t in arrays.items():
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
        data = zlib.compress(raw.numpy().tobytes(), _ZLIB_LEVEL)
        leaves.append({"key": key, "shape": list(t.shape),
                       "dtype": str(t.dtype).removeprefix("torch."),
                       "nbytes": len(data)})
        payloads.append(data)
    header = json.dumps({"format": PARK_FORMAT, "meta": meta,
                         "leaves": leaves}).encode()
    return b"".join([MAGIC, _LEN.pack(len(header)), header, *payloads])


def unpack_parked(blob: bytes) -> Tuple[Dict[str, Any],
                                        Dict[str, torch.Tensor]]:
    """Inverse of :func:`pack_parked`: ``(meta, {key: CPU tensor})``.
    Raises ``ValueError`` for a blob of another format."""
    blob = bytes(blob)
    if not blob.startswith(MAGIC):
        raise ValueError("not a parked-session blob of the port's format "
                         f"(no {MAGIC!r} header)")
    at = len(MAGIC)
    (n,) = _LEN.unpack_from(blob, at)
    at += _LEN.size
    top = json.loads(blob[at:at + n])
    at += n
    fmt = top.get("format")
    if fmt != PARK_FORMAT:
        raise ValueError(f"parked-session blob format {fmt!r}; this build "
                         f"reads format {PARK_FORMAT}")
    arrays: Dict[str, torch.Tensor] = {}
    for leaf in top["leaves"]:
        raw = zlib.decompress(blob[at:at + leaf["nbytes"]])
        at += leaf["nbytes"]
        flat = (torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw
                else torch.empty(0, dtype=torch.uint8))
        arrays[leaf["key"]] = flat.view(_dtype(leaf["dtype"])).reshape(
            leaf["shape"])
    return top["meta"], arrays
