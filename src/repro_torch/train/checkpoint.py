"""Atomic, async, device-agnostic checkpoints (a JSON manifest + zlib).

The counterpart of ``src/repro/train/checkpoint.py``, with the same
contract:

  * **atomic**: a step directory appears only by ``os.rename`` of a
    finished tmp dir, so a crash mid-save never corrupts the latest
    checkpoint;
  * **resumable**: the manifest carries the step; the data pipeline is
    stateless in the step, so a restart resumes bit for bit;
  * **device-agnostic**: leaves are stored logically (full shape, read to
    the host), and :meth:`CheckpointManager.restore` places each on the
    template leaf's device or the one it is given;
  * **async**: :meth:`CheckpointManager.save` copies the state to the host
    on the caller's thread (the next step may update the params in place)
    and hands compression and writing to the manager's writer thread;
  * **keep-k**: old steps are pruned after a successful save.

The format is not the reference's (msgpack, zstandard when present): the
port needs the standard library only, as ``serve/park.py`` does. A step
directory holds ``manifest.json`` (the step, the caller's extras, and per
leaf its path, shape, torch dtype name and the compressed length of each
chunk) and ``state.bin``, every leaf's raw little-endian bytes cut into
``CHUNK_BYTES`` chunks, each a zlib stream of zlib's Huffman-only
strategy: no string matching, which finds little in float or int8
payloads (on random normal f32 and int8 data it gives level 1's ratio or
better at 1.6-2.5x its speed). The chunks are compressed and decompressed
on a pool of threads (zlib releases the interpreter lock): at full width
the f32 params are gigabytes, which one zlib stream takes minutes to get
through. An int8
moment (``QTensor``) is stored as its two leaves, ``<path>/q`` and
``<path>/scale``.

**Elastic**: under a mesh, ``save(..., placements=)`` writes full arrays:
each sharded leaf is all-gathered over the mesh, leaf by leaf, and only
rank 0 copies it to the host and writes; every rank calls it.
``restore(..., placements=)`` cuts each stored full array to this rank's
shard of the current mesh, whatever mesh saved it (the reference's
``restore(..., shardings=)``). A distributed save's ``wait`` holds every
rank until rank 0's write is renamed into place.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.train.optimizer import QTensor

FORMAT = 1
CHUNK_BYTES = 32 << 20
_THREADS = min(8, os.cpu_count() or 1)


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of nested dicts; a QTensor is two leaves."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, f"{path}/{k}" if path else str(k))]
    if isinstance(tree, QTensor):
        return [(f"{path}/q", tree.q), (f"{path}/scale", tree.scale)]
    return [(path, tree)]


def _unflatten(template: Any, leaves: Dict[str, torch.Tensor],
               path: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{path}/{k}" if path else str(k))
                for k, v in template.items()}
    if isinstance(template, QTensor):
        return QTensor(leaves[f"{path}/q"], leaves[f"{path}/scale"])
    return leaves[path]


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint names unknown dtype {name!r}")
    return dtype


def _chunks(raw: memoryview) -> List[memoryview]:
    return [raw[i:i + CHUNK_BYTES] for i in range(0, len(raw), CHUNK_BYTES)]


def _compress(chunk: memoryview) -> bytes:
    """One chunk as a zlib stream, Huffman coding only."""
    z = zlib.compressobj(1, zlib.DEFLATED, zlib.MAX_WBITS, 9,
                         zlib.Z_HUFFMAN_ONLY)
    return z.compress(chunk) + z.flush()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._writer = cf.ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="ckpt")
        self._pending: Optional[cf.Future] = None
        self._distributed = False      # the last save was across ranks
        #: one record a finished save or restore: op, step, seconds (a
        #: save's from its call to its rename), raw bytes, bytes on disk
        self.records: List[Dict[str, Any]] = []

    # ---------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any], *,
             blocking: bool = False, extra: Optional[Dict] = None,
             placements: Any = None) -> None:
        """Write ``state`` (nested dicts of tensors and QTensors) as step
        ``step``. Returns once the state is on the host; the writer thread
        compresses and renames it into place (``blocking`` waits for it).
        With ``placements`` (a tree like ``state`` of
        ``sharding.Placement``, or None for a leaf every rank holds whole)
        the leaves are shards: every rank of the mesh calls ``save``, the
        full arrays are gathered and rank 0 writes them."""
        self.wait()                      # at most one save in flight
        t0 = time.perf_counter()
        leaves = _flatten(state)
        where = (dict(_flatten(placements)) if placements is not None
                 else {})
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        self._distributed = (placements is not None and dist.is_initialized()
                             and dist.get_world_size() > 1)
        host = []
        for key, t in leaves:
            place = where.get(key)
            if place is not None:
                t = shd.gather_full(t.detach().contiguous(), place.spec,
                                    place.mesh)
            if rank0:
                host.append((key, t.detach().to("cpu", copy=True)
                             .contiguous()))
            del t
        if rank0:
            manifest = {"format": FORMAT, "step": step, **(extra or {})}
            self._pending = self._writer.submit(self._write, step, host,
                                                manifest, t0)
        if blocking:
            self.wait()

    def _write(self, step: int, host, manifest: Dict, t0: float) -> None:
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        raws = [memoryview(t.reshape(-1).view(torch.uint8).numpy())
                for _, t in host]
        with cf.ThreadPoolExecutor(_THREADS) as pool:
            blobs = [list(pool.map(_compress, _chunks(raw))) for raw in raws]
        manifest["leaves"] = [
            {"key": key, "shape": list(t.shape),
             "dtype": str(t.dtype).removeprefix("torch."),
             "chunks": [len(b) for b in chunks]}
            for (key, t), chunks in zip(host, blobs)]
        with open(os.path.join(tmp, "state.bin"), "wb") as f:
            for chunks in blobs:
                f.writelines(chunks)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()
        self.records.append({
            "op": "save", "step": step, "seconds": time.perf_counter() - t0,
            "raw_bytes": sum(len(raw) for raw in raws),
            "disk_bytes": sum(len(b) for chunks in blobs for b in chunks)})

    def wait(self) -> None:
        """Block until the save in flight is written; re-raise its error.
        After a save across ranks every rank waits here for rank 0's."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
        if self._distributed:
            self._distributed = False
            dist.barrier()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, placements: Any = None) -> Tuple[int, Any]:
        """Restore into the structure of ``template`` (nested dicts of
        tensors and QTensors, which give the expected shapes and dtypes):
        each leaf on ``device``, else on its template leaf's device.
        With ``placements`` (as :meth:`save` takes them, over the current
        mesh) the template's leaves are shards: each stored full array is
        cut to this rank's shard. Returns ``(step, tree)``."""
        t0 = time.perf_counter()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        manifest = self.manifest(step)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"checkpoint format {manifest.get('format')!r};"
                             f" this build reads format {FORMAT}")
        with open(os.path.join(self.dir, f"step_{step:010d}", "state.bin"),
                  "rb") as f:
            data = memoryview(f.read())
        spans, at = [], 0
        for leaf in manifest["leaves"]:
            spans.append([])
            for n in leaf["chunks"]:
                spans[-1].append(data[at:at + n])
                at += n
        with cf.ThreadPoolExecutor(_THREADS) as pool:
            raws = [bytearray().join(pool.map(zlib.decompress, s))
                    for s in spans]
        stored = {}
        for leaf, raw in zip(manifest["leaves"], raws):
            flat = (torch.frombuffer(raw, dtype=torch.uint8) if raw
                    else torch.empty(0, dtype=torch.uint8))
            stored[leaf["key"]] = flat.view(_dtype(leaf["dtype"])).reshape(
                leaf["shape"])
        where = (dict(_flatten(placements)) if placements is not None
                 else {})
        leaves = {}
        for key, tmpl in _flatten(template):
            if key not in stored:
                raise KeyError(f"checkpoint step {step} has no leaf {key!r}")
            t = stored[key]
            place = where.get(key)
            if place is not None:
                want = shd.global_shape(tmpl.shape, place.spec, place.mesh)
                if tuple(t.shape) != want:
                    raise ValueError(f"{key}: stored {tuple(t.shape)}, the "
                                     f"mesh's full shape {want}")
                t = shd.local_shard(t, place.spec, place.mesh)
            if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
                raise ValueError(
                    f"{key}: stored {t.dtype} {tuple(t.shape)}, template "
                    f"{tmpl.dtype} {tuple(tmpl.shape)}")
            leaves[key] = t.to(device if device is not None else tmpl.device)
        self.records.append({
            "op": "restore", "step": step, "seconds": time.perf_counter() - t0,
            "raw_bytes": sum(len(raw) for raw in raws),
            "disk_bytes": sum(len(c) for span in spans for c in span)})
        return step, _unflatten(template, leaves)
