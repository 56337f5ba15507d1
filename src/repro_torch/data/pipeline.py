"""Deterministic, resumable, host-sharded synthetic token pipeline.

The counterpart of ``src/repro/data/pipeline.py``, numpy only: batches are
bit for bit the reference's (the same seeds, the same draws), and the
trainer moves them to its device.

Production posture without a dataset dependency: batches are a pure function
of (seed, step, host_shard), so (a) restart-resume is exact (no iterator
state to checkpoint beyond the step counter), (b) every host generates only
its shard, (c) elastic re-slicing just changes the shard map.

The token stream is a seeded first-order Markov chain (fixed per-seed bigram
table), so models *can* learn structure, and a training run's loss falls.

Prefetch: a background thread keeps ``depth`` batches ready — the paper's
memory-phase/compute-phase overlap, at the input-pipeline level.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4      # candidate successors per token (structure)
    frontend_len: int = 0   # vlm/audio prefix length
    d_model: int = 0        # for frontend embeds
    encdec: bool = False


class SyntheticPipeline:
    """Stateless batch generation + stateful prefetcher."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        rng = np.random.default_rng(cfg.seed)
        # fixed bigram table: token t -> branching candidates
        self._bigram = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching),
            dtype=np.int32)

    # ------------------------------------------------------------ pure gen
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        seed = (hash((cfg.seed, step, self.host_index)) & 0x7FFFFFFF)
        rng = np.random.default_rng(seed)
        b, s = self.local_batch, cfg.seq_len
        s_text = s - cfg.frontend_len
        toks = np.empty((b, s_text + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        choices = rng.integers(0, cfg.branching, size=(b, s_text))
        for t in range(s_text):
            toks[:, t + 1] = self._bigram[toks[:, t], choices[:, t]]
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
        if cfg.encdec:
            batch["src_embeds"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32) * 0.02
            batch["tokens"] = np.pad(toks[:, :-1], ((0, 0), (0, cfg.frontend_len)))[:, :s]
            batch["labels"] = np.pad(toks[:, 1:], ((0, 0), (0, cfg.frontend_len)),
                                     constant_values=-1)[:, :s]
        elif cfg.frontend_len:
            batch["frontend_embeds"] = rng.standard_normal(
                (b, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.02
        return batch

    # ----------------------------------------------------------- prefetch
    def iterator(self, start_step: int = 0, depth: int = 2
                 ) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                batch = self.batch_at(step)
                while not stop.is_set():
                    try:
                        q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                _, batch = q.get()
                yield batch
        finally:
            stop.set()
