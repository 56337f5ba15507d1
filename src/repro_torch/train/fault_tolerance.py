"""Fault tolerance: heartbeats, straggler detection, restart policy,
failure injection.

The port's own copy of ``src/repro/train/fault_tolerance.py``, which is
pure Python (the reference's package imports JAX, so the port cannot
import it from there).

At 1000+ nodes the failure model is: (a) hard node loss -> restart from the
latest atomic checkpoint on a (possibly re-sliced) mesh; (b) stragglers ->
detect from step-time telemetry and either exclude the host at the next
re-slice or lower its data shard. This module is the host-side control plane
for both; it is deliberately runtime-agnostic (pure data structures +
policies) so it is fully unit-testable without hardware, and the launcher
wires it to the real loop.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-host liveness from heartbeat timestamps."""

    timeout_s: float = 60.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_hosts(now)


@dataclasses.dataclass
class StragglerDetector:
    """Flags hosts whose step time is a robust outlier.

    Uses the median + k*MAD rule over a sliding window — stable against the
    non-Gaussian tail of real step-time distributions.
    """

    window: int = 32
    k_mad: float = 5.0
    min_samples: int = 8
    _hist: Dict[int, List[float]] = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_time_s: float) -> None:
        h = self._hist.setdefault(host, [])
        h.append(step_time_s)
        if len(h) > self.window:
            del h[0]

    def _median(self, xs: Sequence[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def stragglers(self) -> List[int]:
        per_host = {h: self._median(v) for h, v in self._hist.items()
                    if len(v) >= self.min_samples}
        if len(per_host) < 2:
            return []
        meds = list(per_host.values())
        med = self._median(meds)
        mad = self._median([abs(x - med) for x in meds]) or 1e-9
        return sorted(h for h, m in per_host.items()
                      if m > med + self.k_mad * mad)


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Decides the recovery action after a failure event."""

    max_restarts: int = 100
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 300.0

    def next_action(self, n_restarts: int, dead_hosts: Sequence[int],
                    n_hosts: int) -> Tuple[str, float]:
        """Returns (action, backoff_s); action in
        {"restart", "reslice", "abort"}."""
        if n_restarts >= self.max_restarts:
            return "abort", 0.0
        backoff = min(self.backoff_cap_s,
                      self.backoff_base_s * (2.0 ** min(n_restarts, 10)))
        # losing hosts permanently -> restart on a smaller (elastic) mesh
        if dead_hosts and len(dead_hosts) >= max(1, n_hosts // 16):
            return "reslice", backoff
        return "restart", backoff


def elastic_mesh_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid fitting the surviving device count.

    Keeps `model` fixed (TP degree is architectural) and shrinks `data` —
    checkpoints are mesh-agnostic so the optimizer state resharding is free.
    """
    data = n_devices // model_parallel
    if data < 1:
        raise ValueError(f"{n_devices} devices cannot host TP={model_parallel}")
    return data, model_parallel


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for integration tests / drills."""

    fail_at_steps: Tuple[int, ...] = ()
    kind: str = "crash"          # "crash" | "hang" | "slow"

    def check(self, step: int) -> Optional[str]:
        return self.kind if step in self.fail_at_steps else None
