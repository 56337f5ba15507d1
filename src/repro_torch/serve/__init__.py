"""Serving: continuous-batching engine + scheduler over the paged KV pool."""

from repro_torch.serve.engine import Engine, EngineConfig, PoolState, ServeReport
from repro_torch.serve.scheduler import (Request, Scheduler, SlotTable,
                                         derive_n_slots, kv_bytes_per_token,
                                         pool_partition,
                                         resident_bytes_per_slot)

__all__ = [
    "Engine", "EngineConfig", "PoolState", "ServeReport",
    "Request", "Scheduler", "SlotTable",
    "derive_n_slots", "kv_bytes_per_token", "pool_partition",
    "resident_bytes_per_slot",
]
