"""Serving: continuous-batching engine + scheduler over the pooled KV cache
(dense slot slab or paged two-tier pool), with speculative decoding and
disaggregated prefill/decode roles."""

from repro_torch.serve.engine import Engine, EngineConfig, PoolState, ServeReport
from repro_torch.serve.pool import DECODE_ROLE, PREFILL_ROLE, PoolManager
from repro_torch.serve.scheduler import (Request, Scheduler, SlotTable,
                                         derive_n_slots,
                                         derive_prefill_chunk,
                                         derive_speculate_tokens,
                                         kv_bytes_per_token, pool_partition,
                                         resident_bytes_per_slot)
from repro_torch.serve.speculate import (FoldResult, fold_acceptance,
                                         propose_ngram)

__all__ = [
    "Engine", "EngineConfig", "PoolState", "ServeReport",
    "PoolManager", "PREFILL_ROLE", "DECODE_ROLE",
    "Request", "Scheduler", "SlotTable",
    "derive_n_slots", "derive_prefill_chunk", "derive_speculate_tokens",
    "kv_bytes_per_token", "pool_partition", "resident_bytes_per_slot",
    "FoldResult", "fold_acceptance", "propose_ngram",
]
