"""Sharding rules, shards over a ``torch.distributed`` mesh, and the
compressed cross-pod gradient reduction."""
