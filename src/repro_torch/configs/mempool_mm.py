"""The paper's own workload: the tiled matrix-multiplication study (§VI).

Not a transformer — this config parameterizes the MemPool matmul experiment
(M, capacities, bandwidths) exactly as published, and is what
``repro_torch.launch.mempool_matmul`` and the Fig. 6-9 benchmarks consume.
"""

import dataclasses
from typing import Tuple

from repro_torch.core.hw_profiles import MiB
from repro_torch.core.perf_model import PAPER_BANDWIDTHS, PAPER_M


@dataclasses.dataclass(frozen=True)
class MempoolMatmulConfig:
    m: int = PAPER_M
    capacities_mib: Tuple[int, ...] = (1, 2, 4, 8)
    bandwidths: Tuple[float, ...] = PAPER_BANDWIDTHS
    word_bytes: int = 4
    flows: Tuple[str, ...] = ("2D", "3D")


CONFIG = MempoolMatmulConfig()
