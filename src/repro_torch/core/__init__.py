"""Hardware targets, capacity-aware tiling, the kernel planner and the
paper's perf/energy/area models (copied framework-free from ``repro.core``)."""

from repro_torch.core.perf_model import (matmul_cycles, fig6_table,
                                         speedup_vs_baseline)
from repro_torch.core.energy import derive, derive_all, pdp_table
from repro_torch.core.area_model import partition_tile, table1
