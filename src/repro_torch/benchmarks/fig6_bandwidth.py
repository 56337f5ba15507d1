"""Paper Fig. 6: matmul cycle-count speedup vs off-chip bandwidth x SPM
capacity, relative to (1 MiB, 4 B/cycle). Validates the paper's three
published points (43 % / 16 % / 8 % for 8 MiB vs 1 MiB)."""

from __future__ import annotations

from repro_torch.core import perf_model
from repro_torch.core.hw_profiles import MiB, SPM_CAPACITIES_MIB
from repro_torch.core.target import get_target

from repro_torch.benchmarks.common import fmt_table, save_artifact

#: the three speedups (8 MiB over 1 MiB at equal bandwidth) §VI-A publishes
PAPER_POINTS = {4: 1.43, 16: 1.16, 64: 1.08}


def run() -> str:
    # capacities come from the registered MemPool targets' scratchpad level
    caps = [get_target(f"mempool-2d-{mib}mib").scratchpad_bytes // MiB
            for mib in SPM_CAPACITIES_MIB]
    table = perf_model.fig6_table(capacities_mib=caps)
    rows = []
    for bw, caps in table.items():
        marks = []
        for cap, v in caps.items():
            marks.append(f"{v:.3f}")
        rel8 = caps[8] / caps[1]
        check = ""
        if bw in PAPER_POINTS:
            check = f"8v1={rel8:.2f} (paper {PAPER_POINTS[bw]:.2f})"
        rows.append([f"{bw:g} B/cyc"] + marks + [check])
    save_artifact("fig6.json", {str(k): v for k, v in table.items()})
    return fmt_table(
        ["off-chip BW", "1 MiB", "2 MiB", "4 MiB", "8 MiB", "validation"],
        rows, title="Fig. 6 — cycle-count speedup vs (1 MiB, 4 B/cyc)")


def main(argv=None) -> None:
    from repro_torch.benchmarks.common import run_cli
    run_cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
