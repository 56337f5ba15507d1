"""Paper Figs. 7, 8, 9: performance / energy efficiency / EDP across the
eight MemPool configurations at 16 B/cycle, with the paper's headline claims
validated inline."""

from __future__ import annotations

from repro_torch.core import energy
from repro_torch.core.hw_profiles import SPM_CAPACITIES_MIB

from repro_torch.benchmarks.common import fmt_table, pct, save_artifact


def run() -> str:
    derived = energy.derive_all(bw_bytes_per_cycle=16)
    rows = []
    for mib in SPM_CAPACITIES_MIB:
        d2 = derived[f"MemPool-2D_{mib}MiB"]
        d3 = derived[f"MemPool-3D_{mib}MiB"]
        rows.append([
            f"{mib} MiB",
            f"{d2.performance:.3f}", f"{d3.performance:.3f}",
            pct(d3.performance / d2.performance - 1),
            f"{d2.efficiency:.3f}", f"{d3.efficiency:.3f}",
            pct(d3.efficiency / d2.efficiency - 1),
            f"{d2.edp:.3f}", f"{d3.edp:.3f}",
            pct(d3.edp / d2.edp - 1),
        ])
    save_artifact("fig789.json", {k: v.to_dict() if hasattr(v, "to_dict")
                                  else v.__dict__ for k, v in derived.items()})

    checks = [
        ("Fig7: 3D@4MiB perf vs 2D@4MiB (paper +9.1%)",
         derived["MemPool-3D_4MiB"].performance
         / derived["MemPool-2D_4MiB"].performance - 1, 0.091),
        ("Fig7: 3D@8MiB perf vs baseline (paper +8.4%)",
         derived["MemPool-3D_8MiB"].performance - 1, 0.084),
        ("Fig8: 3D@1MiB efficiency vs baseline (paper +14%)",
         derived["MemPool-3D_1MiB"].efficiency - 1, 0.14),
        ("Fig8: 3D@4MiB efficiency vs 2D@4MiB (paper +18.4%)",
         derived["MemPool-3D_4MiB"].efficiency
         / derived["MemPool-2D_4MiB"].efficiency - 1, 0.184),
        ("Fig8: 3D@4MiB energy vs 2D@1MiB (paper -3.7%)",
         derived["MemPool-3D_4MiB"].energy - 1, -0.037),
        ("Fig9: 3D@1MiB EDP vs baseline (paper -15.6%)",
         derived["MemPool-3D_1MiB"].edp - 1, -0.156),
    ]
    lines = [fmt_table(
        ["SPM", "perf 2D", "perf 3D", "Δ", "eff 2D", "eff 3D", "Δ",
         "EDP 2D", "EDP 3D", "Δ"],
        rows, title="Figs. 7-9 — performance / efficiency / EDP @ 16 B/cyc")]
    lines.append("")
    for name, got, want in checks:
        ok = "OK " if abs(got - want) < 0.015 else "DIFF"
        lines.append(f"  [{ok}] {name}: got {pct(got)}")
    return "\n".join(lines)


def main(argv=None) -> None:
    from repro_torch.benchmarks.common import run_cli
    run_cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
