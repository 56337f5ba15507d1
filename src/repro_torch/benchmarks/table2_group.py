"""Paper Table II: group PPA — primitive profile rows + derived PDP, with the
3D-vs-2D deltas the paper prints in parentheses."""

from __future__ import annotations

from repro_torch.core import energy
from repro_torch.core.hw_profiles import SPM_CAPACITIES_MIB
from repro_torch.core.target import get_target

from repro_torch.benchmarks.common import fmt_table, pct, save_artifact

#: the paper's printed PDP deltas (3D vs 2D), for side-by-side validation
PAPER_PDP_DELTA = {1: -0.12, 2: -0.13, 4: -0.16, 8: -0.14}
PAPER_FREQ_DELTA = {1: +0.040, 2: +0.052, 4: +0.091, 8: +0.051}


def run() -> str:
    pdp = energy.pdp_table()
    rows = []
    arts = []
    for mib in SPM_CAPACITIES_MIB:
        # select the flow targets by name through the registry
        p2 = get_target(f"mempool-2d-{mib}mib").profile
        p3 = get_target(f"mempool-3d-{mib}mib").profile
        fp_delta = p3.footprint_norm / p2.footprint_norm - 1
        freq_delta = p3.freq_norm / p2.freq_norm - 1
        pdp_delta = pdp[p3.name] / pdp[p2.name] - 1
        rows.append([
            f"{mib} MiB",
            f"{p2.footprint_norm:.3f}/{p3.footprint_norm:.3f}", pct(fp_delta),
            f"{p2.freq_norm:.3f}/{p3.freq_norm:.3f}",
            f"{pct(freq_delta)} (paper {pct(PAPER_FREQ_DELTA[mib])})",
            f"{p2.power_norm:.3f}/{p3.power_norm:.3f}",
            f"{pdp[p2.name]:.3f}/{pdp[p3.name]:.3f}",
            f"{pct(pdp_delta)} (paper {pct(PAPER_PDP_DELTA[mib])})",
        ])
        arts.append(dict(mib=mib, fp_delta=fp_delta, freq_delta=freq_delta,
                         pdp_delta=pdp_delta,
                         paper_pdp_delta=PAPER_PDP_DELTA[mib]))
    save_artifact("table2.json", arts)
    return fmt_table(
        ["SPM", "footprint 2D/3D", "Δ", "freq 2D/3D", "Δ (vs paper)",
         "power 2D/3D", "PDP 2D/3D", "ΔPDP (vs paper)"],
        rows, title="Table II — group PPA (derived rows reproduce the paper)")


def main(argv=None) -> None:
    from repro_torch.benchmarks.common import run_cli
    run_cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
