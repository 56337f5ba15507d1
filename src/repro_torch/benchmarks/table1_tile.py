"""Paper Table I: tile partitioning / die utilization — model vs published."""

from __future__ import annotations

from repro_torch.core import area_model

from repro_torch.benchmarks.common import fmt_table, save_artifact


def run() -> str:
    rows = []
    arts = []
    for row in area_model.table1():
        paper = area_model.PAPER_TABLE1[(row["flow"], row["spm_mib"])]
        mem_m = "-" if row["mem_util"] is None else f"{row['mem_util']:.2f}"
        mem_p = "-" if paper["mem_util"] is None else f"{paper['mem_util']:.2f}"
        rows.append([
            row["flow"], f"{row['spm_mib']} MiB",
            f"{row['footprint']:.3f}", f"{paper['footprint']:.3f}",
            f"{row['logic_util']:.2f}", f"{paper['logic_util']:.2f}",
            mem_m, mem_p,
            row["banks_on_mem_die"], "yes" if row["icache_on_mem_die"] else "no",
        ])
        arts.append(dict(row, paper=paper))
    save_artifact("table1.json", arts)
    return fmt_table(
        ["flow", "SPM", "footprint(model)", "footprint(paper)",
         "logic util(m)", "(p)", "mem util(m)", "(p)", "banks@mem", "I$@mem"],
        rows, title="Table I — tile partitioning (model vs paper)")


def main(argv=None) -> None:
    from repro_torch.benchmarks.common import run_cli
    run_cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
