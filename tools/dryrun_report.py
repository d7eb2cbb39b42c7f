#!/usr/bin/env python3
"""Tables of a dry-run sweep's JSON (``python -m repro_torch.launch.dryrun
--json OUT``): the roofline table ``repro_torch.launch.roofline.summarize``
prints, of the cells that ran (the skipped ones are counted below), then
one row an (arch, shape) of the memory a device holds on each mesh (the
step's inputs as the port's rank holds them, the same inputs under the
reference's layout, the temps' peak) beside the useful share of the
counted work and the collective bytes.  Every figure is a forecast at an
H100's data-sheet peaks; nothing here runs on a device.  From the repo
root:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --both-meshes --json sweep.json
    PYTHONPATH=src python tools/dryrun_report.py sweep.json

Several JSON files (a sweep split over processes, an arch each) are
read as one sweep, in the order given.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.roofline import summarize  # noqa: E402

GIB = 2 ** 30
# (column, the figure of one cell)
COLUMNS = (
    ("args GiB, rank",
     lambda r: f"{r['memory']['argument_size_in_bytes'] / GIB:.2f}"),
    ("args GiB, layout",
     lambda r: f"{r['memory']['layout_argument_bytes'] / GIB:.2f}"),
    ("temps GiB", lambda r: f"{r['memory']['temp_size_in_bytes'] / GIB:.2f}"),
    ("useful/HLO",
     lambda r: f"{100 * r['roofline']['useful_flops_frac']:.1f}%"),
    ("collective GB", lambda r: f"{r['cost']['collective_bytes'] / 1e9:.2f}"),
)


def memory_table(ok) -> str:
    """One row an (arch, shape), its cells on (16, 16) and (2, 16, 16)
    side by side as ``a / b``."""
    rows = ["| arch | shape | " + " | ".join(c for c, _ in COLUMNS) + " |",
            "|---|---|" + "---|" * len(COLUMNS)]
    cells = {}
    for r in ok:
        cells.setdefault((r["arch"], r["shape"]), []).append(r)
    for (arch, shape), rs in cells.items():
        figs = [" / ".join(fn(r) for r in rs) for _, fn in COLUMNS]
        rows.append(f"| {arch} | {shape} | " + " | ".join(figs) + " |")
    return "\n".join(rows)


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    results = []
    for path in argv:
        with open(path) as f:
            results += json.load(f)
    ok = [r for r in results if r["status"] == "ok"]
    print(summarize(ok))
    print()
    print(memory_table(ok))
    skipped = sum(r["status"].startswith("skip") for r in results)
    failed = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{len(ok)} ok / {skipped} skipped / {failed} FAILED")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
