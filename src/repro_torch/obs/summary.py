"""Render a JSONL telemetry run into the benchmarks' table format (port
of ``repro.obs.summary``: on the same file, the reference's rows).

``summarize(records)`` folds a run's records into ``(table, name,
fields)`` rows — the exact shape :func:`benchmarks.common.emit`
prints — so a live run and a bench script read the same way:

    [obs/train] dqn/cartpole: iters=40 env_steps=10240 steps_per_s=...
    [obs/spans] dqn/cartpole: step=1.23 sync=0.04 checkpoint=0.11
    [obs/serve] dqn/cartpole: requests=6400 actions_per_s=... p50_ms=...

The CLI wrapper is ``tools/obs_summary.py`` (the reference's; it reads
the port's files unchanged).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.obs.hist import FixedHistogram
from repro_torch.obs.sink import read_records

Row = Tuple[str, str, Dict]


def _run_name(records: List[Dict]) -> str:
    for rec in records:
        if rec["kind"] == "meta":
            run = rec["run"]
            algo = run.get("algo") or run.get("family") or "run"
            env = run.get("env")
            return f"{algo}/{env}" if env else str(algo)
    return "run"


def _fold_hist(into: Dict[str, FixedHistogram], hists: Dict) -> None:
    for name, h in hists.items():
        fh = into.get(name)
        if fh is None:
            fh = into[name] = FixedHistogram(h["edges"])
        elif list(fh.edges) != [float(e) for e in h["edges"]]:
            raise ValueError(f"hist {name!r} changed edges mid-run")
        for i, c in enumerate(h["counts"]):
            if c:
                # fold counts bucket-wise: attribute each bucket's
                # mass to its lower edge (the below-range bucket to
                # just under the first edge, keeping it below range)
                e0 = float(h["edges"][0])
                v = (h["edges"][i - 1] if i > 0
                     else e0 - max(abs(e0), 1.0))
                fh.observe(v, int(c))


def summarize(records: List[Dict], name: str = "") -> List[Row]:
    name = name or _run_name(records)
    rows: List[Row] = []

    steps = [r for r in records if r["kind"] == "step"]
    if steps:
        m: Dict[str, float] = {}
        spans: Dict[str, float] = {}
        for rec in steps:
            for k, v in rec["metrics"].items():
                m[k] = m.get(k, 0) + v
            for k, v in rec["spans"].items():
                spans[k] = spans.get(k, 0.0) + v
        g0 = min(r["window"][0] for r in steps)
        g1 = max(r["window"][1] for r in steps)
        fields = {"iters": g1 - g0}
        for k in ("env_steps", "episodes"):
            if k in m:
                fields[k] = int(m[k])
        wall = sum(spans.values())
        if "env_steps" in m and wall > 0:
            fields["steps_per_s"] = round(m["env_steps"] / wall, 1)
        last = steps[-1]["metrics"]
        if "return_mean" in last:
            fields["final_return"] = round(last["return_mean"], 2)
        rows.append(("obs/train", name, fields))
        if spans:
            rows.append(("obs/spans", name,
                         {k: round(v, 3) for k, v in
                          sorted(spans.items())}))

    serves = [r for r in records if r["kind"] == "serve"]
    if serves:
        m = {}
        for rec in serves:
            for k, v in rec["metrics"].items():
                m[k] = m.get(k, 0) + v
        hists: Dict[str, FixedHistogram] = {}
        buckets: Dict[str, int] = {}
        for rec in serves:
            _fold_hist(hists, rec["hists"])
            for b, n in rec["buckets"].items():
                buckets[b] = buckets.get(b, 0) + n
        fields = {"requests": int(m.get("requests", 0)),
                  "infer_s": round(m.get("infer_s", 0.0), 3)}
        if m.get("infer_s", 0) > 0:
            fields["actions_per_s"] = round(
                m["requests"] / m["infer_s"], 1)
        lat = hists.get("latency_s")
        if lat is not None and lat.count:
            fields["p50_ms"] = round(lat.percentile(50) * 1e3, 3)
            fields["p99_ms"] = round(lat.percentile(99) * 1e3, 3)
        rows.append(("obs/serve", name, fields))
        if buckets:
            rows.append(("obs/buckets", name,
                         {f"b{b}": n for b, n in
                          sorted(buckets.items(),
                                 key=lambda kv: int(kv[0]))}))

    for rec in records:
        if rec["kind"] == "profile":
            rows.append(("obs/profile", name,
                         {"dir": rec["dir"],
                          "window": f"{rec['window'][0]}.."
                                    f"{rec['window'][1]}"}))
    return rows


def render(rows: List[Row]) -> str:
    lines = []
    for table, name, fields in rows:
        kv = "  ".join(f"{k}={v}" for k, v in fields.items())
        lines.append(f"[{table}] {name}: {kv}")
    return "\n".join(lines)


def summarize_file(path: str, name: str = "") -> List[Row]:
    return summarize(read_records(path), name=name)
