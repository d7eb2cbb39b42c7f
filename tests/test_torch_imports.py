"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package (``repro``), since the
card's machine has neither.  Each module is imported in a fresh
interpreter (this test file's own process has both loaded)."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, json, pkgutil, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, check=True, timeout=300,
        cwd=ROOT)
    got = json.loads(out.stdout.splitlines()[-1])
    # every layer of the port is walked, the new families' included
    assert {"repro_torch.models.mamba", "repro_torch.models.recurrent",
            "repro_torch.nn.ssm", "repro_torch.nn.rglru",
            "repro_torch.nn.moe", "repro_torch.launch.serve",
            "repro_torch.data", "repro_torch.data.synthetic",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
            "repro_torch.distributed.ranks",
            "repro_torch.distributed.checks",
            "repro_torch.nn.moe_shard", "repro_torch.data.sharded_loader",
            "repro_torch.optim.compression",
            "repro_torch.rl.replay.sharded", "repro_torch.analysis",
            "repro_torch.analysis.cli", "repro_torch.analysis.lint",
            "repro_torch.analysis.allowlist",
            "repro_torch.analysis.trace_audit",
            "repro_torch.analysis.rules",
            "repro_torch.analysis.rules.tracer_control"} \
        <= set(got["modules"])
    banned = [m for m in got["loaded"]
              if m.startswith("jax") or m.split(".")[0] == "repro"]
    assert banned == []
