"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's)."""

import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

CODE = """
import os, sys
sys.path[:0] = [{bench!r}, {repo!r}]
from benchlib import cli, registry, roofline, stats, trace
from reference import checks
for k in os.listdir(os.path.join({bench!r}, "benchlib", "kinds")):
    if k.endswith(".py"):
        registry.kind(k[:-3])
for m in os.listdir(os.path.join({bench!r}, "metrics")):
    registry.metric(m[:-3])
import pcd_tpu_torch.configs, pcd_tpu_torch.ops.fixed_base
import pcd_tpu_torch.snark.msm_dispatch, pcd_tpu_torch.ops.field
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(cli.loaded_forbidden())
"""


def test_no_jax_or_jax_package_loaded():
    p = subprocess.run([sys.executable, "-c", CODE.format(bench=BENCH,
                                                          repo=REPO)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top, found = p.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    names = eval(top)
    assert "pcd_tpu_torch" in names
    assert not {"jax", "jaxlib", "flax", "pcd_tpu"} & set(names)


def test_forbidden_compares_whole_names(monkeypatch):
    sys.path.insert(0, BENCH)
    from benchlib import cli

    monkeypatch.setitem(sys.modules, "pcd_tpu_torch_x", sys)
    assert "pcd_tpu" not in cli.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pcd_tpu.fields", sys)
    assert "pcd_tpu" in cli.loaded_forbidden()
