"""Whole toy runs of the harness on the CPU: each kind of cell is correct
on its own output, the control and every planted fault come out not
correct, and a cell and a metric added as new files only are found and
run.  Minutes in all (toy proves on the CPU)."""

import hashlib
import json
import os

import pytest

import toy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell, seed", [("toy_gm17_msm", 3000000001),
                                        ("toy_g16_chain", 4000000007)])
def test_cell_correct(root, cell, seed):
    rc, res, err = toy.run(root, cell, seed, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], res
    assert res["attempted"] >= 1
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("cell, fault", [
    ("toy_gm17_msm", "control"),
    ("toy_gm17_msm", "half_batch"),
    ("toy_gm17_msm", "altered_msm"),
    ("toy_g16_chain", "control"),
    ("toy_g16_chain", "stale_step"),
    ("toy_g16_chain", "altered_proof"),
])
def test_control_and_faults_not_correct(root, cell, fault):
    rc, res, err = toy.run(root, cell, 11, control=fault == "control",
                           fault=fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
    assert "check " in err.strip().splitlines()[-1]


def digest(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, top)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_from_new_files_only(root):
    bench = os.path.join(root, "benchmark")
    before = digest(bench)
    with open(os.path.join(bench, "traffic", "msm_small.json"), "w") as f:
        json.dump({"kind": "msm_batch", "queries": [["a_query", "g1", "z"],
                                                    ["h_query", "g1", "h"]],
                   "check_batches": 1}, f)
    with open(os.path.join(bench, "metrics", "batches_seen.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.records))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": "toy_msm_small", "config": "toy_gm17",
                           "traffic": "msm_small", "chips": 1, "why": "t"})
    b["end_to_end"].append({"name": "batches_seen", "unit": "1",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["toy_msm_small"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    rc, res, err = toy.run(root, "toy_msm_small", 5)
    assert rc == 0, err[-3000:]
    assert res["correct"]
    assert res["metrics"]["batches_seen"]["value"] == res["attempted"]
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.cuda
def test_cell_on_the_card():
    """A real cell, briefly, where a card is (the full cells run through
    benchmark/run.py on the card)."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "gm17_msm", "--seed", "7", "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=toy.REPO, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
