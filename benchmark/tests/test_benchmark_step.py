"""The cell g16_step_msm (traffic kind step_msm) at toy size on the CPU:
an IVC step's Groth16 commitments on the toy cycle, main then help, read
correct; the control and a fault in the help side's b_g2 MSM alone (the
Fq3 G2 of the toy MNT6) read not correct, so the check reaches both
curves; the readers new with the cell return None with nothing to read
(no trace, no launch of the Fq3 kernels, a program or generator that
keeps no such span or request), and the Fq3 rooflines count the Fq3
query and instance alone; and the traffic file's instance counts
are the program's circuits'.  toy.py's scratch root gets the toy
configuration and cell from this file (about a minute in all)."""

import json
import os
import sys
from types import SimpleNamespace

import pytest

import toy

sys.path[:0] = [toy.BENCH, toy.REPO]

from benchlib import registry  # noqa: E402
from benchlib.cli import Run  # noqa: E402

CELL = "toy_g16_step_msm"
CONFIG = {"name": "toy_groth16_step", "factory": "toy_groth16",
          "main": {"snark": "groth16", "curve": "toy_mnt4", "z": 40,
                   "domain": 64},
          "help": {"snark": "groth16", "curve": "toy_mnt6", "z": 36,
                   "domain": 48}}
NEW_READERS = ("k1_fq3_roofline", "k4_fq3_roofline", "help_side_ms",
               "assemble_ms")
# the help side's b_g2 MSM (Fq3: the toy MNT6's G2) doubled, nothing else
HELP_B2 = """
from pcd_tpu_torch.snark.groth16.native import Groth16
_collect = Groth16._stream_collect
def _stream_collect(self, futs, nm):
    got = _collect(self, futs, nm)
    deg = self.cfg.g2.F.extension_degree_over_prime()
    return got.double() if nm == "b_g2_query" and deg == 3 else got
Groth16._stream_collect = _stream_collect
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """toy.py's scratch root with the toy step configuration and cell."""
    root = toy.make_root(str(tmp_path_factory.mktemp("bench")))
    with open(os.path.join(root, "benchmark", "configs",
                           CONFIG["name"] + ".json"), "w") as f:
        json.dump(CONFIG, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": CONFIG["name"], "source": "toy cycle",
                             "file": f"benchmark/configs/{CONFIG['name']}"
                                     ".json", "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": CELL, "config": CONFIG["name"],
                               "traffic": "g16_step_commit", "chips": 1,
                               "why": "toy"})
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return root


def test_toy_step_correct(root):
    rc, res, err = toy.run(root, CELL, 3219000001, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], res
    assert res["attempted"] >= 1 and res["checks"]["bad_proofs"][
        "value"] == 0
    got = res["metrics"]
    assert got["help_side_ms"]["value"] > 0
    assert got["assemble_ms"]["value"] > 0
    # no card: nothing for the kernels' and the device's readers
    for name in ("k1_roofline.step", "k4_roofline.step", "k1_fq3_roofline",
                 "k4_fq3_roofline", "device_idle.step"):
        assert name not in got


@pytest.mark.parametrize("fault", ["control", "help_b2", "altered_msm"])
def test_toy_step_faults_not_correct(root, monkeypatch, fault):
    monkeypatch.setitem(toy.FAULTS, "help_b2", HELP_B2)
    rc, res, err = toy.run(root, CELL, 12, control=fault == "control",
                           fault=fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
    bad = res["checks"]["bad_proofs"]["value"]
    # the help fault breaks one side of each sampled batch, the others both
    sampled = min(3, res["attempted"])
    assert bad == (sampled if fault == "help_b2" else 2 * sampled)


def test_points_count_l_padded():
    gen = registry.kind("step_msm").Generator(
        {"main": {"z": 223794, "domain": 225792},
         "help": {"z": 31207, "domain": 31360}},
        registry.data("traffic", "g16_step_commit"), 1, None)
    assert gen.points() == 1_277_154


def _run(gen=None, spans=None, events=None):
    return Run(gen or SimpleNamespace(), 1.0, [(0.0, 1.0), (1.0, 2.0)],
               spans or {}, {}, events)


def test_new_readers_nothing_to_read(monkeypatch):
    from pcd_tpu_torch.utils import profiling

    for name in NEW_READERS:               # no trace, no spans, no requests
        assert registry.metric(name).read(_run()) is None
    # a trace without the Fq3 instances (a cell of MNT4 alone)
    ev = {"device": [("void madd_accumulate_kernel<1>(...)", 0.0, 5.0),
                     ("void bucket_finish_kernel<2>(...)", 9.0, 5.0)],
          "host": []}
    for name in ("k1_fq3_roofline", "k4_fq3_roofline"):
        assert registry.metric(name).read(_run(events=ev)) is None
    # the program's span without the assembly span
    spans = {"stream_collect": (0.4, 8), "stream_collect/horner": (0.2, 8)}
    assert registry.metric("assemble_ms").read(_run(spans=spans)) is None
    assert registry.metric("assemble_ms").read(_run(spans={
        "proof_assemble": (0.6, 4)})) == pytest.approx(300.0)
    # requests kept but the program keeps no records
    gen = SimpleNamespace(help_requests=[7, 9])
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert registry.metric("help_side_ms").read(_run(gen)) is None
    rec = profiling.Record
    monkeypatch.setattr(profiling, "records", lambda: [
        rec("stream_dispatch", 1_000_000, 3_000_000, None, 1, 7),
        rec("proof_assemble", 5_000_000, 9_000_000, None, 1, 7),
        rec("stream_dispatch", 9_500_000, 9_600_000, None, 1, 8)])
    assert registry.metric("help_side_ms").read(_run(gen)) == \
        pytest.approx(8.0)
    monkeypatch.delattr(profiling, "records")
    assert registry.metric("help_side_ms").read(_run(gen)) is None


@pytest.mark.parametrize("name", ["k1_fq3_roofline", "k4_fq3_roofline"])
def test_fq3_rooflines_count_the_fq3_query_alone(name):
    """The Fq3 readers' work: the scalars of the degree-3 queries, over the
    `<3>` instance's time alone (1 ms here, beside a `<1>` launch)."""
    import torch

    from benchlib import roofline

    sc = torch.randint(0, 1 << 30, (64, 10), dtype=torch.int32)
    gen = SimpleNamespace(bits=298, work=lambda i: (
        {"help.z": sc, "help.h": sc[:8]},
        [("help.a_query", "help.z", 1), ("help.b_g2_query", "help.z", 3),
         ("help.h_query", "help.h", 1)]))
    kern = "madd_accumulate" if name.startswith("k1") else "bucket_finish"
    ev = {"device": [(f"void {kern}_kernel<3>(...)", 0.0, 1000.0),
                     (f"void {kern}_kernel<1>(...)", 2000.0, 500.0)],
          "host": []}
    nz, wins = roofline.msm_work(sc, 12, 298)
    mads = (roofline.mixed_add_mads(nz, 3) if name.startswith("k1") else
            roofline.complete_add_mads(
                roofline.bucket_reduction_adds(wins, 12), 3))
    want = 2 * 100.0 * roofline.bound_s(mads=mads) / 1e-3   # two batches
    assert registry.metric(name).read(_run(gen, events=ev)) == \
        pytest.approx(want)


def test_instance_counts_are_the_circuits():
    """The traffic file's n_inst: one plus the public inputs each circuit
    of the program allocates (pcd/ec_cycle.py), main then help."""
    from pcd_tpu_torch.crh.bowe_hopwood import BoweHopwoodCRH
    from pcd_tpu_torch.curves import models
    from pcd_tpu_torch.gadgets.inputs import repacked_len

    mix = registry.data("traffic", "g16_step_commit")
    n = {sd["side"]: sd["n_inst"] for sd in mix["sides"]}
    cyc = models.mnt_cycle()
    crh = BoweHopwoodCRH(cyc.crh_te)
    x = crh.convert_output_to_field_elements(crh.default_output())
    assert n["main"] == 1 + len(x)
    assert n["help"] == 1 + repacked_len(cyc.main.Fr, cyc.help.Fr, len(x))
