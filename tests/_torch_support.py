"""What the port's CPU tests share: the fixtures that keep the plain
versions on two threads and wait for pcd_tpu's C++ tier to load, the
Counter predicate, the SquareChain circuit, the placeholder pre-build and
the toy PCD chain held byte for byte against pcd_tpu's.  pcd_tpu is
imported only inside what needs it, so the port-only test files that
import this module stay free of JAX.
"""

import struct
import time

import numpy as np
import pytest
import torch

from pcd_tpu_torch.gadgets.fp import fpvar_class

# K1 launches per prove of one SNARK: (G1, G2).  Groth16: a, b1, l, h in
# G1 and b2 in G2; GM17: a, c, h in G1 and b in G2.
K1_PER_PROVE = {"Groth16": (4, 1), "GM17": (3, 1)}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for the plain versions: the suite runs six
    test processes on a few cores, where torch's default of one thread
    per core oversubscribes them; alone, two threads lose little."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def reference_native_loaded():
    """pcd_tpu builds its C++ tier at first use through one temporary
    that every process shares (ROADMAP section C), so a test worker can
    meet another worker's half-written library: retry until it loads."""
    from pcd_tpu import native as reference_native

    for _ in range(60):
        try:
            reference_native.available()
            return
        except OSError:
            time.sleep(1)


def predicate(base, field):
    class Counter(base):
        """msg == prior_msg + witness (reference tests/mnt4_*.rs)."""

        PRIOR_MSG_LEN = 1

        def generate_constraints(self, cs, msg, wit, priors, base_case):
            (priors[0] + wit).enforce_equal(msg)

    return Counter(field)


class SquareChain:
    """x (public) = a^(2^k): k witnesses squared in turn, enough variables
    for native-encoded query tables."""

    def __init__(self, a=3, k=40):
        self.a, self.k = a, k

    def generate_constraints(self, cs):
        V = fpvar_class(cs)
        v = self.a
        for _ in range(self.k):
            v = v * v % cs.p
        x = V.new_instance(v)
        cur = V.new_witness(self.a)
        for _ in range(self.k):
            cur = cur * cur
        cur.enforce_equal(x)


class ReplayChain(SquareChain):
    """SquareChain over the field of modulus p whose witness the provers
    replay after the first prove (external inputs: x, then a); x may be
    given wrong, so that the replayed witness fails a constraint."""

    def __init__(self, p, a=3, k=40, x=None):
        super().__init__(a, k)
        self.x = pow(a, 1 << k, p) if x is None else x % p

    def external_inputs(self):
        return [self.x, self.a]

    def generate_constraints(self, cs):
        V = fpvar_class(cs)
        x = V.new_instance(self.x)
        cur = V.new_witness(self.a)
        for _ in range(self.k):
            cur = cur * cur
        cur.enforce_equal(x)


def make_placeholders(pcd, pred, pk):
    """The base case's placeholder (vk, proof) pairs of both SNARKs, made
    (or read from .placeholder_cache) before the counted proves: a
    process without the cache files makes them inside its first prove,
    and their MSMs would count as the chain's."""
    from pcd_tpu_torch.pcd.ec_cycle import HelpCircuit, MainCircuit

    MainCircuit(pcd.ic, pred, pk.crh_pp)._resolved()
    HelpCircuit(pcd.ic, pk.main_pvk)._resolved()


def toy_chain_matches_reference(name, pk_bytes, tag, monkeypatch):
    """configs.<name> on the toy cycle: pcd_tpu runs setup and two proves;
    the port takes its keys through convert (the pk blob written by
    pk_bytes(rpcd, pk)), writes them back to the same bytes, and proves
    from a ChaChaRng in the same state with every commitment MSM of every
    prove on its stream tier.  The proof bytes must be pcd_tpu's, the
    chain verifies and rejects the old message, and K1 runs exactly once
    per commitment MSM, and so does K4 (the finish), while K2 runs on no
    path."""
    from pcd_tpu import configs as RC
    from pcd_tpu.pcd.api import FpPredicate as RPredicate
    from pcd_tpu.utils import serialize as RS
    from pcd_tpu.utils.rng import ChaChaRng as RRng
    from pcd_tpu_torch import configs as TC
    from pcd_tpu_torch import convert
    from pcd_tpu_torch.ops import ec as tec
    from pcd_tpu_torch.pcd.api import FpPredicate as TPredicate
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.snark.gm17.native import GM17
    from pcd_tpu_torch.snark.groth16.native import Groth16
    from pcd_tpu_torch.utils import serialize as TS
    from pcd_tpu_torch.utils.rng import ChaChaRng as TRng

    rpcd = getattr(RC, name)()
    F = rpcd.ic.main_field
    rpred = predicate(RPredicate, F)
    pk, vk = rpcd.circuit_specific_setup(rpred, RRng(tag + b" setup"))
    rng = RRng(tag + b" prove")
    one = F.from_int(1)
    ref1 = rpcd.prove(pk, rpred, one, one, [], [], rng)
    ref2 = rpcd.prove(pk, rpred, F.from_int(2), one, [one], [ref1], rng)

    tpcd = getattr(TC, name)(device="cpu")
    TF = tpcd.ic.main_field
    tpred = predicate(TPredicate, TF)
    blob = np.frombuffer(pk_bytes(rpcd, pk), dtype=np.uint8)
    tpk = convert.pcd_pk_from_reference(tpcd, blob)
    assert TS.pcd_pk_to_bytes(tpcd, tpk) == blob.tobytes()
    seed = vk.crh_pp.seed
    vk_blob = np.frombuffer(
        struct.pack("<I", len(seed)) + seed
        + RS.snark_vk_to_bytes(rpcd.ic.help_snark, vk.help_vk),
        dtype=np.uint8)
    tvk = convert.pcd_vk_from_reference(tpcd, vk_blob)
    assert TS.pcd_vk_to_bytes(tpcd, tvk) == vk_blob.tobytes()

    # every commitment MSM of both SNARKs' proves on the stream tier; the
    # toy's 23k-point MSMs take windows of 8 bits on 2048 lanes (the card's
    # 12 and 8192 cost the plain versions several times more here)
    monkeypatch.setattr(Groth16, "STREAM_MIN", 0)
    monkeypatch.setattr(GM17, "STREAM_MIN", 0)
    monkeypatch.setattr(msm_dispatch, "WINDOW_BITS", 8)
    monkeypatch.setattr(msm_dispatch, "LANES", 2048)
    make_placeholders(tpcd, tpred, tpk)
    tec.reset_launch_counts()
    rng = TRng(tag + b" prove")
    one_t = TF.from_int(1)
    p1 = tpcd.prove(tpk, tpred, one_t, one_t, [], [], rng)
    p2 = tpcd.prove(tpk, tpred, TF.from_int(2), one_t, [one_t], [p1], rng)
    plain = tec.plain_counts()

    assert TS.pcd_proof_to_bytes(tpcd, p1) == RS.pcd_proof_to_bytes(rpcd,
                                                                    ref1)
    assert TS.pcd_proof_to_bytes(tpcd, p2) == RS.pcd_proof_to_bytes(rpcd,
                                                                    ref2)
    assert tpcd.verify(tvk, tpred, one_t, p1)
    assert tpcd.verify(tvk, tpred, TF.from_int(2), p2)
    assert not tpcd.verify(tvk, tpred, one_t, p2)
    ic = tpcd.ic
    for cfg, snark in ((ic.cycle.main, ic.main_snark),
                       (ic.cycle.help, ic.help_snark)):
        g1, g2 = K1_PER_PROVE[type(snark).__name__]
        for kernel in ("madd_accumulate", "bucket_finish"):
            assert plain[(kernel, cfg.g1.name)] == 2 * g1
            assert plain[(kernel, cfg.g2.name)] == 2 * g2
        assert ("complete_add", cfg.g1.name) not in plain
        assert ("complete_add", cfg.g2.name) not in plain
    assert tec.launch_counts() == {}
