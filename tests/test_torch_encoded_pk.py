"""A Groth16 proving key whose tables the keygen kernel made, with no host
point objects, on the port's stream tier (CPU, toy cycle, plain versions):
`EncodedPoints.from_affine_words` of K8's output is the table that
`EncodedPoints` builds from the same points, and gives the same stream
MSM; `zpad_query` pads an encoded l query with encoded rows at infinity,
so l keeps sharing a/b1/b2's one schedule of z and the prove gives the
proof of the host-point key; counter `msm_rows.<curve>` counts each
stream MSM's rows; spans `proof_fixed` (the key's points times r and s,
taken before the collects) and `proof_assemble` open once a
`_prove_commit`; a launch digests z once."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcd_tpu_torch.curves import models as M  # noqa: E402
from pcd_tpu_torch.native import EncodedPoints  # noqa: E402
from pcd_tpu_torch.ops.fixed_base import fixed_base_device  # noqa: E402
from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx  # noqa: E402
from pcd_tpu_torch.snark import msm_dispatch as md  # noqa: E402
from pcd_tpu_torch.snark.groth16.native import (Groth16, Groth16PK,  # noqa
                                                Groth16VK)
from pcd_tpu_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
NZ, NH, N_INST = 34, 32, 2      # z rows, h rows, instance columns (a
# host point list of 32 points or more is encoded: `msm/host.encode_query`)
QUERIES = (("a_query", "g1", NZ), ("b_g1_query", "g1", NZ),
           ("b_g2_query", "g2", NZ), ("l_query", "g1", NZ - N_INST),
           ("h_query", "g1", NH))


@pytest.fixture(scope="module", params=["toy_mnt4", "toy_mnt6"])
def key(request):
    """Toy tables t_i G by K8's plain version, t_i random bytes with a
    zero first scalar (a point at infinity): {"cfg", "t", "words",
    "points"}, each by query."""
    cfg = getattr(M, request.param)()
    rng = np.random.default_rng(29)
    out = {"cfg": cfg, "t": {}, "words": {}, "points": {}}
    for nm, grp, n in QUERIES:
        curve, base = ((cfg.g1, cfg.g1_gen) if grp == "g1"
                       else (cfg.g2, cfg.g2_gen))
        fb = fixed_base_device(curve, base, cfg.Fr.BITS)
        dg = rng.integers(0, 256, size=(fb.nwin, n), dtype=np.uint8)
        dg[:, 0] = 0
        words = fb.mul_digits(torch.from_numpy(dg))
        out["t"][nm] = [int.from_bytes(bytes(dg[:, i]), "little")
                        for i in range(n)]
        out["words"][nm] = words
        out["points"][nm] = fb.to_host(words)
    return out


def _pk(key, encoded: bool):
    cfg = key["cfg"]
    g1, g2 = cfg.g1_gen, cfg.g2_gen
    tab = {nm: (EncodedPoints.from_affine_words(
        cfg.g1 if grp == "g1" else cfg.g2, key["words"][nm]) if encoded
        else list(key["points"][nm])) for nm, grp, _ in QUERIES}
    vk = Groth16VK(alpha_g1=g1 * 3, beta_g2=g2 * 5, gamma_g2=None,
                   delta_g2=g2 * 7, gamma_abc=[])
    return Groth16PK(vk=vk, beta_g1=g1 * 5, delta_g1=g1 * 7,
                     num_instance=N_INST, domain_size=NH + 1, **tab)


@pytest.fixture
def stream(monkeypatch):
    monkeypatch.setattr(Groth16, "STREAM_MIN", 0)
    monkeypatch.setattr(md, "WINDOW_BITS", 6)
    monkeypatch.setattr(md, "LANES", 128)
    profiling.enable()
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _scalars(cfg, seed):
    rng = np.random.default_rng(seed)
    r = cfg.Fr.MODULUS
    zs = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(NZ)]
    hs = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(NH)]
    return zs, hs


def test_words_give_the_points_table(key, stream):
    for nm, grp, n in QUERIES:
        cfg = key["cfg"]
        curve = cfg.g1 if grp == "g1" else cfg.g2
        enc = EncodedPoints.from_affine_words(curve, key["words"][nm])
        ref = EncodedPoints(curve, key["points"][nm])
        assert (enc.n, enc.deg, enc.handle) == (ref.n, ref.deg, ref.handle)
        for f in ("xs", "ys", "inf"):
            assert np.array_equal(getattr(enc, f), getattr(ref, f)), f
        assert enc.inf[0] == 1 and key["points"][nm][0].is_infinity()
        if nm not in ("a_query", "b_g2_query"):
            continue
        # the same stream MSM in each form, the sum of t_i s_i times the
        # generator
        zs = _scalars(cfg, 3)[0][:n]
        limbs = StreamMSMCtx.limb_rows(zs, 40)
        got = [md.stream_collect(md.stream_msm_async(
            SimpleNamespace(q=q), "q", curve, cfg.Fr.BITS, limbs, CPU))
            for q in (enc, ref)]
        gen = cfg.g1_gen if grp == "g1" else cfg.g2_gen
        want = gen * (sum(s * t for s, t in zip(zs, key["t"][nm]))
                      % cfg.Fr.MODULUS)
        assert got[0] == got[1] == want


def test_encoded_key_proves_as_the_point_key(key, stream):
    """The five stream MSMs of an encoded key and of a host-point key: the
    same proof, the reference's A, B, C from the t_i; l padded with
    encoded rows shares z's one schedule (h has its own); msm_rows counts
    every MSM's rows; proof_fixed and proof_assemble open once a
    commit."""
    cfg = key["cfg"]
    r_mod = cfg.Fr.MODULUS
    zs, hs = _scalars(cfg, 5)
    z = StreamMSMCtx.limb_rows(zs, 40)
    h = torch.from_numpy(StreamMSMCtx.limb_rows(hs, 40).view(np.int32)
                         .copy())
    r, s = 11, 13
    proofs = []
    for encoded in (True, False):
        g16 = Groth16(cfg, device="cpu")
        pk = _pk(key, encoded)
        profiling.reset()
        futs = g16._stream_launch(pk, z, N_INST)
        assert profiling.counters().get("sched_host") == 1
        proofs.append(g16._prove_commit(pk, N_INST, None, h, r, s,
                                        z_limbs=z, hybrid=futs))
        ctr = profiling.counters()
        assert ctr["sched_host"] == 2
        assert ctr["msm_rows." + cfg.g1.name] == 3 * NZ + NH
        assert ctr["msm_rows." + cfg.g2.name] == NZ
        assert profiling.totals()["proof_assemble"][1] == 1
        assert profiling.totals()["proof_fixed"][1] == 1
        assert isinstance(pk.l_query_zpad, EncodedPoints) == encoded
        assert len(pk.l_query_zpad) == NZ
    assert proofs[0] == proofs[1]
    t = key["t"]

    def dot(nm, sc):
        return sum(a * b for a, b in zip(sc, t[nm]))

    ka = (3 + dot("a_query", zs) + r * 7) % r_mod
    kb1 = (5 + dot("b_g1_query", zs) + s * 7) % r_mod
    kb2 = (5 + dot("b_g2_query", zs) + s * 7) % r_mod
    kc = (dot("l_query", zs[N_INST:]) + dot("h_query", hs) + s * ka
          + r * kb1 - r * s * 7) % r_mod
    assert proofs[0].a == cfg.g1_gen * ka
    assert proofs[0].b == cfg.g2_gen * kb2
    assert proofs[0].c == cfg.g1_gen * kc


def test_launch_digests_z_once(key, stream):
    """The four z MSMs of a launch take one digest of z and one schedule,
    and the same launch again (another dict) digests it afresh."""
    cfg = key["cfg"]
    z = StreamMSMCtx.limb_rows(_scalars(cfg, 9)[0], 40)
    g16 = Groth16(cfg, device="cpu")
    pk = _pk(key, True)
    for i in (1, 2):
        futs = g16._stream_launch(pk, z, N_INST)
        assert len(futs) == 4
        assert profiling.totals()["stream_dispatch/sched_digest"][1] == i
        assert profiling.counters()["sched_host"] == i
