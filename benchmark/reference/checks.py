"""The benchmark's plain reference: what the program's outputs are judged
by.  Plain Python on the frozen field, curve, pairing, ChaCha and CRH code
beside it; it imports nothing of the program, and takes from it only the
outputs it judges.

Points cross from the harness as plain integers: None for the identity,
else (x, y), each a list of the coordinate's prime-field coefficients.

Chains (`check_chain`).  The keys are drawn from one ChaCha stream of the
run's seed, in the order the construction draws them: the CRH's 32-byte
seed, then the main SNARK's trapdoor (Groth16: tau, alpha, beta, gamma,
delta; GM17: s, alpha, gamma, delta, each uniform in [1, r)), then the help
SNARK's.  The reference draws them again, so it holds the verifying keys'
trapdoor elements (alpha G1, beta G2, ...) to its own products, and the
CRH seed to its own.  The public-input elements of a key (Groth16's
gamma_abc, GM17's query) need the circuit, which the reference does not
rebuild: they are the program's, judged only through the proofs that
verify against them.  Each sampled step's two proofs are then verified:
the main SNARK's proof against the main vk and the public input x = H(H(
help vk) || msg) by the CRH, and the PCD proof (the help proof) as the
construction verifies it, x repacked from the main scalar field into the
help one, against the help vk.  So the main prover is judged by the
reference's own pairing, not only through the help circuit's verifier
gadget.

MSMs (`msm_expected`).  The benchmark makes each table point P_i = t_i G
from integers t_i of its own, so an MSM sum s_i P_i is (sum s_i t_i mod r)
G: one sum of products and one scalar multiplication.
"""

from __future__ import annotations

from . import models as M
from .ate import AtePairing
from .crh import BoweHopwoodCRH
from .rng import ChaChaRng

# SNARK kind -> the names of its trapdoor draws and its vk's trapdoor
# elements (element, group, trapdoor name)
TRAPDOOR = {
    "groth16": (("tau", "alpha", "beta", "gamma", "delta"),
                (("alpha_g1", "g1", "alpha"), ("beta_g2", "g2", "beta"),
                 ("gamma_g2", "g2", "gamma"), ("delta_g2", "g2", "delta"))),
    "gm17": (("s", "alpha", "gamma", "delta"),
             (("alpha_g1", "g1", "alpha"), ("alpha_g2", "g2", "alpha"),
              ("gamma_g1", "g1", "gamma"), ("gamma_g2", "g2", "gamma"),
              ("delta_g2", "g2", "delta"))),
}
# the vk's points in the order its hash serializes them
VK_ORDER = {"groth16": ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2",
                        "gamma_abc"),
            "gm17": ("alpha_g1", "alpha_g2", "gamma_g1", "gamma_g2",
                     "delta_g2", "query")}


def cycle(name: str):
    return {"mnt": M.mnt_cycle, "toy": M.toy_cycle}[name]()


def point(curve, enc):
    """A plain (x, y) encoding -> a point of `curve` (raises ValueError if
    it is not on the curve)."""
    if enc is None:
        return curve.infinity()
    F = curve.F
    xs, ys = enc
    if len(xs) == 1:
        return curve.point(F.from_int(xs[0]), F.from_int(ys[0]))
    prime = F.prime_subfield()
    return curve.point(F.from_prime_coeffs([prime.from_int(v) for v in xs]),
                       F.from_prime_coeffs([prime.from_int(v) for v in ys]))


def encode(P):
    """A point -> its plain encoding."""
    if P.is_infinity():
        return None
    return tuple([c.n for c in (v.to_prime_coeffs() if hasattr(
        v, "to_prime_coeffs") else [v])] for v in (P.x, P.y))


def vk_bytes(kind: str, vk: dict) -> bytes:
    """The byte image the PCD hashes a help vk by: each point's x, then y,
    prime-field coefficients, each in its field's little-endian bytes (the
    verifier gadget's layout), in VK_ORDER."""
    out = bytearray()
    for name in VK_ORDER[kind]:
        pts = vk[name] if isinstance(vk[name], list) else [vk[name]]
        for P in pts:
            for coord in (P.x, P.y):
                for c in (coord.to_prime_coeffs()
                          if hasattr(coord, "to_prime_coeffs") else [coord]):
                    out += c.to_bytes()
    return bytes(out)


def repack(F_src, F_dst, elems) -> list:
    """F_src elements -> F_dst elements: the little-endian bits of each
    (F_src.BITS each), cut into chunks of F_dst.CAPACITY bits."""
    bits = [(e.n >> i) & 1 for e in elems for i in range(F_src.BITS)]
    cap = F_dst.CAPACITY
    return [F_dst.from_int(sum(b << j for j, b in enumerate(
        bits[i: i + cap]))) for i in range(0, len(bits), cap)]


def _lincomb(points, xs):
    acc = points[0].curve.infinity()
    for P, x in zip(points, xs):
        acc = acc + P * x
    return acc


def verify(kind: str, cfg, vk: dict, inputs, proof: dict) -> bool:
    """The SNARK's verification equations over curve `cfg`."""
    e = AtePairing(cfg)
    xs = [1] + [x.n for x in inputs]
    a, b, c = proof["a"], proof["b"], proof["c"]
    if kind == "groth16":
        if len(xs) != len(vk["gamma_abc"]):
            return False
        acc = _lincomb(vk["gamma_abc"], xs)
        return e.multi_pairing([(a, b), (-acc, vk["gamma_g2"]),
                                (-c, vk["delta_g2"])]) == e.pairing(
            vk["alpha_g1"], vk["beta_g2"])
    if len(xs) != len(vk["query"]):
        return False
    psi = _lincomb(vk["query"], xs)
    eq1 = e.multi_pairing([(a, b), (-psi, vk["gamma_g2"]),
                           (-c, vk["delta_g2"])]) == e.pairing(
        vk["alpha_g1"], vk["alpha_g2"])
    eq2 = e.multi_pairing([(a, vk["gamma_g2"]),
                           (-vk["gamma_g1"], b)]).is_one()
    return eq1 and eq2


def _decode_vk(cfg, vk: dict) -> dict:
    out = {}
    for name, enc in vk.items():
        grp = cfg.g2 if name.endswith("_g2") else cfg.g1
        out[name] = ([point(grp, p) for p in enc] if isinstance(enc, list)
                     else point(grp, enc))
    return out


def _decode_proof(cfg, proof: dict) -> dict:
    return {"a": point(cfg.g1, proof["a"]), "b": point(cfg.g2, proof["b"]),
            "c": point(cfg.g1, proof["c"])}


def check_chain(cycle_name: str, kinds, seed_bytes: bytes, keys: dict,
                steps, shift: int = 0) -> dict:
    """Judge a chain's keys and the PCD proofs of its sampled steps.

    kinds: (main SNARK kind, help SNARK kind); seed_bytes: the ChaCha seed
    the program's setup drew its keys from; keys: {"crh_seed": bytes,
    "main_vk": plain vk, "help_vk": plain vk}; steps: [(msg as an int,
    plain PCD proof {"a", "b", "c"}, plain main proof)].  shift: judge
    each proof against msg + shift (the control: a statement the chain
    never proved).

    Returns {"bad_keys": key elements that differ from the reference's,
    "bad_proofs": sampled steps whose main or PCD proof does not verify,
    "checked": steps judged}."""
    cyc = cycle(cycle_name)
    rng = ChaChaRng(seed_bytes)
    crh = BoweHopwoodCRH(cyc.crh_te)
    bad_keys = int(BoweHopwoodCRH.setup_seed(rng) != keys["crh_seed"])
    vks = {}
    for side, cfg, kind in (("main", cyc.main, kinds[0]),
                            ("help", cyc.help, kinds[1])):
        names, elems = TRAPDOOR[kind]
        p = cfg.Fr.MODULUS
        td = {n: rng.randrange(1, p) for n in names}
        try:
            vk = _decode_vk(cfg, keys[side + "_vk"])
        except ValueError:
            bad_keys += len(elems) + 1
            continue
        for elem, grp, t in elems:
            gen = cfg.g1_gen if grp == "g1" else cfg.g2_gen
            bad_keys += int(vk[elem] != gen * td[t])
        vks[side] = vk
    if len(vks) < 2:
        return {"bad_keys": bad_keys, "bad_proofs": len(steps),
                "checked": len(steps)}
    help_vk = vks["help"]
    Fm = cyc.main.Fr
    vk_hash = crh.evaluate(keys["crh_seed"],
                           vk_bytes(kinds[1], help_vk)).to_bytes()
    bad = 0
    for msg, proof, main_proof in steps:
        try:
            pf = _decode_proof(cyc.help, proof)
            main_pf = _decode_proof(cyc.main, main_proof)
        except ValueError:
            bad += 1
            continue
        x = crh.evaluate(keys["crh_seed"],
                         vk_hash + Fm.from_int(msg + shift).to_bytes())
        ok = verify(kinds[0], cyc.main, vks["main"], [x], main_pf)
        bad += int(not (ok and verify(kinds[1], cyc.help, help_vk,
                                      repack(Fm, cyc.main.Fq, [x]), pf)))
    return {"bad_keys": bad_keys, "bad_proofs": bad, "checked": len(steps)}


def msm_expected(cfg, group: str, t, s):
    """sum_i s_i [t_i] G for G the generator of cfg's `group` ("g1" or
    "g2"), as a plain encoding: (sum s_i t_i mod r) G."""
    r = cfg.Fr.MODULUS
    k = sum(map(int.__mul__, s, t)) % r
    gen = cfg.g1_gen if group == "g1" else cfg.g2_gen
    return encode(gen * k)
