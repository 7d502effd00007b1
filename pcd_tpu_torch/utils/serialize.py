"""Canonical serialization for proofs, verifying keys and proving-key
checkpoints: the port's copy of `pcd_tpu/utils/serialize.py`, cut to the
Groth16 cycle configs the port runs (the GM17, Marlin and ark-serialize
compat layouts stay in the JAX package until those slices are ported).
The byte layouts are identical, so a blob written by either package reads
in the other (pcd_tpu_torch/convert.py relies on this).

Layouts (little-endian; field elements use the canonical 8*ceil(bits/64)
byte layout of fields/prime.py):
  G1/G2 point:  per-coordinate prime-subfield limbs, then 1 flag byte
                (0 = affine, 1 = infinity; infinity stores zero coords)
  proof/vk:     fixed field order per scheme, length-prefixed vectors
"""

from __future__ import annotations

import struct


def _write_point(out, pt):
    if pt.is_infinity():
        F = pt.curve.F
        zero = F.zero() if hasattr(F, "zero") else F.from_int(0)
        coords = zero.to_prime_coeffs() if hasattr(zero, "to_prime_coeffs") \
            else [zero]
        per = len(coords)
        blank = b"\x00" * (coords[0].BYTES if hasattr(coords[0], "BYTES")
                           else len(coords[0].to_bytes()))
        for _ in range(2 * per):
            out.append(blank)
        out.append(b"\x01")
        return
    for coord in (pt.x, pt.y):
        cs = coord.to_prime_coeffs() if hasattr(coord, "to_prime_coeffs") \
            else [coord]
        for c in cs:
            out.append(c.to_bytes())
    out.append(b"\x00")


def _read_point(curve, buf, off):
    F = curve.F
    prime = F.prime_subfield()
    deg = F.extension_degree_over_prime()
    nb = prime.BYTES
    coords = []
    for _ in range(2):
        cs = []
        for _ in range(deg):
            cs.append(prime.from_bytes(bytes(buf[off : off + nb])))
            off += nb
        coords.append(F.from_prime_coeffs(cs) if deg > 1 else cs[0])
    flag = buf[off]
    off += 1
    if flag == 1:
        return curve.infinity(), off
    return curve.point(coords[0], coords[1]), off


def _point_size(curve):
    F = curve.F
    prime = F.prime_subfield()
    return 2 * F.extension_degree_over_prime() * prime.BYTES + 1


# ---------------------------------------------------------------- Groth16
def groth16_proof_to_bytes(proof) -> bytes:
    out = []
    _write_point(out, proof.a)
    _write_point(out, proof.b)
    _write_point(out, proof.c)
    return b"".join(out)


def groth16_proof_from_bytes(cfg, data: bytes):
    from ..snark.groth16.native import Groth16Proof

    off = 0
    a, off = _read_point(cfg.g1, data, off)
    b, off = _read_point(cfg.g2, data, off)
    c, off = _read_point(cfg.g1, data, off)
    return Groth16Proof(a=a, b=b, c=c)


def groth16_vk_to_bytes(vk) -> bytes:
    out = []
    _write_point(out, vk.alpha_g1)
    _write_point(out, vk.beta_g2)
    _write_point(out, vk.gamma_g2)
    _write_point(out, vk.delta_g2)
    out.append(struct.pack("<I", len(vk.gamma_abc)))
    for p in vk.gamma_abc:
        _write_point(out, p)
    return b"".join(out)


def groth16_vk_from_bytes(cfg, data: bytes):
    from ..snark.groth16.native import Groth16VK

    off = 0
    alpha, off = _read_point(cfg.g1, data, off)
    beta, off = _read_point(cfg.g2, data, off)
    gamma, off = _read_point(cfg.g2, data, off)
    delta, off = _read_point(cfg.g2, data, off)
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    abc = []
    for _ in range(n):
        p, off = _read_point(cfg.g1, data, off)
        abc.append(p)
    return Groth16VK(alpha_g1=alpha, beta_g2=beta, gamma_g2=gamma,
                     delta_g2=delta, gamma_abc=abc)


# ---------------------------------------------------------------- PCD level
def pcd_proof_to_bytes(pcd, proof) -> bytes:
    """Serialize a PCD proof (= the help SNARK's proof)."""
    name = type(proof).__name__
    if name == "Groth16Proof":
        return b"G16" + groth16_proof_to_bytes(proof)
    raise TypeError(name)


def pcd_proof_from_bytes(pcd, data: bytes):
    tag, body = data[:3], data[3:]
    if tag == b"G16":
        return groth16_proof_from_bytes(pcd.ic.cycle.help, body)
    raise ValueError(f"unknown proof tag {tag!r}")


def _groth16_only(snark):
    name = type(snark).__name__
    if name != "Groth16":
        raise TypeError(f"{name}: only Groth16 is ported")


def snark_vk_to_bytes(snark, vk) -> bytes:
    _groth16_only(snark)
    return groth16_vk_to_bytes(vk)


def snark_vk_from_bytes(snark, data: bytes):
    _groth16_only(snark)
    return groth16_vk_from_bytes(snark.cfg, data)


def snark_proof_to_bytes(snark, proof) -> bytes:
    _groth16_only(snark)
    return groth16_proof_to_bytes(proof)


def snark_proof_from_bytes(snark, data: bytes):
    _groth16_only(snark)
    return groth16_proof_from_bytes(snark.cfg, data)


# ------------------------------------------------- proving-key checkpoints
# Framework-internal format (the reference never persists keys; this is the
# checkpoint/resume subsystem for long-running deployments).  A query is
# tag 0 + a length-prefixed host point list; tag 1 (the JAX package's
# device-resident u32 query tables) is refused.

def _write_query(out, q):
    out.append(b"\x00")
    out.append(struct.pack("<I", len(q)))
    for p in q:
        _write_point(out, p)


def _read_query(curve, buf, off):
    tag = buf[off]
    off += 1
    if tag != 0:
        raise ValueError("device-resident query tables are not supported")
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    pts = []
    for _ in range(n):
        p, off = _read_point(curve, buf, off)
        pts.append(p)
    return pts, off


def groth16_pk_to_bytes(pk) -> bytes:
    out = []
    out.append(groth16_vk_to_bytes(pk.vk))
    _write_point(out, pk.beta_g1)
    _write_point(out, pk.delta_g1)
    for q in (pk.a_query, pk.b_g1_query, pk.b_g2_query, pk.h_query,
              pk.l_query):
        qo = []
        _write_query(qo, q)
        blob = b"".join(qo)
        out.append(struct.pack("<Q", len(blob)))
        out.append(blob)
    out.append(struct.pack("<II", pk.num_instance, pk.domain_size))
    body = b"".join(out)
    # vk length prefix so from_bytes can split
    vk_len = len(groth16_vk_to_bytes(pk.vk))
    return struct.pack("<Q", vk_len) + body


def groth16_pk_from_bytes(cfg, data: bytes):
    from ..snark.groth16.native import Groth16PK

    (vk_len,) = struct.unpack_from("<Q", data, 0)
    off = 8
    vk = groth16_vk_from_bytes(cfg, data[off : off + vk_len])
    off += vk_len
    beta_g1, off = _read_point(cfg.g1, data, off)
    delta_g1, off = _read_point(cfg.g1, data, off)
    queries = []
    for curve in (cfg.g1, cfg.g1, cfg.g2, cfg.g1, cfg.g1):
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        q, _ = _read_query(curve, data[off : off + blen], 0)
        off += blen
        queries.append(q)
    n_inst, dom = struct.unpack_from("<II", data, off)
    return Groth16PK(vk=vk, beta_g1=beta_g1, delta_g1=delta_g1,
                     a_query=queries[0], b_g1_query=queries[1],
                     b_g2_query=queries[2], h_query=queries[3],
                     l_query=queries[4], num_instance=n_inst,
                     domain_size=dom)


def pcd_pk_to_bytes(pcd, pk) -> bytes:
    """ECCyclePCDPK checkpoint (Groth16/Groth16 configs)."""
    ic = pcd.ic
    assert type(ic.main_snark).__name__ == "Groth16" \
        and type(ic.help_snark).__name__ == "Groth16", \
        "pk checkpointing currently covers the Groth16 cycle configs"
    main_b = groth16_pk_to_bytes(pk.main_pk)
    help_b = groth16_pk_to_bytes(pk.help_pk)
    help_vk_b = groth16_vk_to_bytes(pk.help_vk)
    out = [struct.pack("<I", len(pk.crh_pp.seed)), pk.crh_pp.seed]
    for blob in (main_b, help_b, help_vk_b):
        out.append(struct.pack("<Q", len(blob)))
        out.append(blob)
    return b"".join(out)


def pcd_pk_from_bytes(pcd, data: bytes):
    from ..crh.api import CRHParams
    from ..pcd.ec_cycle import ECCyclePCDPK

    ic = pcd.ic
    (slen,) = struct.unpack_from("<I", data, 0)
    off = 4
    seed = bytes(data[off : off + slen])
    off += slen
    blobs = []
    for _ in range(3):
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        blobs.append(data[off : off + blen])
        off += blen
    main_pk = groth16_pk_from_bytes(ic.cycle.main, blobs[0])
    help_pk = groth16_pk_from_bytes(ic.cycle.help, blobs[1])
    help_vk = groth16_vk_from_bytes(ic.cycle.help, blobs[2])
    main_pvk = ic.main_snark.process_vk(main_pk.vk)
    return ECCyclePCDPK(crh_pp=CRHParams(seed=seed), main_pk=main_pk,
                        main_pvk=main_pvk, help_pk=help_pk, help_vk=help_vk)


def pcd_vk_to_bytes(pcd, vk) -> bytes:
    """ECCyclePCDVK = (crh seed, help vk): the seed and help-vk blobs in
    the pk checkpoint's layout (u32 seed length + seed, then
    groth16_vk_to_bytes of the help vk)."""
    _groth16_only(pcd.ic.help_snark)
    return (struct.pack("<I", len(vk.crh_pp.seed)) + vk.crh_pp.seed
            + groth16_vk_to_bytes(vk.help_vk))


def pcd_vk_from_bytes(pcd, data: bytes):
    from ..crh.api import CRHParams
    from ..pcd.ec_cycle import ECCyclePCDVK

    (slen,) = struct.unpack_from("<I", data, 0)
    seed = bytes(data[4 : 4 + slen])
    help_vk = groth16_vk_from_bytes(pcd.ic.cycle.help, data[4 + slen:])
    return ECCyclePCDVK(crh_pp=CRHParams(seed=seed), help_vk=help_vk)
