"""Canonical serialization for proofs, verifying keys and proving-key
checkpoints: the port's copy of `pcd_tpu/utils/serialize.py`, cut to the
Groth16 and GM17 cycle configs the port runs (the Marlin and
ark-serialize compat layouts stay in the JAX package until those slices
are ported).  The proof and vk layouts and the Groth16 pk checkpoint are
identical, so a blob written by either package reads in the other
(pcd_tpu_torch/convert.py relies on this).  The JAX package checkpoints
Groth16 pks only; the GM17 pk layout and PCD pks of GM17 and mixed
configs are the port's own, in the same shape.

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


# ---------------------------------------------------------------- GM17
def gm17_proof_to_bytes(proof) -> bytes:
    out = []
    _write_point(out, proof.a)
    _write_point(out, proof.b)
    _write_point(out, proof.c)
    return b"".join(out)


def gm17_proof_from_bytes(cfg, data: bytes):
    from ..snark.gm17.native import GM17Proof

    off = 0
    a, off = _read_point(cfg.g1, data, off)
    b, off = _read_point(cfg.g2, data, off)
    c, off = _read_point(cfg.g1, data, off)
    return GM17Proof(a=a, b=b, c=c)


def gm17_vk_to_bytes(vk) -> bytes:
    out = []
    _write_point(out, vk.alpha_g1)
    _write_point(out, vk.alpha_g2)
    _write_point(out, vk.gamma_g1)
    _write_point(out, vk.gamma_g2)
    _write_point(out, vk.delta_g2)
    out.append(struct.pack("<I", len(vk.query)))
    for p in vk.query:
        _write_point(out, p)
    return b"".join(out)


def gm17_vk_from_bytes(cfg, data: bytes):
    from ..snark.gm17.native import GM17VK

    off = 0
    a1, off = _read_point(cfg.g1, data, off)
    a2, off = _read_point(cfg.g2, data, off)
    g1, off = _read_point(cfg.g1, data, off)
    g2, off = _read_point(cfg.g2, data, off)
    d2, off = _read_point(cfg.g2, data, off)
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    q = []
    for _ in range(n):
        p, off = _read_point(cfg.g1, data, off)
        q.append(p)
    return GM17VK(alpha_g1=a1, alpha_g2=a2, gamma_g1=g1, gamma_g2=g2,
                  delta_g2=d2, query=q)


# ---------------------------------------------------------------- PCD level
def pcd_proof_to_bytes(pcd, proof) -> bytes:
    """Serialize a PCD proof (= the help SNARK's proof)."""
    name = type(proof).__name__
    if name == "Groth16Proof":
        return b"G16" + groth16_proof_to_bytes(proof)
    if name == "GM17Proof":
        return b"GM7" + gm17_proof_to_bytes(proof)
    raise TypeError(name)


def pcd_proof_from_bytes(pcd, data: bytes):
    help_cfg = pcd.ic.cycle.help
    tag, body = data[:3], data[3:]
    if tag == b"G16":
        return groth16_proof_from_bytes(help_cfg, body)
    if tag == b"GM7":
        return gm17_proof_from_bytes(help_cfg, body)
    raise ValueError(f"unknown proof tag {tag!r}")


_SCHEME_SERIALIZERS = {
    "Groth16": (groth16_vk_to_bytes, groth16_vk_from_bytes,
                groth16_proof_to_bytes, groth16_proof_from_bytes),
    "GM17": (gm17_vk_to_bytes, gm17_vk_from_bytes,
             gm17_proof_to_bytes, gm17_proof_from_bytes),
}


def _scheme(snark, table=_SCHEME_SERIALIZERS):
    """The serializers in `table` of a Groth16 or GM17 SNARK (the schemes
    ported)."""
    name = type(snark).__name__
    if name not in table:
        raise TypeError(f"{name}: only Groth16 and GM17 are ported")
    return table[name]


def snark_vk_to_bytes(snark, vk) -> bytes:
    return _scheme(snark)[0](vk)


def snark_vk_from_bytes(snark, data: bytes):
    return _scheme(snark)[1](snark.cfg, data)


def snark_proof_to_bytes(snark, proof) -> bytes:
    return _scheme(snark)[2](proof)


def snark_proof_from_bytes(snark, data: bytes):
    return _scheme(snark)[3](snark.cfg, data)


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


def gm17_pk_to_bytes(pk) -> bytes:
    """The port's GM17 pk checkpoint, in groth16_pk_to_bytes' shape: u64
    vk length, the vk (its `query` included), delta_g1, delta_g2, then
    a_query, b_query, c_query and h_query each u64-length-prefixed, then
    u32 num_instance, num_vars and domain_size."""
    vk_b = gm17_vk_to_bytes(pk.vk)
    out = [struct.pack("<Q", len(vk_b)), vk_b]
    _write_point(out, pk.delta_g1)
    _write_point(out, pk.delta_g2)
    for q in (pk.a_query, pk.b_query, pk.c_query, pk.h_query):
        qo = []
        _write_query(qo, q)
        blob = b"".join(qo)
        out.append(struct.pack("<Q", len(blob)))
        out.append(blob)
    out.append(struct.pack("<III", pk.num_instance, pk.num_vars,
                           pk.domain_size))
    return b"".join(out)


def gm17_pk_from_bytes(cfg, data: bytes):
    from ..snark.gm17.native import GM17PK

    (vk_len,) = struct.unpack_from("<Q", data, 0)
    off = 8
    vk = gm17_vk_from_bytes(cfg, data[off : off + vk_len])
    off += vk_len
    delta_g1, off = _read_point(cfg.g1, data, off)
    delta_g2, off = _read_point(cfg.g2, data, off)
    queries = []
    for curve in (cfg.g1, cfg.g2, cfg.g1, cfg.g1):
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        q, _ = _read_query(curve, data[off : off + blen], 0)
        off += blen
        queries.append(q)
    n_inst, n_vars, dom = struct.unpack_from("<III", data, off)
    return GM17PK(vk=vk, delta_g1=delta_g1, delta_g2=delta_g2,
                  a_query=queries[0], b_query=queries[1],
                  c_query=queries[2], h_query=queries[3],
                  num_instance=n_inst, num_vars=n_vars, domain_size=dom)


_PK_SERIALIZERS = {"Groth16": (groth16_pk_to_bytes, groth16_pk_from_bytes),
                   "GM17": (gm17_pk_to_bytes, gm17_pk_from_bytes)}


def pcd_pk_to_bytes(pcd, pk) -> bytes:
    """ECCyclePCDPK checkpoint, any mix of Groth16 and GM17: u32 CRH-seed
    length and the seed, then the main pk, the help pk and the help vk,
    each u64-length-prefixed in its SNARK's layout.  For Groth16/Groth16
    the bytes are the JAX package's."""
    ic = pcd.ic
    main_to, _ = _scheme(ic.main_snark, _PK_SERIALIZERS)
    help_to, _ = _scheme(ic.help_snark, _PK_SERIALIZERS)
    main_b = main_to(pk.main_pk)
    help_b = help_to(pk.help_pk)
    help_vk_b = snark_vk_to_bytes(ic.help_snark, pk.help_vk)
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
    _, main_from = _scheme(ic.main_snark, _PK_SERIALIZERS)
    _, help_from = _scheme(ic.help_snark, _PK_SERIALIZERS)
    main_pk = main_from(ic.cycle.main, blobs[0])
    help_pk = help_from(ic.cycle.help, blobs[1])
    help_vk = snark_vk_from_bytes(ic.help_snark, blobs[2])
    main_pvk = ic.main_snark.process_vk(main_pk.vk)
    return ECCyclePCDPK(crh_pp=CRHParams(seed=seed), main_pk=main_pk,
                        main_pvk=main_pvk, help_pk=help_pk, help_vk=help_vk)


def pcd_vk_to_bytes(pcd, vk) -> bytes:
    """ECCyclePCDVK = (crh seed, help vk): the seed and help-vk blobs in
    the pk checkpoint's layout (u32 seed length + seed, then the help
    SNARK's vk bytes)."""
    return (struct.pack("<I", len(vk.crh_pp.seed)) + vk.crh_pp.seed
            + snark_vk_to_bytes(pcd.ic.help_snark, vk.help_vk))


def pcd_vk_from_bytes(pcd, data: bytes):
    from ..crh.api import CRHParams
    from ..pcd.ec_cycle import ECCyclePCDVK

    (slen,) = struct.unpack_from("<I", data, 0)
    seed = bytes(data[4 : 4 + slen])
    help_vk = snark_vk_from_bytes(pcd.ic.help_snark, data[4 + slen:])
    return ECCyclePCDVK(crh_pp=CRHParams(seed=seed), help_vk=help_vk)
