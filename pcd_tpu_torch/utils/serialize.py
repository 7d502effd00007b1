"""Canonical serialization for proofs, verifying keys and proving-key
checkpoints: the port's copy of `pcd_tpu/utils/serialize.py` for the
Groth16, GM17 and Marlin cycle configs, and its ark-serialize compat
point layout (`ark_point_to_bytes` / `ark_point_from_bytes`, the same
bytes as the JAX package's).  The proof and vk layouts and the Groth16 pk
checkpoint are identical, so a blob written by either package reads in
the other (pcd_tpu_torch/convert.py relies on this).  The JAX package
checkpoints Groth16 pks only; the GM17 and Marlin pk layouts and PCD pks
of the other configs are the port's own, in the same shape.

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


# ---------------------------------------------------------------- Marlin
def _marlin_orders():
    from ..snark.marlin.native import _B1_POLYS, _B3_POLYS

    from ..snark.marlin.native import _R1_COMMS

    evs = list(_B1_POLYS) + list(_B3_POLYS) + [f"sigma_{n}" for n in "ABC"]
    comm1 = sorted(_R1_COMMS)
    comm3 = [f"g_3{n}" for n in "ABC"] + [f"h_3{n}" for n in "ABC"]
    return evs, comm1, comm3


def marlin_proof_to_bytes(proof, Fr) -> bytes:
    evs, comm1, comm3 = _marlin_orders()
    out = []
    for nm in sorted(comm1):
        _write_point(out, proof.comms1[nm].c)
    for nm in ("g_1", "h_1"):
        _write_point(out, proof.comms2[nm].c)
    _write_point(out, proof.comms2["g_1"].shifted)
    for nm in sorted(comm3):
        _write_point(out, proof.comms3[nm].c)
    for nm in [f"g_3{n}" for n in "ABC"]:
        _write_point(out, proof.comms3[nm].shifted)
    out.append(Fr.from_int(proof.sigma3).to_bytes())
    for nm in evs:
        out.append(Fr.from_int(proof.evals[nm]).to_bytes())
    _write_point(out, proof.pi1)
    _write_point(out, proof.pi3)
    return b"".join(out)


def marlin_proof_from_bytes(cfg, data: bytes):
    from ..snark.marlin.kzg import KZGCommitment
    from ..snark.marlin.native import MarlinProof

    Fr = cfg.Fr
    evs, comm1, comm3 = _marlin_orders()
    off = 0
    comms1 = {}
    for nm in sorted(comm1):
        p, off = _read_point(cfg.g1, data, off)
        comms1[nm] = KZGCommitment(c=p)
    g1c, off = _read_point(cfg.g1, data, off)
    h1c, off = _read_point(cfg.g1, data, off)
    g1s, off = _read_point(cfg.g1, data, off)
    comms2 = {"g_1": KZGCommitment(c=g1c, shifted=g1s),
              "h_1": KZGCommitment(c=h1c)}
    c3 = {}
    for nm in sorted(comm3):
        p, off = _read_point(cfg.g1, data, off)
        c3[nm] = KZGCommitment(c=p)
    for nm in [f"g_3{n}" for n in "ABC"]:
        p, off = _read_point(cfg.g1, data, off)
        c3[nm] = KZGCommitment(c=c3[nm].c, shifted=p)
    nb = Fr.BYTES
    sigma3 = Fr.from_bytes(bytes(data[off : off + nb])).n
    off += nb
    evals = {}
    for nm in evs:
        evals[nm] = Fr.from_bytes(bytes(data[off : off + nb])).n
        off += nb
    pi1, off = _read_point(cfg.g1, data, off)
    pi3, off = _read_point(cfg.g1, data, off)
    return MarlinProof(comms1=comms1, comms2=comms2, comms3=c3,
                       sigma3=sigma3, evals=evals, pi1=pi1, pi3=pi3)


# ---------------------------------------------------------------- PCD level
def pcd_proof_to_bytes(pcd, proof) -> bytes:
    """Serialize a PCD proof (= the help SNARK's proof)."""
    name = type(proof).__name__
    if name == "Groth16Proof":
        return b"G16" + groth16_proof_to_bytes(proof)
    if name == "GM17Proof":
        return b"GM7" + gm17_proof_to_bytes(proof)
    if name == "MarlinProof":
        return b"MRL" + marlin_proof_to_bytes(proof, pcd.ic.cycle.help.Fr)
    raise TypeError(name)


def pcd_proof_from_bytes(pcd, data: bytes):
    help_cfg = pcd.ic.cycle.help
    tag, body = data[:3], data[3:]
    if tag == b"G16":
        return groth16_proof_from_bytes(help_cfg, body)
    if tag == b"GM7":
        return gm17_proof_from_bytes(help_cfg, body)
    if tag == b"MRL":
        return marlin_proof_from_bytes(help_cfg, body)
    raise ValueError(f"unknown proof tag {tag!r}")


def marlin_vk_to_bytes(vk) -> bytes:
    out = []
    for nm in sorted(vk.index_comms):
        _write_point(out, vk.index_comms[nm].c)
    _write_point(out, vk.srs_h)
    _write_point(out, vk.srs_tau_h)
    _write_point(out, vk.srs_g)
    out.append(struct.pack("<5Q", vk.n, vk.k_size, vk.input_size,
                           vk.num_instance, vk.max_degree))
    return b"".join(out)


def marlin_vk_from_bytes(cfg, data: bytes):
    from ..snark.marlin.kzg import KZGCommitment
    from ..snark.marlin.native import MarlinIndexVK

    names = sorted([f"{kind}_{m}" for kind in ("row", "col", "val")
                    for m in "ABC"])
    off = 0
    comms = {}
    for nm in names:
        p, off = _read_point(cfg.g1, data, off)
        comms[nm] = KZGCommitment(c=p)
    h, off = _read_point(cfg.g2, data, off)
    tau_h, off = _read_point(cfg.g2, data, off)
    g, off = _read_point(cfg.g1, data, off)
    n, k, hx, ninst, d = struct.unpack_from("<5Q", data, off)
    return MarlinIndexVK(index_comms=comms, n=n, k_size=k, input_size=hx,
                         num_instance=ninst, srs_h=h, srs_tau_h=tau_h,
                         srs_g=g, max_degree=d)


_SCHEME_SERIALIZERS = {
    "Groth16": (groth16_vk_to_bytes, groth16_vk_from_bytes,
                groth16_proof_to_bytes, groth16_proof_from_bytes),
    "GM17": (gm17_vk_to_bytes, gm17_vk_from_bytes,
             gm17_proof_to_bytes, gm17_proof_from_bytes),
    # a Marlin proof's writer needs Fr: snark_proof_to_bytes passes it
    "MarlinSNARK": (marlin_vk_to_bytes, marlin_vk_from_bytes,
                    None, marlin_proof_from_bytes),
}


def _scheme(snark, table=_SCHEME_SERIALIZERS):
    """The serializers in `table` of a Groth16, GM17 or Marlin SNARK."""
    name = type(snark).__name__
    if name not in table:
        raise TypeError(f"{name}: no serializer")
    return table[name]


def snark_vk_to_bytes(snark, vk) -> bytes:
    return _scheme(snark)[0](vk)


def snark_vk_from_bytes(snark, data: bytes):
    return _scheme(snark)[1](snark.cfg, data)


def snark_proof_to_bytes(snark, proof) -> bytes:
    if type(snark).__name__ == "MarlinSNARK":
        return marlin_proof_to_bytes(proof, snark.cfg.Fr)
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


def _write_frs(out, Fr, vals):
    out.append(struct.pack("<Q", len(vals)))
    out.append(b"".join(int(v).to_bytes(Fr.BYTES, "little") for v in vals))


def _read_frs(Fr, buf, off):
    (n,) = struct.unpack_from("<Q", buf, off)
    off += 8
    nb = Fr.BYTES
    vals = [Fr.from_bytes(bytes(buf[off + i * nb:off + (i + 1) * nb])).n
            for i in range(n)]
    return vals, off + n * nb


_MARLIN_VECS = ("row", "col", "val", "row_evals", "col_evals", "val_evals")


def marlin_pk_to_bytes(cfg, pk) -> bytes:
    """The port's Marlin pk checkpoint: u64 vk length and the vk; the
    index: u64 n, k_size, input_size, num_instance and num_vars, the
    u64-counted u32 col_map, then per matrix A, B, C its index
    polynomials and evaluations (row, col, val, row_evals, col_evals,
    val_evals) as u64-counted Fr lists and its u64-counted entries (u32
    row, u32 col, Fr value); then the SRS: the u64-length-prefixed powers
    query, H, tau H and u64 max_degree.  An Fr element is its canonical
    little-endian Fr.BYTES."""
    Fr = cfg.Fr
    vk_b = marlin_vk_to_bytes(pk.vk)
    out = [struct.pack("<Q", len(vk_b)), vk_b]
    idx = pk.index
    out.append(struct.pack("<5Q", idx.n, idx.k_size, idx.input_size,
                           idx.num_instance, idx.num_vars))
    out.append(struct.pack(f"<Q{len(idx.col_map)}I", len(idx.col_map),
                           *idx.col_map))
    for name in "ABC":
        m = idx.mats[name]
        for vec in _MARLIN_VECS:
            _write_frs(out, Fr, getattr(m, vec))
        entries = idx.rows_cols_vals[name]
        out.append(struct.pack("<Q", len(entries)))
        out.append(b"".join(struct.pack("<II", r, c)
                            + int(v).to_bytes(Fr.BYTES, "little")
                            for r, c, v in entries))
    srs = pk.srs
    qo = []
    _write_query(qo, srs.powers_g1)
    blob = b"".join(qo)
    out += [struct.pack("<Q", len(blob)), blob]
    _write_point(out, srs.h)
    _write_point(out, srs.tau_h)
    out.append(struct.pack("<Q", srs.max_degree))
    return b"".join(out)


def marlin_pk_from_bytes(cfg, data: bytes):
    from ..snark.marlin.ahp import AHPIndex, MatrixArith
    from ..snark.marlin.kzg import KZGSRS
    from ..snark.marlin.native import MarlinIndexPK

    Fr = cfg.Fr
    (vk_len,) = struct.unpack_from("<Q", data, 0)
    off = 8
    vk = marlin_vk_from_bytes(cfg, data[off:off + vk_len])
    off += vk_len
    n, k_size, hx, n_inst, n_vars = struct.unpack_from("<5Q", data, off)
    off += 40
    (ncol,) = struct.unpack_from("<Q", data, off)
    col_map = list(struct.unpack_from(f"<{ncol}I", data, off + 8))
    off += 8 + 4 * ncol
    mats, raw = {}, {}
    for name in "ABC":
        vecs = []
        for _ in _MARLIN_VECS:
            v, off = _read_frs(Fr, data, off)
            vecs.append(v)
        mats[name] = MatrixArith(*vecs)
        (ne,) = struct.unpack_from("<Q", data, off)
        off += 8
        entries = []
        for _ in range(ne):
            r, c = struct.unpack_from("<II", data, off)
            v = Fr.from_bytes(bytes(data[off + 8:off + 8 + Fr.BYTES])).n
            entries.append((r, c, v))
            off += 8 + Fr.BYTES
        raw[name] = entries
    index = AHPIndex(n=n, k_size=k_size, input_size=hx, num_instance=n_inst,
                     num_vars=n_vars, col_map=col_map, mats=mats,
                     rows_cols_vals=raw)
    (blen,) = struct.unpack_from("<Q", data, off)
    off += 8
    powers, _ = _read_query(cfg.g1, data[off:off + blen], 0)
    off += blen
    h, off = _read_point(cfg.g2, data, off)
    tau_h, off = _read_point(cfg.g2, data, off)
    (max_degree,) = struct.unpack_from("<Q", data, off)
    srs = KZGSRS(powers_g1=powers, shifted_g1={}, h=h, tau_h=tau_h,
                 max_degree=max_degree)
    return MarlinIndexPK(vk=vk, index=index, srs=srs)


# SNARK class name -> (pk writer (cfg, pk), pk reader (cfg, data))
_PK_SERIALIZERS = {
    "Groth16": (lambda cfg, pk: groth16_pk_to_bytes(pk),
                groth16_pk_from_bytes),
    "GM17": (lambda cfg, pk: gm17_pk_to_bytes(pk), gm17_pk_from_bytes),
    "MarlinSNARK": (marlin_pk_to_bytes, marlin_pk_from_bytes),
}


def pcd_pk_to_bytes(pcd, pk) -> bytes:
    """ECCyclePCDPK checkpoint, any mix of Groth16 and GM17, or Marlin: u32
    CRH-seed length and the seed, then the main pk, the help pk and the
    help vk, each u64-length-prefixed in its SNARK's layout.  For
    Groth16/Groth16 the bytes are the JAX package's."""
    ic = pcd.ic
    main_to, _ = _scheme(ic.main_snark, _PK_SERIALIZERS)
    help_to, _ = _scheme(ic.help_snark, _PK_SERIALIZERS)
    main_b = main_to(ic.cycle.main, pk.main_pk)
    help_b = help_to(ic.cycle.help, pk.help_pk)
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


# ------------------------------------------------- ark-serialize compat
# Compressed/uncompressed short-Weierstrass point layout matching
# ark-serialize (reference Cargo.toml:16 pin; vk/proof bytes are hashed at
# ec_cycle_pcd/mod.rs:123-141, so this layout is consensus-critical for
# cross-checking against future arkworks golden vectors):
#   - a base-field element is ceil((BITS + flag_bits)/8) little-endian
#     bytes; extension elements are c0..c_{d-1} in order
#   - SWFlags live in the top two bits of the LAST byte of the LAST
#     coefficient: bit 7 = positive-y (y > -y), bit 6 = infinity
#   - compressed = x with flags; uncompressed = x plain, then y with flags
#   - infinity serializes zero coordinates with the infinity flag
# The y-sign comparison for extension fields is lexicographic from the
# highest coefficient down (ark_ff's Ord on QuadExt/CubicExt compares c1
# resp. c2 first).  UNVERIFIED against vendored arkworks bytes (deps are
# not on disk — SURVEY.md L1 note); golden-vector tests can be dropped in
# without code changes.

_ARK_POSITIVE_Y = 1 << 7
_ARK_INFINITY = 1 << 6


def _ark_coeff_sizes(prime, flag_bits: int):
    plain = (prime.BITS + 7) // 8
    flagged = (prime.BITS + flag_bits + 7) // 8
    return plain, flagged


def _ark_write_field(out, elem, prime, deg, flags: int | None):
    """Append one (possibly extension) field element; `flags` goes into
    the final coefficient's final byte (None = no flag bits reserved)."""
    plain, flagged = _ark_coeff_sizes(prime, 2 if flags is not None else 0)
    coeffs = elem.to_prime_coeffs() if deg > 1 else [elem]
    for i, c in enumerate(coeffs):
        last = i == deg - 1
        size = flagged if (last and flags is not None) else plain
        b = bytearray(int(c.n).to_bytes(size, "little"))
        if last and flags is not None:
            b[-1] |= flags
        out.append(bytes(b))


def _ark_read_field(curve, buf, off, with_flags: bool):
    F = curve.F
    prime = F.prime_subfield()
    deg = F.extension_degree_over_prime()
    plain, flagged = _ark_coeff_sizes(prime, 2 if with_flags else 0)
    coeffs = []
    flags = 0
    for i in range(deg):
        last = i == deg - 1
        size = flagged if (last and with_flags) else plain
        raw = bytearray(buf[off : off + size])
        off += size
        if last and with_flags:
            flags = raw[-1] & (_ARK_POSITIVE_Y | _ARK_INFINITY)
            raw[-1] &= ~(_ARK_POSITIVE_Y | _ARK_INFINITY) & 0xFF
        n = int.from_bytes(raw, "little")
        if n >= prime.MODULUS:
            raise ValueError("ark point coefficient >= modulus")
        coeffs.append(prime.from_int(n))
    elem = F.from_prime_coeffs(coeffs) if deg > 1 else coeffs[0]
    return elem, flags, off


def _ark_y_is_positive(y) -> bool:
    """arkworks' from_y_sign(y > -y): lexicographic compare, highest
    extension coefficient first."""
    ny = -y
    if hasattr(y, "to_prime_coeffs"):
        a = tuple(int(c.n) for c in reversed(y.to_prime_coeffs()))
        b = tuple(int(c.n) for c in reversed(ny.to_prime_coeffs()))
        return a > b
    return int(y.n) > int(ny.n)


def ark_point_size(curve, compressed: bool = True) -> int:
    prime = curve.F.prime_subfield()
    deg = curve.F.extension_degree_over_prime()
    plain, flagged = _ark_coeff_sizes(prime, 2)
    one = (deg - 1) * plain + flagged
    return one if compressed else (deg * plain + one)


def ark_point_to_bytes(pt, compressed: bool = True) -> bytes:
    curve = pt.curve
    F = curve.F
    prime = F.prime_subfield()
    deg = F.extension_degree_over_prime()
    out = []
    if pt.is_infinity():
        zero = F.from_int(0) if deg == 1 else F.zero()
        if compressed:
            _ark_write_field(out, zero, prime, deg, _ARK_INFINITY)
        else:
            _ark_write_field(out, zero, prime, deg, None)
            _ark_write_field(out, zero, prime, deg, _ARK_INFINITY)
        return b"".join(out)
    sign = _ARK_POSITIVE_Y if _ark_y_is_positive(pt.y) else 0
    if compressed:
        _ark_write_field(out, pt.x, prime, deg, sign)
    else:
        _ark_write_field(out, pt.x, prime, deg, None)
        _ark_write_field(out, pt.y, prime, deg, sign)
    return b"".join(out)


def ark_point_from_bytes(curve, data, compressed: bool = True, off: int = 0):
    """Parse one point; returns (point, next_offset).  Compressed points
    recover y from the curve equation and the sign flag; all points are
    curve-checked (unlike new_verification_key_unchecked in the reference,
    data_structures.rs:153-162 — deserialization here always validates)."""
    if compressed:
        x, flags, off = _ark_read_field(curve, data, off, True)
        if flags & _ARK_INFINITY:
            return curve.infinity(), off
        rhs = x * x * x + curve.a * x + curve.b
        y = rhs.sqrt()
        if y is None:
            raise ValueError("ark point x has no corresponding y")
        want_pos = bool(flags & _ARK_POSITIVE_Y)
        if _ark_y_is_positive(y) != want_pos:
            y = -y
        return curve.point(x, y), off
    x, _, off = _ark_read_field(curve, data, off, False)
    y, flags, off = _ark_read_field(curve, data, off, True)
    if flags & _ARK_INFINITY:
        return curve.infinity(), off
    pos = bool(flags & _ARK_POSITIVE_Y)
    if _ark_y_is_positive(y) != pos:
        raise ValueError("ark point y-sign flag inconsistent with y")
    return curve.point(x, y), off
