"""Marlin verifier gadget (role of ark-marlin's MarlinSNARKGadget +
FiatShamirAlgebraicSpongeRngVar — reference tests/mnt4_marlin.rs:76-94).

Runs the full Marlin verification inside an R1CS over cfg.Fq (the cycle
partner field):

  - the Poseidon transcript is NATIVE (the sponge field was chosen as this
    circuit's field — that is the whole point of the reference's
    FS<Fr, Fq, PoseidonSponge<Fq>> type);  commitment coordinates absorb
    directly, Fr data absorbs via bit-packing identical to the native path;
  - challenges are squeezed as 128-bit Boolean strings, used both as
    nonnative Fr values (AHP identity checks — pcd_tpu/gadgets/nonnative)
    and as scalar bits (KZG combination MSMs);
  - the two batched KZG pairing checks run with the shared pairing gadget.

Returns a Boolean (AND of identity checks + both pairing checks) — same
contract as the Groth16/GM17 gadgets, so the PCD circuits are SNARK-
agnostic.

The port's copy of `pcd_tpu/snark/marlin/gadget.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...gadgets.fields_ext import circuit_tower
from ...gadgets.fp import Boolean, UInt8, fpvar_class
from ...gadgets.inputs import BooleanInputVar, repack_native
from ...gadgets.nonnative import NonNativeParams, NonNativeVar
from ...gadgets.pairing import PairingGadget
from ...gadgets.sw import AffinePointVar, SWProjVar
from .native import _B1_POLYS, _B3_POLYS
from .poseidon import PoseidonSponge


@dataclass
class MarlinVKVar:
    index_comms: dict      # name -> AffinePointVar (G1)
    n: int
    k_size: int
    input_size: int
    num_instance: int
    max_degree: int
    h: AffinePointVar       # G2
    tau_h: AffinePointVar   # G2
    g: AffinePointVar       # G1 generator (constant)


@dataclass
class MarlinProofVar:
    comms1: dict
    comms2: dict            # includes g_1 shifted as 'g_1_shifted'
    comms3: dict
    sigma3: NonNativeVar
    evals: dict             # name -> NonNativeVar
    pi1: AffinePointVar
    pi3: AffinePointVar


def _eval_order(evals: dict):
    """Canonical allocation order for proof.evals — independent of dict
    insertion order (which serialization round-trips may not preserve)."""
    canon = _B1_POLYS + _B3_POLYS + ["sigma_A", "sigma_B", "sigma_C"]
    out = [nm for nm in canon if nm in evals]
    out += sorted(nm for nm in evals if nm not in set(canon))
    return out


class MarlinVerifierGadget:
    def __init__(self, cfg):
        self.cfg = cfg  # curve of the Marlin SNARK being verified
        self.Fr = cfg.Fr

    def _ctx(self, cs):
        V = fpvar_class(cs)
        circuit_tower(cs, self.cfg)
        key = "_marlin_pg_" + self.cfg.name
        pg = getattr(cs, key, None)
        if pg is None:
            pg = PairingGadget(cs, self.cfg)
            setattr(cs, key, pg)
        nn_key = "_marlin_nn_" + self.cfg.name
        P = getattr(cs, nn_key, None)
        if P is None:
            P = NonNativeVar.params_for(V, self.Fr.MODULUS)
            setattr(cs, nn_key, P)
        return V, pg, P

    # -- allocation --------------------------------------------------------
    def _g1(self, V, pt, mode, check=False):
        alloc = V.constant if mode == "constant" else V.new_witness
        if pt.is_infinity():
            # encode infinity as (0,0) — not on curve, but vk/proof points
            # are only combined linearly before pairing; honest artifacts
            # are never infinite (same caveat as the reference gadgets)
            return AffinePointVar(self.cfg.g1, alloc(0), alloc(0))
        return AffinePointVar.alloc(self.cfg.g1, pt, lambda e: alloc(e.n),
                                    check=check)

    def _g2(self, cs, pt, mode, check=False):
        tower = circuit_tower(cs, self.cfg)
        lift = (tower.lift_half_const if mode == "constant"
                else tower.lift_half_witness)
        return AffinePointVar.alloc(self.cfg.g2, pt, lift, check=check)

    def alloc_vk(self, cs, vk, mode: str = "witness"):
        V, _, _ = self._ctx(cs)
        comms = {nm: self._g1(V, vk.index_comms[nm].c, mode)
                 for nm in sorted(vk.index_comms)}
        return MarlinVKVar(
            index_comms=comms, n=vk.n, k_size=vk.k_size,
            input_size=vk.input_size, num_instance=vk.num_instance,
            max_degree=vk.max_degree,
            h=self._g2(cs, vk.srs_h, mode),
            tau_h=self._g2(cs, vk.srs_tau_h, mode),
            g=self._g1(V, vk.srs_g, "constant"),
        )

    def alloc_proof(self, cs, proof):
        V, _, P = self._ctx(cs)

        def comm_var(c):
            return self._g1(V, c, "witness", check=True)

        comms1 = {nm: comm_var(proof.comms1[nm].c)
                  for nm in sorted(proof.comms1)}
        comms2 = {"g_1": comm_var(proof.comms2["g_1"].c),
                  "g_1_shifted": comm_var(proof.comms2["g_1"].shifted),
                  "h_1": comm_var(proof.comms2["h_1"].c)}
        comms3 = {}
        for name in "ABC":
            comms3[f"g_3{name}"] = comm_var(proof.comms3[f"g_3{name}"].c)
            comms3[f"g_3{name}_shifted"] = comm_var(
                proof.comms3[f"g_3{name}"].shifted)
            comms3[f"h_3{name}"] = comm_var(proof.comms3[f"h_3{name}"].c)
        sigma3 = NonNativeVar.new_witness(V, P, proof.sigma3)
        evals = {nm: NonNativeVar.new_witness(V, P, proof.evals[nm])
                 for nm in _eval_order(proof.evals)}
        return MarlinProofVar(comms1=comms1, comms2=comms2, comms3=comms3,
                              sigma3=sigma3, evals=evals,
                              pi1=comm_var(proof.pi1),
                              pi3=comm_var(proof.pi3))

    def alloc_pvk(self, cs, pvk):
        return self.alloc_vk(cs, pvk, mode="constant")

    # -- witness-program external inputs -----------------------------------
    def _flat_g1(self, pt):
        return [0, 0] if pt.is_infinity() else [pt.x.n, pt.y.n]

    def flatten_vk(self, vk):
        """Flat ints in alloc_vk's witness allocation order (replay)."""
        from ...gadgets.sw import flatten_g2_point

        out = []
        for nm in sorted(vk.index_comms):
            out += self._flat_g1(vk.index_comms[nm].c)
        out += flatten_g2_point(vk.srs_h)
        out += flatten_g2_point(vk.srs_tau_h)
        return out

    def _flat_nn(self, value: int):
        P = NonNativeParams(self.Fr.MODULUS, self.cfg.Fq.BITS)
        mask = (1 << P.B) - 1
        v = value % P.m
        return [(v >> (P.B * i)) & mask for i in range(P.L)]

    def flatten_proof(self, proof):
        out = []
        for nm in sorted(proof.comms1):
            out += self._flat_g1(proof.comms1[nm].c)
        out += self._flat_g1(proof.comms2["g_1"].c)
        out += self._flat_g1(proof.comms2["g_1"].shifted)
        out += self._flat_g1(proof.comms2["h_1"].c)
        for name in "ABC":
            out += self._flat_g1(proof.comms3[f"g_3{name}"].c)
            out += self._flat_g1(proof.comms3[f"g_3{name}"].shifted)
            out += self._flat_g1(proof.comms3[f"h_3{name}"].c)
        out += self._flat_nn(proof.sigma3)
        for nm in _eval_order(proof.evals):
            out += self._flat_nn(proof.evals[nm])
        out += self._flat_g1(proof.pi1)
        out += self._flat_g1(proof.pi3)
        return out

    def flatten_input(self, values):
        from ...gadgets.inputs import repack_chunk_ints

        return repack_chunk_ints(self.Fr, self.cfg.Fq, values)

    # -- inputs ------------------------------------------------------------
    def input_var_from_field_elements(self, cf_fpvars):
        return BooleanInputVar.from_field_elements(self.Fr, cf_fpvars)

    def input_var_new_input(self, cs, values):
        V, _, _ = self._ctx(cs)
        return BooleanInputVar.new_input(V, self.Fr, values)

    def repack_input(self, elems):
        return repack_native(self.Fr, self.cfg.Fq, elems)

    # -- transcript helpers -------------------------------------------------
    def _absorb_point(self, sp, V, pt: AffinePointVar):
        sp.absorb([pt.x, pt.y])

    def _absorb_fr_bits(self, sp, V, bit_lists):
        """Pack concatenated per-value bit lists (each Fr.BITS long) into CF
        capacity chunks — must equal the native absorb_nonnative packing."""
        cap = V.F.CAPACITY
        bits = [b for bl in bit_lists for b in bl]
        for i in range(0, len(bits), cap):
            chunk = bits[i : i + cap]
            sp.absorb([Boolean.le_bits_to_fp(V, chunk)])

    def _nn_transcript_bits(self, V, nn: NonNativeVar):
        bits = nn.to_bits_le(V)
        for b in bits[self.Fr.BITS:]:
            b.negate().enforce_true()  # value < 2^BITS
        return bits[: self.Fr.BITS]

    def _challenge(self, sp, V, P):
        bits = sp.squeeze_challenge_bits(128)
        return NonNativeVar.from_bits(V, P, bits), bits

    # -- scalar muls --------------------------------------------------------
    @staticmethod
    def _smul(point: AffinePointVar, bits):
        return SWProjVar.scalar_mul_bits(point.to_proj(), bits)

    # -- verification -------------------------------------------------------
    def verify(self, cs, vk_var: MarlinVKVar, input_var, proof_var):
        V, pg, P = self._ctx(cs)
        m = self.Fr.MODULUS
        sp = PoseidonSponge(V)

        # transcript: index comms, inputs, round comms
        for nm in sorted(vk_var.index_comms):
            self._absorb_point(sp, V, vk_var.index_comms[nm])
        # xs = [1] + inputs, absorbed as Fr bit-packed (pad each input's
        # bit list to full Fr.BITS — from_field_elements produces
        # capacity-sized chunks)
        one_bits = [Boolean.constant(V, i == 0) for i in range(self.Fr.BITS)]
        padded_inputs = [
            list(bits) + [Boolean.constant(V, False)] * (self.Fr.BITS - len(bits))
            for bits in input_var.bits]
        self._absorb_fr_bits(sp, V, [one_bits] + padded_inputs)
        for nm in sorted(proof_var.comms1):
            self._absorb_point(sp, V, proof_var.comms1[nm])
        alpha, _ = self._challenge(sp, V, P)
        etas = {}
        for nm in "ABC":
            etas[nm], _ = self._challenge(sp, V, P)
        for nm in ("g_1", "g_1_shifted", "h_1"):
            self._absorb_point(sp, V, proof_var.comms2[nm])
        beta1, beta1_bits = self._challenge(sp, V, P)
        self._absorb_fr_bits(
            sp, V, [self._nn_transcript_bits(V, proof_var.evals[f"sigma_{n}"])
                    for n in "ABC"])
        for name in "ABC":  # sorted: g_3A, g_3B, g_3C then h_3A..C
            self._absorb_point(sp, V, proof_var.comms3[f"g_3{name}"])
            self._absorb_point(sp, V, proof_var.comms3[f"g_3{name}_shifted"])
        for name in "ABC":
            self._absorb_point(sp, V, proof_var.comms3[f"h_3{name}"])
        beta3, beta3_bits = self._challenge(sp, V, P)
        self._absorb_fr_bits(
            sp, V, [self._nn_transcript_bits(V, proof_var.evals[nm])
                    for nm in _B1_POLYS + _B3_POLYS])
        xi, xi_bits = self._challenge(sp, V, P)

        ev = proof_var.evals
        nn_c = lambda k: NonNativeVar.constant(V, P, k)

        # ---- identity (i): rowcheck at beta_1
        vH_b1 = beta1.pow_const(V, vk_var.n).sub(V, nn_c(1))
        lhs_i = ev["zhat_A"].mul(V, ev["zhat_B"]).sub(V, ev["zhat_C"])
        rhs_i = ev["h_0"].mul(V, vH_b1)
        ok_i = lhs_i.is_eq(V, rhs_i)

        # ---- identity (ii): lincheck at beta_1
        # xhat(beta1) = sum_j x_j * L_j(beta1) over H_x
        hx = vk_var.input_size
        v_hx_b1 = beta1.pow_const(V, hx).sub(V, nn_c(1))
        Hx_el = []
        w = pow(self.Fr.GENERATOR, (m - 1) // hx, m)
        cur = 1
        for _ in range(hx):
            Hx_el.append(cur)
            cur = cur * w % m
        hx_inv = pow(hx, -1, m)
        xs_nn = [nn_c(1)] + [NonNativeVar.from_bits(V, P, bits)
                             for bits in input_var.bits]
        xhat = nn_c(0)
        for j, xval in enumerate(xs_nn):
            # L_j(b1) = v_Hx(b1) * w^j / (hx * (b1 - w^j))
            den = beta1.sub(V, nn_c(Hx_el[j])).inv(V)
            lj = v_hx_b1.mul_const(V, Hx_el[j] * hx_inv % m).mul(V, den)
            xhat = xhat.add(V, xval.mul(V, lj))
        zhat_b1 = xhat.add(V, v_hx_b1.mul(V, ev["what"]))
        t_b1 = nn_c(0)
        for nm in "ABC":
            t_b1 = t_b1.add(V, etas[nm].mul(V, ev[f"zhat_{nm}"]))
        # u_H(alpha, b1) = (v_H(alpha) - v_H(b1)) / (alpha - b1)
        vH_a = alpha.pow_const(V, vk_var.n).sub(V, nn_c(1))
        uh = vH_a.sub(V, vH_b1).mul(V, alpha.sub(V, beta1).inv(V))
        lhs_ii = ev["s_mask"].add(
            V, uh.mul(V, t_b1)).sub(V, proof_var.sigma3.mul(V, zhat_b1))
        rhs_ii = ev["h_1"].mul(V, vH_b1).add(V, beta1.mul(V, ev["g_1"]))
        ok_ii = lhs_ii.is_eq(V, rhs_ii)

        # ---- identity (iii): per-matrix sumchecks at beta_3, plus
        # sigma_3 == sigma_A + sigma_B + sigma_C
        va_vb = vH_a.mul(V, vH_b1)
        vK_b3 = beta3.pow_const(V, vk_var.k_size).sub(V, nn_c(1))
        kinv = pow(vk_var.k_size, -1, m)
        sig_sum = ev["sigma_A"].add(V, ev["sigma_B"]).add(V, ev["sigma_C"])
        ok_iii = sig_sum.is_eq(V, proof_var.sigma3)
        for nm in "ABC":
            bm = alpha.sub(V, ev[f"row_{nm}"]).mul(
                V, beta1.sub(V, ev[f"col_{nm}"]))
            am = etas[nm].mul(V, va_vb).mul(V, ev[f"val_{nm}"])
            lhs_m = ev[f"h_3{nm}"].mul(V, vK_b3)
            inner = beta3.mul(V, ev[f"g_3{nm}"]).add(
                V, ev[f"sigma_{nm}"].mul_const(V, kinv))
            rhs_m = am.sub(V, bm.mul(V, inner))
            ok_iii = ok_iii & lhs_m.is_eq(V, rhs_m)

        # ---- KZG batch checks
        from .native import _R1_COMMS

        d = vk_var.max_degree
        comm_list1 = ([proof_var.comms1[nm] for nm in _R1_COMMS]
                      + [proof_var.comms2["g_1"], proof_var.comms2["h_1"]]
                      + [proof_var.comms2["g_1_shifted"]])
        vals1 = [ev[nm] for nm in _B1_POLYS] \
            + [ev["g_1"].mul(V, beta1.pow_const(V, d - (vk_var.n - 2)))]
        ok_kzg1 = self._kzg_batch_boolean(cs, vk_var, comm_list1, vals1,
                                          beta1, beta1_bits, xi, xi_bits,
                                          proof_var.pi1)
        shift3 = beta3.pow_const(V, d - (vk_var.k_size - 2))
        comm_list3 = ([vk_var.index_comms[nm] for nm in _B3_POLYS[:9]]
                      + [proof_var.comms3[f"g_3{n}"] for n in "ABC"]
                      + [proof_var.comms3[f"h_3{n}"] for n in "ABC"]
                      + [proof_var.comms3[f"g_3{n}_shifted"] for n in "ABC"])
        vals3 = [ev[nm] for nm in _B3_POLYS] \
            + [ev[f"g_3{n}"].mul(V, shift3) for n in "ABC"]
        ok_kzg3 = self._kzg_batch_boolean(cs, vk_var, comm_list3, vals3,
                                          beta3, beta3_bits, xi, xi_bits,
                                          proof_var.pi3)

        return ok_i & ok_ii & ok_iii & ok_kzg1 & ok_kzg3

    verify_with_processed_vk = verify

    def _kzg_batch_boolean(self, cs, vk_var, comms, values, point_nn,
                           point_bits, xi, xi_bits, pi):
        """Boolean: e(sum xi^i C_i - (sum xi^i y_i) G, H)
                    * e(-pi, tau H - z H) == 1.

        The xi-power combination runs as a HORNER chain from the highest
        index down (acc = xi*acc + C_i): each step multiplies by the
        128-bit challenge instead of a full-field-width xi^i, which at
        MNT-298 scale cuts the dominant scalar-mul cost ~2.3x and drops
        the nonnative xi-power chain entirely.  The combined group element
        and value are identical to the power form, so the prover's batched
        opening pi verifies unchanged."""
        V, pg, P = self._ctx(cs)
        acc_comm = comms[-1].to_proj()
        y_comb = values[-1]
        for c, y in zip(reversed(comms[:-1]), reversed(values[:-1])):
            acc_comm = SWProjVar.scalar_mul_bits(acc_comm, xi_bits)
            acc_comm = acc_comm.add(c.to_proj())
            y_comb = y_comb.mul(V, xi).add(V, y)
        from ...gadgets.sw import safe_affine, sym_eq_boolean

        tower = circuit_tower(fpcls_cs := V.CS, self.cfg)
        y_bits = y_comb.to_bits_le(V)
        yG = self._smul(vk_var.g, y_bits)
        lhs = acc_comm.add(yG.negate())
        # identity-safe conversions: default-valued synthesis (placeholder
        # commitments can be infinity) must stay satisfiable
        lhs_aff, lhs_bad = safe_affine(
            V, lhs, self.cfg.g1_gen, lambda e: V.constant(e.n))
        zH = SWProjVar.scalar_mul_bits(vk_var.h.to_proj(), point_bits)
        rhs2 = vk_var.tau_h.to_proj().add(zH.negate())
        rhs2_aff, rhs_bad = safe_affine(
            V, rhs2, self.cfg.g2_gen, tower.lift_half_const)
        # sanitize pi: the (0,0) infinity encoding would break the Miller
        # loop; substitute the generator and fail the check instead
        pi_bad = sym_eq_boolean(V, pi.x, V.zero()) & \
            sym_eq_boolean(V, pi.y, V.zero())
        gx = V.constant(self.cfg.g1_gen.x.n)
        gy = V.constant(self.cfg.g1_gen.y.n)
        pi_safe = AffinePointVar(self.cfg.g1,
                                 pi_bad.select(gx, pi.x),
                                 pi_bad.select(gy, pi.y))
        ok = pg.product_of_pairings_is_one(
            [(lhs_aff, vk_var.h), (pi_safe.negate(), rhs2_aff)])
        return ok & lhs_bad.negate() & rhs_bad.negate() & pi_bad.negate()

    # -- vk hashing ----------------------------------------------------------
    def vk_to_bytes(self, vk_var: MarlinVKVar):
        V = type(vk_var.g.x)
        out = []
        for nm in sorted(vk_var.index_comms):
            out.extend(vk_var.index_comms[nm].to_bytes())
        out.extend(vk_var.h.to_bytes())
        out.extend(vk_var.tau_h.to_bytes())
        for val in (vk_var.n, vk_var.k_size, vk_var.input_size,
                    vk_var.num_instance, vk_var.max_degree):
            out.extend(UInt8.constant_vec(V, int(val).to_bytes(8, "little")))
        return out

    def vk_shape(self, vk):
        return marlin_vk_shape(vk)

    def reshape_vk(self, vk, shape):
        return marlin_reshape_vk(vk, shape)

    def vk_bytes_native(self, vk) -> bytes:
        from ...r1cs.system import ConstraintSystem

        scratch = ConstraintSystem(self.cfg.Fq)
        vk_var = self.alloc_vk(scratch, vk, mode="witness")
        return bytes(b.value for b in self.vk_to_bytes(vk_var))


    # -- PCD shape-stability hooks ------------------------------------------
def marlin_vk_shape(vk):
    return (vk.n, vk.k_size, vk.input_size, vk.num_instance, vk.max_degree)


def marlin_reshape_vk(vk, shape):
    """Copy of a (placeholder) vk with overridden domain shape — used by the
    PCD setup fixed-point so MainCircuit's structure matches the real help
    vk (domain sizes are structural for the Marlin gadget: pow_const
    exponents etc.)."""
    from dataclasses import replace

    n, k, hx, ninst, d = shape
    return replace(vk, n=n, k_size=k, input_size=hx, max_degree=d)
