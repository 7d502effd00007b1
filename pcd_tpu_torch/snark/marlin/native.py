"""MarlinSNARK: AHP + KZG10 + Poseidon Fiat-Shamir (role of ark-marlin's
MarlinSNARK with MarlinConfig::FOR_RECURSION=true — reference
tests/mnt4_marlin.rs:62-94).

Universal setup: the SRS is a KZG powers-of-tau string sized by a degree
bound; `index` raises NeedLargerBound when the circuit needs more
(the reference's UniversalSetupIndexError::NeedLargerBound driving the
PCD SRS-sizing loop, ec_cycle_pcd/mod.rs:345-470).

Fiat-Shamir runs over the *constraint field of the future verifier circuit*
(cfg.Fq — the cycle partner's scalar field), exactly like the reference's
FiatShamirAlgebraicSpongeRng<Fr, Fq, PoseidonSponge<Fq>>: commitments'
coordinates are native sponge inputs, field elements of Fr are absorbed by
bit-packing, challenges are squeezed as 128-bit integers.

The port's copy of `pcd_tpu/snark/marlin/native.py`: the prover's KZG10
runs its MSMs of KZG10.STREAM_MIN scalars and more on `device` (the
card's kernels, or their plain versions on the CPU), and its AHP runs
the index's and the rounds' large transforms there (ahp.fft_any, K5 on a
card); the `backend` knob is dropped.  A ChaChaRng in the same state
yields the same proof.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...r1cs.system import ConstraintSystem
from ..api import NeedLargerBound, SNARKError
from .ahp import AHP, poly_eval
from .kzg import KZG10, KZGCommitment
from .poseidon import PoseidonSponge
from ...utils.profiling import span


@dataclass
class MarlinBound:
    max_degree: int = 10

    def clone(self):
        return MarlinBound(self.max_degree)


@dataclass
class MarlinIndexVK:
    index_comms: dict        # 9 commitments: row/col/val per matrix
    n: int
    k_size: int
    input_size: int
    num_instance: int
    srs_h: object
    srs_tau_h: object
    srs_g: object
    max_degree: int


@dataclass
class MarlinIndexPK:
    vk: MarlinIndexVK
    index: object            # AHPIndex
    srs: object              # KZGSRS
    cs_template: object = None


@dataclass
class MarlinProof:
    comms1: dict             # zhat_A/B/C, what, h_0
    comms2: dict             # g_1 (with shifted), h_1
    comms3: dict             # g_3 (with shifted), h_3
    sigma3: int
    evals: dict              # all opened values (ints in Fr)
    pi1: object              # batch witness at beta_1
    pi3: object              # batch witness at beta_3

    def clone(self):
        return MarlinProof(dict(self.comms1), dict(self.comms2),
                           dict(self.comms3), self.sigma3, dict(self.evals),
                           self.pi1, self.pi3)


_R1_COMMS = ("zhat_A", "zhat_B", "zhat_C", "what", "h_0", "s_mask")
_B1_POLYS = ["zhat_A", "zhat_B", "zhat_C", "what", "h_0", "s_mask",
             "g_1", "h_1"]
_B3_POLYS = (["row_%s" % m for m in "ABC"] + ["col_%s" % m for m in "ABC"]
             + ["val_%s" % m for m in "ABC"]
             + ["g_3%s" % m for m in "ABC"] + ["h_3%s" % m for m in "ABC"])


class MarlinSNARK:
    def __init__(self, curve_cfg, device=None):
        """device: where KZG10's stream MSMs and the AHP's large
        transforms run (None means the card)."""
        self.cfg = curve_cfg
        self.Fr = curve_cfg.Fr
        self.FS_field = curve_cfg.Fq   # sponge field = verifier-circuit field
        self.kzg = KZG10(curve_cfg, device)
        self.device = self.kzg.device
        self.ahp = AHP(curve_cfg.Fr, self.device)

    # -- transcript helpers ----------------------------------------------
    def _sponge(self):
        return PoseidonSponge(self.FS_field)

    def _absorb_comm(self, sp, comm: KZGCommitment):
        pts = [comm.c] + ([comm.shifted] if comm.shifted is not None else [])
        for pt in pts:
            if pt.is_infinity():
                sp.absorb([self.FS_field.zero(), self.FS_field.zero()])
            else:
                sp.absorb([pt.x, pt.y])

    def _absorb_fr(self, sp, values):
        sp.absorb_nonnative([self.Fr.from_int(int(v)) for v in values],
                            self.Fr.BITS)

    def _challenge(self, sp) -> int:
        return sp.squeeze_challenge_int(128)

    # -- sizing -----------------------------------------------------------
    @staticmethod
    def _required_degree(n: int, k_size: int) -> int:
        return max(2 * n, 3 * k_size, 16)

    def circuit_degree(self, circuit) -> int:
        cs = ConstraintSystem(self.Fr)
        circuit.generate_constraints(cs)
        rows = self._matrix_rows(cs)
        n, _, k_size, _, _ = self.ahp.index_dims(
            rows, cs.num_instance, cs.num_instance + cs.num_witness)
        return self._required_degree(n, k_size)

    @staticmethod
    def _matrix_rows(cs: ConstraintSystem):
        n_inst = cs.num_instance
        rows = []
        for (a, b, c) in cs.constraints:
            def remap(lc):
                return {(n_inst + (-v - 1) if v < 0 else v): co % cs.p
                        for v, co in lc.items()}
            rows.append((remap(a), remap(b), remap(c)))
        return rows

    # -- universal setup ---------------------------------------------------
    def universal_setup(self, bound: MarlinBound, rng):
        """Returns public parameters (the KZG SRS)."""
        return self.kzg.setup(bound.max_degree, rng)

    def index(self, srs, circuit, rng=None, min_shape=None):
        cs = ConstraintSystem(self.Fr)
        circuit.generate_constraints(cs)
        rows = self._matrix_rows(cs)
        nvars = cs.num_instance + cs.num_witness
        # size check BEFORE the expensive index-polynomial FFTs: the
        # universal-setup retry loop probes with too-small SRSs repeatedly
        min_n, min_k = (min_shape[0], min_shape[1]) if min_shape else (1, 1)
        dims = self.ahp.index_dims(rows, cs.num_instance, nvars,
                                   min_n=min_n, min_k=min_k)
        need = self._required_degree(dims[0], dims[2])
        if need > srs.max_degree:
            raise NeedLargerBound(MarlinBound(max_degree=need))
        idx = self.ahp.index(rows, cs.num_instance, nvars, dims=dims)
        comms = {}
        for name in "ABC":
            m = idx.mats[name]
            comms[f"row_{name}"] = self.kzg.commit(srs, m.row)
            comms[f"col_{name}"] = self.kzg.commit(srs, m.col)
            comms[f"val_{name}"] = self.kzg.commit(srs, m.val)
        vk = MarlinIndexVK(index_comms=comms, n=idx.n, k_size=idx.k_size,
                           input_size=idx.input_size,
                           num_instance=cs.num_instance,
                           srs_h=srs.h, srs_tau_h=srs.tau_h,
                           srs_g=self.cfg.g1_gen, max_degree=srs.max_degree)
        pk = MarlinIndexPK(vk=vk, index=idx, srs=srs)
        return pk, vk

    # -- SNARK interface ---------------------------------------------------
    def circuit_specific_setup(self, circuit, rng, min_shape=None):
        """Size the SRS for exactly this circuit, then index.

        min_shape: optional (n, k, ...) floor for the AHP domains (padding;
        see AHP.index_dims) — lets the PCD setup fixed-point force a stable
        vk shape."""
        bound = MarlinBound(max_degree=16)
        while True:
            srs = self.universal_setup(bound, rng)
            try:
                return self.index(srs, circuit, rng, min_shape=min_shape)
            except NeedLargerBound as e:
                bound = e.bound

    def prove(self, pk: MarlinIndexPK, circuit, rng):
        from ..plan import plan_for

        with span("marlin/witness"):
            z, cs, plan = plan_for(pk, lambda: ConstraintSystem(self.Fr),
                                   circuit)
        p = self.Fr.MODULUS
        idx = pk.index
        if len(z) != idx.num_vars:
            raise SNARKError("circuit shape mismatch vs index")
        if cs is not None:
            if cs.first_unsatisfied() is not None:
                raise SNARKError(
                    f"unsatisfied constraint {cs.which_is_unsatisfied()}")
            rows = self._matrix_rows(cs)
            if plan is not None:
                plan.rows = rows
        else:
            rows = plan.rows
        srs = pk.srs
        # Az/Bz/Cz once via the C++ CSR tier: feeds BOTH the replayed-
        # witness satisfiability check (was a Python triple-sum loop over
        # every nonzero) and round 1's matrix evaluations.
        evs1 = None
        with span("marlin/sat_check"):
            nat = None
            try:
                from ... import native as nat

                if not nat.available() or len(rows) < 2048:
                    nat = None
            except Exception:
                nat = None
            if nat is not None:
                import numpy as np

                mv = getattr(pk, "_csr_cache", None)
                if mv is None:
                    mv = nat.SpMatrices(p, rows)
                    try:
                        pk._csr_cache = mv
                    except Exception:
                        pass
                zl = nat.scalars_to_limbs([int(v) % p for v in z])
                azl, bzl, czl = mv.apply_all_limbs(zl)
                bad = nat.vec_op(p, "sub", nat.vec_op(p, "mul", azl, bzl),
                                 czl)
                if np.any(bad):
                    j = int(np.nonzero(bad.any(axis=1))[0][0])
                    raise SNARKError(
                        f"unsatisfied constraint #{j} (replayed)")
                pad = idx.n - len(rows)
                evs1 = {nm: nat.limbs_to_ints(v) + [0] * pad
                        for nm, v in zip("ABC", (azl, bzl, czl))}
            elif cs is None:
                for j, (ra, rb, rc) in enumerate(rows):
                    if (sum(co * z[col] for col, co in ra.items())
                            * sum(co * z[col] for col, co in rb.items())
                            - sum(co * z[col]
                                  for col, co in rc.items())) % p:
                        raise SNARKError(
                            f"unsatisfied constraint #{j} (replayed)")

        sp = self._sponge()
        for key in sorted(pk.vk.index_comms):
            self._absorb_comm(sp, pk.vk.index_comms[key])
        self._absorb_fr(sp, [v for v in z[: idx.num_instance]])

        # round 1 (zk: rng drives the masking polynomials)
        with span("marlin/round1"):
            polys = self.ahp.prover_round1(idx, rows, z, rng, evs=evs1)
        with span("marlin/commit1"):
            comms1 = {nm: self.kzg.commit(srs, polys[nm])
                      for nm in _R1_COMMS}
        for nm in sorted(comms1):
            self._absorb_comm(sp, comms1[nm])
        alpha = self._challenge(sp)
        etas = {"A": self._challenge(sp), "B": self._challenge(sp),
                "C": self._challenge(sp)}

        # round 2
        with span("marlin/round2"):
            g1, h1, zhat = self.ahp.prover_round2(idx, polys, alpha, etas)
        with span("marlin/commit2"):
            comms2 = {"g_1": self.kzg.commit(srs, g1,
                                             degree_bound=idx.n - 2),
                      "h_1": self.kzg.commit(srs, h1)}
        for nm in sorted(comms2):
            self._absorb_comm(sp, comms2[nm])
        beta1 = self._challenge(sp)

        # round 3 (per-matrix sumchecks)
        with span("marlin/round3"):
            sigma3, r3 = self.ahp.prover_round3(idx, alpha, beta1, etas)
        with span("marlin/commit3"):
            comms3 = {}
            for name in "ABC":
                _, g_m, h_m = r3[name]
                comms3[f"g_3{name}"] = self.kzg.commit(
                    srs, g_m, degree_bound=idx.k_size - 2)
                comms3[f"h_3{name}"] = self.kzg.commit(srs, h_m)
        self._absorb_fr(sp, [r3[name][0] for name in "ABC"])
        for nm in sorted(comms3):
            self._absorb_comm(sp, comms3[nm])
        beta3 = self._challenge(sp)

        # openings
        poly_map1 = dict(zhat_A=polys["zhat_A"], zhat_B=polys["zhat_B"],
                         zhat_C=polys["zhat_C"], what=polys["what"],
                         h_0=polys["h_0"], s_mask=polys["s_mask"],
                         g_1=g1, h_1=h1)
        poly_map3 = {}
        for name in "ABC":
            m = idx.mats[name]
            poly_map3[f"row_{name}"] = m.row
            poly_map3[f"col_{name}"] = m.col
            poly_map3[f"val_{name}"] = m.val
            poly_map3[f"g_3{name}"] = r3[name][1]
            poly_map3[f"h_3{name}"] = r3[name][2]

        evals = {}
        with span("marlin/evals"):
            for nm in _B1_POLYS:
                evals[nm] = poly_eval(poly_map1[nm], beta1, p)
            for nm in _B3_POLYS:
                evals[nm] = poly_eval(poly_map3[nm], beta3, p)
        for name in "ABC":
            evals[f"sigma_{name}"] = r3[name][0]
        self._absorb_fr(sp, [evals[nm] for nm in _B1_POLYS + _B3_POLYS])
        xi = self._challenge(sp)

        # batch opening at beta_1 (includes the shifted g_1 shadow —
        # passed as a symbolic (shift, coeffs) pair so no SRS-length
        # list is materialized)
        d = srs.max_degree
        shift1 = d - (idx.n - 2)
        polys1 = [poly_map1[nm] for nm in _B1_POLYS] + [(shift1, list(g1))]
        with span("marlin/open1"):
            _, pi1 = self.kzg.open_batch(srs, polys1, beta1, xi)
        shift3 = d - (idx.k_size - 2)
        polys3 = [poly_map3[nm] for nm in _B3_POLYS] + [
            (shift3, list(r3[name][1])) for name in "ABC"]
        with span("marlin/open3"):
            _, pi3 = self.kzg.open_batch(srs, polys3, beta3, xi)

        return MarlinProof(comms1=comms1, comms2=comms2, comms3=comms3,
                           sigma3=sigma3, evals=evals, pi1=pi1, pi3=pi3)

    def verify(self, vk: MarlinIndexVK, public_input, proof: MarlinProof,
               index_hint=None) -> bool:
        p = self.Fr.MODULUS
        xs = [1] + [int(x.n if hasattr(x, "n") else x) for x in public_input]
        if len(xs) != vk.num_instance:
            raise SNARKError("input length mismatch")

        sp = self._sponge()
        for key in sorted(vk.index_comms):
            self._absorb_comm(sp, vk.index_comms[key])
        self._absorb_fr(sp, xs)
        for nm in sorted(proof.comms1):
            self._absorb_comm(sp, proof.comms1[nm])
        alpha = self._challenge(sp)
        etas = {"A": self._challenge(sp), "B": self._challenge(sp),
                "C": self._challenge(sp)}
        for nm in sorted(proof.comms2):
            self._absorb_comm(sp, proof.comms2[nm])
        beta1 = self._challenge(sp)
        self._absorb_fr(sp, [proof.evals[f"sigma_{name}"] for name in "ABC"])
        for nm in sorted(proof.comms3):
            self._absorb_comm(sp, proof.comms3[nm])
        beta3 = self._challenge(sp)
        self._absorb_fr(sp, [proof.evals[nm] for nm in _B1_POLYS + _B3_POLYS])
        xi = self._challenge(sp)

        # AHP identities on the claimed evaluations
        pseudo_index = _VerifierIndexView(vk)
        if not self.ahp.check_identities(pseudo_index, xs, alpha, etas,
                                         beta1, beta3, proof.sigma3,
                                         proof.evals):
            return False

        # KZG batch checks (with degree-bound shadow values)
        d = vk.max_degree
        comms1 = [proof.comms1[nm] for nm in _R1_COMMS] \
            + [proof.comms2["g_1"], proof.comms2["h_1"]]
        ys1 = [proof.evals[nm] for nm in _B1_POLYS]
        shadow1 = KZGCommitment(c=proof.comms2["g_1"].shifted)
        ys1_shadow = pow(beta1, d - (vk.n - 2), p) * proof.evals["g_1"] % p
        if not self.kzg.check_batch(
                pk_srs_view(vk), comms1 + [shadow1], beta1,
                ys1 + [ys1_shadow], proof.pi1, xi):
            return False
        comms3 = [vk.index_comms[nm] for nm in _B3_POLYS[:9]] \
            + [proof.comms3[f"g_3{name}"] for name in "ABC"] \
            + [proof.comms3[f"h_3{name}"] for name in "ABC"]
        ys3 = [proof.evals[nm] for nm in _B3_POLYS]
        shadow3 = [KZGCommitment(c=proof.comms3[f"g_3{name}"].shifted)
                   for name in "ABC"]
        shift_factor = pow(beta3, d - (vk.k_size - 2), p)
        ys3_shadow = [shift_factor * proof.evals[f"g_3{name}"] % p
                      for name in "ABC"]
        if not self.kzg.check_batch(
                pk_srs_view(vk), comms3 + shadow3, beta3,
                ys3 + ys3_shadow, proof.pi3, xi):
            return False
        return True

    def process_vk(self, vk):
        return vk

    def verify_with_processed_vk(self, pvk, public_input, proof):
        return self.verify(pvk, public_input, proof)


class _VerifierIndexView:
    """Just enough of AHPIndex for check_identities + x_poly."""

    def __init__(self, vk: MarlinIndexVK):
        self.n = vk.n
        self.k_size = vk.k_size
        self.input_size = vk.input_size
        self.num_instance = vk.num_instance


class _SRSView:
    def __init__(self, vk):
        self.h = vk.srs_h
        self.tau_h = vk.srs_tau_h
        self.max_degree = vk.max_degree
        self.powers_g1 = None


def pk_srs_view(vk):
    return _SRSView(vk)
