"""In-circuit ate pairing (the PairingVar role of ark-mnt4/6-298
`constraints`, reference tests/mnt4_groth16.rs:6-9; SURVEY.md D10 — the
dominant contributor to recursion circuit size).

Mirrors pcd_tpu/pairing/ate.py step-for-step over symbolic towers:
  - untwist G2 by constant 1/gamma, 1/(omega*gamma)  (constants -> free)
  - affine Miller loop; slope divisions become witness-inverse constraints
    (1 constraint each - affine coordinates are *cheap* in-circuit)
  - final exponentiation: easy part by conjugation + witness inverse; hard
    part as a multi-exponentiation over constant base-q digits with free
    Frobenius maps.

Completeness caveat mirrored from the reference (SURVEY.md §7 hard part 1;
the reference carries the same risk via new_verification_key_unchecked,
data_structures.rs:153-162): inputs at infinity / degenerate additions make
the constraints unsatisfiable rather than wrong — honest Groth16/GM17
artifacts avoid them with overwhelming probability.  The failure mode is
always DIAGNOSABLE, never silently-accepting: a zero slope denominator
raises SynthesisError at synthesis (gadgets/fp.py inv()), the affine
allocator refuses infinity, and raw zero coordinates drive the
verification boolean False (pinned by
tests/test_groth16_gadget.py::test_pairing_gadget_degenerate_inputs_diagnosable).

The port's copy of `pcd_tpu/gadgets/pairing.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from ..pairing.ate import pairing_for
from .fields_ext import circuit_tower


class PairingGadget:
    def __init__(self, cs, cfg):
        """cfg: MNTCurveConfig of the SNARK curve being verified; the
        circuit field is cfg.Fq (guaranteed by the cycle)."""
        self.cs = cs
        self.cfg = cfg
        self.tower = circuit_tower(cs, cfg)
        self.host = pairing_for(cfg)
        t = self.tower
        self.inv_gamma_k = t.lift_k_const(self.host.inv_gamma_k)
        self.inv_omega_gamma = t.lift_k_const(self.host.inv_omega_gamma)
        self.a_k = t.lift_k_const(self.host.a_k)
        # hard-part exponent in base-q digits (constant)
        q = cfg.Fq.MODULUS
        e = self.host.hard_exp
        self.hard_digits = []
        while e:
            self.hard_digits.append(e % q)
            e //= q

    # ------------------------------------------------------------------
    def untwist(self, Q):
        """Q: AffinePointVar over ExtHalf -> (x, y) in ExtK."""
        t = self.tower
        x = t.half_to_k(Q.x) * self.inv_gamma_k
        y = t.half_to_k(Q.y) * self.inv_omega_gamma
        return x, y

    def miller_loop(self, P, Q):
        """P: AffinePointVar with FpVar coords (G1); Q: AffinePointVar with
        ExtHalf coords (G2 twist).  Returns f in symbolic ExtK."""
        t = self.tower
        xq, yq = self.untwist(Q)
        xp = t.base_to_k(P.x)
        yp = t.base_to_k(P.y)
        ExtK = t.ExtK
        one = ExtK.one()
        f = one
        tx, ty = xq, yq
        n = self.cfg.ate_loop
        bits = bin(n)[3:]
        three = 3
        for b in bits:
            lam = (tx.square() * three + self.a_k) * (ty + ty).inv()
            l_val = yp - ty - lam * (xp - tx)
            f = f.square() * l_val
            x3 = lam.square() - tx - tx
            ty = lam * (tx - x3) - ty
            tx = x3
            if b == "1":
                lam = (ty - yq) * (tx - xq).inv()
                l_val = yp - ty - lam * (xp - tx)
                f = f * l_val
                x3 = lam.square() - tx - xq
                ty = lam * (tx - x3) - ty
                tx = x3
        if self.cfg.ate_is_neg:
            f = f.inv()
        return f

    # ------------------------------------------------------------------
    def final_exponentiation(self, f):
        # easy: f^(q^{k/2}-1) = conj(f) * f^-1
        f1 = f.conjugate() * f.inv()
        # hard: multi-exp over base-q digits with Frobenius (free, constant
        # coefficient maps)
        bases = [f1.frobenius(i) for i in range(len(self.hard_digits))]
        nbits = max(d.bit_length() for d in self.hard_digits)
        acc = type(f1).one()
        started = False
        for bit in range(nbits - 1, -1, -1):
            if started:
                acc = acc.square()
            for i, d in enumerate(self.hard_digits):
                if (d >> bit) & 1:
                    if started or not acc.is_one():
                        acc = acc * bases[i]
                    else:
                        acc = bases[i]
            started = True
        return acc

    def product_of_pairings_is_one(self, pairs):
        """Boolean: prod e(P_i, Q_i) == 1 (one shared final exponentiation)."""
        from .sw import sym_eq_boolean

        f = None
        for (P, Q) in pairs:
            m = self.miller_loop(P, Q)
            f = m if f is None else f * m
        out = self.final_exponentiation(f)
        return sym_eq_boolean(self.tower.V, out, type(out).one())
