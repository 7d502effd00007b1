"""Ate pairing for MNT-style curves (embedding degree 4 or 6, quadratic twist
over Fq^{k/2}).

Host-side reference implementation (control plane + gadget oracle).  The
in-circuit pairing gadget (pcd_tpu/gadgets/pairing.py) mirrors this algorithm
constraint-for-value, and the device path batches the same loop structure.

Structure (replaces ark-mnt4-298/ark-mnt6-298 pairing internals, reference
Cargo.toml:33-34; verified by bilinearity + non-degeneracy tests):

  - G2 points (on the twist E'/Fq^{k/2}) are untwisted into E(Fq^k) via
    psi(x, y) = (x / gamma, y / (omega * gamma)) where gamma = u (the tower
    generator of Fq^{k/2}) and omega = v (Fq^k = Fq^{k/2}[v]/(v^2 - u)).
  - Miller loop over |trace - 1| bits with denominator elimination (vertical
    lines fall in Fq^{k/2} and are killed by the easy part of the final
    exponentiation, valid for even embedding degree).
  - Final exponentiation split: easy part f^(q^{k/2} - 1) via conjugation,
    hard part exponent (q^{k/2} + 1) / r by square-and-multiply.

A frozen copy of the port's `pcd_tpu_torch/pairing/ate.py` for the
benchmark's plain reference; it imports nothing of the program.
"""

from __future__ import annotations

from functools import lru_cache


class AtePairing:
    def __init__(self, cfg):
        """cfg: an MNTCurveConfig (pcd_tpu.curves.models)."""
        self.cfg = cfg
        self.Fqk = cfg.Fq_k
        self.Fq_half = cfg.Fq_half
        k_half = cfg.Fq_half.DEGREE
        q = cfg.Fq.MODULUS
        self.q = q
        r = cfg.g1.order
        self.r = r
        q_half = q**k_half
        assert (q_half + 1) % r == 0, "r must divide q^{k/2}+1"
        self.hard_exp = (q_half + 1) // r
        # untwisted curve E over Fq^k: same a, b as G1, lifted
        self.a_k = self._lift_base(cfg.g1.a)
        self.b_k = self._lift_base(cfg.g1.b)
        # gamma = u in Fq^{k/2}; omega = v in Fq^k; omega^2 = gamma
        self.gamma = cfg.Fq_half.gen_v()
        self.omega = self.Fqk.gen_v()
        self.inv_gamma_k = self._lift_half(self.gamma).inv()
        self.inv_omega_gamma = (self.omega * self._lift_half(self.gamma)).inv()

    # -- embeddings ----------------------------------------------------
    def _lift_base(self, x):
        """Fq -> Fq^k."""
        return self.Fqk.from_base(self.Fq_half.from_base(x))

    def _lift_half(self, x):
        """Fq^{k/2} -> Fq^k."""
        return self.Fqk.from_base(x)

    def untwist(self, Q):
        """G2 (twist over Fq^{k/2}) -> E(Fq^k) affine coordinates."""
        x = self._lift_half(Q.x) * self.inv_gamma_k
        y = self._lift_half(Q.y) * self.inv_omega_gamma
        return (x, y)

    # -- miller loop ---------------------------------------------------
    def miller_loop(self, P, Q):
        """P in G1 (affine, not infinity), Q in G2 (affine, not infinity).
        Returns the unreduced pairing value f in Fq^k."""
        if P.is_infinity() or Q.is_infinity():
            return self.Fqk.one()
        cfg = self.cfg
        xq, yq = self.untwist(Q)
        xp = self._lift_base(P.x)
        yp = self._lift_base(P.y)
        one = self.Fqk.one()
        two = one + one
        three = two + one

        f = one
        tx, ty = xq, yq
        n = cfg.ate_loop
        bits = bin(n)[3:]  # skip leading 1
        for b in bits:
            # doubling step: lambda = (3 tx^2 + a) / (2 ty)
            lam = (three * tx * tx + self.a_k) / (two * ty)
            l_val = yp - ty - lam * (xp - tx)
            f = f * f * l_val
            x3 = lam * lam - tx - tx
            ty = lam * (tx - x3) - ty
            tx = x3
            if b == "1":
                # addition step with Q
                lam = (ty - yq) / (tx - xq)
                l_val = yp - ty - lam * (xp - tx)
                f = f * l_val
                x3 = lam * lam - tx - xq
                ty = lam * (tx - x3) - ty
                tx = x3
        if cfg.ate_is_neg:
            f = f.inv()
        return f

    # -- final exponentiation ------------------------------------------
    def final_exponentiation(self, f):
        # easy part: f^(q^{k/2} - 1) = conj(f) / f  (conjugation over Fq^{k/2})
        f = f.conjugate() * f.inv()
        # hard part: f^((q^{k/2} + 1)/r); f is now unitary
        return f**self.hard_exp

    def pairing(self, P, Q):
        return self.final_exponentiation(self.miller_loop(P, Q))

    def multi_pairing(self, pairs):
        """prod e(P_i, Q_i) with one shared final exponentiation."""
        f = self.Fqk.one()
        for (P, Q) in pairs:
            f = f * self.miller_loop(P, Q)
        return self.final_exponentiation(f)


@lru_cache(maxsize=None)
def pairing_for(cfg):
    return AtePairing(cfg)
