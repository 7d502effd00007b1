"""Nonnative field arithmetic gadget (replaces ark-nonnative-field,
reference Cargo.toml:28; SURVEY.md D14).  Simulates arithmetic of a target
field F_m (modulus m) inside an R1CS over CF — required by the Marlin
verifier gadget, whose AHP identity checks run over the *other* field of
the cycle.

Representation: L limbs of B bits (LSB-first), each an FpVar range-checked
to B bits.  Defaults: B chosen so that 4 limbs cover m with comfortable
carry guards inside CF (B = ceil(bits/4)).

Multiplication z = x*y mod m introduces witness q, r with the integer
identity  x*y = q*m + r  enforced limb-group-wise with signed carries
(offset-encoded, range-checked); all intermediate magnitudes stay far below
CF's modulus so field equality implies integer equality.

Values are kept canonical (inputs of mul are reduced); `enforce_equal`
compares canonical representations including a bits-vs-(m-1) comparison.

The port's copy of `pcd_tpu/gadgets/nonnative.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from .fp import Boolean, FpVarBase


class NonNativeParams:
    def __init__(self, target_modulus: int, cf_bits: int):
        self.m = target_modulus
        self.bits = target_modulus.bit_length()
        self.L = 4
        self.B = (self.bits + self.L - 1) // self.L
        # guard bits for carries in the mul identity
        self.G = self.B + 6
        assert 2 * self.B + 8 < cf_bits - 2, "CF too small for limb scheme"


class NonNativeVar:
    """x in F_m as L range-checked limbs over CF."""

    __slots__ = ("params", "limbs", "_bits")

    def __init__(self, params, limbs, bits=None):
        self.params = params
        self.limbs = limbs
        self._bits = bits  # cached LSB-first Booleans if produced

    # -- constructors ---------------------------------------------------
    @staticmethod
    def params_for(fpcls, target_modulus: int) -> NonNativeParams:
        return NonNativeParams(target_modulus, fpcls.F.BITS)

    @classmethod
    def constant(cls, fpcls, params, value: int):
        value %= params.m
        limbs = [fpcls.constant((value >> (params.B * i)) & ((1 << params.B) - 1))
                 for i in range(params.L)]
        return cls(params, limbs)

    @classmethod
    def new_witness(cls, fpcls, params, value: int, hint=None):
        """hint: optional (HintGroup, base_offset) — replay recipe source
        for the limbs (offset i holds limb i); None = external input."""
        value %= params.m
        limbs = []
        bits_all = []
        for i in range(params.L):
            v = (value >> (params.B * i)) & ((1 << params.B) - 1)
            rec = None if hint is None else ("hint", hint[0], hint[1] + i)
            limb, bits = _range_checked(fpcls, v, params.B, recipe=rec)
            limbs.append(limb)
            bits_all.append(bits)
        out = cls(params, limbs)
        out._bits = [b for bs in bits_all for b in bs]
        return out

    @classmethod
    def from_bits(cls, fpcls, params, bits):
        """Construct from LSB-first Booleans (length <= L*B); the value must
        already be < m (caller's obligation, e.g. 128-bit challenges)."""
        B = params.B
        limbs = []
        for i in range(params.L):
            chunk = bits[i * B : (i + 1) * B]
            if chunk:
                limbs.append(Boolean.le_bits_to_fp(fpcls, chunk))
            else:
                limbs.append(fpcls.zero())
        out = cls(params, limbs)
        out._bits = list(bits) + [Boolean.constant(fpcls, False)] * (
            params.L * B - len(bits))
        return out

    # -- value access ----------------------------------------------------
    @property
    def value(self) -> int:
        v = 0
        for i, l in enumerate(self.limbs):
            v |= l.val << (self.params.B * i)
        return v % self.params.m if v >= self.params.m else v

    def raw_int(self) -> int:
        v = 0
        for i, l in enumerate(self.limbs):
            v |= l.val << (self.params.B * i)
        return v

    def to_bits_le(self, fpcls):
        """LSB-first bits (L*B of them) with range-enforced decomposition."""
        if self._bits is not None:
            return self._bits
        bits = []
        for limb in self.limbs:
            if limb.is_constant:
                bits.extend(Boolean.constant(fpcls, (limb.val >> i) & 1 == 1)
                            for i in range(self.params.B))
            else:
                lb = []
                src_lc = limb.lc  # shared object -> replay groups the bits
                for i in range(self.params.B):
                    lb.append(Boolean.new_witness(
                        fpcls, (limb.val >> i) & 1 == 1))
                    fpcls.CS.set_last_recipe(("bit", src_lc, i))
                Boolean.le_bits_to_fp(fpcls, lb).enforce_equal(limb)
                bits.extend(lb)
        self._bits = bits
        return bits

    # -- arithmetic -------------------------------------------------------
    def mul(self, fpcls, other: "NonNativeVar") -> "NonNativeVar":
        P = self.params
        m, B, L, G = P.m, P.B, P.L, P.G
        x_val = self.raw_int()
        y_val = other.raw_int()
        prod = x_val * y_val
        q_val, r_val = divmod(prod, m)
        assert q_val < (1 << (L * B + 8)), "unreduced inputs to nonnative mul"

        from ..r1cs.program import HintGroup

        def _qr(vals, m=m, B=B, L=L):
            mask = (1 << B) - 1
            x = sum(vals[i] << (B * i) for i in range(L))
            y = sum(vals[L + i] << (B * i) for i in range(L))
            q, r0 = divmod(x * y, m)
            return ([(q >> (B * i)) & mask for i in range(L + 1)]
                    + [(r0 >> (B * i)) & mask for i in range(L)])

        qr_group = HintGroup(_qr, [l._as_lc() for l in self.limbs]
                             + [l._as_lc() for l in other.limbs])

        # witnesses: q (L+1 limbs to be safe), r (L limbs), all range-checked
        q_limbs = []
        for i in range(L + 1):
            v = (q_val >> (B * i)) & ((1 << B) - 1)
            limb, _ = _range_checked(fpcls, v, B,
                                     recipe=("hint", qr_group, i))
            q_limbs.append(limb)
        r = NonNativeVar.new_witness(fpcls, P, r_val,
                                     hint=(qr_group, L + 1))

        m_limbs = [(m >> (B * i)) & ((1 << B) - 1) for i in range(L)]
        # t_k = sum_{i+j=k} x_i y_j ;  rhs_k = sum_{i+j=k} q_i m_j + r_k
        n_co = 2 * L
        t = [fpcls.zero() for _ in range(n_co)]
        for i in range(L):
            for j in range(L):
                t[i + j] = t[i + j] + self.limbs[i] * other.limbs[j]
        rhs = [fpcls.zero() for _ in range(n_co)]
        for i in range(L + 1):
            for j in range(L):
                if i + j < n_co:
                    rhs[i + j] = rhs[i + j] + q_limbs[i].scale(m_limbs[j])
        for k in range(L):
            rhs[k] = rhs[k] + r.limbs[k]

        # carry chain with signed carries (offset 2^G)
        carry = fpcls.zero()
        carry_val = 0
        for k in range(n_co):
            # integer: t_k - rhs_k + carry = 2^B * carry_next
            t_int = sum(self.limbs[i].val * other.limbs[k - i].val
                        for i in range(max(0, k - L + 1), min(k + 1, L)))
            rhs_int = sum(q_limbs[i].val * m_limbs[k - i]
                          for i in range(max(0, k - L + 1),
                                         min(k + 1, L + 1)) if k - i < L)
            if k < L:
                rhs_int += r.limbs[k].val
            diff = t_int - rhs_int + carry_val
            assert diff % (1 << B) == 0, "nonnative mul carry misalignment"
            nxt = diff >> B
            expr = t[k] - rhs[k] + carry
            if k == n_co - 1:
                # final: remainder must be zero
                expr.enforce_equal(fpcls.zero())
                assert nxt == 0
                break
            u_val = nxt + (1 << G)
            assert 0 <= u_val < (1 << (G + 1)), "carry out of range"
            cg = HintGroup(_carry_hint(B, 1 << G, fpcls.MODULUS),
                           [expr._as_lc()])
            u, _ = _range_checked(fpcls, u_val, G + 1,
                                  recipe=("hint", cg, 0))
            nxt_var = u - fpcls.constant(1 << G)
            expr.enforce_equal(nxt_var.scale(1 << B))
            carry = nxt_var
            carry_val = nxt
        return r

    def _enforce_lincomb(self, fpcls, pos_terms, neg_terms, ov, ov_val):
        """Enforce  sum(pos) - sum(neg) - ov*m = 0  as integers, limb-group
        wise with small signed carries (full-width recomposition would
        overflow CF — limbs must be compared group by group)."""
        P = self.params
        B = P.B
        m_limbs = [(P.m >> (B * i)) & ((1 << B) - 1) for i in range(P.L)]
        carry = fpcls.zero()
        carry_val = 0
        for k in range(P.L):
            expr = carry
            int_val = carry_val
            for t in pos_terms:
                expr = expr + t.limbs[k]
                int_val += t.limbs[k].val
            for t in neg_terms:
                expr = expr - t.limbs[k]
                int_val -= t.limbs[k].val
            expr = expr - ov.scale(m_limbs[k])
            int_val -= ov_val * m_limbs[k]
            assert int_val % (1 << B) == 0, "nonnative lincomb misalignment"
            nxt = int_val >> B
            if k == P.L - 1:
                expr.enforce_equal(fpcls.zero())
                assert nxt == 0
                return
            u_val = nxt + 8
            assert 0 <= u_val < 16, "nonnative lincomb carry out of range"
            from ..r1cs.program import HintGroup

            cg = HintGroup(_carry_hint(B, 8, fpcls.MODULUS),
                           [expr._as_lc()])
            u, _ = _range_checked(fpcls, u_val, 4, recipe=("hint", cg, 0))
            nxt_var = u - fpcls.constant(8)
            expr.enforce_equal(nxt_var.scale(1 << B))
            carry = nxt_var
            carry_val = nxt

    def _limb_group(self, fpcls, others, fn):
        from ..r1cs.program import HintGroup

        lcs = [l._as_lc() for l in self.limbs]
        for o in others:
            lcs.extend(l._as_lc() for l in o.limbs)
        return HintGroup(fn, lcs)

    def add(self, fpcls, other: "NonNativeVar") -> "NonNativeVar":
        """x + y mod m: witness the reduced sum s and overflow ov in {0,1},
        enforce x + y - s - ov*m = 0 limb-group-wise."""
        P = self.params
        s_total = self.raw_int() + other.raw_int()
        ov_val, s_val = divmod(s_total, P.m)
        assert ov_val <= 2, "unreduced inputs to nonnative add"

        def _sum_ov(vals, m=P.m, B=P.B, L=P.L):
            mask = (1 << B) - 1
            x = sum(vals[i] << (B * i) for i in range(L))
            y = sum(vals[L + i] << (B * i) for i in range(L))
            ov, s0 = divmod(x + y, m)
            return [(s0 >> (B * i)) & mask for i in range(L)] + [ov]

        g = self._limb_group(fpcls, [other], _sum_ov)
        s = NonNativeVar.new_witness(fpcls, P, s_val, hint=(g, 0))
        ov, _ = _range_checked(fpcls, ov_val, 2, recipe=("hint", g, P.L))
        self._enforce_lincomb(fpcls, [self, other], [s], ov, ov_val)
        return s

    def sub(self, fpcls, other: "NonNativeVar") -> "NonNativeVar":
        """x - y mod m via  y + d - x - ov*m = 0."""
        P = self.params
        d_val = (self.raw_int() - other.raw_int()) % P.m
        ov_val = (other.raw_int() + d_val - self.raw_int()) // P.m
        assert 0 <= ov_val <= 2

        def _diff_ov(vals, m=P.m, B=P.B, L=P.L):
            mask = (1 << B) - 1
            x = sum(vals[i] << (B * i) for i in range(L))
            y = sum(vals[L + i] << (B * i) for i in range(L))
            d0 = (x - y) % m
            ov = (y + d0 - x) // m
            return [(d0 >> (B * i)) & mask for i in range(L)] + [ov]

        g = self._limb_group(fpcls, [other], _diff_ov)
        d = NonNativeVar.new_witness(fpcls, P, d_val, hint=(g, 0))
        ov, _ = _range_checked(fpcls, ov_val, 2, recipe=("hint", g, P.L))
        self._enforce_lincomb(fpcls, [other, d], [self], ov, ov_val)
        return d

    def inv(self, fpcls) -> "NonNativeVar":
        P = self.params
        v = self.value
        if v == 0:
            from ..r1cs.system import SynthesisError

            raise SynthesisError("nonnative inverse of zero")
        iv = pow(v, -1, P.m)

        def _inv_limbs(vals, m=P.m, B=P.B, L=P.L):
            mask = (1 << B) - 1
            x = sum(vals[i] << (B * i) for i in range(L)) % m
            xi = pow(x, -1, m) if x else 0
            return [(xi >> (B * i)) & mask for i in range(L)]

        g = self._limb_group(fpcls, [], _inv_limbs)
        out = NonNativeVar.new_witness(fpcls, P, iv, hint=(g, 0))
        one = NonNativeVar.constant(fpcls, P, 1)
        prod = self.mul(fpcls, out)
        prod.enforce_equal(fpcls, one)
        return out

    def mul_const(self, fpcls, k: int) -> "NonNativeVar":
        kc = NonNativeVar.constant(fpcls, self.params, k)
        return self.mul(fpcls, kc)

    def pow_const(self, fpcls, e: int) -> "NonNativeVar":
        result = NonNativeVar.constant(fpcls, self.params, 1)
        base = self
        started = False
        bits = bin(e)[2:]
        for b in bits:
            if started:
                result = result.mul(fpcls, result)
            if b == "1":
                result = base if not started else result.mul(fpcls, base)
                started = True
        return result

    # -- comparisons -------------------------------------------------------
    def enforce_equal(self, fpcls, other: "NonNativeVar"):
        """Canonical equality: both sides reduced below m, limbs equal."""
        for a, b in zip(self.limbs, other.limbs):
            a.enforce_equal(b)

    def is_eq(self, fpcls, other: "NonNativeVar") -> Boolean:
        from .sw import sym_eq_boolean

        acc = Boolean.constant(fpcls, True)
        for a, b in zip(self.limbs, other.limbs):
            acc = acc & sym_eq_boolean(fpcls, a, b)
        return acc

    def enforce_canonical(self, fpcls):
        """Enforce value < m via the bit comparison gadget."""
        bits = self.to_bits_le(fpcls)

        class _Fake:
            MODULUS = self.params.m

        # reuse Boolean.enforce_in_field_le against m-1
        m = self.params.m - 1
        eq = Boolean.constant(fpcls, True)
        gt = Boolean.constant(fpcls, False)
        for i in reversed(range(len(bits))):
            b = bits[i]
            if (m >> i) & 1:
                eq = eq & b
            else:
                gt = gt | (eq & b)
        gt.negate().enforce_true()


def _range_checked(fpcls, value: int, nbits: int, recipe=None):
    """Allocate a witness enforced to fit nbits; returns (var, bits).
    `recipe` (optional) is the replay recipe for the value itself; the bits
    are always tagged as its decomposition."""
    var = fpcls.new_witness(value)
    if recipe is not None:
        fpcls.CS.set_last_recipe(recipe)
    bits = []
    src_lc = var.lc  # shared object -> replay groups the bits
    for i in range(nbits):
        bits.append(Boolean.new_witness(fpcls, (value >> i) & 1 == 1))
        fpcls.CS.set_last_recipe(("bit", src_lc, i))
    Boolean.le_bits_to_fp(fpcls, bits).enforce_equal(var)
    return var, bits


def _carry_hint(B: int, offset: int, p: int):
    """Replay fn for signed carries: the carry equation value e (mod p) is a
    signed multiple of 2^B; recover  u = (signed(e) >> B) + offset."""
    half = p >> 1

    def fn(vals, B=B, offset=offset, p=p, half=half):
        v = vals[0]
        if v > half:
            v -= p
        return [(v >> B) + offset]

    return fn


def _recompose(fpcls, limbs, B):
    acc = fpcls.zero()
    for i, l in enumerate(limbs):
        acc = acc + l.scale(1 << (B * i))
    return acc
