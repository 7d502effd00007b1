"""Short-Weierstrass point gadgets (replaces ark-r1cs-std
groups::curves::short_weierstrass; needed by the SNARK verifier gadgets —
SURVEY.md D10).

Points whose coordinates are FpVars (G1) or symbolic tower elements (G2).
Variable-point addition uses the Renes–Costello–Batina complete projective
formulas (eprint 2015/1060, Algorithm 1 — arbitrary a), which handle
identity and doubling uniformly; FpVar constant-folding automatically turns
mixed (variable + constant) additions into cheaper circuits.

The port's copy of `pcd_tpu/gadgets/sw.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations


class SWProjVar:
    """Projective (X, Y, Z) over any symbolic field (FpVar or ext tower).
    Identity is (0, 1, 0)."""

    __slots__ = ("curve", "X", "Y", "Z")

    def __init__(self, curve, X, Y, Z):
        self.curve = curve  # host SWCurve (for a, b constants)
        self.X, self.Y, self.Z = X, Y, Z

    # -- constructors ----------------------------------------------------
    @staticmethod
    def identity(curve, fld):
        return SWProjVar(curve, fld.zero(), fld.one(), fld.zero())

    @staticmethod
    def from_affine(curve, x, y, fld):
        return SWProjVar(curve, x, y, fld.one())

    @staticmethod
    def constant(curve, pt, lift):
        """lift: host-field-elem -> symbolic constant."""
        if pt.is_infinity():
            z = lift(curve.F.zero())
            return SWProjVar(curve, z, lift(curve.F.one()), z)
        return SWProjVar(curve, lift(pt.x), lift(pt.y), lift(curve.F.one()))

    def _consts(self, fld):
        c = self.curve
        a = c.a
        b3 = c.b + c.b + c.b

        def mk(e):
            # symbolic constant of the same field type
            if hasattr(fld, "from_prime_coeffs") and hasattr(e, "to_prime_coeffs"):
                prime = fld.prime_subfield()
                return fld.from_prime_coeffs(
                    [prime.from_int(x.n) for x in e.to_prime_coeffs()])
            return fld.from_int(e.n)

        return mk(a), mk(b3)

    # -- complete addition (RCB15 alg. 1) --------------------------------
    def add(self, o: "SWProjVar"):
        fld = type(self.X)
        a, b3 = self._consts(fld)
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = o.X, o.Y, o.Z

        t0 = X1 * X2
        t1 = Y1 * Y2
        t2 = Z1 * Z2
        t3 = (X1 + Y1) * (X2 + Y2) - t0 - t1
        t4 = (X1 + Z1) * (X2 + Z2) - t0 - t2
        t5 = (Y1 + Z1) * (Y2 + Z2) - t1 - t2
        Z3 = a * t4 + b3 * t2
        X3 = t1 - Z3
        Z3 = t1 + Z3
        Y3 = X3 * Z3
        t1n = t0 + t0 + t0 + a * t2
        t2n = a * (t0 - a * t2)
        t4n = b3 * t4 + t2n
        Y3 = Y3 + t1n * t4n
        X3o = t3 * X3 - t5 * t4n
        Z3o = t5 * Z3 + t3 * t1n
        return SWProjVar(self.curve, X3o, Y3, Z3o)

    __add__ = add

    def double(self):
        return self.add(self)

    def negate(self):
        return SWProjVar(self.curve, self.X, -self.Y, self.Z)

    def select(self, cond, other: "SWProjVar"):
        """cond ? self : other (coordinate-wise)."""
        return SWProjVar(self.curve,
                         cond.select(self.X, other.X),
                         cond.select(self.Y, other.Y),
                         cond.select(self.Z, other.Z))

    # -- scalar multiplication by bit gadgets ----------------------------
    @staticmethod
    def scalar_mul_bits(base: "SWProjVar", bits_le):
        """sum over set bits (MSB-first ladder); complete formulas, so no
        special cases.  bits_le: list[Boolean], LSB first."""
        fld = type(base.X)
        acc = SWProjVar.identity(base.curve, fld)
        for b in reversed(bits_le):
            acc = acc.double()
            added = acc.add(base)
            acc = added.select(b, acc)

        return acc

    # -- conversion ------------------------------------------------------
    def to_affine(self):
        """(x, y) with division constraints; identity is NOT representable
        (the constraint z * z_inv = 1 is unsatisfiable for Z=0) — matches
        honest-use domains of the verifier gadget."""
        zi = self.Z.inv()
        return (self.X * zi, self.Y * zi)

    def value_is_identity(self) -> bool:
        return _sym_is_zero_val(self.Z)


def _sym_is_zero_val(e):
    if hasattr(e, "val"):
        return e.val == 0
    return all(_sym_is_zero_val(c) for c in e.c)


class AffinePointVar:
    """Affine (x, y) symbolic point — the I/O format of the pairing gadget."""

    __slots__ = ("curve", "x", "y")

    def __init__(self, curve, x, y):
        self.curve = curve
        self.x = x
        self.y = y

    @staticmethod
    def alloc(curve, pt, alloc_fn, check: bool = True):
        """alloc_fn: host-field-elem -> symbolic value."""
        assert not pt.is_infinity(), "affine gadget cannot hold infinity"
        v = AffinePointVar(curve, alloc_fn(pt.x), alloc_fn(pt.y))
        if check:
            v.enforce_on_curve()
        return v

    def enforce_on_curve(self):
        c = self.curve
        fld = type(self.x)

        def mkc(e):
            if hasattr(fld, "from_prime_coeffs") and hasattr(e, "to_prime_coeffs"):
                prime = fld.prime_subfield()
                return fld.from_prime_coeffs(
                    [prime.from_int(x.n) for x in e.to_prime_coeffs()])
            return fld.from_int(e.n)

        a_sym, b_sym = mkc(c.a), mkc(c.b)
        lhs = self.y * self.y
        rhs = self.x * self.x * self.x + a_sym * self.x + b_sym
        _enforce_sym_eq(lhs, rhs)

    def negate(self):
        return AffinePointVar(self.curve, self.x, -self.y)

    def to_proj(self):
        fld = type(self.x)
        return SWProjVar.from_affine(self.curve, self.x, self.y, fld)

    def to_bytes(self):
        """Serialization for vk hashing: x bytes || y bytes (each coordinate
        flattened to prime coeffs; infinity excluded by construction) plus a
        zero flag byte — must match the layout fixed in
        snark/groth16/gadget.py vk hashing."""
        out = []
        for coord in (self.x, self.y):
            for c in _prime_coeffs(coord):
                out.extend(c.to_bytes())
        return out


def flatten_g1_point(pt):
    """Witness-program external-input image of AffinePointVar.alloc over a
    prime-field curve (x then y)."""
    return [pt.x.n, pt.y.n]


def flatten_g2_point(pt):
    """External-input image of AffinePointVar.alloc with a tower lift:
    x coefficients then y coefficients (mirrors lift_half_witness)."""
    return [c.n for c in pt.x.c] + [c.n for c in pt.y.c]


def _prime_coeffs(e):
    if hasattr(e, "to_prime_coeffs"):
        return e.to_prime_coeffs()
    return [e]


def _enforce_sym_eq(a, b):
    if hasattr(a, "enforce_equal"):
        a.enforce_equal(b)
        return
    for ca, cb in zip(a.c, b.c):
        _enforce_sym_eq(ca, cb)


def sym_eq_boolean(fpcls, a, b):
    """Equality of two symbolic values (FpVar or tower) as a Boolean.

    Per prime coefficient d: allocate bit e_i and inverse hint inv_i with
      d * e_i = 0          (e_i = 1 forces d = 0)
      d * inv_i = 1 - e_i  (e_i = 0 forces d != 0)
    then AND the bits."""
    from .fp import Boolean

    diffs = []

    def collect(x, y):
        if hasattr(x, "c"):
            for cx, cy in zip(x.c, y.c):
                collect(cx, cy)
        else:
            diffs.append(x - y)

    collect(a, b)
    acc = Boolean.constant(fpcls, True)
    p = fpcls.MODULUS
    for d in diffs:
        if d.is_constant:
            acc = acc & Boolean.constant(fpcls, d.val == 0)
            continue
        is_z = d.val == 0
        e = Boolean.new_witness(fpcls, is_z)
        fpcls.CS.set_last_recipe(("iszero", d._as_lc()))
        inv_hint = fpcls.new_witness(0 if is_z else pow(d.val, -1, p))
        fpcls.CS.set_last_recipe(("inv0", d._as_lc()))
        fpcls.CS.enforce(d._as_lc(), e.fp._as_lc(), {})
        one_minus = (fpcls.one() - e.fp)
        fpcls.CS.enforce(d._as_lc(), inv_hint._as_lc(), one_minus._as_lc())
        acc = acc & e
    return acc


def _host_mirror(E_sym):
    """Host-int tower class structurally identical to a symbolic tower class
    (same degrees and NR values) — used to compute witness hints."""
    from ..fields.prime import make_prime_field
    from ..fields.tower import make_ext_field

    if not hasattr(E_sym, "DEGREE") or E_sym.DEGREE == 1 or not hasattr(E_sym, "BASE"):
        return make_prime_field(E_sym.MODULUS, f"mirror_{E_sym.MODULUS % 99991}")
    base_host = _host_mirror(E_sym.BASE)
    nr = E_sym.NR
    nr_vals = tuple(c.val for c in _leaves(nr)) if hasattr(nr, "c") else (nr.val,)
    key = nr_vals if len(nr_vals) > 1 else nr_vals[0]
    return make_ext_field(base_host, E_sym.DEGREE, key,
                          f"mirror_{E_sym.NAME}")


def _leaves(e):
    if hasattr(e, "c"):
        out = []
        for c in e.c:
            out.extend(_leaves(c))
        return out
    return [e]


def _sym_to_host(e, H):
    if hasattr(e, "c"):
        prime = H.prime_subfield()
        return H.from_prime_coeffs([prime.from_int(x.val) for x in _leaves(e)])
    return H.from_int(e.val)


def _host_to_sym_witness(fpcls, E_sym, h):
    if hasattr(h, "c") and hasattr(E_sym, "from_prime_coeffs"):
        vals = [c.n for c in h.to_prime_coeffs()]
        # rebuild nested structure by allocating witnesses leaf-wise
        def build(E, vals):
            if not hasattr(E, "BASE") or E.DEGREE == 1:
                return fpcls.new_witness(vals.pop(0)), vals
            coeffs = []
            for _ in range(E.DEGREE):
                c, vals = build(E.BASE, vals)
                coeffs.append(c)
            return E(coeffs), vals
        out, rest = build(E_sym, list(vals))
        assert not rest
        return out
    return fpcls.new_witness(h.n)


def _scale_tree(e, fp_scalar):
    if hasattr(e, "c"):
        return type(e)([_scale_tree(c, fp_scalar) for c in e.c])
    return e * fp_scalar


def _inv_with_guard(fpcls, e, is_zero_bool):
    """Witness w enforced by  e * w == (1 - b) * 1, identical constraint
    structure whether e is zero or not (shape stability!); w is the true
    inverse when e != 0 and unconstrained-but-guarded otherwise."""
    if hasattr(e, "c"):
        from ..r1cs.program import HintGroup

        E_sym = type(e)
        H = _host_mirror(E_sym)
        hv = _sym_to_host(e, H)
        hint = H.zero() if hv.is_zero() else hv.inv()
        leaf_vals = [c.n for c in hint.to_prime_coeffs()]

        def _inv0_ext(vals, H=H):
            prime = H.prime_subfield()
            x = H.from_prime_coeffs([prime.from_int(v) for v in vals])
            out = H.zero() if x.is_zero() else x.inv()
            return [c.n for c in out.to_prime_coeffs()]

        group = HintGroup(_inv0_ext, [lf._as_lc() for lf in _leaves(e)])

        # rebuild nested structure, tagging each leaf with its hint slot
        def build(E, vals, off):
            if not hasattr(E, "BASE") or E.DEGREE == 1:
                wv = fpcls.new_witness(vals[off])
                fpcls.CS.set_last_recipe(("hint", group, off))
                return wv, off + 1
            coeffs = []
            for _ in range(E.DEGREE):
                c, off = build(E.BASE, vals, off)
                coeffs.append(c)
            return E(coeffs), off

        w, off = build(E_sym, leaf_vals, 0)
        assert off == len(leaf_vals)
        _enforce_sym_eq(e * w, _scale_tree(E_sym.one(),
                                           fpcls.one() - is_zero_bool.fp))
        return w
    val = 0 if e.val == 0 else pow(e.val, -1, fpcls.MODULUS)
    w = fpcls.new_witness(val)
    fpcls.CS.set_last_recipe(("inv0", e._as_lc()))
    fpcls.CS.enforce(e._as_lc(), w._as_lc(),
                     (fpcls.one() - is_zero_bool.fp)._as_lc())
    return w


def safe_affine(fpcls, proj, fallback_pt, lift_const):
    """Projective -> affine tolerating the identity (and any Z = 0 input):
    returns (AffinePointVar, is_degenerate_boolean).  When Z == 0 the
    fallback host point's coordinates are substituted so downstream pairing
    math stays well-defined; callers fold the Boolean into their verdict."""
    Z = proj.Z
    zero = type(Z).zero() if hasattr(Z, "c") else fpcls.zero()
    is_id = sym_eq_boolean(fpcls, Z, zero)
    w = _inv_with_guard(fpcls, Z, is_id)
    x = proj.X * w
    y = proj.Y * w
    fx = lift_const(fallback_pt.x)
    fy = lift_const(fallback_pt.y)
    x = is_id.select(fx, x)
    y = is_id.select(fy, y)
    return AffinePointVar(proj.curve, x, y), is_id
