"""Evaluation domains + mixed-radix FFT over prime fields (replaces
ark-poly's GeneralEvaluationDomain, reference Cargo.toml:19; need pinned by
the QAP/SAP provers — SURVEY.md D5).

ark-poly supports radix-2 and (2^i * q^j) mixed-radix domains.  We generalize:
a domain is any smooth divisor of p-1 (prime radixes <= 31), which covers
both the high-2-adicity MNT4.Fr (2-adicity 34) and the low-adicity MNT6.Fr
(2-adicity 17, then odd factors) as well as the toy fields.

Host implementation (Python ints) is the correctness oracle and handles
small/toy sizes; the device path (pcd_tpu/ops/fft_tensor.py) executes the
same radix plan as a batched tensor program for production sizes.

The port's copy of `pcd_tpu/poly/domain.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from functools import lru_cache

_RADIXES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31)


def _factor_smooth(n: int, radixes=_RADIXES):
    """Factor n over `radixes`; returns list of prime factors (ascending) or
    None if n is not smooth."""
    fs = []
    for r in radixes:
        while n % r == 0:
            fs.append(r)
            n //= r
    return fs if n == 1 else None


@lru_cache(maxsize=None)
def _smooth_divisors(group_order: int, cap: int = 1 << 26):
    """Sorted smooth divisors of group_order (capped)."""
    m = group_order
    fac = {}
    for r in _RADIXES:
        while m % r == 0:
            fac[r] = fac.get(r, 0) + 1
            m //= r
    divs = [1]
    for p, e in fac.items():
        new = []
        for d in divs:
            pe = 1
            for _ in range(e + 1):
                v = d * pe
                if v <= cap:
                    new.append(v)
                pe *= p
        divs = new
    return sorted(set(divs))


class EvaluationDomain:
    """Multiplicative subgroup of F^* of smooth order `size`."""

    def __init__(self, F, size: int):
        p = F.MODULUS
        assert (p - 1) % size == 0, "domain size must divide p-1"
        fs = _factor_smooth(size)
        assert fs is not None, f"domain size {size} not smooth"
        self.F = F
        self.p = p
        self.n = size
        self.factors = fs
        self.omega = pow(F.GENERATOR, (p - 1) // size, p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(size, -1, p)
        # coset shift for coset FFTs (any non-subgroup element; the field
        # generator works whenever size < p-1)
        self.coset_shift = F.GENERATOR
        self.coset_shift_inv = pow(F.GENERATOR, -1, p)

    @classmethod
    def new(cls, F, min_size: int) -> "EvaluationDomain":
        for d in _smooth_divisors(F.MODULUS - 1):
            if d >= min_size:
                return cls(F, d)
        raise ValueError(
            f"no smooth domain of size >= {min_size} in {F.NAME} "
            f"(p-1 smooth part exhausted)")

    # -- core mixed-radix FFT (host ints) -------------------------------
    def _fft_rec(self, a, omega: int):
        n = len(a)
        if n == 1:
            return a
        p = self.p
        r = _factor_smooth(n)[0]  # smallest prime factor
        m = n // r
        omega_r = pow(omega, r, p)
        subs = [self._fft_rec(a[j::r], omega_r) for j in range(r)]
        # combine: X[k] = sum_j omega^{j k} * subs[j][k mod m]
        out = [0] * n
        wk = [1] * r  # omega^{j*k} accumulated per j
        omega_pows_j = [pow(omega, j, p) for j in range(r)]
        for k in range(n):
            km = k % m
            acc = 0
            for j in range(r):
                acc += wk[j] * subs[j][km]
            out[k] = acc % p
            for j in range(r):
                wk[j] = wk[j] * omega_pows_j[j] % p
        return out

    _NATIVE_MIN = 256

    def _native(self):
        """C++ NTT backend (pcd_tpu/native) for production host sizes;
        the Python recursion stays as oracle + small-size path."""
        if self.n < self._NATIVE_MIN or self.p.bit_length() > 320:
            return None
        from .. import native

        return native if native.available() else None

    def fft(self, coeffs):
        """coefficients (ints, len <= n) -> evaluations over the domain."""
        a = list(coeffs) + [0] * (self.n - len(coeffs))
        assert len(a) == self.n
        nat = self._native()
        if nat is not None:
            return nat.ntt(self.p, self.omega, a)
        return self._fft_rec(a, self.omega)

    def ifft(self, evals):
        nat = self._native()
        if nat is not None:
            return nat.ntt(self.p, self.omega_inv, list(evals),
                           scale=self.n_inv)
        a = self._fft_rec(list(evals), self.omega_inv)
        ninv, p = self.n_inv, self.p
        return [x * ninv % p for x in a]

    def coset_fft(self, coeffs):
        p = self.p
        g = self.coset_shift
        a = list(coeffs) + [0] * (self.n - len(coeffs))
        nat = self._native()
        if nat is not None:
            return nat.ntt(p, self.omega, nat.geom_scale(p, g, a))
        gk = 1
        for i in range(self.n):
            a[i] = a[i] * gk % p
            gk = gk * g % p
        return self._fft_rec(a, self.omega)

    def coset_ifft(self, evals):
        p = self.p
        gi = self.coset_shift_inv
        nat = self._native()
        if nat is not None:
            a = nat.ntt(p, self.omega_inv, list(evals), scale=self.n_inv)
            return nat.geom_scale(p, gi, a)
        a = self.ifft(evals)
        gk = 1
        for i in range(self.n):
            a[i] = a[i] * gk % p
            gk = gk * gi % p
        return a

    # -- helpers ---------------------------------------------------------
    def vanishing_poly_at(self, x: int) -> int:
        return (pow(x, self.n, self.p) - 1) % self.p

    def elements(self):
        w, p = self.omega, self.p
        cur = 1
        for _ in range(self.n):
            yield cur
            cur = cur * w % p

    def lagrange_coeffs_at(self, tau: int):
        """[L_j(tau)] for all j: L_j(tau) = omega^j (tau^n - 1)/(n (tau - omega^j)).
        O(n) with a batched inversion."""
        p = self.p
        z = self.vanishing_poly_at(tau)
        if z == 0:
            # tau in domain: indicator vector
            out = [0] * self.n
            w, cur = self.omega, 1
            for j in range(self.n):
                if cur == tau % p:
                    out[j] = 1
                cur = cur * w % p
            return out
        # denominators n*(tau - w^j); batch invert
        dens = []
        w, cur = self.omega, 1
        n_mod = self.n % p
        for _ in range(self.n):
            dens.append(n_mod * (tau - cur) % p)
            cur = cur * w % p
        inv = batch_inverse(dens, p)
        out = []
        cur = 1
        for j in range(self.n):
            out.append(cur * z % p * inv[j] % p)
            cur = cur * self.omega % p
        return out


def batch_inverse(xs, p):
    """Montgomery batch inversion of nonzero ints mod p."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * xs[i] % p
    return out


def poly_mul(a, b, p):
    """Schoolbook for small, host-side polynomial multiply."""
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
    return out


def poly_eval(a, x, p):
    if len(a) >= 4096:
        # sequential C++ Horner when the native tier is up (the Marlin
        # prover evaluates ~20 domain-length polynomials per prove)
        try:
            from .. import native

            if native.available() and p.bit_length() <= 320:
                return native.poly_eval_mod(p, a, x)
        except Exception:
            pass
    acc = 0
    for c in reversed(a):
        acc = (acc * x + c) % p
    return acc
