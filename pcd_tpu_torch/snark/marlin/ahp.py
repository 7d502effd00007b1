"""Marlin AHP for R1CS (role of ark-marlin's AHP, reference Cargo.toml:41).

Algebraic holographic proof with one lincheck (matrices combined by
eta challenges) and one matrix sumcheck over the non-zero-entry domain K:

  round 1:  zhat_A, zhat_B, zhat_C (Mz extensions over H), what (witness
            poly on H over the input subdomain complement), h_0 (rowcheck)
  round 2:  g_1 (deg < n-1), h_1   — lincheck sumcheck over H
  round 3:  sigma_3, g_3 (deg < |K|-1), h_3 — matrix sumcheck over K

Verifier identities (checked at random beta_1 / beta_3 via KZG openings):
  (i)   zhat_A zhat_B - zhat_C = h_0 v_H                     at beta_1
  (ii)  u_H(alpha,b1) t(b1) - sigma_3 zhat(b1)
            = h_1(b1) v_H(b1) + b1 g_1(b1)                   at beta_1
  (iii) h_3 v_K = a - b (X g_3 + sigma_3/|K|)                at beta_3
  with t = sum eta_M zhat_M,  zhat(X) = xhat(X) + v_Hx(X) what(X),
  a(X) = sum_M eta_M v_H(alpha) v_H(b1) val_M(X) prod_{N != M} b_N(X),
  b(X) = prod_M b_M(X),  b_M(X) = (alpha - row_M(X)) (b1 - col_M(X)).

Host-int implementation, field-generic; heavy polynomial products use
FFT multiplication over smooth domains.

The port's copy of `pcd_tpu/snark/marlin/ahp.py`.  `fft_any` keeps the
reference's size dispatch: a transform of _DEVICE_FFT_THRESHOLD points or
more on a card goes to the device NTT (ops/fft_tensor.py, K5 `ntt_pass`),
every other one to the host mixed-radix and C++ NTT paths.  The card is
the prover's: MarlinSNARK hands its device to AHP, and an AHP without
one (or on the CPU) stays on the host, as pcd_tpu does on the CPU.
`poly_mul_fft` has no device branch: the reference takes one only where
the C++ tier is absent, and the port always has it.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from ...device import on_card
from ...poly.domain import EvaluationDomain, batch_inverse, poly_eval
from ...utils.profiling import span


_DEVICE_FFT_THRESHOLD = 16384
# device transforms fft_any ran, by (direction, coset), since the last
# clear (chip_smoke.py counts them per index and per prove)
DEVICE_FFTS: Counter = Counter()


def fft_any(F, coeffs_or_evals, size: int, direction: str, coset: bool = False,
            device=None):
    """Size-dispatching transform of a zero-padded vector: the host
    mixed-radix below _DEVICE_FFT_THRESHOLD points or off the card, else
    the device NTT on `device`.  There the canonical ints go up as limbs,
    K7 takes them to Montgomery form, K5 runs the transform and its
    scaling, K7 takes them back, and the limbs come down as ints."""
    vec = list(coeffs_or_evals) + [0] * (size - len(coeffs_or_evals))
    if size < _DEVICE_FFT_THRESHOLD or not on_card(device):
        dom = EvaluationDomain(F, size)
        if direction == "fft":
            return dom.coset_fft(vec) if coset else dom.fft(vec)
        return dom.coset_ifft(vec) if coset else dom.ifft(vec)
    from ...ops.fft_tensor import fft_ctx
    from ...ops.field import ints_to_limbs, limbs_to_ints

    fctx = fft_ctx(F, size, device)
    f, p = fctx.f, F.MODULUS
    with span("fft_any/encode"):
        a = f.to_mont(torch.from_numpy(ints_to_limbs(
            [int(v) % p for v in vec]).view(np.int32)).to(device))
    with span("fft_any/transform"):
        if direction == "fft":
            out = fctx.coset_fft(a) if coset else fctx.fft(a)
        else:
            out = fctx.coset_ifft(a) if coset else fctx.ifft(a)
        out = f.from_mont(out)
    with span("fft_any/decode"):
        res = limbs_to_ints(out.cpu().numpy())
    DEVICE_FFTS[(direction, coset)] += 1
    return res


def poly_mul_fft(F, a, b):
    """FFT-based polynomial product: schoolbook up to 64 coefficients, the
    C++ limb NTT from a 4096-point domain, host transforms between."""
    if not a or not b:
        return []
    need = len(a) + len(b) - 1
    if need <= 64:
        p = F.MODULUS
        out = [0] * need
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    out[i + j] = (out[i + j] + ai * bj) % p
        return out
    d = EvaluationDomain.new(F, need)
    p = F.MODULUS
    try:
        from ... import native

        nat_ok = native.available() and d.n >= 4096 \
            and p.bit_length() <= 320
    except Exception:
        nat_ok = False
    if nat_ok:
        # limb-resident product: NTT -> pointwise -> inverse NTT with no
        # Python-int detours (the pointwise Python pass alone cost ~2 s
        # per 527k-point product in the real-scale Marlin prove)
        al = native.scalars_to_limbs(
            [int(v) % p for v in a] + [0] * (d.n - len(a)))
        bl = native.scalars_to_limbs(
            [int(v) % p for v in b] + [0] * (d.n - len(b)))
        ea = native.ntt_limbs(p, d.omega, al)
        eb = native.ntt_limbs(p, d.omega, bl)
        prod = native.vec_op(p, "mul", ea, eb)
        res = native.ntt_limbs(p, pow(d.omega, -1, p), prod,
                               scale=pow(d.n, -1, p))
        return native.limbs_to_ints(res)[:need]
    ea = d.fft(list(a) + [0] * (d.n - len(a)))
    eb = d.fft(list(b) + [0] * (d.n - len(b)))
    prod = [x * y % p for x, y in zip(ea, eb)]
    return d.ifft(prod)[:need]


def poly_add(p1, p2, p):
    n = max(len(p1), len(p2))
    out = [0] * n
    for i, c in enumerate(p1):
        out[i] = c
    for i, c in enumerate(p2):
        out[i] = (out[i] + c) % p
    return out


def poly_scale(p1, k, p):
    return [c * k % p for c in p1]


def divide_by_vanishing(coeffs, n, p):
    """Divide by X^n - 1; returns (quotient, remainder)."""
    rem = list(coeffs)
    q = [0] * max(len(coeffs) - n, 0)
    for i in range(len(rem) - 1, n - 1, -1):
        c = rem[i]
        if c:
            q[i - n] = c
            rem[i] = 0
            rem[i - n] = (rem[i - n] + c) % p
    return q, rem[:n]


@dataclass
class MatrixArith:
    """Index polynomials of one sparse matrix over K."""

    row: list   # coeffs over K (evals are H-elements)
    col: list
    val: list
    row_evals: list
    col_evals: list
    val_evals: list


@dataclass
class AHPIndex:
    n: int               # H size
    k_size: int          # K size
    input_size: int      # |H_x| (smooth divisor of n >= num_instance)
    num_instance: int
    num_vars: int
    col_map: list        # variable index -> H position (instances occupy
                         # the H_x subgroup positions j*(n/|H_x|))
    mats: dict           # 'A'/'B'/'C' -> MatrixArith
    rows_cols_vals: dict  # remapped sparse entries per matrix


class AHP:
    def __init__(self, F, device=None):
        """device: where fft_any's large transforms run (a card), None for
        the host."""
        self.F = F
        self.p = F.MODULUS
        self.device = device

    # -- indexer ---------------------------------------------------------
    def index_dims(self, cs_rows, num_instance: int, num_vars: int,
                   min_n: int = 1, min_k: int = 1):
        """Domain selection only (no polynomial building): returns
        (n, hx, k_size, col_map, entries_per).  Cheap — lets the caller
        raise NeedLargerBound BEFORE paying the index FFTs.

        min_n/min_k: padding floors for the H and K domains.  Matrices are
        zero outside the real rows and K entries are (0,0,0)-padded, so any
        domain >= the natural size is sound.  Used by the PCD setup
        fixed-point (pcd/ec_cycle.py) to break shape oscillation: the vk
        shape becomes monotone in the floor, so driving the floor to the
        running max converges."""
        p = self.p
        from ...poly.domain import _smooth_divisors

        # choose H and the input subdomain H_x together: H_x positions hold
        # ONLY instances (unused H_x slots must stay zero so xhat matches),
        # so we need n - hx >= num_witness
        n_needed = max(len(cs_rows), num_vars, min_n)
        H = EvaluationDomain.new(self.F, n_needed)
        while True:
            n = H.n
            hx = None
            for d in _smooth_divisors(self.p - 1):
                if d >= num_instance and n % d == 0:
                    hx = d
                    break
            if hx is not None and n - hx >= num_vars - num_instance:
                break
            H = EvaluationDomain.new(self.F, n + 1)

        stride = n // hx
        input_positions = [j * stride for j in range(num_instance)]
        hx_set = set(j * stride for j in range(hx))
        free = [i for i in range(n) if i not in hx_set]
        col_map = input_positions + free[: num_vars - num_instance]
        assert len(col_map) == num_vars

        nnz_max = 1
        entries_per = {}
        for mi, name in enumerate("ABC"):
            entries = []
            for r, row in enumerate(cs_rows):
                for cidx, v in row[mi].items():
                    if v % p:
                        entries.append((r, col_map[cidx], v % p))
            entries_per[name] = entries
            nnz_max = max(nnz_max, len(entries))
        k_size = EvaluationDomain.new(self.F, max(nnz_max, min_k)).n
        return n, hx, k_size, col_map, entries_per

    def index(self, cs_rows, num_instance: int, num_vars: int,
              dims=None) -> AHPIndex:
        """cs_rows: list of (a_lc, b_lc, c_lc) dicts in column space
        (instance-first).  Builds square matrices over H and index polys
        over K."""
        p = self.p
        if dims is None:
            dims = self.index_dims(cs_rows, num_instance, num_vars)
        n, hx, k_n, col_map, entries_per = dims
        H = self.domain(n)
        Hel = list(H.elements())

        ninv = pow(n, -1, p)
        mats = {}
        raw = {}
        K = self.domain(k_n)
        for name in "ABC":
            entries = entries_per[name]
            entries = entries + [(0, 0, 0)] * (K.n - len(entries))
            row_e = [Hel[r] for (r, _, _) in entries]
            col_e = [Hel[c] for (_, c, _) in entries]
            # normalized value: val * col_elem / n  (Lagrange-at-beta factor,
            # so that sigma_3 = r(alpha, beta_1) exactly)
            val_e = [v * Hel[c] % p * ninv % p for (_, c, v) in entries]
            mats[name] = MatrixArith(
                row=fft_any(self.F, row_e, K.n, "ifft",
                            device=self.device),
                col=fft_any(self.F, col_e, K.n, "ifft",
                            device=self.device),
                val=fft_any(self.F, val_e, K.n, "ifft",
                            device=self.device),
                row_evals=row_e, col_evals=col_e, val_evals=val_e)
            raw[name] = entries
        return AHPIndex(n=n, k_size=K.n, input_size=hx,
                        num_instance=num_instance, num_vars=num_vars,
                        col_map=col_map, mats=mats, rows_cols_vals=raw)

    # -- helpers ---------------------------------------------------------
    def domain(self, size):
        return EvaluationDomain(self.F, size)

    def x_poly(self, index: AHPIndex, public_input):
        """Interpolation of padded public input over H_x (subgroup)."""
        p = self.p
        Hx = self.domain(index.input_size)
        vals = [int(x) % p for x in public_input]
        vals += [0] * (Hx.n - len(vals))
        return Hx.ifft(vals)

    def z_on_H(self, index: AHPIndex, z):
        """Place the assignment on H according to col_map."""
        p = self.p
        out = [0] * index.n
        for i, v in enumerate(z):
            out[index.col_map[i]] = int(v) % p
        return out

    def z_poly_parts(self, index: AHPIndex, z):
        """Returns (xhat coeffs, what coeffs) with
        zhat(X) = xhat(X) + v_Hx(X) * what(X); what = (zhat_full - xhat)/v_Hx."""
        p = self.p
        H = self.domain(index.n)
        zfull = self.z_on_H(index, z)
        z_coeffs = fft_any(self.F, zfull, H.n, "ifft",
                           device=self.device)
        xhat = self.x_poly(index, z[: index.num_instance])
        diff = poly_add(z_coeffs, poly_scale(xhat, p - 1, p), p)
        # divide by v_Hx = X^hx - 1
        q, rem = divide_by_vanishing(diff, index.input_size, p)
        assert all(c == 0 for c in rem), "input inconsistency in z"
        return xhat, q

    def u_H(self, alpha, beta, n):
        """u_H(alpha, beta) for alpha not in H:
        (v_H(alpha) - v_H(beta)) / (alpha - beta)."""
        p = self.p
        va = (pow(alpha, n, p) - 1) % p
        vb = (pow(beta, n, p) - 1) % p
        return (va - vb) * pow((alpha - beta) % p, -1, p) % p

    def u_H_poly(self, alpha, n):
        """u_H(alpha, X) as coefficients: sum_{i<n} alpha^{n-1-i} X^i
        (since (alpha^n - X^n)/(alpha - X) for X^n excluded... exact:
        (v_H(alpha) - v_H(X))/(alpha - X) = sum_{i=0}^{n-1} alpha^{n-1-i} X^i)."""
        p = self.p
        out = [0] * n
        cur = 1
        for i in range(n - 1, -1, -1):
            out[i] = cur
            cur = cur * alpha % p
        return out

    # -- prover ----------------------------------------------------------
    def prover_round1(self, index: AHPIndex, cs_rows, z, rng=None,
                      evs=None):
        """Returns dict of polynomials: zhat_A/B/C, what, h_0, s_mask.

        Zero-knowledge (role of ark-marlin's zk mode, reference
        Cargo.toml:41): every witness-dependent round-1 polynomial gets a
        degree-1 polynomial mask times the vanishing polynomial —
          zhat_M' = zhat_M + v_H * rho_M,   zhat' = zhat + v_H * rho_w
        (realized through what' = what + (v_H/v_Hx) * rho_w), leaving the
        values on H unchanged.  Two fresh random dimensions per polynomial
        cover the two leaked evaluations (the commitment's p(tau) and the
        opening at beta_1).  The lincheck is blinded by an independent
        mask polynomial s with sum_H s = 0, committed in round 1 and
        opened at beta_1 (identity (ii) gains an s(beta_1) term).
        h_0 is recomputed from the masked polynomials, so the rowcheck
        identity holds verbatim."""
        p = self.p
        H = self.domain(index.n)
        n = index.n
        zvals = [int(v) % p for v in z]
        if evs is None:
            # Az/Bz/Cz on H (callers with the native CSR tier pass these
            # in — marlin/native.prove computes them once for the
            # satisfiability check and reuses them here)
            evs = {}
            for mi, name in enumerate("ABC"):
                mz = [0] * index.n
                for r, row in enumerate(cs_rows):
                    mz[r] = sum(co * zvals[c]
                                for c, co in row[mi].items()) % p
                evs[name] = mz
        with span("r1/ifft_mz"):
            zh = {name: fft_any(self.F, evs[name], H.n, "ifft",
                                 device=self.device)
                  for name in "ABC"}
        with span("r1/z_parts"):
            xhat, what = self.z_poly_parts(index, z)

        def rand():
            return rng.randrange(p) if rng is not None else 0

        # v_H * (r0 + r1 X)  as coefficients
        def vh_mask():
            r0, r1 = rand(), rand()
            out = [0] * (n + 2)
            out[0] = (p - r0) % p
            out[1] = (p - r1) % p
            out[n] = (out[n] + r0) % p
            out[n + 1] = (out[n + 1] + r1) % p
            return out

        for name in "ABC":
            zh[name] = poly_add(zh[name], vh_mask(), p)
        # what' = what + (v_H / v_Hx)(r0 + r1 X); v_H/v_Hx = sum X^{hx j}
        hx = index.input_size
        r0, r1 = rand(), rand()
        qmask = [0] * (n - hx + 2)
        for j in range(n // hx):
            qmask[hx * j] = (qmask[hx * j] + r0) % p
            qmask[hx * j + 1] = (qmask[hx * j + 1] + r1) % p
        what = poly_add(what, qmask, p)
        # lincheck mask s: random deg <= n+1 with sum_H s = 0
        # (sum_H X^k = n iff n | k; only k = 0 and k = n occur up to n+1,
        #  so fixing c_0 = -c_n zeroes the sum).  Bulk draw: |H|
        # rejection samples through the scalar path cost ~8 s per
        # real-scale prove
        if rng is not None and hasattr(rng, "randrange_many"):
            s_mask = rng.randrange_many(p, n + 2)
        else:
            s_mask = [rand() for _ in range(n + 2)]
        s_mask[0] = (p - s_mask[n]) % p
        # rowcheck from the MASKED polynomials
        with span("r1/mul_ab"):
            prod = poly_mul_fft(self.F, zh["A"], zh["B"])
        with span("r1/sub_c"):
            num = poly_add(prod, poly_scale(zh["C"], p - 1, p), p)
        with span("r1/div_vanish"):
            h0, rem = divide_by_vanishing(num, index.n, p)
        assert all(c == 0 for c in rem), "rowcheck failed (unsatisfied R1CS)"
        return dict(zhat_A=zh["A"], zhat_B=zh["B"], zhat_C=zh["C"],
                    what=what, h_0=h0, s_mask=s_mask, _xhat=xhat)

    def prover_round2(self, index: AHPIndex, polys, alpha, etas):
        """Lincheck sumcheck: returns (g_1, h_1)."""
        p = self.p
        n = index.n
        # t = sum eta_M zhat_M
        t = [0]
        with span("r2/t"):
            for name in "ABC":
                t = poly_add(t, poly_scale(polys[f"zhat_{name}"],
                                           etas[name], p), p)
        uh = self.u_H_poly(alpha, n)
        with span("r2/mul_uh_t"):
            q1 = poly_mul_fft(self.F, uh, t)
        q1 = poly_add(q1, polys.get("s_mask", []), p)
        # r(alpha, X) = sum_M eta_M sum_k u_H(alpha,row_k) val_k L_{col_k}(X)
        # evaluate r(alpha, .) on H directly from sparse entries
        r_evals = [0] * n
        H = self.domain(n)
        Hel = list(H.elements())
        va = (pow(alpha, n, p) - 1) % p
        # u_H(alpha, y) for y in H = v_H(alpha)/(n... careful:
        # u_H(alpha,y) = v_H(alpha)/(alpha - y) since v_H(y)=0... times?
        # (v_H(alpha) - 0)/(alpha - y)
        with span("r2/u_alpha_inv"):
            dens = [(alpha - y) % p for y in Hel]
            inv_dens = batch_inverse(dens, p)
        u_alpha = [va * iv % p for iv in inv_dens]
        el_index = {y: i for i, y in enumerate(Hel)}
        for name in "ABC":
            eta = etas[name]
            for (r, c, v) in index.rows_cols_vals[name]:
                if v:
                    r_evals[c] = (r_evals[c] + eta * v % p * u_alpha[r]) % p
        # zhat evals on H = z (by construction)
        zhat_evals = None
        # q1 -= r(alpha,X) * zhat(X): compute r*zhat in evaluation form on a
        # larger domain
        with span("r2/ifft_r"):
            r_coeffs = fft_any(self.F, r_evals, H.n, "ifft",
                               device=self.device)
        zhat = poly_add(polys["_xhat"],
                        poly_mul_fft(self.F,
                                     [p - 1] + [0] * (index.input_size - 1) + [1],
                                     polys["what"]), p)
        with span("r2/mul_rz"):
            rz = poly_mul_fft(self.F, r_coeffs, zhat)
        with span("r2/sub_rz"):
            q1 = poly_add(q1, poly_scale(rz, p - 1, p), p)
        # sumcheck decomposition: q1 = h_1 v_H + X g_1 (+ sigma/n, sigma=0)
        with span("r2/div_vanish"):
            h1, rem = divide_by_vanishing(q1, n, p)
        assert rem[0] == 0, "lincheck sum not zero"
        g1 = rem[1:]
        return g1, h1, zhat

    def prover_round3(self, index: AHPIndex, alpha, beta1, etas):
        """Per-matrix sumchecks over K (the Marlin-style split keeps the
        committed degrees at ~3|K| instead of ~7|K|).

        For each M:  sigma_M = sum_K a_M(k)/b_M(k)  with
          a_M = eta_M v_H(alpha) v_H(beta1) val_M(X),
          b_M = (alpha - row_M(X)) (beta1 - col_M(X));
        prover sends per M: sigma_M, g_M (deg < |K|-1), h_M with
          h_M v_K = a_M - b_M (X g_M + sigma_M/|K|).
        Returns (sigma3 = sum sigma_M, {M: (sigma_M, g_M, h_M)}).
        """
        p = self.p
        K = self.domain(index.k_size)
        n = index.n
        va = (pow(alpha, n, p) - 1) % p
        vb = (pow(beta1, n, p) - 1) % p
        out = {}
        sigma3 = 0
        kinv = pow(K.n, -1, p)
        for name in "ABC":
            m = index.mats[name]
            with span("r3/ab_ev"):
                b_ev = [(alpha - m.row_evals[i]) * (beta1 - m.col_evals[i])
                        % p for i in range(K.n)]
                a_ev = [etas[name] * va % p * vb % p * m.val_evals[i] % p
                        for i in range(K.n)]
            with span("r3/binv"):
                binv = batch_inverse(b_ev, p)
                f = [a_ev[i] * binv[i] % p for i in range(K.n)]
            sigma_m = sum(f) % p
            with span("r3/ifft_f"):
                f_coeffs = fft_any(self.F, f, K.n, "ifft",
                                   device=self.device)
            assert f_coeffs[0] == sigma_m * kinv % p
            g_m = f_coeffs[1:]
            # h_M: a_M - b_M (X g_M + sigma_M/|K|) = h_M v_K  (product form)
            a_poly = poly_scale(m.val, etas[name] * va % p * vb % p, p)
            neg_row = poly_scale(m.row, p - 1, p)
            neg_col = poly_scale(m.col, p - 1, p)
            with span("r3/mul_b"):
                b_poly = poly_mul_fft(self.F,
                                      poly_add([alpha % p], neg_row, p),
                                      poly_add([beta1 % p], neg_col, p))
            xg = [0] + list(g_m)
            xg[0] = (xg[0] + sigma_m * kinv) % p
            with span("r3/mul_bxg"):
                num = poly_add(a_poly,
                               poly_scale(poly_mul_fft(self.F, b_poly, xg),
                                          p - 1, p), p)
            with span("r3/div_vanish"):
                h_m, rem = divide_by_vanishing(num, K.n, p)
            assert all(c == 0 for c in rem), "matrix sumcheck division failed"
            out[name] = (sigma_m, g_m, h_m)
            sigma3 = (sigma3 + sigma_m) % p
        return sigma3, out

    # -- verifier equation checks (on opened values) ----------------------
    def check_identities(self, index: AHPIndex, public_input, alpha, etas,
                         beta1, beta3, sigma3, ev):
        """ev: dict of polynomial evaluations:
          at beta1: zhat_A, zhat_B, zhat_C, what, h_0, g_1, h_1
          at beta3: row/col/val per matrix, g_3, h_3
        Returns bool."""
        p = self.p
        n = index.n
        vH_b1 = (pow(beta1, n, p) - 1) % p
        # (i) rowcheck
        if (ev["zhat_A"] * ev["zhat_B"] - ev["zhat_C"] - ev["h_0"] * vH_b1) % p:
            return False
        # reconstruct zhat(beta1)
        xhat = self.x_poly(index, public_input)
        x_b1 = poly_eval(xhat, beta1, p)
        v_hx_b1 = (pow(beta1, index.input_size, p) - 1) % p
        zhat_b1 = (x_b1 + v_hx_b1 * ev["what"]) % p
        # (ii) lincheck (with the zk sumcheck mask s opened at beta1)
        t_b1 = sum(etas[nm] * ev[f"zhat_{nm}"] for nm in "ABC") % p
        uh = self.u_H(alpha, beta1, n)
        lhs = (ev["s_mask"] + uh * t_b1 - sigma3 * zhat_b1) % p
        rhs = (ev["h_1"] * vH_b1 + beta1 * ev["g_1"]) % p
        if (lhs - rhs) % p:
            return False
        # (iii) per-matrix sumchecks at beta3; sigma_3 = sum of claimed
        # per-matrix sums (ev carries sigma_A/B/C)
        va = (pow(alpha, n, p) - 1) % p
        vb = (pow(beta1, n, p) - 1) % p
        if (sum(ev[f"sigma_{nm}"] for nm in "ABC") - sigma3) % p:
            return False
        vK_b3 = (pow(beta3, index.k_size, p) - 1) % p
        kinv = pow(index.k_size, -1, p)
        for nm in "ABC":
            bm = (alpha - ev[f"row_{nm}"]) * (beta1 - ev[f"col_{nm}"]) % p
            am = etas[nm] * va % p * vb % p * ev[f"val_{nm}"] % p
            lhs3 = ev[f"h_3{nm}"] * vK_b3 % p
            rhs3 = (am - bm * ((beta3 * ev[f"g_3{nm}"] +
                                ev[f"sigma_{nm}"] * kinv) % p)) % p
            if (lhs3 - rhs3) % p:
                return False
        return True
