"""KZG10 polynomial commitments (role of ark-poly-commit's MarlinKZG10,
reference Cargo.toml:42, tests/mnt4_marlin.rs:22,56-57) with degree-bound
enforcement via shifted powers, batched openings, and the in-circuit check
used by the Marlin verifier gadget.

  SRS:    {tau^i G}, {tau^i gamma G} (hiding), {tau H, H}
          + shifted powers {tau^(D - d + i) G} per supported degree bound d
  commit: C = sum c_i tau^i G     (+ optional degree-bound shadow
          C' = sum c_i tau^(D-d+i) G)
  open at z:  w(X) = (p(X) - p(z)) / (X - z),  pi = w(tau) G
  check:  e(C - p(z) G, H) == e(pi, tau H - z H)

Batch verification over many (commitment, point, value) triples combines
claims with a challenge xi:  sum xi^i (C_i - y_i G) and sum xi^i pi_i per
distinct point, then one pairing pair per point.

The port's KZG10 (`pcd_tpu/snark/marlin/kzg.py`): every commit and open
MSM of at least STREAM_MIN scalars runs on the stream MSM
(ops/msm_stream.py) on `device`, over the rows it needs of the SRS powers
table, which goes to the device once and stays cached on the SRS.
Smaller MSMs take the host C++ Pippenger, as in the reference.  Unlike
the reference, a stream MSM that fails raises: nothing latches the
stream tier off or retries on the host, and only the n scalars of an MSM
are scheduled, not the whole SRS length zero-padded.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...poly.domain import poly_eval
from ..msm_dispatch import fb_mul, host_query, msm_any, subrange


@dataclass
class KZGSRS:
    powers_g1: list          # tau^i G, i <= D
    shifted_g1: dict         # degree_bound -> [tau^(D-d+i) G]
    h: object                # H
    tau_h: object            # tau H
    max_degree: int

    def clone(self):
        return self


@dataclass
class KZGCommitment:
    c: object                # G1
    shifted: object = None   # degree-bound shadow commitment (optional)


class KZG10:
    # Stream-MSM threshold: the reference's value (kzg.py:61-66 takes
    # msm_dispatch.STREAM_MIN), the starting point to measure again on
    # the card (PERF.md)
    STREAM_MIN = 24_000

    def __init__(self, curve_cfg, device=None):
        """device: where the MSMs of STREAM_MIN scalars and more run (None
        means the card)."""
        from ...device import resolve_device
        from ...pairing.ate import pairing_for

        self.cfg = curve_cfg
        self.Fr = curve_cfg.Fr
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from ... import native

            if not native.available():
                # the stream tier's schedule and table encoding run there
                raise RuntimeError("the C++ tier (pcd_tpu_torch/native) "
                                   "failed to build; the card needs it")
        self.pairing = pairing_for(curve_cfg)

    def _stream_msm(self, srs: KZGSRS, offset: int, scalars):
        """sum_i scalars[i] * powers_g1[offset + i] on the stream tier of
        self.device when there are at least STREAM_MIN scalars, else None
        (the caller's host MSM takes it).  scalars: an int list or an
        (n, NL) canonical limb array."""
        import numpy as np

        from ..msm_dispatch import stream_collect, stream_msm_async

        n = scalars.shape[0] if hasattr(scalars, "shape") else len(scalars)
        if n < self.STREAM_MIN:
            return None
        from ...native import scalars_to_limbs

        sl = scalars if isinstance(scalars, np.ndarray) \
            else scalars_to_limbs(scalars)
        return stream_collect(stream_msm_async(
            srs, "powers_g1", self.cfg.g1, self.Fr.BITS, sl, self.device,
            offset=offset))

    # -- setup -----------------------------------------------------------
    def setup(self, max_degree: int, rng):
        """Universal SRS: {tau^i G} i<=D, H, tau H.  Shifted powers for any
        degree bound d are the subrange powers[D-d:] — no per-bound setup
        (this is what makes the SRS universal & the index updatable)."""
        p = self.Fr.MODULUS
        tau = rng.randrange(1, p)
        tau_pows = []
        cur = 1
        for _ in range(max_degree + 1):
            tau_pows.append(cur)
            cur = cur * tau % p
        powers = fb_mul(self.cfg, "g1", tau_pows, self.Fr.BITS, self.device)
        tau_h = fb_mul(self.cfg, "g2", [tau], self.Fr.BITS, self.device)[0]
        return KZGSRS(powers_g1=powers, shifted_g1={},
                      h=self.cfg.g2_gen, tau_h=tau_h,
                      max_degree=max_degree)

    # -- commit ----------------------------------------------------------
    def commit(self, srs: KZGSRS, coeffs, degree_bound=None) -> KZGCommitment:
        assert len(coeffs) <= srs.max_degree + 1, "degree exceeds SRS"
        coeffs = list(coeffs) or [0]
        c = self._stream_msm(srs, 0, coeffs)
        if c is None:
            powers = host_query(srs, "powers_g1")
            c = msm_any(subrange(powers, 0, len(coeffs)), coeffs)
        shadow = None
        if degree_bound is not None:
            assert len(coeffs) <= degree_bound + 1, "degree bound violated"
            off = srs.max_degree - degree_bound
            shadow = self._stream_msm(srs, off, coeffs)
            if shadow is None:
                powers = host_query(srs, "powers_g1")
                row = subrange(powers, off, off + len(coeffs))
                shadow = msm_any(row, coeffs)
        return KZGCommitment(c=c, shifted=shadow)

    # -- open ------------------------------------------------------------
    def open(self, srs: KZGSRS, coeffs, z: int):
        """Returns (value, witness commitment pi).  coeffs: int list or a
        canonical (n, NL) u64 limb array (the batch path's combined
        polynomial stays in limb form end-to-end)."""
        import numpy as np

        p = self.Fr.MODULUS
        n = coeffs.shape[0] if isinstance(coeffs, np.ndarray) \
            else len(coeffs)
        try:
            from ...native import available, poly_div_linear
        except Exception:
            available = lambda: False
        if n >= 4096 and available():
            # C++ Horner scan: the synthetic division was a sequential
            # Python-bigint loop over SRS-length lists (Marlin's opens
            # walk the full max_degree when degree-bound shadows shift)
            q, y = poly_div_linear(p, coeffs, z)
            pi = self._stream_msm(srs, 0, q)
            if pi is None:
                pi = msm_any(subrange(host_query(srs, "powers_g1"), 0,
                                      q.shape[0]), q)
            return y, pi
        if isinstance(coeffs, np.ndarray):
            from ...native import limbs_to_ints

            coeffs = limbs_to_ints(coeffs)
        y = poly_eval(coeffs, z, p)
        # synthetic division by (X - z)
        q = [0] * max(len(coeffs) - 1, 1)
        acc = 0
        for i in range(len(coeffs) - 1, 0, -1):
            acc = (coeffs[i] + acc * z) % p
            q[i - 1] = acc
        pi = msm_any(subrange(host_query(srs, "powers_g1"), 0, len(q)), q)
        return y, pi

    def open_batch(self, srs: KZGSRS, polys, z: int, xi: int):
        """Single witness for several polys at one point, combined with
        powers of challenge xi.  Each entry is a coefficient list OR a
        (shift, coeffs) pair meaning X^shift * coeffs — degree-bound
        shadows pass the shift symbolically so no SRS-length Python list
        is ever materialized.  Returns (values list, pi)."""
        p = self.Fr.MODULUS

        def parts(entry):
            return entry if isinstance(entry, tuple) else (0, entry)

        maxlen = max((parts(e)[0] + len(parts(e)[1]) for e in polys),
                     default=1)
        try:
            from ... import native
        except Exception:
            native = None
        if native is not None and native.available() and maxlen >= 4096:
            import numpy as np

            acc = np.zeros((maxlen, native.NL), dtype="<u8")
            cur = 1
            for entry in polys:
                shift, coeffs = parts(entry)
                if len(coeffs):
                    native.vec_axpy(p, acc[shift:shift + len(coeffs)],
                                    coeffs, cur)
                cur = cur * xi % p
            values = [poly_eval(list(parts(e)[1]), z, p)
                      * pow(z, parts(e)[0], p) % p for e in polys]
            _, pi = self.open(srs, acc, z)
            return values, pi
        combined = []
        cur = 1
        for entry in polys:
            shift, coeffs = parts(entry)
            for i, c in enumerate(coeffs):
                j = i + shift
                if j >= len(combined):
                    combined.extend([0] * (j + 1 - len(combined)))
                combined[j] = (combined[j] + cur * c) % p
            cur = cur * xi % p
        values = [poly_eval(list(parts(e)[1]), z, p)
                  * pow(z, parts(e)[0], p) % p for e in polys]
        _, pi = self.open(srs, combined, z)
        return values, pi

    # -- verify ----------------------------------------------------------
    def check(self, srs: KZGSRS, comm: KZGCommitment, z: int, y: int, pi):
        g = self.cfg.g1_gen
        lhs = comm.c - g * y
        # e(C - yG, H) * e(-pi, tauH - zH) == 1
        rhs_g2 = srs.tau_h - srs.h * z
        return self.pairing.multi_pairing(
            [(lhs, srs.h), (-pi, rhs_g2)]).is_one()

    def check_batch(self, srs: KZGSRS, comms, z: int, ys, pi, xi: int):
        """Check a combined opening (same xi as open_batch)."""
        p = self.Fr.MODULUS
        g = self.cfg.g1_gen
        acc = self.cfg.g1.infinity()
        acc_y = 0
        cur = 1
        for comm, y in zip(comms, ys):
            acc = acc + comm.c * cur
            acc_y = (acc_y + cur * y) % p
            cur = cur * xi % p
        lhs = acc - g * acc_y
        rhs_g2 = srs.tau_h - srs.h * z
        return self.pairing.multi_pairing(
            [(lhs, srs.h), (-pi, rhs_g2)]).is_one()

    def check_degree_bound(self, srs: KZGSRS, comm: KZGCommitment,
                           degree_bound: int) -> bool:
        """Pairing check that the shadow commitment encodes
        tau^(D-d) * same polynomial:  e(C', H) == e(C, tau^(D-d) H)...
        (requires tau^(D-d) H in the SRS; we instead verify at opening time
        via the shifted-value relation — see marlin/native.py usage)."""
        return comm.shifted is not None
