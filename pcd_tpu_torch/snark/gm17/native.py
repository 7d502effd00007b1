"""GM17 native prover/verifier of the port: a copy of
`pcd_tpu/snark/gm17/native.py` (which replaces ark-gm17, reference
Cargo.toml:40; used at tests/mnt4_gm17.rs:27-30 and the mixed configs)
without its legacy device tier (the device h-poly, the `backend` knob).
Its setup's query vectors go through msm_dispatch.fb_mul, on the tier
msm_dispatch.KEYGEN names: K8 on `device`'s card, or the C++ fixed-base
(the reference's fb_mul).

Construction (GM17-shaped; design re-derived in the Groth16 tradition —
the reference's exact CRS cannot be byte-verified here, and interchange-
ability with Groth16 inside the PCD is what the mixed configs test):

  R1CS -> SAP: each constraint a*b = c becomes two squarings
      (a+b)^2 = 4c + w,   (a-b)^2 = w        (fresh wire w)
  plus one squaring row (z_i)^2 = sq_i per instance wire for A-poly
  independence.  SAP relation: (sum z_i a_i(s))^2 = sum z_i c_i(s) + h Z.

  Secrets (s, alpha, gamma, delta).  With a := sum z_i a_i(s):
    A = G^{alpha + a + r delta}
    B = H^{alpha + a + r delta}          (same exponent, enforced by eq. 2)
    C = G^{[sum_wit z_i (2 alpha a_i + c_i) + h Z
            + r delta (2 alpha + 2a + r delta)] / delta}
  Verify:
    (1) e(A, B) == e(G^alpha, H^alpha)
                   * e(prod_pub G^{(2 alpha a_i + c_i)/gamma * x_i}, H^gamma)
                   * e(C, H^delta)
    (2) e(A, H^gamma) == e(G^gamma, B)

The quotient runs on the tier msm_dispatch.QUOTIENT names: "host", the
C++ CSR matvec, the SAP evaluations and the fused squaring quotient, or
"device", the reference's device tier (its `_use_device` branch of
`prove`) on `device`: the sparse matvec (ops/matvec_tensor.py), the SAP
evaluations (K7) and the squaring coset pipeline (ops/fft_tensor.py).
Meanwhile the commitment MSMs of circuits with at least STREAM_MIN SAP
variables go to the stream MSM (ops/msm_stream.py) on `device`: the CUDA
kernels on a card, their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...msm.host import fixed_base_many, msm as host_msm
from ...poly.domain import EvaluationDomain
from ...r1cs.system import ConstraintSystem
from ...utils.profiling import in_request, span
from ..api import SNARKError


@dataclass
class GM17Proof:
    a: object  # G1
    b: object  # G2
    c: object  # G1

    def clone(self):
        return GM17Proof(self.a, self.b, self.c)


@dataclass
class GM17VK:
    alpha_g1: object
    alpha_g2: object
    gamma_g1: object
    gamma_g2: object
    delta_g2: object
    query: list  # G1: (2 alpha a_i + c_i)/gamma for instance wires


@dataclass
class GM17PVK:
    vk: GM17VK
    alpha_alpha: object  # e(alpha_g1, alpha_g2)


@dataclass
class GM17PK:
    vk: GM17VK
    delta_g1: object
    delta_g2: object
    a_query: list      # G1 a_i(s) per wire
    b_query: list      # G2 a_i(s) per wire
    c_query: list      # G1 (2 alpha a_i + c_i)/delta for witness wires
    h_query: list      # G1 s^j Z(s)/delta
    num_instance: int
    num_vars: int      # R1CS vars (before SAP extension)
    domain_size: int


class GM17:
    def __init__(self, curve_cfg, device=None):
        """curve_cfg: MNTCurveConfig — G1/G2/Fr and the pairing.
        device: where the stream MSM runs the commitment MSMs of circuits
        from STREAM_MIN SAP variables up (None means the card)."""
        from ...device import resolve_device

        self.cfg = curve_cfg
        self.Fr = curve_cfg.Fr
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from ... import native

            if not native.available():
                # the stream tier's schedule and table encoding run there
                raise RuntimeError("the C++ tier (pcd_tpu_torch/native) "
                                   "failed to build; the card needs it")
        from ...pairing.ate import pairing_for

        self.pairing = pairing_for(curve_cfg)
        self.msm = host_msm

    # -- R1CS -> SAP ----------------------------------------------------
    def _sap_rows(self, cs: ConstraintSystem):
        """Returns (rows, num_sap_vars): rows are (a_lc, c_lc) dicts over
        column indices [instance..., r1cs witness..., sap extra wires...];
        the prover appends the extra wires' values to the assignment."""
        p = cs.p
        n_inst = cs.num_instance
        n_vars = n_inst + cs.num_witness
        rows = []
        extra = 0

        def remap(lc):
            return {(n_inst + (-v - 1) if v < 0 else v): co % p
                    for v, co in lc.items()}

        for (a, b, c) in cs.constraints:
            ra, rb, rc = remap(a), remap(b), remap(c)
            w_col = n_vars + extra
            extra += 1
            # (a+b)^2 = 4c + w
            apb = dict(ra)
            for col, co in rb.items():
                apb[col] = (apb.get(col, 0) + co) % p
            c4 = {col: 4 * co % p for col, co in rc.items()}
            c4[w_col] = 1
            rows.append((apb, c4))
            # (a-b)^2 = w
            amb = dict(ra)
            for col, co in rb.items():
                amb[col] = (amb.get(col, 0) - co) % p
            rows.append((amb, {w_col: 1}))
        # instance independence rows: z_i^2 = sq_i
        for i in range(n_inst):
            sq_col = n_vars + extra
            extra += 1
            rows.append(({i: 1}, {sq_col: 1}))
        return rows, n_vars + extra

    def _synthesize(self, circuit) -> ConstraintSystem:
        cs = ConstraintSystem(self.Fr)
        circuit.generate_constraints(cs)
        return cs

    # -- setup ----------------------------------------------------------
    def circuit_specific_setup(self, circuit, rng):
        with span("gm17_setup/synthesize"):
            cs = self._synthesize(circuit)
        p = self.Fr.MODULUS
        with span("gm17_setup/sap_rows"):
            rows, num_sap_vars = self._sap_rows(cs)
        n_inst = cs.num_instance
        domain = EvaluationDomain.new(self.Fr, len(rows))

        s = rng.randrange(1, p)
        alpha = rng.randrange(1, p)
        gamma = rng.randrange(1, p)
        delta = rng.randrange(1, p)

        with span("gm17_setup/lagrange"):
            lag = domain.lagrange_coeffs_at(s)
        with span("gm17_setup/columns"):
            a_of = [0] * num_sap_vars
            c_of = [0] * num_sap_vars
            for j, (ra, rc) in enumerate(rows):
                lj = lag[j]
                if lj == 0:
                    continue
                for col, co in ra.items():
                    a_of[col] = (a_of[col] + co * lj) % p
                for col, co in rc.items():
                    c_of[col] = (c_of[col] + co * lj) % p

        zt = domain.vanishing_poly_at(s)
        gamma_inv = pow(gamma, -1, p)
        delta_inv = pow(delta, -1, p)

        h_scalars = []
        cur = zt * delta_inv % p
        for _ in range(domain.n - 1):
            h_scalars.append(cur)
            cur = cur * s % p

        # the query vectors through fb_mul (KEYGEN's tier: K8 on the card,
        # or the C++ fixed-base), as the port's Groth16 keygen; the
        # instance-sized query and the three-scalar key elements, always
        # under KEYGEN_MIN, stay on the host's fixed_base_many
        from ..msm_dispatch import fb_mul

        cfg, dev = self.cfg, self.device
        g1g, g2g, bits = cfg.g1_gen, cfg.g2_gen, self.Fr.BITS
        with span("gm17_setup/fb_g1"):
            query = fixed_base_many(
                g1g, [(2 * alpha * a_of[i] + c_of[i]) % p * gamma_inv % p
                      for i in range(n_inst)], bits)
            c_query = fb_mul(
                cfg, "g1", [(2 * alpha * a_of[i] + c_of[i]) % p * delta_inv
                            % p for i in range(n_inst, num_sap_vars)],
                bits, dev)
            a_query = fb_mul(cfg, "g1", a_of, bits, dev)
        with span("gm17_setup/fb_g2"):
            b_query = fb_mul(cfg, "g2", a_of, bits, dev)
        with span("gm17_setup/fb_h"):
            h_query = fb_mul(cfg, "g1", h_scalars, bits, dev)
        small1 = fixed_base_many(g1g, [alpha, gamma, delta], bits)
        small2 = fixed_base_many(g2g, [alpha, gamma, delta], bits)

        vk = GM17VK(
            alpha_g1=small1[0],
            alpha_g2=small2[0],
            gamma_g1=small1[1],
            gamma_g2=small2[1],
            delta_g2=small2[2],
            query=query,
        )
        pk = GM17PK(
            vk=vk,
            delta_g1=small1[2],
            delta_g2=small2[2],
            a_query=a_query,
            b_query=b_query,
            c_query=c_query,
            h_query=h_query,
            num_instance=n_inst,
            num_vars=n_inst + cs.num_witness,
            domain_size=domain.n,
        )
        return pk, vk

    # -- stream-MSM offload ---------------------------------------------
    # As in the port's Groth16: the a, b (G2) and c query MSMs need only
    # the SAP-extended assignment, which is ready before the quotient, so
    # a background thread enqueues them on the side stream while the host
    # runs the squaring quotient; the h MSM follows once the quotient
    # lands.  c_query covers the witness columns; padded with n_inst
    # flagged-infinity rows it shares the a/b schedule.  Once a circuit is
    # streamed, all four MSMs are: a missing one raises rather than
    # running on the host.
    STREAM_MIN = 24_000
    STREAMED = ("a_query", "b_query", "c_query", "h_query")

    def _stream_launch(self, pk, z_ext, n_inst):
        """Enqueue the a/b/c MSMs on the stream tier; returns {name:
        future}."""
        from ..msm_dispatch import side_stream, stream_launch, zpad_query

        g1, g2 = self.cfg.g1, self.cfg.g2
        c_nm = zpad_query(pk, "c_query", n_inst, g1)
        with side_stream(self, self.device) as sched:
            futs = stream_launch(
                pk, (("a_query", g1), ("b_query", g2), (c_nm, g1)), g1,
                self.Fr.BITS, z_ext, self.device, sched)
        futs["c_query"] = futs.pop(c_nm)
        return futs

    def _stream_launch_bg(self, pk, z_ext, n_inst):
        """_stream_launch from a background thread, in this thread's
        profiling request, when the SAP-extended assignment reaches
        STREAM_MIN: returns its future, else None."""
        from concurrent.futures import ThreadPoolExecutor

        if z_ext.shape[0] < self.STREAM_MIN:
            return None
        ex = ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(in_request(self._stream_launch), pk, z_ext, n_inst)
        ex.shutdown(wait=False)
        return fut

    def _stream_launch_h(self, pk, futs, h_limbs):
        """Enqueue the h-query MSM once the quotient limbs land (host
        limbs, or the device quotient's tensor, which the side stream
        reads after the quotient's stream has computed it)."""
        import torch

        from ..msm_dispatch import side_stream, stream_msm_async

        reads = (h_limbs,) if isinstance(h_limbs, torch.Tensor) else ()
        with side_stream(self, self.device, reads) as sched, \
                span("stream_dispatch_h"):
            futs["h_query"] = stream_msm_async(
                pk, "h_query", self.cfg.g1, self.Fr.BITS, h_limbs,
                self.device, sched_stream=sched)

    # -- prove ----------------------------------------------------------
    def prove(self, pk: GM17PK, circuit, rng):
        """Works from the R1CS row evaluations Az/Bz/Cz only — the SAP
        extension (reference ark-gm17's A/C polynomials) is assembled
        elementwise:  a_ev[2j] = Az+Bz, a_ev[2j+1] = Az-Bz,
        c_ev[2j] = 4Cz + w, c_ev[2j+1] = w  with w = (Az-Bz)^2,
        plus the per-instance squaring rows.  No SAP matrices are ever
        materialized at prove time."""
        from ..plan import plan_for

        with span("gm17/witness"):
            z, cs, plan = plan_for(pk, lambda: ConstraintSystem(self.Fr),
                                   circuit)
        p = self.Fr.MODULUS
        if len(z) != pk.num_vars:
            raise SNARKError("circuit shape mismatch vs proving key")
        if cs is not None:
            rows3 = []
            n_inst = cs.num_instance

            def remap(lc):
                return {(n_inst + (-v - 1) if v < 0 else v): co % p
                        for v, co in lc.items()}

            for (a, b, c) in cs.constraints:
                rows3.append((remap(a), remap(b), remap(c)))
            n_cons = cs.num_constraints
            if plan is not None:
                plan.rows = rows3
        else:
            rows3 = plan.rows
            n_inst = plan.n_inst
            n_cons = plan.n_constraints
        replayed = cs is None
        domain = EvaluationDomain(self.Fr, pk.domain_size)
        futs = None

        with span("gm17/h_poly"):
            from ... import native as _nat
            from ..msm_dispatch import quotient_tier

            if quotient_tier() == "device":
                z, h, futs = self._h_device(pk, rows3, z, n_inst, n_cons,
                                            domain, replayed)
            elif _nat.available() and p.bit_length() <= 320:
                z, h, futs = self._h_limbs(pk, _nat, rows3, z, n_inst,
                                           n_cons, domain, replayed)
            else:
                z, h = self._h_python(rows3, z, n_inst, n_cons, domain,
                                      replayed)

        r = rng.randrange(p)

        with span("gm17/msm"):
            return self._prove_commit(pk, n_inst, z, h, r, futs)

    def _h_limbs(self, pk, _nat, rows3, z, n_inst, n_cons, domain,
                 replayed):
        """Limb path: CSR matvec, SAP evaluations (vec_op elementwise),
        the fused squaring quotient h = (A^2 - C)/Z_H (hpoly with b
        aliased to a); the MSM scalars stay limbs.  Returns (SAP-extended
        z, h, stream futures or None)."""
        import numpy as np

        p = self.Fr.MODULUS
        mats = getattr(pk, "_host_mats", None)
        if mats is None:
            with span("csr_build"):
                mats = _nat.SpMatrices(p, rows3, n_cons)
            pk._host_mats = mats
        with span("z_marshal"):
            z_limbs = _nat.scalars_to_limbs(z)
        with span("matvec"):
            azl, bzl, czl = mats.apply_all_limbs(z_limbs)
        with span("sap_evals"):
            d = _nat.vec_op(p, "sub", azl, bzl)
            w = _nat.vec_op(p, "mul", d, d)
            apb = _nat.vec_op(p, "add", azl, bzl)
            cz2 = _nat.vec_op(p, "add", czl, czl)
            c0 = _nat.vec_op(p, "add", _nat.vec_op(p, "add", cz2, cz2), w)
            zi = np.ascontiguousarray(z_limbs[:n_inst])
            zisq = _nat.vec_op(p, "mul", zi, zi) if n_inst else zi
            z_ext = np.concatenate([z_limbs, w, zisq])
        # the SAP-extended assignment is ready BEFORE the quotient:
        # enqueue the a/b/c MSMs from a background thread while the host
        # (pure C++, GIL released) runs hpoly below
        launch = self._stream_launch_bg(pk, z_ext, n_inst)
        nl = z_limbs.shape[1]
        a_ev = np.zeros((domain.n, nl), dtype="<u8")
        c_ev = np.zeros((domain.n, nl), dtype="<u8")
        a_ev[0: 2 * n_cons: 2] = apb
        a_ev[1: 2 * n_cons: 2] = d
        a_ev[2 * n_cons: 2 * n_cons + n_inst] = zi
        c_ev[0: 2 * n_cons: 2] = c0
        c_ev[1: 2 * n_cons: 2] = w
        c_ev[2 * n_cons: 2 * n_cons + n_inst] = zisq
        zh_inv = pow(domain.vanishing_poly_at(domain.coset_shift), -1, p)
        try:
            # even SAP row check: A^2 - C = 4(Az.Bz - Cz)
            with span("hpoly"):
                h_limbs = _nat.hpoly(
                    p, domain.omega, domain.coset_shift, zh_inv,
                    a_ev, a_ev, c_ev,
                    check_rows=2 * n_cons if replayed else 0)
        except ValueError:
            raise SNARKError("unsatisfied constraint (replayed witness)")
        h = h_limbs[: domain.n - 1]
        futs = None
        if launch is not None:
            futs = launch.result()
            self._stream_launch_h(pk, futs, h)
        return z_ext, h, futs

    def _h_device(self, pk, rows3, z, n_inst, n_cons, domain, replayed):
        """The device quotient tier: z goes to the device once (K7 to
        Montgomery form), K6 evaluates A z, B z and C z, K7 builds the SAP
        evaluations and the extension w, z_i^2 of the assignment, which
        come back as canonical limbs for the a/b/c MSMs (enqueued from the
        background thread, as in the host tier), and hpoly runs the
        squaring quotient with b aliased to a (K5, K7), checking the even
        SAP rows of a replayed witness.  Returns (SAP-extended z limbs,
        h, stream futures or None): h (n - 1, 10) canonical limbs on the
        device when the h-query MSM streams, else host limbs."""
        import numpy as np

        from ... import native as _nat
        from ...ops.fft_tensor import fft_ctx, hpoly
        from ...ops.field import limbs_host, upload_limbs
        from ...ops.matvec_tensor import device_matrices

        p, n = self.Fr.MODULUS, domain.n
        fctx = fft_ctx(self.Fr, n, self.device)
        f = fctx.f
        mats = device_matrices(pk, self.Fr, rows3, n_cons, len(z),
                               self.device)
        with span("z_marshal"):
            z_limbs = _nat.scalars_to_limbs(z)
        with span("matvec"):
            z_mont = f.to_mont(upload_limbs(z_limbs, self.device))
            az, bz, cz = (m.apply(z_mont) for m in mats)
        with span("sap_evals"):
            a_ev, c_ev, ext = f.sap(az, bz, cz, z_mont[:n_inst], n)
            z_ext = np.concatenate([z_limbs, limbs_host(f.from_mont(ext))])
        launch = self._stream_launch_bg(pk, z_ext, n_inst)
        zh_inv = pow(domain.vanishing_poly_at(domain.coset_shift), -1, p)
        try:
            # even SAP row check: A^2 - C = 4(Az.Bz - Cz)
            with span("hpoly"):
                h = hpoly(fctx, a_ev, a_ev, c_ev, zh_inv,
                          2 * n_cons if replayed else 0)[: n - 1]
        except ValueError:
            raise SNARKError("unsatisfied constraint (replayed witness)")
        if launch is None:
            return z_ext, limbs_host(h), None
        futs = launch.result()
        self._stream_launch_h(pk, futs, h)
        return z_ext, h, futs

    def _h_python(self, rows3, z, n_inst, n_cons, domain, replayed):
        """Pure-Python path for circuits the C++ tier cannot take.
        Returns (SAP-extended z, h) as int lists."""
        p = self.Fr.MODULUS
        azs = [0] * n_cons
        bzs = [0] * n_cons
        czs = [0] * n_cons
        for j, (ra, rb, rc) in enumerate(rows3):
            azs[j] = sum(co * z[col] for col, co in ra.items()) % p
            bzs[j] = sum(co * z[col] for col, co in rb.items()) % p
            czs[j] = sum(co * z[col] for col, co in rc.items()) % p
        if replayed:
            for j in range(n_cons):
                if (azs[j] * bzs[j] - czs[j]) % p:
                    raise SNARKError(
                        f"unsatisfied constraint #{j} (replayed)")
        a_ev = [0] * domain.n
        c_ev = [0] * domain.n
        for j in range(n_cons):
            wj = (azs[j] - bzs[j]) ** 2 % p
            a_ev[2 * j] = (azs[j] + bzs[j]) % p
            a_ev[2 * j + 1] = (azs[j] - bzs[j]) % p
            c_ev[2 * j] = (4 * czs[j] + wj) % p
            c_ev[2 * j + 1] = wj
        for i in range(n_inst):
            a_ev[2 * n_cons + i] = z[i]
            c_ev[2 * n_cons + i] = z[i] * z[i] % p
        # SAP extension of the assignment
        z = z + [(azs[j] - bzs[j]) ** 2 % p for j in range(n_cons)] \
            + [z[i] * z[i] % p for i in range(n_inst)]
        a_cos = domain.coset_fft(domain.ifft(a_ev))
        c_cos = domain.coset_fft(domain.ifft(c_ev))
        zh_inv = pow(domain.vanishing_poly_at(domain.coset_shift), -1, p)
        h_cos = [(a_cos[i] * a_cos[i] - c_cos[i]) % p * zh_inv % p
                 for i in range(domain.n)]
        return z, domain.coset_ifft(h_cos)[: domain.n - 1]

    def _prove_commit(self, pk, n_inst, z, h, r, futs):
        from ..msm_dispatch import host_query, msm_any, stream_collect

        p = self.Fr.MODULUS
        if len(pk.a_query) >= self.STREAM_MIN and (
                self.device.type == "cuda" or futs is not None):
            missing = [nm for nm in self.STREAMED
                       if futs is None or nm not in futs]
            if missing:
                raise RuntimeError("commitment MSMs missing from the "
                                   "stream tier: " + ", ".join(missing))

        def msm_q(nm, scalars):
            if futs is not None and nm in futs:
                with span("msm_" + nm + "_dev"):
                    return stream_collect(futs[nm])
            with span("msm_" + nm):
                return msm_any(host_query(pk, nm), scalars)

        a_part = msm_q("a_query", z)  # G^{a(s)}
        g_a = pk.vk.alpha_g1 + a_part + pk.delta_g1 * r
        g_b = pk.vk.alpha_g2 + msm_q("b_query", z) + pk.delta_g2 * r

        # C = sum_wit z_i (2 alpha a_i + c_i)/delta + h Z/delta
        #     + r * (2 alpha + 2 a(s)) + r^2 delta
        c_acc = msm_q("c_query", z[n_inst:])
        c_acc = c_acc + msm_q("h_query", h)
        c_acc = c_acc + (pk.vk.alpha_g1 * (2 * r % p)) \
            + (a_part * (2 * r % p)) + (pk.delta_g1 * (r * r % p))
        return GM17Proof(a=g_a, b=g_b, c=c_acc)

    # -- verify ----------------------------------------------------------
    def process_vk(self, vk: GM17VK) -> GM17PVK:
        return GM17PVK(vk=vk,
                       alpha_alpha=self.pairing.pairing(vk.alpha_g1,
                                                        vk.alpha_g2))

    def verify_with_processed_vk(self, pvk: GM17PVK, public_input,
                                 proof) -> bool:
        vk = pvk.vk
        xs = [1] + [int(x.n if hasattr(x, "n") else x) for x in public_input]
        if len(xs) != len(vk.query):
            raise SNARKError("input length mismatch")
        psi = self.msm(vk.query, xs)
        eq1 = self.pairing.multi_pairing([
            (proof.a, proof.b),
            (-psi, vk.gamma_g2),
            (-proof.c, vk.delta_g2),
        ]) == pvk.alpha_alpha
        eq2 = self.pairing.multi_pairing([
            (proof.a, vk.gamma_g2),
            (-vk.gamma_g1, proof.b),
        ]).is_one()
        return eq1 and eq2

    def verify(self, vk: GM17VK, public_input, proof) -> bool:
        return self.verify_with_processed_vk(self.process_vk(vk),
                                             public_input, proof)
