"""Groth16 native prover/verifier of the port: a copy of
`pcd_tpu/snark/groth16/native.py` (which replaces ark-groth16, reference
Cargo.toml:39; used as MainSNARK/HelpSNARK in tests/mnt4_groth16.rs:26-29)
without its legacy device tier (device h-poly, DevicePointVec queries).
Its setup's query vectors go through msm_dispatch.fb_mul, on the tier
msm_dispatch.KEYGEN names: K8 on `device`'s card, or the C++ fixed-base
(the reference's `_fb_mul` and its host keygen).

Standard Groth16 over the QAP of the R1CS:
  - domain H of size >= num_constraints + num_instance; the instance
    variables get "input consistency" rows (A[nc+i][i]=1) so their
    A-polynomials are independent (libsnark/arkworks convention)
  - setup evaluates u_i/v_i/w_i at tau via Lagrange coefficients (no FFT)
  - prove computes h = (A B - C)/Z_H on a coset and commits via MSMs
  - proofs are randomized (r, s)

The quotient runs on the tier msm_dispatch.QUOTIENT names: "host", the
C++ CSR matvec and fused quotient pipeline, or "device", the reference's
device tier (its `_use_device` branch of `prove`) on `device`: the sparse
matvec (ops/matvec_tensor.py), the replay check and the coset pipeline
(ops/fft_tensor.py).  Meanwhile the commitment MSMs of circuits with at
least STREAM_MIN variables go to the stream MSM (ops/msm_stream.py) on
`device`: the CUDA kernels on a card, their plain versions on the CPU.

A parallel.dist.DistContext assigned to `.dist` (the reference's seam,
its groth16/native.py:78-83) shards the prove over the ranks of its mesh,
every rank running the same prove: the five commitment MSMs go through
the sharded stream MSM, and the device quotient through the sharded
matvec and quotient (parallel/dist.py), whose h never leaves the rank:
the h-query MSM takes each rank's h-query rows in the layout of its h
block.  Every rank ends with the same proof.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...curves import jacobian
from ...msm.host import msm as host_msm
from ...poly.domain import EvaluationDomain
from ...r1cs.system import ConstraintSystem
from ...utils.profiling import in_request, span
from ..api import SNARKError


@dataclass
class Groth16Proof:
    a: object  # G1
    b: object  # G2
    c: object  # G1

    def clone(self):
        return Groth16Proof(self.a, self.b, self.c)


@dataclass
class Groth16VK:
    alpha_g1: object
    beta_g2: object
    gamma_g2: object
    delta_g2: object
    gamma_abc: list  # G1, length num_instance


@dataclass
class Groth16PVK:
    vk: Groth16VK
    alpha_beta: object  # e(alpha, beta) in Fq^k


@dataclass
class Groth16PK:
    vk: Groth16VK
    beta_g1: object
    delta_g1: object
    a_query: list     # u_i(tau) G1 per variable
    b_g1_query: list  # v_i(tau) G1
    b_g2_query: list  # v_i(tau) G2
    h_query: list     # tau^i Z(tau)/delta G1,  i < n-1
    l_query: list     # (beta u_i + alpha v_i + w_i)/delta G1, witness vars
    num_instance: int
    domain_size: int


class Groth16:
    def __init__(self, curve_cfg, device=None):
        """curve_cfg: MNTCurveConfig — G1/G2/Fr and the pairing.
        device: where the stream MSM runs the commitment MSMs of circuits
        from STREAM_MIN variables up (None means the card)."""
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
        self.dist = None

    def _h_poly(self, domain, a_ev, b_ev, c_ev):
        """h = (A B - C)/Z_H on a coset (pure-Python host pipeline)."""
        p = self.Fr.MODULUS
        a_cos = domain.coset_fft(domain.ifft(a_ev))
        b_cos = domain.coset_fft(domain.ifft(b_ev))
        c_cos = domain.coset_fft(domain.ifft(c_ev))
        zh_inv = pow(domain.vanishing_poly_at(domain.coset_shift), -1, p)
        h_cos = [(a_cos[i] * b_cos[i] - c_cos[i]) % p * zh_inv % p
                 for i in range(domain.n)]
        return domain.coset_ifft(h_cos)

    # -- stream-MSM offload -----------------------------------------------
    # The host tier and the device are independent execution units; the
    # prove's five commitment MSMs are independent given (z, h).  The
    # a/b1/b2/l query MSMs (b2 in G2 through the Fp2/Fp3 kernels) are
    # enqueued on the device from a background thread as soon as z is
    # known, while the host C++ tier runs the matvec and the quotient
    # pipeline; the h MSM follows once the quotient lands, and the small
    # window sums are fetched and Horner-combined after.  On a card the
    # schedules read the scalars on a schedule stream that waits only for
    # their producer, and K1 and K4 run on one side stream; every future
    # carries the CUDA event recorded after its work, and the collect waits
    # on that event.  Once
    # a circuit is streamed, all five MSMs are: a missing one raises
    # rather than running on the host.
    STREAM_MIN = 24_000
    STREAMED = ("a_query", "b_g1_query", "b_g2_query", "l_query", "h_query")

    def _stream_launch(self, pk, z_limbs, n_inst):
        """Enqueue the a/b1/b2/l MSMs on the stream tier; returns {name:
        future}, or None for a circuit below STREAM_MIN."""
        from ..msm_dispatch import side_stream, stream_launch, zpad_query

        if z_limbs is None or len(pk.a_query) < self.STREAM_MIN:
            return None
        # l_query is the z vector offset by the instance columns; padded,
        # all four z-driven MSMs (a/b1/b2/l) share one schedule and one
        # schedule upload
        g1, g2 = self.cfg.g1, self.cfg.g2
        l_nm = zpad_query(pk, "l_query", n_inst, g1)
        queries = (("a_query", g1), ("b_g1_query", g1), ("b_g2_query", g2),
                   (l_nm, g1))
        with side_stream(self, self.device) as sched:
            if self.dist is not None:
                futs = self.dist.stream_launch(pk, queries, self.Fr.BITS,
                                               z_limbs, sched)
            else:
                futs = stream_launch(pk, queries, g1, self.Fr.BITS, z_limbs,
                                     self.device, sched)
        futs["l_query"] = futs.pop(l_nm)
        return futs

    def _stream_launch_bg(self, pk, z_limbs, n_inst):
        """_stream_launch from a background thread, in this thread's
        profiling request: returns its future."""
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(in_request(self._stream_launch), pk, z_limbs, n_inst)
        ex.shutdown(wait=False)
        return fut

    def _stream_launch_h(self, pk, futs, h_limbs):
        """Enqueue the h-query MSM once the quotient limbs land (host
        limbs, or the device quotient's tensor, which the side stream
        reads after the quotient's stream has computed it, or under
        `.dist` a rank's SigmaH block)."""
        import torch

        from ...parallel.dist import SigmaH
        from ..msm_dispatch import side_stream, stream_msm_async

        if futs is None:
            return False
        t = h_limbs.limbs if isinstance(h_limbs, SigmaH) else h_limbs
        reads = (t,) if isinstance(t, torch.Tensor) else ()
        with side_stream(self, self.device, reads) as sched, \
                span("stream_dispatch_h"):
            if self.dist is not None:
                futs["h_query"] = self.dist.stream_msm_async(
                    pk, "h_query", self.cfg.g1, self.Fr.BITS, h_limbs,
                    sched_stream=sched)
            else:
                futs["h_query"] = stream_msm_async(
                    pk, "h_query", self.cfg.g1, self.Fr.BITS, h_limbs,
                    self.device, sched_stream=sched)
        return True

    def _stream_collect(self, futs, nm):
        """Wait for one dispatched MSM and Horner-combine on the host
        (under `.dist`: after the all-gather of every rank's window
        sums)."""
        from ..msm_dispatch import stream_collect

        if self.dist is not None:
            return self.dist.stream_collect(futs[nm])
        return stream_collect(futs[nm])

    # ------------------------------------------------------------------
    def _synthesize(self, circuit) -> ConstraintSystem:
        cs = ConstraintSystem(self.Fr)
        circuit.generate_constraints(cs)
        return cs

    @staticmethod
    def _matrix_rows(cs: ConstraintSystem):
        """Constraint rows + input-consistency rows, as sparse lc dicts in
        *column* index space (0..num_vars)."""
        n_inst = cs.num_instance
        rows = []
        for (a, b, c) in cs.constraints:
            def remap(lc):
                return {(n_inst + (-v - 1) if v < 0 else v): co % cs.p
                        for v, co in lc.items()}
            rows.append((remap(a), remap(b), remap(c)))
        for i in range(n_inst):
            rows.append(({i: 1}, {}, {}))
        return rows

    # ------------------------------------------------------------------
    def circuit_specific_setup(self, circuit, rng):
        cs = self._synthesize(circuit)
        p = self.Fr.MODULUS
        rows = self._matrix_rows(cs)
        num_vars = cs.num_instance + cs.num_witness
        n_inst = cs.num_instance
        domain = EvaluationDomain.new(self.Fr, len(rows))

        tau = rng.randrange(1, p)
        alpha = rng.randrange(1, p)
        beta = rng.randrange(1, p)
        gamma = rng.randrange(1, p)
        delta = rng.randrange(1, p)

        lag = domain.lagrange_coeffs_at(tau)
        u = [0] * num_vars
        v = [0] * num_vars
        w = [0] * num_vars
        for j, (ra, rb, rc) in enumerate(rows):
            lj = lag[j]
            if lj == 0:
                continue
            for col, co in ra.items():
                u[col] = (u[col] + co * lj) % p
            for col, co in rb.items():
                v[col] = (v[col] + co * lj) % p
            for col, co in rc.items():
                w[col] = (w[col] + co * lj) % p

        zt = domain.vanishing_poly_at(tau)
        gamma_inv = pow(gamma, -1, p)
        delta_inv = pow(delta, -1, p)

        h_scalars = []
        cur = zt * delta_inv % p
        for _ in range(domain.n - 1):
            h_scalars.append(cur)
            cur = cur * tau % p

        from ...msm.host import fixed_base_many
        from ..msm_dispatch import fb_mul

        # the query vectors through fb_mul (KEYGEN's tier: K8 on the card,
        # or the C++ fixed-base); the instance-sized gamma_abc and the
        # three-scalar key elements, always under KEYGEN_MIN, stay on the
        # host's fixed_base_many
        cfg, dev = self.cfg, self.device
        g1g, g2g, bits = cfg.g1_gen, cfg.g2_gen, self.Fr.BITS
        gamma_abc = fixed_base_many(
            g1g, [(beta * u[i] + alpha * v[i] + w[i]) % p
                  * gamma_inv % p for i in range(n_inst)], bits)
        l_query = fb_mul(
            cfg, "g1", [(beta * u[i] + alpha * v[i] + w[i]) % p
                        * delta_inv % p for i in range(n_inst, num_vars)],
            bits, dev)
        a_query = fb_mul(cfg, "g1", u, bits, dev)
        b_g1_query = fb_mul(cfg, "g1", v, bits, dev)
        b_g2_query = fb_mul(cfg, "g2", v, bits, dev)
        h_query = fb_mul(cfg, "g1", h_scalars, bits, dev)
        alpha_g1, beta_g1, delta_g1 = fixed_base_many(
            g1g, [alpha, beta, delta], bits)
        beta_g2, gamma_g2, delta_g2 = fixed_base_many(
            g2g, [beta, gamma, delta], bits)


        vk = Groth16VK(
            alpha_g1=alpha_g1,
            beta_g2=beta_g2,
            gamma_g2=gamma_g2,
            delta_g2=delta_g2,
            gamma_abc=gamma_abc,
        )
        pk = Groth16PK(
            vk=vk,
            beta_g1=beta_g1,
            delta_g1=delta_g1,
            a_query=a_query,
            b_g1_query=b_g1_query,
            b_g2_query=b_g2_query,
            h_query=h_query,
            l_query=l_query,
            num_instance=n_inst,
            domain_size=domain.n,
        )
        return pk, vk

    # ------------------------------------------------------------------
    def prove(self, pk: Groth16PK, circuit, rng):
        from ..plan import plan_for

        with span("groth16/witness"):
            z, cs, plan = plan_for(pk, lambda: ConstraintSystem(self.Fr),
                                   circuit)
        p = self.Fr.MODULUS
        num_vars = len(z)
        if num_vars != len(pk.a_query):
            raise SNARKError(
                f"circuit shape mismatch: {num_vars} vars vs pk {len(pk.a_query)}")
        if cs is not None:
            bad = cs.first_unsatisfied()
            if bad is not None:
                raise SNARKError(
                    f"unsatisfied constraint {cs.which_is_unsatisfied()}")
            rows = self._matrix_rows(cs)
            n_inst = cs.num_instance
            n_cons = cs.num_constraints
            if plan is not None:
                plan.rows = rows
        else:
            rows = plan.rows
            n_inst = plan.n_inst
            n_cons = plan.n_constraints
        replayed = cs is None

        domain = EvaluationDomain(self.Fr, pk.domain_size)

        # h(x) = (A(x) B(x) - C(x)) / Z_H(x) via coset evaluation
        z_limbs = None
        hybrid = None
        with span("groth16/h_poly"):
            from ... import native as _nat
            from ..msm_dispatch import quotient_tier

            if quotient_tier() == "device":
                z_limbs, hybrid, h = self._h_device(
                    pk, rows, z, n_inst, n_cons if replayed else 0, domain)
            elif _nat.available() and p.bit_length() <= 320:
                # limb fast path: z is marshalled ONCE; the CSR
                # matvec, the fused quotient pipeline (7 NTTs +
                # pointwise in one native call) and the MSM scalars
                # all consume limbs — no Python-int round-trips
                mats = getattr(pk, "_host_mats", None)
                if mats is None:
                    with span("csr_build"):
                        mats = _nat.SpMatrices(p, rows, domain.n)
                    pk._host_mats = mats
                with span("z_marshal"):
                    z_limbs = _nat.scalars_to_limbs(z)
                # enqueue the query MSMs on the device NOW — they only
                # need z — from a background thread, while the host
                # (pure C++, GIL released) runs matvec + the quotient
                # pipeline below
                hybrid = self._stream_launch_bg(pk, z_limbs, n_inst)
                with span("matvec"):
                    a_l, b_l, c_l = mats.apply_all_limbs(z_limbs)
                zh_inv = pow(
                    domain.vanishing_poly_at(domain.coset_shift),
                    -1, p)
                try:
                    with span("hpoly"):
                        h_limbs = _nat.hpoly(
                            p, domain.omega, domain.coset_shift, zh_inv,
                            a_l, b_l, c_l,
                            check_rows=n_cons if replayed else 0)
                except ValueError:
                    raise SNARKError(
                        "unsatisfied constraint (replayed witness)")
                h = h_limbs[: domain.n - 1]
            else:
                a_ev = [0] * domain.n
                b_ev = [0] * domain.n
                c_ev = [0] * domain.n
                for j, (ra, rb, rc) in enumerate(rows):
                    a_ev[j] = sum(co * z[col]
                                  for col, co in ra.items()) % p
                    b_ev[j] = sum(co * z[col]
                                  for col, co in rb.items()) % p
                    c_ev[j] = sum(co * z[col]
                                  for col, co in rc.items()) % p
                if replayed:
                    for j in range(n_cons):
                        if (a_ev[j] * b_ev[j] - c_ev[j]) % p:
                            raise SNARKError(
                                f"unsatisfied constraint #{j} (replayed)")
                h = self._h_poly(domain, a_ev, b_ev, c_ev)
                h = h[: domain.n - 1]

        r = rng.randrange(p)
        s = rng.randrange(p)

        with span("groth16/msm"):
            return self._prove_commit(pk, n_inst, z, h, r, s,
                                      z_limbs=z_limbs, hybrid=hybrid)

    def _h_device(self, pk, rows, z, n_inst, check_rows, domain):
        """The device quotient tier: z goes to the device once (K7 to
        Montgomery form), K6 evaluates A z, B z and C z into one (3, n, 10)
        tensor, and hpoly checks rows [:check_rows] (the replayed witness)
        and runs the coset pipeline (K5, K7).  The a/b1/b2/l MSMs are
        enqueued from the background thread as soon as z is known, on the
        side stream.  Returns (z limbs, that future, h): h the (n - 1, 10)
        canonical limbs on the device, which the h-query MSM reads there."""
        import torch

        from ... import native as _nat
        from ...ops.fft_tensor import fft_ctx, hpoly
        from ...ops.field import NLIMB, upload_limbs
        from ...ops.matvec_tensor import device_matrices

        p, n = self.Fr.MODULUS, domain.n
        dh = None
        if self.dist is not None:
            dh = self.dist.h_poly(self.Fr, n)
            if dh is None:
                # no (n1, n2) split of n for this size: every rank runs the
                # unsharded quotient, as the reference does
                self.dist.unsharded.append((self.Fr.NAME, n))
        if dh is not None:
            with span("h_dist"):
                return self._h_dist(pk, dh, rows, z, n_inst, check_rows)
        fctx = fft_ctx(self.Fr, n, self.device)
        mats = device_matrices(pk, self.Fr, rows, n, len(z), self.device)
        with span("z_marshal"):
            z_limbs = _nat.scalars_to_limbs(z)
        hybrid = self._stream_launch_bg(pk, z_limbs, n_inst)
        with span("matvec"):
            z_mont = fctx.f.to_mont(upload_limbs(z_limbs, self.device))
            evs = torch.empty((3, n, NLIMB), dtype=torch.int32,
                              device=self.device)
            for k, m in enumerate(mats):
                m.apply(z_mont, out=evs[k])
        zh_inv = pow(domain.vanishing_poly_at(domain.coset_shift), -1, p)
        try:
            with span("hpoly_unsharded" if self.dist is not None
                      else "hpoly"):
                h = hpoly(fctx, evs[0], evs[1], evs[2], zh_inv, check_rows)
        except ValueError:
            raise SNARKError("unsatisfied constraint (replayed witness)")
        return z_limbs, hybrid, h[: n - 1]

    def _h_dist(self, pk, dh, rows, z, n_inst, check_rows):
        """_h_device sharded over `.dist`'s mesh: K6 over the rows of this
        rank's natural block (parallel/dist.py), the replayed-witness
        check with every rank's flag (all ranks raise together), and the
        sharded quotient.  h is this rank's sigma block, a SigmaH."""
        from ... import native as _nat
        from ...ops.field import upload_limbs
        from ...parallel.dist import SigmaH

        n = dh.N
        mv = self.dist.prover_matvec(pk, self.Fr, rows, n, len(z), dh)
        with span("z_marshal"):
            z_limbs = _nat.scalars_to_limbs(z)
        hybrid = self._stream_launch_bg(pk, z_limbs, n_inst)
        with span("matvec"):
            z_mont = dh.f.to_mont(upload_limbs(z_limbs, dh.mesh.device))
            evs = mv.apply_all(z_mont)
        try:
            if check_rows:
                mv.check(evs, check_rows)
        except ValueError:
            raise SNARKError("unsatisfied constraint (replayed witness)")
        with span("hpoly"):
            h = dh.h_block(evs)
        return z_limbs, hybrid, SigmaH(h, dh)

    def _prove_commit(self, pk, n_inst, z, h, r, s, z_limbs=None,
                      hybrid=None):
        from ..msm_dispatch import host_query, msm_any

        p = self.Fr.MODULUS
        # pre-marshalled limbs shared by the a/b1/b2/l MSMs
        zq = z if z_limbs is None else z_limbs

        def msm_q(name, scalars, spn):
            if hybrid is not None and name in hybrid:
                with span(spn + "_dev"):
                    return self._stream_collect(hybrid, name)
            with span(spn):
                return msm_any(host_query(pk, name), scalars)

        import numpy as np
        import torch

        from ...ops.field import limbs_host
        from ...parallel.dist import SigmaH

        if hybrid is not None and not isinstance(hybrid, dict):
            # background-thread launch (see prove): resolve it here —
            # matvec + hpoly have run under it
            hybrid = hybrid.result()

        # The h-query MSM joins the device queue as soon as the quotient
        # limbs land; the collects below then block only on whatever the
        # device hasn't finished.
        h_streamed = (isinstance(h, (np.ndarray, torch.Tensor, SigmaH))
                      and self._stream_launch_h(pk, hybrid, h))
        if isinstance(h, SigmaH) and not h_streamed:
            # a sharded h meeting the host MSM: every rank takes all of it
            h = h.dh.gather(h.limbs)[: pk.domain_size - 1]
        if isinstance(h, torch.Tensor) and not h_streamed:
            h = limbs_host(h)
        if len(pk.a_query) >= self.STREAM_MIN and (
                self.device.type == "cuda" or hybrid is not None):
            missing = [nm for nm in self.STREAMED
                       if hybrid is None or nm not in hybrid]
            if missing:
                raise RuntimeError("commitment MSMs missing from the "
                                   "stream tier: " + ", ".join(missing))

        # the key's fixed points times r and s need no MSM: they are taken
        # while the card works through the queued MSMs
        mul = jacobian.mul
        with span("proof_fixed"):
            d1r, d1s = mul(pk.delta_g1, r), mul(pk.delta_g1, s)
            d1rs = mul(pk.delta_g1, r * s % p)
            d2s = mul(pk.vk.delta_g2, s)

        # collected in the card's order, so that each Horner tail runs
        # while the card works on the next MSM
        ma = msm_q("a_query", zq, "msm_a")
        mb1 = msm_q("b_g1_query", zq, "msm_b1")
        mb2 = msm_q("b_g2_query", zq, "msm_b2")
        ml = msm_q("l_query", zq[n_inst:], "msm_l")
        from ...native import EncodedPoints

        mh = None
        if h_streamed:
            with span("msm_h_dev"):
                mh = self._stream_collect(hybrid, "h_query")
        else:
            hq = host_query(pk, "h_query")
            if isinstance(hq, EncodedPoints):
                with span("msm_h"):
                    mh = msm_any(hq, h)
            else:
                if isinstance(h, np.ndarray):
                    from ...native import limbs_to_ints

                    h = limbs_to_ints(h)
                nz = [(pt, co) for pt, co in zip(hq, h) if co]
                if nz:
                    with span("msm_h"):
                        mh = self.msm([a for a, _ in nz],
                                      [b for _, b in nz])

        with span("proof_assemble"):
            g_a = pk.vk.alpha_g1 + ma + d1r
            g_b2 = pk.vk.beta_g2 + mb2 + d2s
            g_b1 = pk.beta_g1 + mb1 + d1s
            c_acc = ml if mh is None else ml + mh
            g_c = c_acc + mul(g_a, s) + mul(g_b1, r) - d1rs

        return Groth16Proof(a=g_a, b=g_b2, c=g_c)

    # ------------------------------------------------------------------
    def process_vk(self, vk: Groth16VK) -> Groth16PVK:
        return Groth16PVK(vk=vk, alpha_beta=self.pairing.pairing(vk.alpha_g1, vk.beta_g2))

    def verify_with_processed_vk(self, pvk: Groth16PVK, public_input, proof) -> bool:
        vk = pvk.vk
        xs = [1] + [int(x.n if hasattr(x, "n") else x) for x in public_input]
        if len(xs) != len(vk.gamma_abc):
            raise SNARKError(
                f"input length mismatch: {len(xs)} vs {len(vk.gamma_abc)}")
        acc = self.msm(vk.gamma_abc, xs)
        lhs = self.pairing.multi_pairing(
            [(proof.a, proof.b), (-acc, vk.gamma_g2), (-proof.c, vk.delta_g2)])
        return lhs == pvk.alpha_beta

    def verify(self, vk: Groth16VK, public_input, proof) -> bool:
        return self.verify_with_processed_vk(self.process_vk(vk), public_input, proof)
