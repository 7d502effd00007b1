#!/usr/bin/env python3
"""Drive pcd_tpu_torch on an NVIDIA card and hold its kernels to their
plain versions.  Run from the root of a checkout with one CUDA card:

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --phases 1,2   # a subset (1 must be among them)

Phases, one output line each, then a `kernels` JSON line and the final
status line:
  1  card and build: nvidia-smi's name and power limit; the C++ host tier
     (g++) and the CUDA kernels (one nvcc per source) built in parallel
     from the checkout, with ptxas' register and spill report;
  2  every kernel against its plain torch version on the card, for the
     four field forms of the main path (MNT4/MNT6 G1 over Fq, MNT4 G2 over
     Fq2, MNT6 G2 over Fq3): K1 on 25 windows x 8192 lanes, T = 8, with
     zero loads and infinity-flagged rows, K2 on 204800 pairs with P = Q,
     P = -Q and identities; exact equality of the limbs; CUDA-event times
     at these shapes;
  3  one 2^18-point MNT4 G1 stream MSM against the C++ Pippenger;
  4  the real-cycle mnt4_groth16 IVC chain on the card: setup, the base
     case, a warm step-2 prove, both verified, and the negative check
     (the old message against the newest proof must be rejected); every
     kernel instantiation must have launched on that path, K1 exactly
     once per commitment MSM; CUDA-event device time of every launch of
     the warm step;
  5  each kernel again on the inputs of its first launch in the warm step
     (K1: the a-query or b_g2 MSM; K2: the first suffix-scan step),
     exactly against its plain version, with CUDA-event times: these are
     the numbers of the `kernels` line.
Any failure exits non-zero without the final line.  Nothing here imports
JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM rates for the bounds (NVIDIA data sheet; 700 W):
HBM_BYTES_PER_S = 3.35e12
# INT32 multiply-add: 64 results/clock/SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput) x 132 SMs x 1.98 GHz boost.
INT32_MAD_PER_S = 64 * 132 * 1.98e9
# 32x32 -> 64-bit partial products per Fp^D Montgomery product, each two
# multiply-adds (low and high halves): CIOS for D = 1 (100 + 10 + 100);
# for D > 1 Karatsuba's D (D + 1) / 2 wide products of 100, the nr
# scalings of 10 limbs, and D word-by-word reductions of 110.
PRODUCTS = {1: 210, 2: 300 + 10 + 220, 3: 600 + 30 + 330}
MULS_MADD, MULS_ADD = 17, 18
# K1 launches per prove of one SNARK: a, b_g1, l and h in G1, b_g2 in G2
K1_PER_PROVE = {"g1": 4, "g2": 1}

REPLACES = {
    ("madd_accumulate", 1): "pcd_tpu/ops/ec32.py:721",
    ("madd_accumulate", 2): "pcd_tpu/ops/ec32.py:1319",
    ("madd_accumulate", 3): "pcd_tpu/ops/ec32.py:1319",
    ("complete_add", 1): "pcd_tpu/ops/ec32.py:502",
    ("complete_add", 2): "pcd_tpu/ops/ec32.py:1211",
    ("complete_add", 3): "pcd_tpu/ops/ec32.py:1211",
}
SOURCES = {"madd_accumulate": "pcd_tpu_torch/csrc/madd_accumulate.cu",
           "complete_add": "pcd_tpu_torch/csrc/complete_add.cu"}


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def raw_points(native, base, scalars, bits):
    """[s * base] through the C++ windowed fixed-base, as the EncodedPoints
    arrays (xs, ys, inf) without host point objects."""
    import numpy as np

    curve = base.curve
    h, deg, _ = native.curve_handle(curve)
    lib = native._load()
    NL = native.NL
    bxy = np.zeros(2 * deg * NL, dtype="<u8")
    for d, c in enumerate(native._coeffs(base.x, deg)):
        bxy[d * NL:(d + 1) * NL] = native.ints_to_limbs([c])[0]
    for d, c in enumerate(native._coeffs(base.y, deg)):
        bxy[(deg + d) * NL:(deg + d + 1) * NL] = native.ints_to_limbs([c])[0]
    n = len(scalars)
    sc = native.ints_to_limbs([int(s) for s in scalars])
    xs = np.zeros((n, deg * NL), dtype="<u8")
    ys = np.zeros((n, deg * NL), dtype="<u8")
    inf = np.zeros(n, dtype=np.uint8)
    rc = lib.pcd_fixed_base(h, native._u64p(bxy), bits, n, native._u64p(sc),
                            native._u64p(xs), native._u64p(ys),
                            native._u8p(inf))
    if rc != 0:
        raise RuntimeError("pcd_fixed_base failed")
    return xs, ys, inf.astype(bool)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def device_ms(fn, reps, dev, warm=True):
    """Mean time of fn: CUDA events on the card (host clock elsewhere,
    for rehearsals)."""
    import torch

    if warm:
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_build():
    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    t0 = time.perf_counter()
    got = {}
    th = threading.Thread(target=lambda: got.update(ok=native.available()))
    th.start()
    info = kernels.build()
    th.join()
    t_all = time.perf_counter() - t0
    if not got.get("ok"):
        raise RuntimeError("the C++ host tier failed to build")
    for name, rec in info.items():
        for line in rec["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Function properties")):
                say(1, f"{name}: {line.strip()}")
    say(1, "built C++ tier + " + ", ".join(
        f"{n} {rec['seconds']:.1f}s" for n, rec in info.items())
        + f" in {t_all:.1f}s wall")
    return card


def form_cases():
    from pcd_tpu_torch.curves import models as M

    cyc = M.mnt_cycle()
    return [("mnt4_298.G1", cyc.main, "g1"), ("mnt4_298.G2", cyc.main, "g2"),
            ("mnt6_298.G1", cyc.help, "g1"), ("mnt6_298.G2", cyc.help, "g2")]


def phase_kernels(dev="cuda", nwin=25, T=8, L=8192, m=4096):
    """K1 and K2 against their plain versions, all four forms, with the
    edge cases: K1 on the 25 windows x 8192 lanes of a 298-bit-scalar MSM
    (T = 8, the help circuit's rounds) with zero loads and flagged rows,
    K2 on the 25 x 8192 lanes of the finish's first scan with P = Q,
    P = -Q and identities."""
    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops.ec import ec_ctx

    dev = torch.device(dev)
    rng = np.random.default_rng(2026)
    for form, cfg, which in form_cases():
        curve, gen = getattr(cfg, which), getattr(cfg, which + "_gen")
        ec = ec_ctx(curve)
        D = ec.d
        xs, ys, inf = raw_points(native, gen, [int(s) for s in rng.integers(
            1, 1 << 62, m)], cfg.Fr.BITS)
        inf[rng.choice(m, 64, replace=False)] = True      # flagged rows
        table = torch.from_numpy(ec.table_from_u64(xs, ys, inf)).to(dev)
        perm = (rng.integers(0, m, (nwin, T, L), dtype=np.int64)
                | (rng.integers(0, 2, (nwin, T, L), dtype=np.int64) << 31))
        perm = torch.from_numpy(perm.astype(np.uint32).view(np.int32)).to(dev)
        loads_np = rng.integers(0, T + 1, (nwin, L)).astype(np.int32)
        loads_np[:, ::7] = 0                               # zero loads
        loads = torch.from_numpy(loads_np).to(dev)
        got = ec.madd_accumulate(table, perm, loads)
        want = ec.madd_accumulate_plain(table, perm, loads)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {form}: kernel != plain")
        ms = device_ms(lambda: ec.madd_accumulate(table, perm, loads), 5, dev)
        say(2, f"K1 madd_accumulate {form}: exact on {nwin}x{L} lanes, "
               f"T={T}; {ms:.3f} ms")
        # K2 on pairs built from K1's projective outputs
        P = got.reshape(-1, 3, D, 10)
        n = P.shape[0]
        Q = P[torch.randperm(n, device=dev)].clone()
        k = n // 16
        Q[:k] = P[:k]                                      # P = Q
        negY = ec.f.from_plain(ec.f.neg(ec.f.to_plain(P[k:2 * k, 1])))
        Q[k:2 * k] = P[k:2 * k]
        Q[k:2 * k, 1] = negY                               # P = -Q
        Q[2 * k:3 * k] = ec.identity((k,), dev)            # Q = O
        P = P.clone()
        P[3 * k:4 * k] = ec.identity((k,), dev)            # P = O
        got2 = ec.add(P, Q)
        if not torch.equal(got2, ec.complete_add_plain(P, Q)):
            raise AssertionError(f"K2 {form}: kernel != plain")
        # P = -Q must give the identity (Z = 0)
        if bool(got2[k:2 * k, 2].any()):
            raise AssertionError(f"K2 {form}: P + (-P) is not the identity")
        ms = device_ms(lambda: ec.add(P, Q), 10, dev)
        say(2, f"K2 complete_add {form}: exact on {n} pairs; {ms:.3f} ms")


def record(kernel, form, D, err, ms, plain_ms, nbytes, mads):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mads / INT32_MAD_PER_S * 1e3
    return {"name": f"{kernel}[{form}]", "route": "cuda",
            "source": SOURCES[kernel], "replaces": REPLACES[(kernel, D)],
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}


def phase_msm(dev="cuda", log_n=18):
    """2^18 MNT4 G1 stream MSM against the C++ Pippenger."""
    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx

    dev = torch.device(dev)
    cfg = M.mnt_cycle().main
    n = 1 << log_n
    rng = np.random.default_rng(18)
    r = cfg.Fr.MODULUS
    t0 = time.perf_counter()
    xs, ys, inf = raw_points(native, cfg.g1_gen, [int(s) for s in
                                                  rng.integers(1, 1 << 62, n)],
                             cfg.Fr.BITS)
    scal = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
    limbs = native.ints_to_limbs(scal)
    enc = object.__new__(native.EncodedPoints)
    enc.curve = cfg.g1
    enc.handle, enc.deg, _ = native.curve_handle(cfg.g1)
    enc.xs, enc.ys, enc.inf, enc.n = xs, ys, inf.astype(np.uint8), n
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = native.msm(enc, limbs)
    t_host = time.perf_counter() - t0
    sctx = StreamMSMCtx(cfg.g1, cfg.Fr.BITS)
    table = sctx.table_from_limbs(xs, ys, inf, dev)
    got = sctx.msm_limbs(table, limbs)             # warm-up + correctness
    t0 = time.perf_counter()
    sched = sctx.schedule_native(limbs)
    t_sched = time.perf_counter() - t0
    sync(dev)
    t0 = time.perf_counter()
    ws = sctx.collect(*sctx.window_sums_async(table, sched))
    t_dev = time.perf_counter() - t0
    got2 = sctx.horner_host(ws)
    if not (got == want and got2 == want):
        raise AssertionError(f"2^{log_n} stream MSM != C++ Pippenger")
    say(3, f"2^{log_n} MNT4 G1 stream MSM == C++ Pippenger; schedule "
           f"{t_sched:.3f}s + device {t_dev:.3f}s vs C++ {t_host:.3f}s "
           f"(points built in {t_gen:.1f}s)")


class LaunchProbe:
    """While `on`, wraps the two kernel wrappers of ops/ec.py: the first
    call per (kernel, curve) keeps its inputs, and every call on the card
    gets CUDA events around it on the caller's current stream (the MSM
    side stream in the prover's background thread).  The wrappers' launch
    counters are untouched; leaving the `with` restores the wrappers."""

    def __init__(self):
        self.on = False
        self.first = {}      # (kernel, curve name) -> (ECCtx, args)
        self.events = []     # ((kernel, curve name), start, end)

    def __enter__(self):
        import torch

        from pcd_tpu_torch.ops.ec import ECCtx

        self._orig = (ECCtx.madd_accumulate, ECCtx.add)

        def wrap(kernel, fn):
            def probed(ctx, *args):
                if not self.on:
                    return fn(ctx, *args)
                key = (kernel, ctx.name)
                self.first.setdefault(key, (ctx, args))
                if args[0].device.type != "cuda":
                    return fn(ctx, *args)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(ctx, *args)
                b.record()
                self.events.append((key, a, b))
                return out
            return probed

        ECCtx.madd_accumulate = wrap("madd_accumulate", self._orig[0])
        ECCtx.add = wrap("complete_add", self._orig[1])
        return self

    def __exit__(self, *exc):
        from pcd_tpu_torch.ops.ec import ECCtx

        ECCtx.madd_accumulate, ECCtx.add = self._orig

    def device_ms(self):
        """{(kernel, curve name): summed CUDA-event ms of its launches}."""
        import torch

        if self.events:
            torch.cuda.synchronize()
        out = {}
        for key, a, b in self.events:
            out[key] = out.get(key, 0.0) + a.elapsed_time(b)
        return out


def phase_chain(factory=None, dev=None):
    """The real-cycle mnt4_groth16 chain on the card.  Returns the launch
    counts of the main path (base case + warm step) and the probe of the
    warm step."""
    from pcd_tpu_torch import configs
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.pcd.api import FpPredicate
    from pcd_tpu_torch.utils import profiling
    from pcd_tpu_torch.utils.rng import ChaChaRng

    class Counter(FpPredicate):
        PRIOR_MSG_LEN = 1

        def generate_constraints(self, cs, msg, wit, priors, base):
            (priors[0] + wit).enforce_equal(msg)

    secs = {}
    t0 = time.perf_counter()
    pcd = (factory or configs.mnt4_groth16)(dev)   # None: the card
    dev = pcd.ic.main_snark.device
    # on the CPU (a rehearsal) the wrappers count plain-version calls
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    F = pcd.ic.main_field
    pred = Counter(F)
    rng = ChaChaRng(b"chip smoke mnt4_groth16")
    pk, vk = pcd.circuit_specific_setup(pred, rng)
    secs["setup"] = time.perf_counter() - t0
    one, two = F.from_int(1), F.from_int(2)
    ec.reset_launch_counts()                       # the main path starts
    t0 = time.perf_counter()
    proof_1 = pcd.prove(pk, pred, one, one, [], [], rng)
    sync(dev)
    secs["prove_base"] = time.perf_counter() - t0
    base_counts = counter()
    profiling.reset()
    profiling.enable()
    with LaunchProbe() as probe:
        probe.on = True
        t0 = time.perf_counter()
        proof_2 = pcd.prove(pk, pred, two, one, [one], [proof_1], rng)
        sync(dev)
        secs["prove_step2_warm"] = time.perf_counter() - t0
        probe.on = False
    profiling.enable(False)
    spans = {k: round(v[0], 3) for k, v in profiling.totals().items()
             if v[0] >= 0.05}
    counts = counter()                             # the main path ended
    step2 = {k: v - base_counts.get(k, 0) for k, v in counts.items()}
    t0 = time.perf_counter()
    ok1 = pcd.verify(vk, pred, one, proof_1)
    ok2 = pcd.verify(vk, pred, two, proof_2)
    secs["verify_both"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    neg = pcd.verify(vk, pred, one, proof_2)
    secs["negative_check"] = time.perf_counter() - t0
    if not (ok1 and ok2):
        raise AssertionError(f"chain proofs do not verify ({ok1}, {ok2})")
    if neg:
        raise AssertionError("negative check accepted an old message")
    sizes = (len(pk.main_pk.a_query), len(pk.help_pk.a_query))
    say(4, f"{pcd.ic.cycle.name} Groth16 chain on {dev}: "
           + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
           + f"; base and step 2 verify, negative check rejects; "
             f"z sizes main {sizes[0]} help {sizes[1]}")
    say(4, "warm step spans (s): " + json.dumps(spans))
    say(4, "launches (base + step 2): " + json.dumps(
        {f"{k}[{f}]": v for (k, f), v in sorted(counts.items())}))
    say(4, "launches per warm step: " + json.dumps(
        {f"{k}[{f}]": v for (k, f), v in sorted(step2.items())}))
    dms = probe.device_ms()
    say(4, "kernel device ms per warm step (CUDA events): " + json.dumps(
        {f"{k}[{f}]": round(v, 3) for (k, f), v in sorted(dms.items())})
        + f"; all kernels {sum(dms.values()):.1f} ms of the "
          f"{secs['prove_step2_warm'] * 1e3:.0f} ms step")
    cyc = pcd.ic.cycle
    forms = [(c.name, grp) for cfg in (cyc.main, cyc.help)
             for grp, c in (("g1", cfg.g1), ("g2", cfg.g2))]
    missing = [f"{k}[{f}]" for k in ("madd_accumulate", "complete_add")
               for f, _ in forms if counts.get((k, f), 0) <= 0]
    if missing:
        raise AssertionError("kernels not launched on the main path: "
                             + ", ".join(missing))
    # every commitment MSM of both proves ran K1 once: none went to the
    # host
    for f, grp in forms:
        want = K1_PER_PROVE[grp]
        got = (step2.get(("madd_accumulate", f), 0),
               counts.get(("madd_accumulate", f), 0))
        if got != (want, 2 * want):
            raise AssertionError(
                f"madd_accumulate[{f}]: {got[0]} launches in the warm step "
                f"and {got[1]} in both proves, expected {want} and "
                f"{2 * want}")
    return counts, probe


def phase_path(results, probe):
    """Each kernel on the inputs of its first launch in the warm step,
    exactly against its plain version, timed with CUDA events (the plain
    version by its one call)."""
    import numpy as np
    import torch

    for (kernel, form), (ec, args) in sorted(probe.first.items()):
        D = ec.d
        dev = args[0].device
        if kernel == "madd_accumulate":
            table, perm, loads = args
            nwin, T, L = perm.shape
            pm = perm.cpu().numpy().view(np.uint32) & 0x7FFFFFFF
            flagged = (table[:, 0, 0, -1] < 0).cpu().numpy()
            act = np.arange(T)[None, :, None] < loads.cpu().numpy()[
                :, None, :]
            madds = int((act & ~flagged[pm]).sum())
            nbytes = (table.numel() + perm.numel() + loads.numel()
                      + nwin * L * ec.point_words) * 4
            mads = madds * MULS_MADD * PRODUCTS[D] * 2
            shape = (f"{nwin}x{L} lanes, T={T}, {madds} mixed adds, "
                     f"{table.shape[0]}-row table")
            reps = 5
        else:
            n = args[0].numel() // ec.point_words
            nbytes = 3 * args[0].numel() * 4
            mads = n * MULS_ADD * PRODUCTS[D] * 2
            shape = f"{n} pairs"
            reps = 10
        kern = getattr(ec, "madd_accumulate" if kernel == "madd_accumulate"
                       else "add")
        plain = getattr(ec, kernel + "_plain")
        got = kern(*args)
        sync(dev)
        t0 = time.perf_counter()
        want = plain(*args)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"{kernel}[{form}] on the warm step's "
                                 f"inputs: kernel != plain")
        ms = device_ms(lambda: kern(*args), reps, dev)
        rec = record(kernel, form, D, err, ms, plain_ms, nbytes, mads)
        results.append(rec)
        say(5, f"{kernel}[{form}] on the warm step's first-launch inputs "
               f"({shape}): exact; {ms:.3f} ms, bound {rec['bound_ms']:.3f}"
               f" ms ({rec['bound_by']}), plain {plain_ms:.0f} ms")


def main(argv):
    phases = {1, 2, 3, 4}
    if "--phases" in argv:
        phases = {int(x) for x in argv[argv.index("--phases") + 1].split(",")}
    if not os.path.isdir(os.path.join(HERE, "pcd_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(pcd_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    results = []
    counts = {}
    card = phase_build()
    if 2 in phases:
        phase_kernels()
    if 3 in phases:
        phase_msm()
    if 4 in phases:
        counts, probe = phase_chain()
        phase_path(results, probe)
    for rec in results:
        kernel, form = rec["name"].rstrip("]").split("[")
        rec["launches"] = counts.get((kernel, form), 0)
    say(6, f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
