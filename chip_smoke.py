#!/usr/bin/env python3
"""Drive pcd_tpu_torch on an NVIDIA card and hold its kernels to their
plain versions.  Run from the root of a checkout with one CUDA card:

    python3 chip_smoke.py                # phases 1-7 and 9
    python3 chip_smoke.py --phases 1,6   # a subset of 1, 2, 3, 4, 6, 7, 9
    python3 chip_smoke.py --phases 8     # the real Marlin chain (hours)

Phases, one output line each, then a `kernels` JSON line and the final
status line:
  1  card and build: nvidia-smi's name and power limit; the C++ host tier
     (g++) and the CUDA kernels (one nvcc per source, sched_digits too)
     built in parallel from the checkout, with ptxas' register and spill
     report;
  2  every kernel against its plain torch version on the card, for the
     four field forms of the main path (MNT4/MNT6 G1 over Fq, MNT4 G2 over
     Fq2, MNT6 G2 over Fq3): K1 on 25 windows x 8192 lanes, T = 8, with
     zero loads and infinity-flagged rows, K2 on 204800 pairs with P = Q,
     P = -Q and identities; for G1, K3 on K1's 204800 outputs with mixed
     signs, a quarter of the rows inactive, acc = identity and acc = Q
     rows, and once more from the identity against K1 at T = 1; K4 on K1's
     25 x 8192 outputs for a real C++ schedule of 2^16 298-bit scalars
     (c = 12) with an all-zero window, a window whose digits all fall in
     one bucket (the run of maxrun lanes) and P, -P in every bucket of
     one scalar, against its plain version and, as affine points, against
     the K2-step finish (StreamMSMCtx.finish_steps), both timed in turns;
     exact equality of the limbs; CUDA-event times at these shapes;
  3  one 2^18-point MNT4 G1 stream MSM against the C++ Pippenger;
  4  the real-cycle mnt4_groth16 IVC chain on the card: setup, the base
     case, a warm step-2 prove, both verified, and the negative check
     (the old message against the newest proof must be rejected); every
     kernel instantiation must have launched on that path, K1 exactly
     once per commitment MSM, K4 once per commitment MSM, K2 never;
     CUDA-event device time of every launch of the warm step, of the
     whole finish (StreamMSMCtx._finish), and of the warm step's finishes
     replayed through K4 and through finish_steps in turns; then ten more
     warm steps, the scheduler (msm_dispatch.SCHEDULER) in five adjacent
     host/device pairs, alternating which runs first, each step with K1
     and K4 exactly once per commitment MSM (sched_digits twice a prove
     under "device"), the last proof of each verified; per scheduler the
     medians and ranges of the step, stream_dispatch, stream_dispatch_h,
     the MSM collect (groth16/msm) and the schedule spans, and the
     verdict that sets the default: "device" when its step is shorter in
     at least nine tenths of the pairs and its median shorter than the
     host's by more than the host steps' interquartile distance;
  5  each kernel again on the inputs of its first launch in the warm step
     (K1 and K4: the a-query or b_g2 MSM), exactly against its plain
     version, with CUDA-event times, K4 beside finish_steps on the same
     inputs: these are the numbers of the `kernels` line.  Runs after every chain of phases
     4 and 6, on that chain's inputs, and cannot be chosen alone;
  6  phases 4 and 5 for the real-cycle GM17 chain mnt4_gm17 and the
     mixed chains mnt4_mix_groth16_gm17 and mnt4_mix_gm17_groth16, each
     at full width; K1 exactly once per commitment MSM of either SNARK;
  7  the Marlin SNARK (KZG10 over the real curves, universal SRS) on
     MNT4-298, the main side of mnt4_marlin, and MNT6-298, its help side,
     on a squaring chain of 2^MARLIN_LOG_M constraints in place of the
     PCD's verifier circuit: universal setup, index, a cold and a warm
     prove, both verified; a wrong public input, a tampered sigma3 and a
     tampered evaluation rejected; K1<1> and K4<1> exactly once per KZG
     MSM of KZG10.STREAM_MIN scalars or more (the host Pippenger takes
     only smaller ones), K2 and K3 never; one degree-bound shadow commit
     against the C++ Pippenger on the same SRS rows; CUDA-event ms of
     every launch of the warm prove, and K1 and K4 again, exactly against
     their plain versions, on the inputs of the warm prove's first
     round-1 commit and of its open3 MSM;
  9  the device scheduler (ops/msm_stream_dev.py) at c = 12, L = 8192:
     a 2^18-point MNT4 G1 MSM and a 2^16-point MNT4 G2 MSM, dense and
     low-entropy scalars (digits in two windows only), each equal to the
     C++ Pippenger with K1, K4 and sched_digits launched once; the G1
     schedules equal the host placement law (the numpy schedule at the
     device's T) and the low-entropy ones leave the empty windows out;
     sched_digits exactly against its plain version on the dense
     scalars; the schedule's CUDA-event ms (upload to placement, the
     histogram fetch included) against the C++ schedule's wall ms, in
     turns, with the digits, sort and placement times beside them;
  8  (only when asked for alone) the real mnt4_marlin PCD chain through
     the universal setup (reference tests/mnt4_marlin.rs:141-204):
     universal setup, index, base case, step 2, both verified, and the
     negative check.  Hours of host work: never in the default run.
Phase 1 always runs, and phase 9 runs after phase 3, before the chains.
K2's and K3's records come from phase 2; their `launches` sum their
launches over the chains run (null when none ran).  sched_digits' record
comes from phase 9; its `launches` are those of phase 4's
device-scheduled warm steps (phase 9's own when phase 4 did not run).
Phases 6 and 7 run msm_dispatch.SCHEDULER's default.  Any failure exits
non-zero without the final line.  Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import json
import os
import random
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
# K1 launches per prove of one SNARK: Groth16's a, b_g1, l and h in G1
# and b_g2 in G2; GM17's a, c and h in G1 and b in G2
K1_PER_PROVE = {"Groth16": {"g1": 4, "g2": 1}, "GM17": {"g1": 3, "g2": 1}}
# the chains of phases 4 and 6 (pcd_tpu_torch.configs factories)
CHAINS = {4: ("mnt4_groth16",),
          6: ("mnt4_gm17", "mnt4_mix_groth16_gm17", "mnt4_mix_gm17_groth16")}
# phase 7's squaring chain: 2^MARLIN_LOG_M R1CS constraints
MARLIN_LOG_M = 16

# each port kernel and the Pallas call sites (pl.pallas_call lines) it
# replaces: K4 took the finish's complete adds (sites 3-6) from K2, which
# stays as the row-layout EC32Ctx._add_pallas (site 7), on no path
REPLACES = {
    ("madd_accumulate", 1): "pcd_tpu/ops/ec32.py:721",
    ("madd_accumulate", 2): "pcd_tpu/ops/ec32.py:1319",
    ("madd_accumulate", 3): "pcd_tpu/ops/ec32.py:1319",
    ("bucket_finish", 1): "pcd_tpu/ops/ec32.py:502, pcd_tpu/ops/ec32.py:401",
    ("bucket_finish", 2): "pcd_tpu/ops/ec32.py:1211, "
                          "pcd_tpu/ops/ec32.py:1003",
    ("bucket_finish", 3): "pcd_tpu/ops/ec32.py:1211, "
                          "pcd_tpu/ops/ec32.py:1003",
    ("complete_add", 1): "pcd_tpu/ops/ec32.py:436",
    ("madd", 1): "pcd_tpu/ops/ec32.py:620",
    # no Pallas site: the XLA digit glue of DevSchedMSM._p1 (lines 80-110)
    ("sched_digits", 0): "pcd_tpu/ops/msm_stream_dev.py:80",
}
SOURCES = {"madd_accumulate": "pcd_tpu_torch/csrc/madd_accumulate.cu",
           "complete_add": "pcd_tpu_torch/csrc/complete_add.cu",
           "madd": "pcd_tpu_torch/csrc/madd.cu",
           "bucket_finish": "pcd_tpu_torch/csrc/bucket_finish.cu",
           "sched_digits": "pcd_tpu_torch/csrc/sched_digits.cu"}
# phase 4's extra warm steps: the stream-MSM scheduler of each, in turns
# of adjacent pairs
SCHED_TURNS = ("host", "device", "device", "host", "host", "device",
               "device", "host", "host", "device")


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
    K2 on K1's 204800 outputs as pairs with P = Q, P = -Q and identities;
    K3 for the G1 forms (check_madd); K4 on a real schedule
    (check_finish).  Returns the `kernels` records of K2<1> and K3."""
    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops.ec import ec_ctx

    dev = torch.device(dev)
    rng = np.random.default_rng(2026)
    records = []
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
        sync(dev)
        t0 = time.perf_counter()
        want2 = ec.complete_add_plain(P, Q)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got2, want2):
            raise AssertionError(f"K2 {form}: kernel != plain")
        # P = -Q must give the identity (Z = 0)
        if bool(got2[k:2 * k, 2].any()):
            raise AssertionError(f"K2 {form}: P + (-P) is not the identity")
        ms = device_ms(lambda: ec.add(P, Q), 10, dev)
        say(2, f"K2 complete_add {form}: exact on {n} pairs; {ms:.3f} ms, "
               f"plain {plain_ms:.0f} ms")
        if which == "g1":
            records.append(record("complete_add", form, 1, 0, ms, plain_ms,
                                  3 * P.numel() * 4,
                                  n * MULS_ADD * PRODUCTS[1] * 2))
            records.append(check_madd(ec, table, got.reshape(-1, 3, D, 10),
                                      rng, form))
        check_finish(ec, cfg, which, rng, form, dev)
    return records


def finish_work(ec, accs, bidx, runrem):
    """K4's work on these inputs, the same for any implementation: per
    window (used lanes - nonempty buckets) + 2 B complete adds, and the
    accumulators read once and the window sums written once.  Returns
    (adds, bytes, 32-bit multiply-adds)."""
    nwin, L = runrem.shape
    B = bidx.shape[1]
    used = int((runrem > 0).sum())
    nonempty = int((bidx != nwin * L).sum())
    adds = used - nonempty + 2 * B * nwin
    nbytes = (accs.numel() + nwin * ec.point_words) * 4
    return adds, nbytes, adds * MULS_ADD * PRODUCTS[ec.d] * 2


def finish_inputs(ec, cfg, which, rng, dev, n=1 << 16, c=12, lanes=8192,
                  edges=True):
    """K4's inputs on a real C++ schedule (c-bit windows, 8192 lanes) of n
    scalars below 2^297: window 2 all zero digits (window 1's top two bits
    clear, so no carry), window 3 every digit 5 (one bucket of n points,
    the run of maxrun lanes), and rows 0 and 1 P and -P with the same
    scalar (they share a bucket in every window); with edges=False only
    the random scalars (every bucket a run of about four lanes, as in the
    chains' MSMs).  K1 folds the lanes.  Returns (StreamMSMCtx, schedule,
    accs, bidx, runrem)."""
    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx

    curve, gen = getattr(cfg, which), getattr(cfg, which + "_gen")
    xs, ys, inf = raw_points(native, gen, [int(s) for s in rng.integers(
        1, 1 << 62, n)], cfg.Fr.BITS)
    sctx = StreamMSMCtx(curve, cfg.Fr.BITS, c, lanes)
    table = sctx.table_from_limbs(xs, ys, inf, dev)
    sc = [int.from_bytes(rng.bytes(38), "little") % (1 << 297)
          for _ in range(n)]
    if edges:
        table[1] = table[0]
        table[1, 1] = ec.f.from_plain(ec.f.neg(ec.f.to_plain(table[0, 1])))
        mask = (1 << c) - 1
        keep = ((1 << 297) - 1 - (3 << (2 * c - 2)) - (mask << 2 * c)
                - (mask << 3 * c))
        sc = [(s & keep) | (5 << 3 * c) for s in sc]
        sc[1] = sc[0]
    sched = sctx.schedule_native(native.ints_to_limbs(sc))
    perm, loads, bidx, runrem = sched.on(dev)
    accs = ec.madd_accumulate(table, perm, loads)
    return sctx, sched, accs, bidx, runrem


def check_finish(ec, cfg, which, rng, form, dev):
    """K4 on finish_inputs: it must equal its plain version limb for limb
    and finish_steps as affine points, window by window; both timed with
    CUDA events in turns (K4, steps, steps, K4)."""
    import torch

    sctx, sched, accs, bidx, runrem = finish_inputs(ec, cfg, which, rng, dev)
    got = ec.bucket_finish(accs, bidx, runrem)
    sync(dev)
    t0 = time.perf_counter()
    want = ec.bucket_finish_plain(accs, bidx, runrem)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, want):
        raise AssertionError(f"K4 {form}: kernel != plain")
    steps = sctx.finish_steps(accs, bidx, runrem, sched.maxrun)
    g, s = got.cpu().numpy(), steps.cpu().numpy()
    for w in range(sctx.nwin):
        if ec.decode_point(g[w]) != ec.decode_point(s[w]):
            raise AssertionError(f"K4 {form}: window {w} != finish_steps")
    if not ec.decode_point(g[2]).is_infinity():
        raise AssertionError(f"K4 {form}: the all-zero window is not O")
    bucket5 = int(sched.runrem[3, sched.bidx[3, 4] - 3 * sctx.L])
    k4 = lambda: ec.bucket_finish(accs, bidx, runrem)  # noqa: E731
    old = lambda: sctx.finish_steps(accs, bidx, runrem,  # noqa: E731
                                    sched.maxrun)
    t = {"k4": [], "steps": []}
    for name in ("k4", "steps", "steps", "k4"):
        t[name].append(device_ms(k4 if name == "k4" else old, 3, dev))
    ms, ms_old = (sum(v) / 2 for v in t.values())
    adds, nbytes, mads = finish_work(ec, accs, bidx, runrem)
    bound = max(nbytes / HBM_BYTES_PER_S, mads / INT32_MAD_PER_S) * 1e3
    say(2, f"K4 bucket_finish {form}: exact against plain and finish_steps "
           f"on {sctx.nwin}x{sctx.L} lanes ({int(sched.loads.sum())} "
           f"digits, T={sched.T}, maxrun {sched.maxrun}, window 3's bucket {bucket5} lanes, "
           f"{adds} adds); {ms:.3f} ms vs finish_steps {ms_old:.3f} ms, "
           f"bound {bound:.3f} ms, plain {plain_ms:.0f} ms")


def check_madd(ec, table, acc0, rng, form):
    """K3 on K1's n lane outputs against its plain version: q gathered
    from the table (its flagged rows included), mixed signs, a quarter of
    the rows inactive; a sixteenth of the accumulators set to the
    identity and a sixteenth to Q itself (half of those with Q's sign
    cleared, a doubling, half set, P + (-P)).  Then K3 from the identity
    against K1 at T = 1 on the same rows and flags (loads = active).
    Returns K3's `kernels` record."""
    import numpy as np
    import torch

    dev = acc0.device
    n, m = acc0.shape[0], table.shape[0]
    idx = rng.integers(0, m, n).astype(np.uint32)
    sign_np = rng.integers(0, 2, n).astype(np.int32)
    act_np = (rng.random(n) >= 0.25).astype(np.int32)
    k = n // 16
    sign_np[k:k + k // 2] = 0                          # acc = Q: doubling
    sign_np[k + k // 2:2 * k] = 1                      # acc = Q: P - P
    q = table[torch.from_numpy(idx.astype(np.int64)).to(dev)].contiguous()
    sign = torch.from_numpy(sign_np).to(dev)
    active = torch.from_numpy(act_np).to(dev)
    acc = acc0.clone()
    acc[:2 * k] = ec.identity((2 * k,), dev)           # acc = O
    acc[k:2 * k, :2] = q[k:2 * k]                      # acc = (x2 : y2 : 1)
    acc[k:2 * k, 0, 0, 9] &= 0x7FFFFFFF                # (flag bit cleared)
    acc[k:2 * k, 2] = acc[:k, 1]
    sync(dev)
    t0 = time.perf_counter()
    want = ec.madd_plain(acc, q, sign, active)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = ec.madd(acc.clone(), q, sign, active)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"K3 {form}: kernel != plain")
    flagged = (q[:, 0, 0, 9] < 0).cpu().numpy()
    live = (act_np != 0) & ~flagged
    neg = np.flatnonzero(live[k + k // 2:2 * k]) + k + k // 2
    if bool(got[torch.from_numpy(neg).to(dev), 2].any()):
        raise AssertionError(f"K3 {form}: Q + (-Q) is not the identity")
    from_o = ec.madd(ec.identity((n,), dev), q, sign, active)
    perm = (idx | (sign_np.astype(np.uint32) << 31)).view(np.int32)
    k1 = ec.madd_accumulate(table, torch.from_numpy(perm.reshape(1, 1, n))
                            .to(dev), active.reshape(1, n))
    if not torch.equal(k1.reshape(from_o.shape), from_o):
        raise AssertionError(f"K3 {form}: != K1 at T = 1")
    ms = device_ms(lambda: ec.madd(acc, q, sign, active), 10, dev)
    nbytes = n * (2 * 3 + 2) * 10 * 4 + 2 * n * 4
    rec = record("madd", form, 1, err, ms, plain_ms, nbytes,
                 int(live.sum()) * MULS_MADD * PRODUCTS[1] * 2)
    say(2, f"K3 madd {form}: exact against plain and K1 at T = 1 on {n} "
           f"rows ({int(live.sum())} mixed adds); {ms:.3f} ms, bound "
           f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), plain "
           f"{plain_ms:.0f} ms")
    return rec


def record(kernel, form, D, err, ms, plain_ms, nbytes, mads):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mads / INT32_MAD_PER_S * 1e3
    return {"name": f"{kernel}[{form}]", "route": "cuda",
            "source": SOURCES[kernel], "replaces": REPLACES[(kernel, D)],
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}


def encoded(native, curve, xs, ys, inf):
    """raw_points' arrays as the C++ tier's EncodedPoints (no host point
    objects), for native.msm."""
    import numpy as np

    enc = object.__new__(native.EncodedPoints)
    enc.curve = curve
    enc.handle, enc.deg, _ = native.curve_handle(curve)
    enc.xs, enc.ys, enc.inf, enc.n = xs, ys, inf.astype(np.uint8), len(xs)
    return enc


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
    enc = encoded(native, cfg.g1, xs, ys, inf)
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


def low_entropy(n, c=12):
    """Scalars with digits in two windows only, 0 and 5 (window 5's in one
    of three buckets): the other windows stay empty."""
    return [(i % 1009) | ((i % 3 + 1) << (5 * c)) for i in range(n)]


def phase_devsched(results, dev="cuda", log_n=18, log_n2=16, phase=9):
    """The device scheduler at the chains' c = 12, L = 8192 (see the module
    docstring, phase 9).  Appends sched_digits' `kernels` record (its
    launches those of this phase; main() puts phase 4's there when it
    ran)."""
    import statistics

    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx
    from pcd_tpu_torch.ops.msm_stream_dev import DevSchedMSM

    dev = torch.device(dev)
    # on the CPU (a rehearsal) the wrappers count plain-version calls
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    cfg = M.mnt_cycle().main
    r = cfg.Fr.MODULUS
    rng = np.random.default_rng(9)
    launches = 0
    for grp, log in (("g1", log_n), ("g2", log_n2)):
        curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
        n = 1 << log
        xs, ys, inf = raw_points(native, gen, [int(s) for s in rng.integers(
            1, 1 << 62, n)], cfg.Fr.BITS)
        enc = encoded(native, curve, xs, ys, inf)
        sctx = StreamMSMCtx(curve, cfg.Fr.BITS)
        dm = DevSchedMSM(sctx)
        table = sctx.table_from_limbs(xs, ys, inf, dev)
        dense = [int.from_bytes(rng.bytes(40), "little") % r
                 for _ in range(n)]
        for kind, sc in (("dense", dense), ("low-entropy", low_entropy(n))):
            limbs = native.ints_to_limbs(sc)
            want = native.msm(enc, limbs)
            ec.reset_launch_counts()           # this MSM starts
            got = dm.msm_limbs(table, limbs)
            counts = counter()                 # this MSM ended
            launches += counts.get(("sched_digits", dm.form), 0)
            expect = {("madd_accumulate", curve.name): 1,
                      ("bucket_finish", curve.name): 1,
                      ("sched_digits", dm.form): 1}
            if counts != expect:
                raise AssertionError(f"devsched {curve.name} {kind}: "
                                     f"launches {counts}, expected {expect}")
            if got != want:
                raise AssertionError(f"devsched 2^{log} {curve.name} {kind} "
                                     f"MSM != C++ Pippenger")
            W = dm.upload(limbs, dev)
            sched = dm.schedule(W)
            if kind == "low-entropy" and list(sched.act) != [0, 5]:
                raise AssertionError(f"low-entropy scalars: active windows "
                                     f"{sched.act}, expected [0, 5]")
            msg = ""
            if grp == "g1":
                t0 = time.perf_counter()
                mags, signs = sctx.digits_signed(limbs)
                host = sctx.schedule(mags, signs, T=sched.T)
                act = list(sched.act)
                hb = host.bidx[act].astype(np.int64)
                nact, L = len(act), sctx.L
                shift = (np.arange(nact) - np.asarray(act))[:, None] * L
                want_t = (host.perm.view(np.int32)[act], host.loads[act],
                          np.where(hb == sctx.nwin * L, nact * L, hb + shift),
                          host.runrem[act])
                for nm, a, b in zip(("perm", "loads", "bidx", "runrem"),
                                    sched.on(dev), want_t):
                    if not np.array_equal(a.cpu().numpy(), b):
                        raise AssertionError(f"devsched {kind}: {nm} != the "
                                             f"host placement law at T = "
                                             f"{sched.T}")
                msg = (f"; schedule == host placement law at T = {sched.T} "
                       f"(numpy oracle {time.perf_counter() - t0:.1f}s)")
            say(phase, f"2^{log} {curve.name} {kind}: device-scheduled MSM "
                       f"== C++ Pippenger, K1, K4 and sched_digits once; "
                       f"{len(sched.act)} of {sctx.nwin} windows active, "
                       f"T = {sched.T}, maxrun {sched.maxrun}" + msg)
        if grp != "g1":
            continue
        limbs = native.ints_to_limbs(dense)
        W = dm.upload(limbs, dev)
        got = dm.digits(W)
        sync(dev)
        t0 = time.perf_counter()
        want = dm.digits_plain(W)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        if err:
            raise AssertionError("sched_digits != its plain version")
        ms = device_ms(lambda: dm.digits(W), 10, dev)
        nbytes = W.numel() * 4 + sctx.nwin * n * 5
        rec = record("sched_digits", dm.form, 0, err, ms, plain_ms, nbytes, 0)
        results.append(rec)
        # the schedule: C++ (host wall) against the device's (CUDA events
        # from the upload to the placement, histogram fetch included), in
        # turns, and the device steps alone
        t = {"cpp": [], "dev": [], "dev_wall": []}
        for who in ("cpp", "dev", "dev", "cpp", "cpp", "dev"):
            sync(dev)
            t0 = time.perf_counter()
            if who == "cpp":
                sctx.schedule_native(limbs)
                t["cpp"].append((time.perf_counter() - t0) * 1e3)
                continue
            if dev.type != "cuda":                 # a CPU rehearsal
                dm.schedule(dm.upload(limbs, dev))
                t["dev_wall"].append((time.perf_counter() - t0) * 1e3)
                t["dev"].append(t["dev_wall"][-1])
                continue
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dm.schedule(dm.upload(limbs, dev))
            b.record()
            sync(dev)
            t["dev_wall"].append((time.perf_counter() - t0) * 1e3)
            t["dev"].append(a.elapsed_time(b))
        order, signs_, counts = dm.p1(W)
        act, T, _ = dm._pick_shapes(counts.cpu().numpy())
        parts = {
            "upload": device_ms(lambda: dm.upload(limbs, dev), 3, dev),
            "digits": ms,
            "sort+histogram": device_ms(
                lambda: dm.p1(W), 5, dev) - ms,
            "placement": device_ms(
                lambda: dm.place(order, signs_, counts, act, T), 5, dev)}
        med = {k: statistics.median(v) for k, v in t.items()}
        say(phase, f"sched_digits[{dm.form}] on 2^{log} scalars: exact "
                   f"against plain; {ms:.4f} ms, bound "
                   f"{rec['bound_ms']:.4f} ms (bytes), plain "
                   f"{plain_ms:.1f} ms")
        say(phase, f"2^{log} schedule, medians of 3 in turns: device "
                   f"{med['dev']:.3f} ms CUDA events ({med['dev_wall']:.3f} "
                   f"ms wall) vs C++ {med['cpp']:.3f} ms wall; all "
                   + json.dumps({k: [round(x, 3) for x in v]
                                 for k, v in t.items()})
                   + "; device parts (ms): " + json.dumps(
                       {k: round(v, 4) for k, v in parts.items()}))
    for rec in results:
        if rec["name"].startswith("sched_digits["):
            rec["launches"] = launches


class LaunchProbe:
    """While `on`, wraps the four kernel wrappers of ops/ec.py and the
    stream MSM's finish: the first call per (kernel, curve) keeps its
    inputs (K3's accumulator, which it updates in place, as a copy), every
    finish keeps its StreamMSMCtx and inputs, and every call on the card
    gets CUDA events around it on the caller's current stream (the MSM
    side stream in the prover's background thread).  The wrappers' launch
    counters are untouched; leaving the `with` restores the wrappers."""

    WRAPPED = (("madd_accumulate", "madd_accumulate"),
               ("complete_add", "add"), ("madd", "madd"),
               ("bucket_finish", "bucket_finish"))

    def __init__(self):
        self.on = False
        self.first = {}      # (kernel, curve name) -> (ECCtx, args)
        self.last = {}       # the same for the latest call (not K3's)
        self.finishes = []   # (StreamMSMCtx, args) of every finish
        self.firsts = []     # the first of them per curve
        self.events = []     # ((kernel or "finish", curve name), start, end)

    def _timed(self, key, fn, *args):
        import torch

        if args[1].device.type != "cuda":
            return fn(*args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args)
        b.record()
        self.events.append((key, a, b))
        return out

    def __enter__(self):
        from pcd_tpu_torch.ops.ec import ECCtx
        from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx

        self._orig = {attr: getattr(ECCtx, attr) for _, attr in self.WRAPPED}
        self._finish = StreamMSMCtx._finish

        def finish(sctx, *args):
            if not self.on:
                return self._finish(sctx, *args)
            self.finishes.append((sctx, args))
            if all(p[0].ec is not sctx.ec for p in self.firsts):
                self.firsts.append((sctx, args))
            return self._timed(("finish", sctx.ec.name), self._finish, sctx,
                               *args)
        StreamMSMCtx._finish = finish

        def wrap(kernel, fn):
            def probed(ctx, *args):
                if not self.on:
                    return fn(ctx, *args)
                key = (kernel, ctx.name)
                if key not in self.first:
                    kept = ((args[0].clone(),) + args[1:] if kernel == "madd"
                            else args)
                    self.first[key] = (ctx, kept)
                if kernel != "madd":
                    self.last[key] = (ctx, args)
                return self._timed(key, fn, ctx, *args)
            return probed

        for kernel, attr in self.WRAPPED:
            setattr(ECCtx, attr, wrap(kernel, self._orig[attr]))
        return self

    def __exit__(self, *exc):
        from pcd_tpu_torch.ops.ec import ECCtx
        from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx

        for attr, fn in self._orig.items():
            setattr(ECCtx, attr, fn)
        StreamMSMCtx._finish = self._finish

    def replay_finishes(self):
        """The warm step's finishes again, each through K4 (the port's
        `_finish`) and through finish_steps in turns (K4, steps, steps,
        K4): {curve name: [K4 ms, finish_steps ms]} summed over the step,
        one call each, CUDA events."""
        out = {}
        for sctx, (accs, bidx, runrem) in self.finishes:
            top = max(1, int(runrem.max()))
            maxrun = 1 << (top - 1).bit_length()
            k4 = lambda: self._finish(sctx, accs, bidx, runrem)  # noqa
            old = lambda: sctx.finish_steps(accs, bidx, runrem,  # noqa
                                            maxrun)
            got = [0.0, 0.0]
            for i in (0, 1, 1, 0):
                got[i] += device_ms(k4 if i == 0 else old, 1,
                                    accs.device) / 2
            tot = out.setdefault(sctx.ec.name, [0.0, 0.0])
            tot[0] += got[0]
            tot[1] += got[1]
        return out

    def device_ms(self):
        """{(kernel, curve name): summed CUDA-event ms of its launches}."""
        import torch

        if self.events:
            torch.cuda.synchronize()
        out = {}
        for key, a, b in self.events:
            out[key] = out.get(key, 0.0) + a.elapsed_time(b)
        return out


def check_once_per_msm(counts, forms, what):
    """K1 and K4 of every form exactly once per commitment MSM of one
    prove of each side, K2 never."""
    for f, grp, kind in forms:
        want = K1_PER_PROVE[kind][grp]
        for k in ("madd_accumulate", "bucket_finish"):
            if counts.get((k, f), 0) != want:
                raise AssertionError(f"{what}: {k}[{f}] launched "
                                     f"{counts.get((k, f), 0)} times, "
                                     f"expected {want}")
        if counts.get(("complete_add", f), 0):
            raise AssertionError(f"{what}: complete_add[{f}] launched")


def sched_turns(pcd, pk, vk, pred, proof_1, rng, forms, counter, dev, phase,
                turns=SCHED_TURNS):
    """Warm steps with msm_dispatch.SCHEDULER set in `turns`: each its
    launches counted alone (K1 and K4 once per commitment MSM, sched_digits
    twice a prove under "device", never under "host") and its spans; the
    last proof of each scheduler verified.  Returns ({scheduler: {metric:
    [median, min, max] s}}, sched_digits launches in all)."""
    import statistics

    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.utils import profiling

    F = pcd.ic.main_field
    one, two = F.from_int(1), F.from_int(2)
    default = msm_dispatch.SCHEDULER
    runs, last = {}, {}
    digits_all = 0
    profiling.enable()
    try:
        for sch in turns:
            msm_dispatch.SCHEDULER = sch
            profiling.reset()
            ec.reset_launch_counts()           # this warm step starts
            t0 = time.perf_counter()
            last[sch] = pcd.prove(pk, pred, two, one, [one], [proof_1], rng)
            sync(dev)
            wall = time.perf_counter() - t0
            got = counter()                    # this warm step ended
            check_once_per_msm(got, forms, f"warm step, {sch} scheduler")
            digits = sum(v for (k, _), v in got.items()
                         if k == "sched_digits")
            if digits != (4 if sch == "device" else 0):
                raise AssertionError(f"warm step, {sch} scheduler: "
                                     f"{digits} sched_digits launches")
            digits_all += digits
            tot = profiling.totals()

            def total(leaf, tot=tot):
                return sum(v[0] for k, v in tot.items()
                           if k.rsplit("/", 1)[-1] == leaf)
            runs.setdefault(sch, []).append({
                "step": wall, "stream_dispatch": total("stream_dispatch"),
                "stream_dispatch_h": total("stream_dispatch_h"),
                "msm_collect": total("msm"),
                "schedule": total("schedule_" + sch)})
    finally:
        msm_dispatch.SCHEDULER = default
        profiling.enable(False)
    for sch, proof in last.items():
        if not pcd.verify(vk, pred, two, proof):
            raise AssertionError(f"the {sch}-scheduled warm step does not "
                                 f"verify")
    out = {sch: {m: [statistics.median(r[m] for r in recs),
                     min(r[m] for r in recs), max(r[m] for r in recs)]
                 for m in recs[0]} for sch, recs in runs.items()}
    verdict = None
    if set(runs) == {"host", "device"}:
        steps = {sch: [r["step"] for r in recs] for sch, recs in runs.items()}
        it = {sch: iter(v) for sch, v in steps.items()}
        order = [(sch, next(it[sch])) for sch in turns]
        pairs = [dict(order[i:i + 2]) for i in range(0, len(order) - 1, 2)]
        wins = sum(p.get("device", 1e9) < p.get("host", 0) for p in pairs)
        q1, _, q3 = statistics.quantiles(steps["host"], n=4,
                                         method="inclusive")
        gap = out["host"]["step"][0] - out["device"]["step"][0]
        verdict = ("device" if wins >= 0.9 * len(pairs) and gap > q3 - q1
                   else "host")
        say(phase, f"scheduler verdict: device shorter in {wins} of "
                   f"{len(pairs)} pairs, medians {gap:+.4f} s apart "
                   f"(host interquartile {q3 - q1:.4f} s): {verdict!r}")
    for sch, recs in runs.items():
        say(phase, f"{sch}-scheduled warm steps ({len(recs)}, turns "
                   f"{'/'.join(turns)}), each verified or checked once per "
                   f"MSM: " + json.dumps(
                       {m: [round(r[m], 4) for r in recs] for m in recs[0]}))
    say(phase, "scheduler medians [median, min, max] (s): " + json.dumps(
        {sch: {m: [round(x, 4) for x in v] for m, v in ms.items()}
         for sch, ms in out.items()}) + f"; default {default!r}")
    if verdict is not None and verdict != default:
        say(phase, f"note: the verdict {verdict!r} is not "
                   f"msm_dispatch.SCHEDULER's default {default!r}")
    return out, digits_all


def phase_chain(name="mnt4_groth16", phase=4, dev=None, turns=()):
    """The IVC chain of configs.<name> (the real cycle, on the card unless
    `dev` says otherwise).  Returns the launch counts of the main path
    (base case + warm step), the probe of the warm step, and with `turns`
    sched_turns' result (else None)."""
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
    profiling.reset()
    profiling.enable()
    t0 = time.perf_counter()
    pcd = getattr(configs, name)(dev)              # None: the card
    dev = pcd.ic.main_snark.device
    # on the CPU (a rehearsal) the wrappers count plain-version calls
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    F = pcd.ic.main_field
    pred = Counter(F)
    rng = ChaChaRng(b"chip smoke " + name.encode())
    pk, vk = pcd.circuit_specific_setup(pred, rng)
    secs["setup"] = time.perf_counter() - t0
    one, two = F.from_int(1), F.from_int(2)
    ec.reset_launch_counts()                       # the main path starts
    t0 = time.perf_counter()
    proof_1 = pcd.prove(pk, pred, one, one, [], [], rng)
    sync(dev)
    secs["prove_base"] = time.perf_counter() - t0
    base_counts = counter()
    early = {k: round(v[0], 1) for k, v in profiling.totals().items()
             if v[0] >= 1.0}
    profiling.reset()
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
    ic = pcd.ic
    kinds = (type(ic.main_snark).__name__, type(ic.help_snark).__name__)
    say(phase, f"{name} ({ic.cycle.name}, {kinds[0]} main / {kinds[1]} "
               f"help) chain on {dev}: "
               + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
               + f"; base and step 2 verify, negative check rejects; "
                 f"z sizes main {sizes[0]} help {sizes[1]}")
    say(phase, "setup and base-case spans (s): " + json.dumps(early))
    say(phase, "warm step spans (s): " + json.dumps(spans))
    say(phase, "launches (base + step 2): " + json.dumps(
        {f"{k}[{f}]": v for (k, f), v in sorted(counts.items())}))
    say(phase, "launches per warm step: " + json.dumps(
        {f"{k}[{f}]": v for (k, f), v in sorted(step2.items())}))
    dms = probe.device_ms()
    kern = {key: v for key, v in dms.items() if key[0] != "finish"}
    say(phase, "kernel device ms per warm step (CUDA events): " + json.dumps(
        {f"{k}[{f}]": round(v, 3) for (k, f), v in sorted(kern.items())})
        + f"; all kernels {sum(kern.values()):.1f} ms of the "
          f"{secs['prove_step2_warm'] * 1e3:.0f} ms step")
    if dev.type == "cuda":
        fin = {f: v for (k, f), v in dms.items() if k == "finish"}
        say(phase, "whole finish (StreamMSMCtx._finish) device ms per warm "
                   "step: " + json.dumps({f: round(v, 3) for f, v in
                                          sorted(fin.items())})
            + f"; {sum(fin.values()):.3f} ms in all")
        rep = probe.replay_finishes()
        say(phase, "the warm step's finishes replayed, K4 vs finish_steps "
                   "(ms, in turns): " + json.dumps(
                       {f: [round(a, 3), round(b, 3)]
                        for f, (a, b) in sorted(rep.items())})
            + f"; {sum(a for a, _ in rep.values()):.3f} vs "
              f"{sum(b for _, b in rep.values()):.3f} ms in all")
    probe.finishes.clear()
    cyc = ic.cycle
    forms = [(c.name, grp, kind) for cfg, kind in zip((cyc.main, cyc.help),
                                                      kinds)
             for grp, c in (("g1", cfg.g1), ("g2", cfg.g2))]
    missing = [f"{k}[{f}]" for k in ("madd_accumulate", "bucket_finish")
               for f, _, _ in forms if counts.get((k, f), 0) <= 0]
    if missing:
        raise AssertionError("kernels not launched on the main path: "
                             + ", ".join(missing))
    # every commitment MSM of both proves ran K1 and K4 once: none went to
    # the host; K2 no longer runs on the path
    check_once_per_msm(base_counts, forms, "the base case")
    check_once_per_msm(step2, forms, "the warm step")
    took = None
    if turns:
        took = sched_turns(pcd, pk, vk, pred, proof_1, rng, forms, counter,
                           dev, phase, turns)
    return counts, probe, took


def phase_path(results, probe, counts, name="mnt4_groth16", phase=5,
               which="the warm step's first-launch inputs"):
    """Each kernel on the inputs of its first launch in the warm step of
    chain `name`, exactly against its plain version, timed with CUDA
    events (the plain version by its one call).  The records carry the
    chain's launch counts; past the Groth16 chain their names end in
    "@<name>"."""
    import numpy as np
    import torch

    tag = "" if name == "mnt4_groth16" else "@" + name
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
        elif kernel == "bucket_finish":
            accs, bidx, runrem = args
            adds, nbytes, mads = finish_work(ec, accs, bidx, runrem)
            nwin, L = runrem.shape
            shape = (f"{nwin}x{L} lanes, {bidx.shape[1]} buckets, "
                     f"{adds} adds")
            reps = 5
        elif kernel == "madd":
            acc, q, sign, active = args
            n = acc.shape[0]
            live = int(((active != 0) & ~(q[:, 0, 0, -1] < 0)).sum())
            nbytes = (2 * acc.numel() + q.numel() + 2 * n) * 4
            mads = live * MULS_MADD * PRODUCTS[D] * 2
            shape = f"{n} rows, {live} mixed adds"
            reps = 10
        else:
            n = args[0].numel() // ec.point_words
            nbytes = 3 * args[0].numel() * 4
            mads = n * MULS_ADD * PRODUCTS[D] * 2
            shape = f"{n} pairs"
            reps = 10
        kern = getattr(ec, dict(LaunchProbe.WRAPPED)[kernel])
        plain = getattr(ec, kernel + "_plain")
        # K3 updates its accumulator in place: it runs on a copy
        own = (args[0].clone(),) + args[1:] if kernel == "madd" else args
        got = kern(*own)
        sync(dev)
        t0 = time.perf_counter()
        want = plain(*args)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"{kernel}[{form}] on the warm step's "
                                 f"inputs: kernel != plain")
        ms = device_ms(lambda: kern(*own), reps, dev)
        if kernel == "bucket_finish":            # the K2-step yardstick
            sctx, _ = next(p for p in probe.firsts if p[0].ec is ec)
            top = max(1, int(runrem.max()))
            old = [device_ms(lambda: sctx.finish_steps(
                accs, bidx, runrem, 1 << (top - 1).bit_length()), 3, dev)
                for _ in range(2)]
            ms = (ms + device_ms(lambda: kern(*own), reps, dev)) / 2
            shape += (f"; finish_steps on the same inputs "
                      f"{sum(old) / 2:.3f} ms")
        rec = record(kernel, form, D, err, ms, plain_ms, nbytes, mads)
        rec["name"] += tag
        rec["launches"] = counts.get((kernel, form), 0)
        results.append(rec)
        say(phase, f"{kernel}[{form}]{tag} on {which} ({shape}): exact; "
                   f"{ms:.3f} ms, bound "
                   f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), plain "
                   f"{plain_ms:.0f} ms")


class SquareChain:
    """x (public) = a^(2^k): k witnesses squared in turn, k + 1 R1CS
    constraints (phase 7's circuit)."""

    def __init__(self, a, k):
        self.a, self.k = a, k

    def public(self, Fr):
        return Fr.from_int(pow(self.a, 1 << self.k, Fr.MODULUS))

    def generate_constraints(self, cs):
        from pcd_tpu_torch.gadgets.fp import fpvar_class

        V = fpvar_class(cs)
        x = V.new_instance(pow(self.a, 1 << self.k, cs.p))
        cur = V.new_witness(self.a)
        for _ in range(self.k):
            cur = cur * cur
        cur.enforce_equal(x)


class KZGProbe:
    """While on, records every KZG10 MSM: ("stream", n, offset) for each
    _stream_msm call that ran on the stream tier, ("host", n) for each
    host MSM of the kzg module.  Leaving the `with` restores both."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from pcd_tpu_torch.snark.marlin import kzg

        self._orig = (kzg.KZG10._stream_msm, kzg.msm_any)

        def stream(obj, srs, offset, scalars):
            out = self._orig[0](obj, srs, offset, scalars)
            if out is not None:
                n = scalars.shape[0] if hasattr(scalars, "shape") \
                    else len(scalars)
                self.calls.append(("stream", n, offset))
            return out

        def host(query, scalars):
            self.calls.append(("host", len(scalars)))
            return self._orig[1](query, scalars)

        kzg.KZG10._stream_msm, kzg.msm_any = stream, host
        return self

    def __exit__(self, *exc):
        from pcd_tpu_torch.snark.marlin import kzg

        kzg.KZG10._stream_msm, kzg.msm_any = self._orig

    def take(self):
        out, self.calls = self.calls, []
        return out


def marlin_stage(what, calls, before, after, form, stream_min, most):
    """Hold one stage's launches to its KZG MSMs: K1 and K4 of `form` once
    per stream MSM (and sched_digits under the device scheduler), each of
    at least stream_min scalars, the host MSMs all below it, no other
    launch.  Returns the number of stream MSMs."""
    from pcd_tpu_torch.snark import msm_dispatch

    streamed = [c for c in calls if c[0] == "stream"]
    hosted = [c for c in calls if c[0] == "host"]
    if any(c[1] < stream_min for c in streamed) \
            or any(c[1] >= stream_min for c in hosted):
        raise AssertionError(f"{what}: an MSM on the wrong side of "
                             f"STREAM_MIN {stream_min}: {calls}")
    if len(streamed) > most:
        raise AssertionError(f"{what}: {len(streamed)} stream MSMs, at "
                             f"most {most} expected")
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    digits = sum(delta.pop(k) for k in list(delta) if k[0] == "sched_digits")
    if digits != (len(streamed) if msm_dispatch.SCHEDULER == "device"
                  else 0):
        raise AssertionError(f"{what}: {digits} sched_digits launches for "
                             f"{len(streamed)} stream MSMs under the "
                             f"{msm_dispatch.SCHEDULER!r} scheduler")
    want = {(k, form): len(streamed) for k in ("madd_accumulate",
                                                "bucket_finish")
            if streamed}
    if delta != want:
        raise AssertionError(f"{what}: launches {delta}, expected {want} "
                             f"(one K1 and one K4 per stream MSM)")
    return len(streamed)


def phase_marlin(results, log_m=MARLIN_LOG_M, dev=None, phase=7):
    """The Marlin SNARK on both curves of the cycle (see the module
    docstring, phase 7).  Appends the K1 and K4 records of the warm prove's
    first round-1 commit ("@marlin") and of its open3 MSM
    ("@marlin-open3"), their launches those of the warm prove."""
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.snark.marlin.kzg import KZG10
    from pcd_tpu_torch.snark.marlin.native import MarlinBound, MarlinSNARK
    from pcd_tpu_torch.snark.msm_dispatch import host_query, msm_any, subrange
    from pcd_tpu_torch.utils import profiling
    from pcd_tpu_torch.utils.rng import ChaChaRng

    cyc = M.mnt_cycle()
    stream_min = KZG10.STREAM_MIN
    for side, cfg in (("main", cyc.main), ("help", cyc.help)):
        form = cfg.g1.name
        snark = MarlinSNARK(cfg, dev)                  # None: the card
        dev_ = snark.device
        counter = ec.launch_counts if dev_.type == "cuda" \
            else ec.plain_counts
        Fr = cfg.Fr
        circ = SquareChain(3, (1 << log_m) - 1)
        x = circ.public(Fr)
        rng = ChaChaRng(b"chip smoke marlin " + side.encode())
        secs = {}
        stages = {}
        profiling.reset()
        profiling.enable()
        ec.reset_launch_counts()                   # the Marlin path starts
        with KZGProbe() as kp:
            t0 = time.perf_counter()
            need = snark.circuit_degree(circ)
            srs = snark.universal_setup(MarlinBound(need), rng)
            secs["setup"] = time.perf_counter() - t0
            before = counter()
            t0 = time.perf_counter()
            pk, vk = snark.index(srs, circ, rng)
            sync(dev_)
            secs["index"] = time.perf_counter() - t0
            stages["index"] = marlin_stage("index", kp.take(), before,
                                           counter(), form, stream_min, 9)
            before = counter()
            t0 = time.perf_counter()
            proof_1 = snark.prove(pk, circ, rng)
            sync(dev_)
            secs["prove_cold"] = time.perf_counter() - t0
            stages["prove_cold"] = marlin_stage(
                "cold prove", kp.take(), before, counter(), form,
                stream_min, 20)
            spans_cold = profiling.totals()
            profiling.reset()
            ec.reset_launch_counts()               # the warm prove starts
            with LaunchProbe() as probe:
                probe.on = True
                t0 = time.perf_counter()
                proof_2 = snark.prove(pk, circ, rng)
                sync(dev_)
                secs["prove_warm"] = time.perf_counter() - t0
                probe.on = False
            warm = counter()                       # the warm prove ended
            stages["prove_warm"] = marlin_stage(
                "warm prove", kp.take(), {}, warm, form, stream_min, 20)
            spans = {k: round(v[0], 3) for k, v in profiling.totals().items()
                     if v[0] >= 0.05}
            profiling.enable(False)
            # one degree-bound shadow (offset > 0) through the stream tier
            # against the C++ Pippenger on the same rows
            D = srs.max_degree
            n_s = stream_min + 16
            bound = n_s + (D - n_s) // 2          # offset D - bound > 0
            draw = random.Random(7)
            coeffs = [draw.randrange(Fr.MODULUS) for _ in range(n_s)]
            before = counter()
            comm = snark.kzg.commit(srs, coeffs, degree_bound=bound)
            marlin_stage("shadow commit", kp.take(), before, counter(),
                         form, stream_min, 2)
        table = host_query(srs, "powers_g1")
        off = D - bound
        if comm.c != msm_any(subrange(table, 0, n_s), coeffs) \
                or comm.shifted != msm_any(subrange(table, off, off + n_s),
                                           coeffs):
            raise AssertionError(f"{form}: the stream tier's commit or its "
                                 f"shadow at offset {off} != C++ Pippenger")
        t0 = time.perf_counter()
        ok = (snark.verify(vk, [x], proof_1), snark.verify(vk, [x], proof_2))
        secs["verify_both"] = time.perf_counter() - t0
        if not all(ok):
            raise AssertionError(f"Marlin {side} proofs do not verify {ok}")
        bad_sigma = proof_2.clone()
        bad_sigma.sigma3 = (bad_sigma.sigma3 + 1) % Fr.MODULUS
        bad_eval = proof_2.clone()
        bad_eval.evals = dict(proof_2.evals)
        bad_eval.evals["g_3A"] = (proof_2.evals["g_3A"] + 1) % Fr.MODULUS
        t0 = time.perf_counter()
        neg = (snark.verify(vk, [x + Fr.from_int(1)], proof_2),
               snark.verify(vk, [x], bad_sigma),
               snark.verify(vk, [x], bad_eval))
        secs["negative_checks"] = time.perf_counter() - t0
        if any(neg):
            raise AssertionError(f"Marlin {side}: a negative check accepted "
                                 f"(input, sigma3, evals): {neg}")
        idx = pk.index
        say(phase, f"Marlin {side} ({cfg.name}, {form}) on {dev_}: m = "
                   f"{circ.k + 1} constraints, H = {idx.n}, K = "
                   f"{idx.k_size}, D = {D}; "
                   + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
                   + "; both proofs verify, the wrong input, sigma3 and "
                     "evaluation reject; the shadow commit at offset "
                     f"{off} == C++ Pippenger")
        say(phase, f"stream MSMs (K1 and K4 once each, STREAM_MIN "
                   f"{stream_min}): " + json.dumps(stages))
        say(phase, "cold prove spans (s): " + json.dumps(
            {k: round(v[0], 3) for k, v in spans_cold.items()
             if v[0] >= 0.05}))
        say(phase, "warm prove spans (s): " + json.dumps(spans))
        dms = probe.device_ms()
        kern = {key: v for key, v in dms.items() if key[0] != "finish"}
        say(phase, "kernel device ms per warm prove (CUDA events): "
                   + json.dumps({f"{k}[{f}]": round(v, 3)
                                 for (k, f), v in sorted(kern.items())})
            + f"; all kernels {sum(kern.values()):.1f} ms of the "
              f"{secs['prove_warm'] * 1e3:.0f} ms prove")
        if not stages["prove_warm"]:
            continue
        # K1 and K4 on the first round-1 commit's and open3's inputs
        phase_path(results, probe, warm, "marlin", phase,
                   "the warm prove's first stream MSM's inputs")
        open3 = ProbeInputs({k: v for k, v in probe.last.items()
                             if k[1] == form}, probe.finishes[-1:])
        phase_path(results, open3, warm, "marlin-open3", phase,
                   "the warm prove's open3 MSM's inputs")
        probe.finishes.clear()


class ProbeInputs:
    """Kernel inputs for phase_path, as a LaunchProbe holds them: `first`
    {(kernel, curve name): (ECCtx, args)} and `firsts` [(StreamMSMCtx,
    finish args)]."""

    def __init__(self, first, firsts):
        self.first, self.firsts = first, firsts


def phase_marlin_chain(dev=None, phase=8):
    """The real mnt4_marlin PCD chain through the universal setup
    (reference tests/mnt4_marlin.rs:141-204); K1 and K4 must run on both
    curves' G1, no kernel on G2 (Marlin has no G2 MSM)."""
    from pcd_tpu_torch import configs
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.pcd.api import FpPredicate
    from pcd_tpu_torch.snark.marlin.native import MarlinBound
    from pcd_tpu_torch.utils.rng import ChaChaRng

    class Counter(FpPredicate):
        PRIOR_MSG_LEN = 1

        def generate_constraints(self, cs, msg, wit, priors, base):
            (priors[0] + wit).enforce_equal(msg)

    secs = {}
    pcd = configs.mnt4_marlin(dev)
    dev = pcd.ic.main_snark.device
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    F = pcd.ic.main_field
    pred = Counter(F)
    rng = ChaChaRng(b"chip smoke mnt4_marlin")
    ec.reset_launch_counts()                       # the Marlin chain starts
    t0 = time.perf_counter()
    pp = pcd.universal_setup(MarlinBound(max_degree=16), rng)
    secs["universal_setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk, vk = pcd.index(pp, pred, rng)
    secs["index"] = time.perf_counter() - t0
    one, two = F.from_int(1), F.from_int(2)
    t0 = time.perf_counter()
    p1 = pcd.prove(pk, pred, one, one, [], [], rng)
    sync(dev)
    secs["prove_base"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2 = pcd.prove(pk, pred, two, one, [one], [p1], rng)
    sync(dev)
    secs["prove_step2"] = time.perf_counter() - t0
    counts = counter()                             # the chain ended
    t0 = time.perf_counter()
    ok = (pcd.verify(vk, pred, one, p1), pcd.verify(vk, pred, two, p2))
    secs["verify_both"] = time.perf_counter() - t0
    if not all(ok):
        raise AssertionError(f"mnt4_marlin chain proofs do not verify {ok}")
    if pcd.verify(vk, pred, one, p2):
        raise AssertionError("mnt4_marlin: negative check accepted an old "
                             "message")
    cyc = pcd.ic.cycle
    for c in (cyc.main.g1, cyc.help.g1):
        for k in ("madd_accumulate", "bucket_finish"):
            if counts.get((k, c.name), 0) <= 0:
                raise AssertionError(f"{k}[{c.name}] not launched on the "
                                     f"mnt4_marlin chain")
    for c in (cyc.main.g2, cyc.help.g2):
        if any(f == c.name for _, f in counts):
            raise AssertionError(f"a kernel launched on {c.name}")
    say(phase, "mnt4_marlin chain (universal setup) on "
               f"{dev}: " + ", ".join(f"{k} {v:.1f}s"
                                      for k, v in secs.items())
        + "; base and step 2 verify, negative check rejects; launches "
        + json.dumps({f"{k}[{f}]": v for (k, f), v in sorted(counts.items())}))


def main(argv):
    phases = {1, 2, 3, 4, 6, 7, 9}
    if "--phases" in argv:
        asked = {int(x) for x in argv[argv.index("--phases") + 1].split(",")}
        if asked - phases - {8} or (8 in asked and asked - {1, 8}):
            print(f"chip_smoke: phases to choose: 1, 2, 3, 4, 6, 7, 9, or "
                  f"8 alone (5 runs with 4 and 6); asked {sorted(asked)}",
                  file=sys.stderr)
            return 2
        phases = asked | {1}
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
    card = phase_build()
    k3 = phase_kernels() if 2 in phases else []
    results += k3
    if 3 in phases:
        phase_msm()
    if 9 in phases:                # before the chains: they run it too
        t0 = time.perf_counter()
        phase_devsched(results)
        say(9, f"device scheduler: {time.perf_counter() - t0:.1f}s")
    chain_counts = []
    for ph in sorted(set(CHAINS) & phases):
        for name in CHAINS[ph]:
            t0 = time.perf_counter()
            counts, probe, took = phase_chain(
                name, ph, turns=SCHED_TURNS if ph == 4 else ())
            chain_counts.append(counts)
            if took is not None:   # sched_digits' launches on the path
                for rec in results:
                    if rec["name"].startswith("sched_digits["):
                        rec["launches"] = took[1]
            phase_path(results, probe, counts, name, 5 if ph == 4 else ph)
            say(ph, f"{name}: {time.perf_counter() - t0:.1f}s with its "
                    f"first-launch kernel checks")
    if 7 in phases:
        t0 = time.perf_counter()
        phase_marlin(results)
        say(7, f"Marlin on both curves: {time.perf_counter() - t0:.1f}s "
               f"with its kernel checks")
    if 8 in phases:
        phase_marlin_chain()
    for rec in k3:                 # K2's, K3's launches on the chains run
        kernel, form = rec["name"][:-1].split("[")
        rec["launches"] = (sum(c.get((kernel, form), 0)
                               for c in chain_counts)
                           if chain_counts else None)
    say("all", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
