#!/usr/bin/env python3
"""Drive pcd_tpu_torch on an NVIDIA card and hold its kernels to their
plain versions.  Run from the root of a checkout with one CUDA card:

    python3 chip_smoke.py                # phases 1-7 and 9-12
    python3 chip_smoke.py --phases 1,6   # a subset of 1-4, 6, 7, 9-12
    python3 chip_smoke.py --phases 8     # the real Marlin chain (hours)

Phases, one output line each, then a `kernels` JSON line and the final
status line:
  1  card and build: nvidia-smi's name and power limit; the C++ host tier
     (g++) and the CUDA kernels (one nvcc per source, the device
     scheduler's P1 and P2 and the quotient's K5-K7 too) built in parallel
     from the checkout, with ptxas' register and spill report;
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
     once per commitment MSM, K4 once per commitment MSM, K2 and K3
     never; the setup under msm_dispatch.KEYGEN's default: K8 on every
     G1 and G2 form under "device", never under "host";
     then base case and step 2 once more through PipelinedChainProver
     (parallel/pipeline.py: the help prove on a worker thread), both
     verified, the negative check rejected, K1 and K4 once per commitment
     MSM of its four proves;
     CUDA-event device time of every launch of the warm step, of the
     whole finish (StreamMSMCtx._finish), and of the warm step's finishes
     replayed through K4 and through finish_steps in turns; then six more
     warm steps, the scheduler (msm_dispatch.SCHEDULER) forced in three
     adjacent host/device pairs, alternating which runs first, each step
     with K1 and K4 exactly once per commitment MSM (each P1 kernel and
     the P2 kernel twice a prove under "device", never under "host"),
     the last proof of each verified; per scheduler the medians and
     ranges of the step, stream_dispatch, stream_dispatch_h, the MSM
     collect (groth16/msm) and the schedule spans (no verdict: the
     default follows the MSM's device); then one untimed warm step under
     the device quotient (its set-up) and ten warm steps with the
     quotient tier (msm_dispatch.QUOTIENT) in five such pairs, K5, K6 and
     K7 launched under "device" only (K5 once a pass of hpoly's three
     transforms, K7 twice a field for Groth16 and four times for GM17:
     the quotient's scalings run in K5), with the same medians (and the
     h_poly, matvec and hpoly spans) and the verdict: "device" when its
     step is shorter in at least nine tenths of the pairs and its median
     shorter than the host's by more than the host steps' interquartile
     distance; then one warm step under each quotient tier inside
     device_trace (torch.profiler; chiprun_out/device_trace/), the
     scheduler the default's, with the card's busy and idle shares of
     the step and each P1 and P2 kernel's launches and kernel time in it;
  5  each kernel again on the inputs of its first launch in the warm step
     (K1 and K4: the a-query or b_g2 MSM), exactly against its plain
     version, with CUDA-event times, K4 beside finish_steps on the same
     inputs: these are the numbers of the `kernels` line; and each P1
     kernel and P2 on the inputs of their first launch at each scalar
     count of the warm step (the provers' z and h, most with a partial
     last P1 tile), exactly against their plain versions, P1 and P2
     timed.  Runs after every chain of phases 4 and 6, on that chain's
     inputs, and cannot be chosen alone;
  6  phases 4 and 5 for the real-cycle GM17 chain mnt4_gm17 and the
     mixed chains mnt4_mix_groth16_gm17 and mnt4_mix_gm17_groth16, each
     at full width; K1 exactly once per commitment MSM of either SNARK;
     each chain then one more warm step under the device quotient, which
     verifies, K5-K7 launched as in phase 4;
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
     round-1 commit and of its open3 MSM; the AHP's transforms (fft_any,
     from 16,384 points up) on K5: 9 an index and 8 a prove, each of the
     index's and the cold prove's equal to the host path's, K5 once a pass
     and K7 twice a transform; K5's plans of Marlin's domains, each pass
     of Marlin's ifft and K7's conversions exactly against their plain
     versions, with CUDA-event ms; on the main side two more warm proves,
     the transforms on the host and on K5 in one pair of turns, with the
     three ifft spans and fft_any's encode, transform and decode; the
     universal setup's K8 launches (one under KEYGEN "device");
  9  the device scheduler (ops/msm_stream_dev.py) at c = 12, L = 8192:
     a 2^18-point MNT4 G1 MSM and a 2^16-point MNT4 G2 MSM, dense and
     low-entropy scalars (digits in two windows only), each equal to the
     C++ Pippenger with K1, K4 and each P1 and P2 kernel launched once,
     P1 (order with each digit's sign in bit 31, signs, counts) exactly
     equal to the plain P1 (the digits, a stable torch.sort and a
     searchsorted), and the P2 kernel (p2_place, one launch) exactly
     equal to its plain version and to place_plain (the torch-ops law)
     on the same inputs; the G1 schedules equal the host
     placement law (the numpy schedule at the device's T) and the
     low-entropy ones leave the empty windows out; on the dense G1
     scalars each P1 kernel exactly against its plain version on the
     same inputs, with CUDA-event ms, bound and library call, P1's
     CUDA-event ms against its bound and the torch sort and searchsorted,
     and the P2 kernel's against its bound by bytes (the bound of the
     design before, which read the signs, beside it) and the torch-ops
     placement's; the schedule's CUDA-event ms
     (upload to placement, the histogram fetch included) against the C++
     schedule's wall ms, in turns, and split by events between its
     stages (upload, P1, histogram fetch with _pick_shapes, P2, and what
     is left);
 10  the device quotient, after phase 4: K5 (every pass of a forward
     transform, its passes and tile printed, at most 3 launches a
     transform in every direction; every prologue x epilogue
     instantiation on the first pass and the epilogues on the last; the
     three transforms of hpoly) and K7 (every op) exactly against their
     plain versions on the four real domains, random inputs from a
     seed: MNT4-298 Fr at 225,792 (Groth16 main) and 688,128 (GM17 main)
     points, MNT6-298 Fr at 31,360 and 107,520; K6 on the three real
     Groth16 matrices of phase 4's pk, main and help, against its plain
     version and the C++ matvec on the z of a host-quotient warm step,
     with each matrix's row lengths, warp rows and share of unit
     entries; the device h equal to that step's C++ hpoly h, main and
     help; ptxas' registers for K5 (each instantiation; a spill fails)
     and K6; CUDA-event ms per kernel and per quotient, and each
     quotient's kernel time from a torch.profiler trace
     (utils/profiling.device_trace), each bound also by the count of
     every entry and of r - 1 products at every level.  Without phase 4
     only the first part runs;
 11  the device keygen, inside phase 1 once K8's source has built, while
     the other kernels still build (K4's nvcc alone takes minutes; the
     host timings below share the host with it), before the chains: K8
     (csrc/fixed_base.cu) on 2^14 scalars of each of the four forms (0, 1,
     r - 1, all-0xFF low windows, the integers whose top window wraps onto
     +-T so that the last add doubles or cancels, random ones), exactly
     against its plain version and, as affine points, against the C++
     fixed-base, with CUDA-event ms, plain ms, its launch shape (splits a
     scalar, lanes an add, scalars a tile), registers, stack and ptxas'
     lines, and the bound by the fewest partial products (K3's small-a
     mixed add, one batched inversion), the kernel's own count beside it;
     then K8's CUDA-event ms and bound at each form's KEYGEN_LOG_N
     scalars, the setups' size (no plain version there: the fb_mul turns
     hold those points to the host's);
     then msm_dispatch.fb_mul under KEYGEN "host" and "device" in three
     adjacent pairs of turns (2^18 MNT4 G1 scalars, 2^16 of the others),
     the same points from both, the device's wall split into digits,
     upload, kernel, download and point objects, and the verdict:
     "device" when its fb_mul is shorter in every pair of every form;
 12  the sharded prover (parallel/), after phase 4 on its pk (alone, it
     sets mnt4_groth16 up itself): at world size 1 under NCCL
     (parallel/mesh.make_mesh), `.dist` on both Groth16 provers, a warm
     step from the same ChaCha seed as an unsharded one, then two more
     (the first builds the shards' tables, matrices and roots); the
     proofs byte-equal, the sharded step verified and the negative check
     rejected, K1 and K4 exactly once per commitment MSM, K5 once a pass
     of the three 4-step transforms' n1 and n2 transforms, K6 once a
     matrix and K7 eight times a field; the steps' seconds, with no
     verdict (one card); then two gloo ranks, threads of this process
     sharing the card: sharded stream MSMs of 2^14 + 3 MNT4 G1 and 2^12 +
     1 MNT6 G2 points against the C++ Pippenger on both ranks, K1 and K4
     once a rank, and DistHPoly on MNT4-298's Fr at n = 2^12 3 against
     the single-card hpoly on the same evaluations;
  8  (only when asked for alone) the real mnt4_marlin PCD chain through
     the universal setup (reference tests/mnt4_marlin.rs:141-204):
     universal setup, index, base case, step 2, both verified, and the
     negative check.  Hours of host work: never in the default run.
Phase 1 always runs, phase 11 inside it, phase 9 after phase 3, before
the chains, and phases 10 and 12 between phases 4 and 6.  K8's records come from
phase 11; their `launches` are the setups' (phases 4, 6 and 7).  K2's and K3's records come from phase
2; their `launches` sum their launches over the chains run (null when
none ran).  The P1 and P2 kernels' records come from phase 9; their
`launches` sum their launches on the main paths (base case and warm
step) of the chains run (phase 9's own when none ran).  K5-K7's records come from phase 10; their `launches`
are those of a device-quotient warm step of their chain (mnt4_groth16's
from phase 4, mnt4_gm17's from phase 6; null when it did not run).
Phases 4, 6 and 7 set up under msm_dispatch.KEYGEN's default, and
their main paths run SCHEDULER's and QUOTIENT's.
Any failure exits non-zero without the final line.  Nothing here imports
JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
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
# schedules (P1s under the device scheduler) per prove of either SNARK:
# one for the z-driven MSMs, which share it, and one for h
P1_PER_PROVE = 2
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
    # the elementwise G2 add (_add_pallas_T of EC32ExtCtx.add), whose
    # finish use K4 took
    ("complete_add", 2): "pcd_tpu/ops/ec32.py:1003",
    ("complete_add", 3): "pcd_tpu/ops/ec32.py:1003",
    ("madd", 1): "pcd_tpu/ops/ec32.py:620",
    # no Pallas site: the XLA program of DevSchedMSM._p1 (lines 67-118):
    # its digit glue, argsort and searchsorted
    ("p1_digits", 0): "pcd_tpu/ops/msm_stream_dev.py:80",
    ("p1_hist", 0): "pcd_tpu/ops/msm_stream_dev.py:116",
    ("p1_scan", 0): "pcd_tpu/ops/msm_stream_dev.py:116",
    ("p1_scatter", 0): "pcd_tpu/ops/msm_stream_dev.py:112",
    # no Pallas site: the placement of DevSchedMSM._p2 (lines 171-196 and
    # 227-229), and its per-round ranks and signed rows (210-216)
    ("p2_place", 0): "pcd_tpu/ops/msm_stream_dev.py:172, "
                     "pcd_tpu/ops/msm_stream_dev.py:210",
    # no Pallas site: the device quotient's XLA programs
    ("ntt_pass", 0): "pcd_tpu/ops/fft_tensor.py:74",
    ("spmv_rows", 0): "pcd_tpu/ops/matvec_tensor.py:77",
    ("fp_vec", 0): "pcd_tpu/snark/groth16/native.py:497, "
                   "pcd_tpu/ops/fft_tensor.py:111",
    # no Pallas site: the XLA program of FixedBaseDevice.mul_digits
    ("fixed_base_mul", 1): "pcd_tpu/ops/fixed_base.py:63",
    ("fixed_base_mul", 2): "pcd_tpu/ops/fixed_base.py:63",
    ("fixed_base_mul", 3): "pcd_tpu/ops/fixed_base.py:63",
}
SOURCES = {"madd_accumulate": "pcd_tpu_torch/csrc/madd_accumulate.cu",
           "complete_add": "pcd_tpu_torch/csrc/complete_add.cu",
           "madd": "pcd_tpu_torch/csrc/madd.cu",
           "bucket_finish": "pcd_tpu_torch/csrc/bucket_finish.cu",
           "p1_digits": "pcd_tpu_torch/csrc/sched_digits.cu",
           "p1_hist": "pcd_tpu_torch/csrc/sched_digits.cu",
           "p1_scan": "pcd_tpu_torch/csrc/sched_digits.cu",
           "p1_scatter": "pcd_tpu_torch/csrc/sched_digits.cu",
           "p2_place": "pcd_tpu_torch/csrc/sched_place.cu",
           "ntt_pass": "pcd_tpu_torch/csrc/ntt.cu",
           "spmv_rows": "pcd_tpu_torch/csrc/spmv.cu",
           "fp_vec": "pcd_tpu_torch/csrc/fp_vec.cu",
           "fixed_base_mul": "pcd_tpu_torch/csrc/fixed_base.cu"}
# phase 4's extra warm steps: the stream-MSM scheduler of each, then the
# quotient tier of each, in turns of adjacent pairs
SCHED_TURNS = ("host", "device", "device", "host", "host", "device")
QUOTIENT_TURNS = ("host", "device", "device", "host", "host", "device",
                  "device", "host", "host", "device")
# phase 11: K8 on 2^K8_LOG_N scalars a form, then msm_dispatch.fb_mul in
# KEYGEN_TURNS (three adjacent host/device pairs) on 2^18 MNT4 G1 scalars
# and 2^16 of each other form
K8_LOG_N = 14
KEYGEN_TURNS = ("host", "device", "device", "host", "host", "device")
KEYGEN_LOG_N = {"mnt4_298.G1": 18, "mnt4_298.G2": 16, "mnt6_298.G1": 16,
                "mnt6_298.G2": 16}


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


# about 10 ms of a spinning kernel on the card: device_ms(queued=True)
# enqueues the timed calls behind it
QUEUE_CYCLES = 20_000_000


def device_ms(fn, reps, dev, warm=True, queued=False):
    """Mean time of fn: CUDA events on the card (host clock elsewhere,
    for rehearsals).  queued: the calls are enqueued behind a spinning
    kernel, so the events time the card's work back to back and not the
    host's pace of launching; raises if the card ran dry before the last
    call was enqueued."""
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
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    if queued and a.query():   # the spin ended before the last call
        raise RuntimeError("device_ms: the card ran dry while the calls "
                           "were enqueued; raise QUEUE_CYCLES")
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_ms(fn, logdir, launches=None, reps=5):
    """Device time of one fn() in ms: the busy time of the kernels in a
    torch.profiler trace (utils/profiling.device_trace), so host gaps
    between launches and copies do not count.  The trace holds 1 + reps
    calls of the same work, as the profiler may drop a kernel's record;
    the last reps x `launches` kernels recorded are summed (`launches`
    None: the kernels recorded over 1 + reps, rounded down; None when
    fewer were recorded)."""
    import torch

    from pcd_tpu_torch.utils.profiling import device_trace

    fn()
    torch.cuda.synchronize()
    with device_trace(logdir):
        for _ in range(1 + reps):
            fn()
        torch.cuda.synchronize()
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") == "kernel")
    if launches is None:
        launches = len(kern) // (1 + reps)
    if not launches or len(kern) < reps * launches:
        print(f"kernel_ms: {len(kern)} kernels in {logdir}, "
              f"{(1 + reps) * launches} launched: not measured", flush=True)
        return None
    busy, end = 0.0, None
    for a, b in kern[len(kern) - reps * launches:]:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3 / reps


def phase_build(meanwhile=None):
    """nvidia-smi's line, the CUDA kernels' builds started (ops/kernels.py:
    one nvcc a source, each library loadable as soon as its own ends),
    the C++ host tier built meanwhile, then `meanwhile()` (phase 11,
    whose K8 builds in a fraction of K4's time) while the rest build; the
    build report once every nvcc has ended.  Returns (the card's line,
    what meanwhile returned)."""
    from pcd_tpu_torch import native
    from pcd_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.build(wait=False)
    try:
        if not native.available():
            raise RuntimeError("the C++ host tier failed to build")
        t_cpp = time.perf_counter() - t0
        out = meanwhile() if meanwhile is not None else None
    finally:
        info = kernels.build()       # every nvcc ended, or raises
    t_all = max([t_cpp] + [rec["seconds"] for rec in info.values()])
    for name, rec in info.items():
        for line in rec["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "Function properties")):
                say(1, f"{name}: {line.strip()}")
    say(1, f"built C++ tier {t_cpp:.1f}s + " + ", ".join(
        f"{n} {rec['seconds']:.1f}s" for n, rec in info.items())
        + f" in {t_all:.1f}s wall"
        + (", phase 11 meanwhile" if meanwhile is not None else ""))
    return card, out


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
    (check_finish).  Returns the `kernels` records of K2 and K3, with
    their group size, registers, spills and resident blocks printed."""
    import numpy as np
    import torch

    from pcd_tpu_torch.ops.ec import ec_ctx

    dev = torch.device(dev)
    rng = np.random.default_rng(2026)
    records = []
    for form, cfg, which in form_cases():
        ec = ec_ctx(getattr(cfg, which))
        D = ec.d
        table, perm, loads = k1_inputs(ec, cfg, which, rng, dev, nwin, T, L,
                                       m)
        got = ec.madd_accumulate(table, perm, loads)
        want = ec.madd_accumulate_plain(table, perm, loads)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {form}: kernel != plain")
        ms = device_ms(lambda: ec.madd_accumulate(table, perm, loads), 5, dev)
        say(2, f"K1 madd_accumulate {form}: exact on {nwin}x{L} lanes, "
               f"T={T}; {ms:.3f} ms")
        # K2 on pairs built from K1's projective outputs
        P, Q, k = pair_inputs(ec, got)
        n = P.shape[0]
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
        rcb, own = MULS_ADD * PRODUCTS[D], own_products("complete_add", ec)
        rec = record("complete_add", form, D, 0, ms, plain_ms,
                     3 * P.numel() * 4, n * min(rcb, own) * 2)
        records.append(rec)
        say(2, f"K2 complete_add {form}: exact on {n} pairs; {ms:.3f} ms, "
               f"{bound_text(rec, n, own, rcb)}, plain {plain_ms:.0f} ms; "
               f"{geometry('complete_add', ec)}")
        if which == "g1":
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
    from pcd_tpu_torch.ops.fixed_base import raw_fixed_base
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx

    curve, gen = getattr(cfg, which), getattr(cfg, which + "_gen")
    xs, ys, inf = raw_fixed_base(gen, [int(s) for s in rng.integers(
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
    n = acc0.shape[0]
    acc, q, sign, active, idx, sign_np, act_np, k = madd_inputs(
        ec, table, acc0, rng)
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
    adds = int(live.sum())
    rcb, own = MULS_MADD * PRODUCTS[1], own_products("madd", ec)
    rec = record("madd", form, 1, err, ms, plain_ms, nbytes,
                 adds * min(rcb, own) * 2)
    say(2, f"K3 madd {form}: exact against plain and K1 at T = 1 on {n} "
           f"rows ({adds} mixed adds); {ms:.3f} ms, "
           f"{bound_text(rec, adds, own, rcb)}, plain {plain_ms:.0f} ms; "
           f"{geometry('madd', ec)}")
    return rec


def k1_inputs(ec, cfg, which, rng, dev, nwin=25, T=8, L=8192, m=4096):
    """K1's phase-2 operands: a table of m real points (C++ fixed-base,
    64 rows flagged infinity), nwin x T x L random rows and signs, loads
    uniform in 0..T with every seventh lane's 0.  Returns (table, perm,
    loads) on dev."""
    import numpy as np
    import torch

    from pcd_tpu_torch.ops.fixed_base import raw_fixed_base

    gen = getattr(cfg, which + "_gen")
    xs, ys, inf = raw_fixed_base(gen, [int(s) for s in rng.integers(
        1, 1 << 62, m)], cfg.Fr.BITS)
    inf[rng.choice(m, 64, replace=False)] = True      # flagged rows
    table = torch.from_numpy(ec.table_from_u64(xs, ys, inf)).to(dev)
    perm = (rng.integers(0, m, (nwin, T, L), dtype=np.int64)
            | (rng.integers(0, 2, (nwin, T, L), dtype=np.int64) << 31))
    perm = torch.from_numpy(perm.astype(np.uint32).view(np.int32)).to(dev)
    loads_np = rng.integers(0, T + 1, (nwin, L)).astype(np.int32)
    loads_np[:, ::7] = 0                               # zero loads
    return table, perm, torch.from_numpy(loads_np).to(dev)


def pair_inputs(ec, acc):
    """K2's phase-2 operands from K1's (..., 3, d, 10) outputs: P those
    points, Q a shuffle of them with P = Q in the first sixteenth, P = -Q
    in the second, Q = O in the third and P = O in the fourth.  Returns
    (P, Q, a sixteenth)."""
    import torch

    dev = acc.device
    P = acc.reshape(-1, 3, ec.d, 10)
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
    return P, Q, k


def madd_inputs(ec, table, acc0, rng):
    """K3's phase-2 operands on K1's n lane outputs acc0: q gathered from
    the table (its flagged rows included), mixed signs, a quarter of the
    rows inactive; a sixteenth of the accumulators the identity and a
    sixteenth Q itself (half of those with Q's sign cleared, a doubling,
    half set, P + (-P)).  Returns acc, q, sign, active and their numpy
    row indices, signs and flags, and the sixteenth."""
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
    return acc, q, sign, active, idx, sign_np, act_np, k


def own_products(kernel, ec):
    """32x32-bit partial products one add of K2 ("complete_add") or K3
    ("madd") issues in this form: an Fp^D product D (100 D + 110), the nr
    scalings 10 (D - 1); K2's one-thread body (lanes 0): 18 products,
    else the group add's count (group_products)."""
    if ec.kernel_info(kernel)["group"] == 0:
        return 18 * (ec.d * (100 * ec.d + 110) + 10 * (ec.d - 1))
    return group_products(ec.d, ec.small_a, 6 if kernel == "complete_add"
                          else 5)


def group_products(D, small_a, inputs):
    """Partial products of one add of the group add (csrc/ec_group.cuh)
    over Fp^D: `inputs` (six for the complete add, five for the mixed add)
    products of the inputs, two by 3b, four by a or a^2 (in the small-a
    form scalings of 20 D: the scaling and its quotient's multiple of p),
    and X3, Y3, Z3 each D (200 D + 110) + 20 (D - 1); an Fp^D product is
    D (100 D + 110) + 10 (D - 1)."""
    prod = D * (100 * D + 110) + 10 * (D - 1)
    sum2 = D * (200 * D + 110) + 20 * (D - 1)
    by_a = 4 * 20 * D if small_a else 4 * prod
    return inputs * prod + 2 * prod + by_a + 3 * sum2


def bound_text(rec, adds, own, rcb):
    """K2's or K3's bound as phase 2 prints it: by the fewer of the
    kernel's own partial products an add and RCB15's count (18 or 17
    Fp^D products of PRODUCTS each), and the time RCB15's count alone
    would bound, over `adds` adds."""
    rcb_ms = adds * rcb * 2 / INT32_MAD_PER_S * 1e3
    return (f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{min(own, rcb)} partial products an add: own {own}, RCB15's "
            f"{rcb}, which bounds at {rcb_ms:.4f} ms)")


def geometry(kernel, ec):
    """K2's or K3's group, block, registers, local bytes and resident
    blocks per SM in this form's instantiation, with ptxas' spill line."""
    from pcd_tpu_torch.ops import kernels

    g = ec.kernel_info(kernel)
    key = (f"{kernel}_kernelILi{ec.d}ELb{int(ec.small_a)}E" if g["group"]
           else f"{kernel}_oneILi{ec.d}E")
    spill = ptxas_lines(kernels.BUILD_INFO.get(kernel, {}).get("ptxas", ""),
                        key)
    lanes = (f"{g['group']} lane{'s' * (g['group'] > 1)} an add"
             if g["group"] else "one thread an add (rcb_add)")
    return (f"{lanes}, {g['threads']} threads a block "
            f"(min {g['min_blocks']}), {g['registers']} registers, "
            f"{g['local_bytes']} local bytes, {g['smem_bytes']} shared "
            f"bytes a block, {g['blocks_per_sm']} blocks per SM"
            + (f"; ptxas: {spill}" if spill else ""))


def ptxas_lines(log, key):
    """ptxas' spill and register lines of the entry whose mangled name
    holds `key` ("" if the log has none)."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" \
                in line:
            on = key in line
            continue
        if on and ("spill" in line or "registers" in line):
            out.append(line.strip())
    return "; ".join(dict.fromkeys(out))


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
    """raw_fixed_base's arrays as the C++ tier's EncodedPoints (no host point
    objects), for native.msm."""
    import numpy as np

    enc = object.__new__(native.EncodedPoints)
    enc.curve = curve
    enc.handle, enc.deg, _ = native.curve_handle(curve)
    enc.xs, enc.ys, enc.inf, enc.n = xs, ys, inf.astype(np.uint8), len(xs)
    return enc


def k8_scalars(r, nwin, n, rng):
    """n scalars for K8's exactness: 0, 1, r - 1, every low byte 0xFF
    (with and without a top digit), the integers below 2^(8 nwin) whose
    top window wraps onto +-T[top][d] (the last add doubles or cancels),
    then random ones below r."""
    top = 8 * (nwin - 1)
    low = (1 << top) - 1
    wraps = [lo + (d << top) for d in range(1, 256)
             for lo in ((d << top) % r, (-(d << top)) % r) if lo < 1 << top]
    edge = [0, 1, r - 1, low, low + (1 << top)] + wraps
    return edge + [rng.randrange(r) for _ in range(n - len(edge))]


def fermat_products(d, p):
    """Fp products of one Fermat inversion in Fp^D: z^(p - 2)'s squarings
    and products, and at D = 2 / 3 the 4 / 12 Fp products of the norm and
    the conjugates."""
    e = p - 2
    return e.bit_length() - 1 + bin(e).count("1") - 1 + {1: 0, 2: 4, 3: 12}[d]


def k8_products(ec, p, n, nonzero, info):
    """32 x 32-bit partial products of one K8 launch, two ways.  "own":
    what the kernel issues at its launch shape `info` (FixedBaseDevice.
    kernel_info): K3's group add a nonzero digit (group_products), the
    splits' S - 1 complete group adds a scalar, a tile's product tree (3
    Fp^D products a leaf of its power-of-two tree) and one inversion (a
    binary Euclid: no products but its input's conversion and, at D = 2,
    3, the norm's 4 or 12 Fp products), then x Z^-1, y Z^-1 and the 2 D
    products by 1 out of Montgomery form.  "least": the same function at
    the fewest products this repo knows for it, the mixed add of K3's
    group add or RCB's, whichever is fewer, and the affine conversion as
    one batched inversion (3 Fp^D products a scalar and one Fermat
    inversion a launch) before the same x, y products and conversion out
    of Montgomery form."""
    d = ec.d
    tail = 2 * PRODUCTS[d] + 2 * d * PRODUCTS[1]
    ntiles = -(-n // info["tile"])
    inv = (1 + {1: 0, 2: 4, 3: 12}[d]) * PRODUCTS[1]
    own = (nonzero * group_products(d, ec.small_a, 5)
           + n * ((info["splits"] - 1) * group_products(d, ec.small_a, 6)
                  + tail)
           + ntiles * (3 * (info["tree"] - 1) * PRODUCTS[d] + inv))
    add = min(MULS_MADD * PRODUCTS[d], group_products(d, ec.small_a, 5))
    least = nonzero * add + n * (3 * PRODUCTS[d] + tail) \
        + fermat_products(d, p) * PRODUCTS[1]
    return {"own": own, "least": least}


def k8_work(fb, digits, n, nbytes_out, p):
    """K8's work on these digits: (nonzero digits, k8_products, bytes
    moved: the digits, the output and the table once)."""
    nonzero = int((digits != 0).sum())
    prods = k8_products(fb.ec, p, n, nonzero, fb.kernel_info(n))
    return nonzero, prods, digits.numel() + nbytes_out + fb.table_host.nbytes


def phase_keygen(results, dev="cuda", phase=11):
    """The device keygen (ops/fixed_base.py, K8): on the four forms, K8
    exactly against its plain version and, as affine points, against the
    C++ fixed-base on 2^K8_LOG_N scalars (k8_scalars), with CUDA-event
    ms, bound and plain ms; then msm_dispatch.fb_mul under KEYGEN "host"
    and "device" in KEYGEN_TURNS on KEYGEN_LOG_N scalars a form, the
    device's wall split into digits, upload, kernel, download and point
    objects, and the verdict: "device" when its fb_mul is shorter in every
    pair of every form.  Appends K8's records; returns them by form and
    the verdict."""
    import numpy as np
    import torch

    from pcd_tpu_torch.ops import kernels
    from pcd_tpu_torch.ops.field import NLIMB
    from pcd_tpu_torch.ops.fixed_base import fixed_base_device, raw_fixed_base
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.utils import profiling

    dev = torch.device(dev)
    rng = random.Random(11)
    kernels.lib("fixed_base")      # its build ended (the others may not)
    log = kernels.BUILD_INFO.get("fixed_base", {}).get("ptxas", "")
    recs = {}
    for form, cfg, grp in form_cases():
        curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
        r, bits = cfg.Fr.MODULUS, cfg.Fr.BITS
        t0 = time.perf_counter()
        fb = fixed_base_device(curve, gen, bits)
        fb.table(dev)
        t_tbl = time.perf_counter() - t0
        d, n = fb.ec.d, 1 << K8_LOG_N
        sc = k8_scalars(r, fb.nwin, n, rng)
        digits = torch.from_numpy(fb.digits_from_ints(sc)).to(dev)
        out = fb.mul_digits(digits)
        sync(dev)
        want, plain_ms = timed_plain(lambda: fb.mul_digits_plain(digits),
                                     dev)
        if not torch.equal(out, want):
            raise AssertionError(f"K8 {form}: kernel != plain")
        # as affine points against the C++ tier's fixed-base of s mod r
        xs, ys, inf = raw_fixed_base(gen, [s % r for s in sc], bits)
        got = np.ascontiguousarray(out.cpu().numpy()).view(np.uint32)
        ginf = (got[:, 0, 0, NLIMB - 1] >> 31).astype(bool)
        got[:, 0, 0, NLIMB - 1] &= 0x7FFFFFFF
        got = got.reshape(n, 2, -1).view("<u8")
        if not (np.array_equal(ginf, inf) and np.array_equal(
                got[~inf, 0], xs[~inf]) and np.array_equal(
                got[~inf, 1], ys[~inf]) and not got[inf].any()):
            raise AssertionError(f"K8 {form}: != the C++ fixed-base")
        ms = device_ms(lambda: fb.mul_digits(digits), 5, dev)
        p = curve.F.prime_subfield().MODULUS
        nonzero, prods, nbytes = k8_work(fb, digits, n, out.numel() * 4, p)
        rec = record("fixed_base_mul", form, d, 0, ms, plain_ms, nbytes,
                     2 * prods["least"])
        own_ms = 2 * prods["own"] / INT32_MAD_PER_S * 1e3
        results.append(rec)
        recs[form] = rec
        info = fb.kernel_info(n)
        say(phase, f"K8 fixed_base_mul {form}: {n} scalars ({fb.nwin} "
                   f"windows, {nonzero} nonzero digits, {int(inf.sum())} "
                   f"identities; 0, 1, r - 1, 0xFF low windows and the top "
                   f"window's wraps) exact against plain and == the C++ "
                   f"fixed-base "
                   f"as affine points; {ms:.4f} ms, bound "
                   f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                   f"{rec['bound_ms'] / ms:.1%}; partial products: least "
                   f"{prods['least']}, the kernel's own {prods['own']}, "
                   f"which bound at {own_ms:.4f} ms, {own_ms / ms:.1%}), "
                   f"plain {plain_ms:.0f} ms; table {t_tbl:.2f}s; shape "
                   + json.dumps(info) + "; ptxas: "
                   + ptxas_lines(log, f"fixed_base_kernelILi{d}ELb"
                                      f"{int(fb.ec.small_a)}E"))
    # K8 at the setups' size: the fb_mul turns below hold its points
    for form, cfg, grp in form_cases():
        curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
        fb = fixed_base_device(curve, gen, cfg.Fr.BITS)
        n = 1 << KEYGEN_LOG_N[form]
        digits = torch.from_numpy(fb.digits_from_ints(
            [rng.randrange(cfg.Fr.MODULUS) for _ in range(n)])).to(dev)
        ms = device_ms(lambda: fb.mul_digits(digits), 3, dev)
        nonzero, prods, nbytes = k8_work(
            fb, digits, n, n * 2 * fb.ec.d * NLIMB * 4,
            curve.F.prime_subfield().MODULUS)
        big = record("fixed_base_mul", form, fb.ec.d, 0, ms, None, nbytes,
                     2 * prods["least"])
        own_ms = 2 * prods["own"] / INT32_MAD_PER_S * 1e3
        say(phase, f"K8 fixed_base_mul {form} at the setups' size, 2^"
                   f"{KEYGEN_LOG_N[form]} random scalars ({nonzero} nonzero "
                   f"digits; launch " + json.dumps(
                       {k: v for k, v in fb.kernel_info(n).items()
                        if k in ("splits", "tile", "grid")})
                   + f"): {ms:.4f} ms CUDA events, bound "
                   f"{big['bound_ms']:.4f} ms ({big['bound_by']}, "
                   f"{big['bound_ms'] / ms:.1%}; the kernel's own count "
                   f"{own_ms:.4f} ms, {own_ms / ms:.1%})")
        del digits
    # fb_mul in turns: KEYGEN's verdict, from the scalars to host points
    default = msm_dispatch.KEYGEN
    shorter, summary = [], {}
    try:
        for form, cfg, grp in form_cases():
            n = 1 << KEYGEN_LOG_N[form]
            r, bits = cfg.Fr.MODULUS, cfg.Fr.BITS
            sc = [rng.randrange(r) for _ in range(n)]
            walls = {"host": [], "device": []}
            first = {}
            profiling.reset()
            profiling.enable()
            for tier in KEYGEN_TURNS:
                msm_dispatch.KEYGEN = tier
                t0 = time.perf_counter()
                pts = msm_dispatch.fb_mul(cfg, grp, sc, bits, dev)
                walls[tier].append(time.perf_counter() - t0)
                if tier not in first:
                    first[tier] = pts
                del pts
            profiling.enable(False)
            tot = profiling.totals()
            parts = {part: sum(v[0] for k, v in tot.items()
                               if k.endswith(f"fixed_base/{part}"))
                     for part in ("digits", "upload", "kernel", "download",
                                  "points")}
            if first["host"] != first["device"]:
                raise AssertionError(f"fb_mul {form}: the tiers' points "
                                     f"differ")
            first.clear()
            pairs = [KEYGEN_TURNS[i:i + 2]
                     for i in range(0, len(KEYGEN_TURNS), 2)]
            it = {"host": iter(walls["host"]), "device": iter(walls["device"])}
            wins = 0
            for pair in pairs:
                t = {k: next(it[k]) for k in pair}
                wins += t["device"] < t["host"]
            shorter.append(wins == len(pairs))
            summary[form] = {k: [round(v, 4) for v in w]
                             for k, w in walls.items()}
            say(phase, f"fb_mul {form} on 2^{KEYGEN_LOG_N[form]} scalars, "
                       f"turns {'/'.join(KEYGEN_TURNS)}: host "
                       f"{summary[form]['host']} s, device "
                       f"{summary[form]['device']} s (same points); device "
                       f"shorter in {wins} of {len(pairs)} pairs; device "
                       f"parts (spans), mean s: " + json.dumps(
                           {k: round(v / len(walls["device"]), 4)
                            for k, v in parts.items()}))
    finally:
        profiling.enable(False)
        profiling.reset()
        msm_dispatch.KEYGEN = default
    verdict = "device" if all(shorter) else "host"
    say(phase, f"KEYGEN verdict: device shorter in every pair on "
               f"{sum(shorter)} of {len(shorter)} forms: {verdict!r}; "
               f"default {default!r}")
    if verdict != default:
        say(phase, f"note: the verdict {verdict!r} is not "
                   f"msm_dispatch.KEYGEN's default {default!r}")
    return recs, verdict


def phase_msm(dev="cuda", log_n=18):
    """2^18 MNT4 G1 stream MSM against the C++ Pippenger."""
    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops.fixed_base import raw_fixed_base
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx

    dev = torch.device(dev)
    cfg = M.mnt_cycle().main
    n = 1 << log_n
    rng = np.random.default_rng(18)
    r = cfg.Fr.MODULUS
    t0 = time.perf_counter()
    xs, ys, inf = raw_fixed_base(cfg.g1_gen, [int(s) for s in
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


def p1_exact(dm, W, what):
    """P1 on W against its plain version (order, signs, counts), element
    for element; returns P1's result."""
    import torch

    got = dm.p1(W)
    for nm, a, b in zip(("order", "signs", "counts"), got, dm.p1_plain(W)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"P1 {what}: {nm} != the plain P1")
    return got


def p1_kernels_exact(dm, W, what):
    """Each P1 kernel on the scalars W, each on its predecessor's output,
    exactly against its plain version on the same inputs (p1_scan's
    starts and counts against scan_plain's, the scatter's order against
    scatter_plain's), and the whole P1 against the plain P1.  Returns
    (mags, signs, the tiles' histogram, starts, counts, the plain
    magnitudes, the plain starts)."""
    import torch

    nwin = dm.sctx.nwin
    mags, signs = dm.digits(W)
    hist = dm.tile_hist(mags)
    hist0 = hist.clone()                       # p1_scan works in place
    starts, counts = dm.tile_scan(hist)
    order = dm.scatter(mags, signs, starts, counts)
    pm, ps = dm.digits_plain(W)
    checks = {"p1_digits": (mags.int(), pm), "p1_hist": (
        hist0, dm.hist_plain(mags))}
    ws, wc = dm.scan_plain(hist0)
    checks["p1_scan"] = (torch.cat([starts.view(nwin, -1), counts], 1),
                         torch.cat([ws.view(nwin, -1), wc], 1))
    checks["p1_scatter"] = (order, dm.scatter_plain(mags, signs, starts,
                                                    counts))
    if not torch.equal(signs, ps):
        raise AssertionError(f"p1_digits on {what}: signs != the plain "
                             f"version")
    for k, (a, b) in checks.items():
        if not torch.equal(a, b):
            raise AssertionError(f"{k} on {what} != its plain version")
    p1_exact(dm, W, what)
    return mags, signs, hist0, starts, counts, pm, ws


def p1_records(dm, W, dev):
    """Each P1 kernel on the dense scalars W: exact against its plain
    version on the same inputs, CUDA-event ms, plain ms (one call), bound
    by bytes, and a library call where one computes the same function
    (p1_hist: index_add_ of ones at the (window, tile, magnitude) keys
    into a zeroed histogram; p1_scan: torch.cumsum over the tiles, the
    inclusive scan whose difference from hist is starts and whose last
    row is counts; p1_scatter: a stable torch.sort of the magnitudes).
    Returns (the records, P1's CUDA-event ms (queued behind a spinning
    kernel, and as the host launches it), the plain P1's ms, the torch
    sort and searchsorted's ms, P1's bound in ms).  The kernels' and the
    library calls' ms are queued alike: a kernel of a few tens of
    microseconds is shorter than its wrapper's host work."""
    import torch

    from pcd_tpu_torch.ops.msm_stream_dev import P1_TILE

    s = dm.sctx
    n, nw = W.shape
    K, nt = s.B + 2, -(-n // P1_TILE)
    nwin = s.nwin
    mags, signs, hist0, starts, counts, pm, ws = p1_kernels_exact(
        dm, W, f"{n} scalars")
    scratch = hist0.clone()    # p1_scan works in place: its time on one
    # buffer, L2-warm as in P1 (the values it leaves are not checked)
    key = ((torch.arange(nwin, device=dev)[:, None] * nt
            + torch.arange(n, device=dev) // P1_TILE) * K
           + mags.to(torch.int64)).view(-1)
    ones = torch.ones_like(key, dtype=torch.int32)
    lib_hist = torch.zeros(nwin * nt * K, dtype=torch.int32,
                           device=dev).index_add_(0, key, ones)
    if not torch.equal(lib_hist.view(nwin, nt, K), hist0):
        raise AssertionError("p1_hist's library call != p1_hist")
    incl = torch.cumsum(hist0, 1, dtype=torch.int32)
    if not (torch.equal(incl - hist0, ws)
            and torch.equal(incl[:, -1], counts)):
        raise AssertionError("p1_scan's library call != p1_scan")
    m32 = pm
    timing = {
        "p1_digits": (lambda: dm.digits(W), lambda: dm.digits_plain(W),
                      None, W.numel() * 4 + nwin * n * 3),
        "p1_hist": (lambda: dm.tile_hist(mags), lambda: dm.hist_plain(mags),
                    lambda: torch.zeros(nwin * nt * K, dtype=torch.int32,
                                        device=dev).index_add_(0, key, ones),
                    nwin * n * 2 + nwin * nt * K * 4),
        "p1_scan": (lambda: dm.tile_scan(scratch),
                    lambda: dm.scan_plain(hist0),
                    lambda: torch.cumsum(hist0, 1, dtype=torch.int32),
                    nwin * nt * K * 8 + nwin * K * 4),
        "p1_scatter": (lambda: dm.scatter(mags, signs, starts, counts),
                       lambda: dm.scatter_plain(mags, signs, starts, counts),
                       lambda: torch.sort(mags, dim=1, stable=True),
                       nwin * n * 7 + nwin * nt * K * 4 + nwin * K * 4)}
    recs = []
    for k, (fn, plain, lib_fn, nbytes) in timing.items():
        ms = device_ms(fn, 10, dev, queued=True)
        _, plain_ms = timed_plain(plain, dev)
        rec = record(k, dm.form, 0, 0, ms, plain_ms, nbytes, 0)
        rec["library_ms"] = None if lib_fn is None else device_ms(
            lib_fn, 10, dev, queued=True)
        recs.append(rec)
    p1_ms = (device_ms(lambda: dm.p1(W), 10, dev, queued=True),
             device_ms(lambda: dm.p1(W), 10, dev))
    _, plain_p1 = timed_plain(lambda: dm.p1_plain(W), dev)

    def sort_hist():
        sk, _ = torch.sort(m32, dim=1, stable=True)
        return torch.searchsorted(sk, torch.arange(
            K + 1, dtype=torch.int32, device=dev).expand(nwin, -1)
            .contiguous())
    lib_ms = device_ms(sort_hist, 10, dev, queued=True)
    bound = (W.numel() * 4 + nwin * n * 5 + nwin * K * 4) \
        / HBM_BYTES_PER_S * 1e3
    return recs, p1_ms, plain_p1, lib_ms, bound


def p2_exact(dm, order, counts, act, T, what):
    """P2 on P1's (order, counts) over the active windows act at T: place
    (the P2 kernel) against its plain version and against place_plain
    (the torch-ops law), element for element."""
    import torch

    got = dm.place(order, counts, act, T)
    for nm, want in (("p2_place", dm.p2_place_plain(order, counts, act, T)),
                     ("place_plain", dm.place_plain(order, counts, act, T))):
        if any(x.dtype != y.dtype or not torch.equal(x, y)
               for x, y in zip(got, want)):
            raise AssertionError(f"P2 {what}: p2_place != {nm}")


def p2_records(dm, p1_out, act, T, dev):
    """The P2 kernel on the dense schedule (p2_exact checked it): CUDA-
    event ms queued behind a spinning kernel and as launched, plain ms
    (one call), bound by bytes: each input read once and each output
    written once, of order the entries this schedule places (the lanes'
    loads), of counts the active windows' rows; no one PyTorch call
    computes it, so library_ms is null.  Returns (the record, its ms as
    launched, place_plain's (the torch-ops law) as launched: its host
    work outlasts a queue, the bound in ms, and the bound of the design
    before, which also read each placed entry's sign byte, in ms)."""
    order, _, counts = p1_out
    s = dm.sctx
    nact, L, B = len(act), s.L, s.B
    _, loads, _, _ = dm.place(order, counts, act, T)
    live = int(loads.sum())                    # placed entries
    nbytes = (nact * (B + 1) * 4 + live * 4 + nact * T * L * 4
              + nact * B * 4 + nact * L * 8)  # perm, bidx, loads, runrem

    def place():
        return dm.place(order, counts, act, T)

    def plain():
        return dm.place_plain(order, counts, act, T)
    ms = device_ms(place, 10, dev, queued=True)
    _, plain_ms = timed_plain(lambda: dm.p2_place_plain(order, counts, act,
                                                        T), dev)
    rec = record("p2_place", dm.form, 0, 0, ms, plain_ms, nbytes, 0)
    return (rec, device_ms(place, 10, dev), device_ms(plain, 5, dev),
            rec["bound_ms"], (nbytes + live) / HBM_BYTES_PER_S * 1e3)


SCHED_STAGES = ("upload", "p1", "fetch_pick", "p2", "left")


def staged_schedule(dm, limbs, dev):
    """One device schedule as msm_dispatch runs it (the upload, then
    DevSchedMSM.schedule's steps), a CUDA event after each stage: {stage:
    ms} over SCHED_STAGES (the histogram fetch with the overflow check
    and _pick_shapes as fetch_pick; left: the DevSchedule's construction
    and return).  The host clock on the CPU."""
    import torch

    from pcd_tpu_torch.ops.msm_stream_dev import DevSchedule

    def mark():
        if dev.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    sync(dev)
    marks = [mark()]
    W = dm.upload(limbs, dev)
    marks.append(mark())
    order, signs, counts = dm.p1(W)
    marks.append(mark())
    counts_h = counts.cpu().numpy()
    if counts_h[:, -1].any():
        raise ValueError("scalar exceeds declared scalar_bits")
    act, T, maxrun = dm._pick_shapes(counts_h)
    marks.append(mark())
    tensors = dm.place(order, counts, act, T)
    marks.append(mark())
    DevSchedule(act, T, maxrun, W.device, tensors)
    marks.append(mark())
    sync(dev)
    if dev.type != "cuda":
        return {k: (b - a) * 1e3 for k, a, b in zip(SCHED_STAGES, marks,
                                                     marks[1:])}
    return {k: a.elapsed_time(b) for k, a, b in zip(SCHED_STAGES, marks,
                                                     marks[1:])}


def phase_devsched(results, dev="cuda", log_n=18, log_n2=16, phase=9):
    """The device scheduler at the chains' c = 12, L = 8192 (see the module
    docstring, phase 9).  Appends the P1 and P2 kernels' `kernels` records
    (their launches those of this phase; main() puts phase 4's there when
    it ran)."""
    import statistics

    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.ops.fixed_base import raw_fixed_base
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx
    from pcd_tpu_torch.ops.msm_stream_dev import SCHED_KERNELS, DevSchedMSM

    dev = torch.device(dev)
    # on the CPU (a rehearsal) the wrappers count plain-version calls
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    cfg = M.mnt_cycle().main
    r = cfg.Fr.MODULUS
    rng = np.random.default_rng(9)
    launches = dict.fromkeys(SCHED_KERNELS, 0)
    for grp, log in (("g1", log_n), ("g2", log_n2)):
        curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
        n = 1 << log
        xs, ys, inf = raw_fixed_base(gen, [int(s) for s in rng.integers(
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
            for k in SCHED_KERNELS:
                launches[k] += counts.get((k, dm.form), 0)
            expect = {("madd_accumulate", curve.name): 1,
                      ("bucket_finish", curve.name): 1}
            expect.update({(k, dm.form): 1 for k in SCHED_KERNELS})
            if counts != expect:
                raise AssertionError(f"devsched {curve.name} {kind}: "
                                     f"launches {counts}, expected {expect}")
            if got != want:
                raise AssertionError(f"devsched 2^{log} {curve.name} {kind} "
                                     f"MSM != C++ Pippenger")
            W = dm.upload(limbs, dev)
            what = f"2^{log} {curve.name} {kind}"
            order, _, cnt = p1_exact(dm, W, what)
            act, T, _ = dm._pick_shapes(cnt.cpu().numpy())
            p2_exact(dm, order, cnt, act, T, what)
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
            say(phase, f"{what}: device-scheduled MSM == C++ Pippenger, K1, "
                       f"K4 and each P1 and P2 kernel once; P1 == plain P1 "
                       f"(order, signs, counts); each P2 kernel == its "
                       f"plain version, place == place_plain; "
                       f"{len(sched.act)} of {sctx.nwin} windows active, "
                       f"T = {sched.T}, maxrun {sched.maxrun}" + msg)
        if grp != "g1":
            continue
        limbs = native.ints_to_limbs(dense)
        W = dm.upload(limbs, dev)
        recs, p1_ms, plain_ms, lib_ms, bound = p1_records(dm, W, dev)
        results.extend(recs)
        p1_out = dm.p1(W)
        act, T, _ = dm._pick_shapes(p1_out[2].cpu().numpy())
        rec2, launched_ms, torch_ms, bound2, old2 = p2_records(
            dm, p1_out, act, T, dev)
        results.append(rec2)
        # the schedule: C++ (host wall) against the device's (CUDA events
        # from the upload to the DevSchedule, histogram fetch included, an
        # event between each two stages), in turns
        t = {"cpp": [], "dev": [], "dev_wall": []}
        staged = []
        for who in ("cpp", "dev", "dev", "cpp", "cpp", "dev"):
            sync(dev)
            t0 = time.perf_counter()
            if who == "cpp":
                sctx.schedule_native(limbs)
                t["cpp"].append((time.perf_counter() - t0) * 1e3)
                continue
            staged.append(staged_schedule(dm, limbs, dev))
            t["dev_wall"].append((time.perf_counter() - t0) * 1e3)
            t["dev"].append(sum(staged[-1].values()))
        med = {k: statistics.median(v) for k, v in t.items()}
        split = {k: statistics.median(st[k] for st in staged)
                 for k in SCHED_STAGES}
        say(phase, f"P1[{dm.form}] on 2^{log} scalars: each kernel exact "
                   f"against its plain version; P1 {p1_ms[0]:.4f} ms CUDA "
                   f"events queued ({p1_ms[1]:.4f} ms as launched), bound "
                   f"{bound:.4f} ms (bytes, {100 * bound / p1_ms[0]:.1f}% "
                   f"of it), plain P1 "
                   f"{plain_ms:.1f} ms, torch sort + searchsorted "
                   f"{lib_ms:.4f} ms; kernels (ms): " + json.dumps(
                       {rec["name"]: [round(rec["ms"], 4),
                                      round(rec["bound_ms"], 4)]
                        for rec in recs}))
        placed = int(p1_out[2][act, 1:-1].sum())
        say(phase, f"P2[{dm.form}] on the 2^{log} dense schedule "
                   f"({len(act)} windows, T = {T}, {placed} placed "
                   f"entries): p2_place exact against its plain version "
                   f"and place_plain; {rec2['ms']:.4f} ms CUDA events "
                   f"queued ({launched_ms:.4f} ms as launched), bound "
                   f"{bound2:.4f} ms (bytes, "
                   f"{100 * bound2 / rec2['ms']:.1f}% of it; the design "
                   f"before read the signs too: {old2:.4f} ms, "
                   f"{100 * old2 / rec2['ms']:.1f}%), plain "
                   f"{rec2['plain_ms']:.2f} ms, torch-ops place "
                   f"(place_plain) {torch_ms:.4f} ms as launched")
        say(phase, f"2^{log} schedule, medians of 3 in turns: device "
                   f"{med['dev']:.3f} ms CUDA events ({med['dev_wall']:.3f} "
                   f"ms wall) vs C++ {med['cpp']:.3f} ms wall; all "
                   + json.dumps({k: [round(x, 3) for x in v]
                                 for k, v in t.items()})
                   + "; split (ms, each stage's median over the device "
                     "turns): " + json.dumps(
                         {k: round(v, 4) for k, v in split.items()})
                   + "; by turn: " + json.dumps(
                       [{k: round(v, 4) for k, v in st.items()}
                        for st in staged]))
    for rec in results:
        kernel = rec["name"].split("[")[0]
        if kernel in launches:
            rec["launches"] = launches[kernel]


class LaunchProbe:
    """While `on`, wraps the four kernel wrappers of ops/ec.py and the
    stream MSM's finish: the first call per (kernel, curve) keeps its
    inputs (K3's accumulator, which it updates in place, as a copy), every
    finish keeps its StreamMSMCtx and inputs, and every call on the card
    gets CUDA events around it on the caller's current stream (the MSM
    side stream in the prover's background thread).  It also wraps the
    device scheduler's P1 (DevSchedMSM.p1) and P2 (DevSchedMSM.place):
    the first call per (step, form, scalars) keeps a copy of its inputs.
    The wrappers' launch counters are untouched; leaving the `with`
    restores the wrappers."""

    WRAPPED = (("madd_accumulate", "madd_accumulate"),
               ("complete_add", "add"), ("madd", "madd"),
               ("bucket_finish", "bucket_finish"))

    def __init__(self):
        self.on = False
        self.first = {}      # (kernel, curve name) -> (ECCtx, args)
        self.last = {}       # the same for the latest call (not K3's)
        self.finishes = []   # (StreamMSMCtx, args) of every finish
        self.firsts = []     # the first of them per curve
        self.sched = {}      # ("p1" or "place", form, scalars) ->
                             # (DevSchedMSM, copied args)
        self.events = []     # ((kernel or "finish", curve name), start, end,
                             #  host seconds from start's record to end's)

    def _timed(self, key, fn, *args, on=None):
        import torch

        if (args[1] if on is None else on).device.type != "cuda":
            return fn(*args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn(*args)
        b.record()
        self.events.append((key, a, b, time.perf_counter() - t0))
        return out

    def __enter__(self):
        import torch

        from pcd_tpu_torch.ops.ec import ECCtx
        from pcd_tpu_torch.ops.fft_tensor import FFTTensorCtx
        from pcd_tpu_torch.ops.field import FieldCtx
        from pcd_tpu_torch.ops.matvec_tensor import SparseMatVec
        from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx
        from pcd_tpu_torch.ops.msm_stream_dev import DevSchedMSM

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
        self._sched = {attr: getattr(DevSchedMSM, attr)
                       for attr in ("p1", "place")}

        def keep(attr, fn):
            def probed(dm, *args):
                if self.on:
                    # p1(W): W (n, words); place(order, ...): (nwin, n)
                    n = args[0].shape[0 if attr == "p1" else 1]
                    key = (attr, dm.form, n)
                    if key not in self.sched:
                        self.sched[key] = (dm, tuple(
                            a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args))
                return fn(dm, *args)
            return probed

        for attr, fn in self._sched.items():
            setattr(DevSchedMSM, attr, keep(attr, fn))
        # the device quotient's K5-K7: CUDA events only
        self._quot = [(FFTTensorCtx, "ntt_pass", "ntt_pass",
                       lambda c, a: (c.f.name, a[0])),
                      (SparseMatVec, "apply", "spmv_rows",
                       lambda c, a: (c.f.name, a[0])),
                      (FieldCtx, "_fp_vec", "fp_vec",
                       lambda c, a: (c.name, a[5][0]))]

        def timed(kernel, fn, where):
            def probed(ctx, *args, **kw):
                if not self.on:
                    return fn(ctx, *args, **kw)
                name, t = where(ctx, args)
                return self._timed((kernel, name), lambda *a: fn(*a, **kw),
                                   ctx, *args, on=t)
            return probed

        self._quot_orig = [(cls, attr, getattr(cls, attr))
                           for cls, attr, _, _ in self._quot]
        for (cls, attr, kernel, where), (_, _, fn) in zip(self._quot,
                                                          self._quot_orig):
            setattr(cls, attr, timed(kernel, fn, where))
        return self

    def __exit__(self, *exc):
        from pcd_tpu_torch.ops.ec import ECCtx
        from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx
        from pcd_tpu_torch.ops.msm_stream_dev import DevSchedMSM

        for attr, fn in self._orig.items():
            setattr(ECCtx, attr, fn)
        for attr, fn in self._sched.items():
            setattr(DevSchedMSM, attr, fn)
        StreamMSMCtx._finish = self._finish
        for cls, attr, fn in self._quot_orig:
            setattr(cls, attr, fn)

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
        for key, a, b, _ in self.events:
            out[key] = out.get(key, 0.0) + a.elapsed_time(b)
        return out

    def brackets(self):
        """{(kernel, curve name): [launches, summed CUDA-event ms, the
        longest one's ms, summed host ms between each pair's records]}:
        where the events' sum far exceeds the kernel's time alone, the host
        ms say whether the card waited for the host inside the brackets
        (host ms near the events') or for other streams' work (host ms
        small)."""
        import torch

        if self.events:
            torch.cuda.synchronize()
        out = {}
        for key, a, b, host in self.events:
            ms = a.elapsed_time(b)
            row = out.setdefault(key, [0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += ms
            row[2] = max(row[2], ms)
            row[3] += host * 1e3
        return out


def check_keygen_launches(counts, cyc, dev, what):
    """K8's launches in a setup by form: on every G1 and G2 form of the
    cycle under KEYGEN "device" on a card (each side's query vectors are
    at least KEYGEN_MIN scalars), on none under "host"; else
    AssertionError."""
    from pcd_tpu_torch.snark import msm_dispatch

    got = {f: v for (k, f), v in sorted(counts.items())
           if k == "fixed_base_mul"}
    want = set()
    if msm_dispatch.KEYGEN == "device" and msm_dispatch.on_card(
            dev):
        want = {c.name for cfg in (cyc.main, cyc.help)
                for c in (cfg.g1, cfg.g2)}
    if set(got) != want:
        raise AssertionError(f"{what}: K8 launched on {sorted(got)} under "
                             f"KEYGEN {msm_dispatch.KEYGEN!r}, expected "
                             f"{sorted(want)}")
    return got


def pipelined_chain(pcd, pk, vk, pred, forms, counter, dev, phase):
    """Base case and step 2 through PipelinedChainProver (parallel/
    pipeline.py: the help prove on a worker thread, both provers on the
    card): both proofs verify, the old message against the newest proof
    is rejected, and K1 and K4 run once per commitment MSM of the two
    steps' four proves."""
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.parallel.pipeline import PipelinedChainProver

    F = pcd.ic.main_field
    one, two = F.from_int(1), F.from_int(2)
    ec.reset_launch_counts()
    t0 = time.perf_counter()
    proofs = PipelinedChainProver(pcd, pred, pk).prove_chain(
        [one, two], [one, one], b"chip smoke pipeline")
    sync(dev)
    secs = time.perf_counter() - t0
    counts = counter()
    ok = (pcd.verify(vk, pred, one, proofs[0]),
          pcd.verify(vk, pred, two, proofs[1]))
    if not all(ok):
        raise AssertionError(f"pipelined chain proofs do not verify {ok}")
    if pcd.verify(vk, pred, one, proofs[1]):
        raise AssertionError("pipelined chain: negative check accepted an "
                             "old message")
    check_once_per_msm(counts, forms, "the pipelined chain", dev,
                       proves=2)
    say(phase, f"pipelined chain (PipelinedChainProver, help stage on a "
               f"worker thread): base case and step 2 in {secs:.1f}s, both "
               f"verify, negative check rejects, K1 and K4 once per "
               f"commitment MSM of its four proves")


def check_once_per_msm(counts, forms, what, dev, proves=1):
    """K1 and K4 of every form exactly once per commitment MSM of
    `proves` proves of each side, K2 and K3 never; each P1 kernel once per
    schedule (P1_PER_PROVE a prove of each side) where the scheduler
    msm_dispatch picks for `dev` is the device's, never under the host
    one; each P2 kernel as each P1 kernel (every schedule of a prove has
    an active window)."""
    from pcd_tpu_torch.ops.msm_stream_dev import SCHED_KERNELS
    from pcd_tpu_torch.snark import msm_dispatch

    tier = msm_dispatch.scheduler_tier(dev)
    want = proves * P1_PER_PROVE * len(forms) // 2 if tier == "device" else 0
    for k in SCHED_KERNELS:
        got = sum(v for (kk, _), v in counts.items() if kk == k)
        if got != want:
            raise AssertionError(f"{what}: {k} launched {got} times under "
                                 f"the {tier!r} scheduler, expected {want}")
    for f, grp, kind in forms:
        want = proves * K1_PER_PROVE[kind][grp]
        for k in ("madd_accumulate", "bucket_finish"):
            if counts.get((k, f), 0) != want:
                raise AssertionError(f"{what}: {k}[{f}] launched "
                                     f"{counts.get((k, f), 0)} times, "
                                     f"expected {want}")
        for k in ("complete_add", "madd"):
            if counts.get((k, f), 0):
                raise AssertionError(f"{what}: {k}[{f}] launched")


# the device quotient's kernels (on the path only under QUOTIENT "device")
QUOTIENT_KERNELS = ("ntt_pass", "spmv_rows", "fp_vec")
# K7 launches per device-quotient warm step and field: z to Montgomery and
# the replayed-witness check; GM17 also the SAP evaluations and their
# extension from Montgomery.  The quotient's scalings run in K5, which
# launches once per pass of each of hpoly's three transforms.
K7_PER_QUOTIENT = {"Groth16": 2, "GM17": 4}


def check_quotient_launches(counts, pcd, pk, what):
    """K5 three transforms' worth of passes and K7 K7_PER_QUOTIENT times
    per field of a device-quotient warm step, or AssertionError."""
    from pcd_tpu_torch.ops.fft_tensor import passes, plan
    from pcd_tpu_torch.poly.domain import EvaluationDomain

    ic = pcd.ic
    for snark, F, spk in ((ic.main_snark, ic.main_field, pk.main_pk),
                          (ic.help_snark, ic.help_field, pk.help_pk)):
        kind, n = type(snark).__name__, spk.domain_size
        want = {"ntt_pass": 3 * len(passes(n, plan(EvaluationDomain(
            F, n).factors))), "fp_vec": K7_PER_QUOTIENT[kind]}
        for k, v in want.items():
            got = counts.get((k, F.NAME), 0)
            if got != v:
                raise AssertionError(f"{what}: {k}[{F.NAME}] launched {got} "
                                     f"times, expected {v} ({kind}, n = "
                                     f"{n})")


def knob_turns(knob, pcd, pk, vk, pred, proof_1, rng, forms, counter, dev,
               phase, turns):
    """Warm steps with msm_dispatch.<knob> ("SCHEDULER" or "QUOTIENT") set
    in `turns`: each its launches counted alone (K1 and K4 once per
    commitment MSM; each P1 and P2 kernel twice a prove under the device
    scheduler and never under the host one; K5, K6 and K7 under the
    device quotient only, K5 and K7 as check_quotient_launches says) and
    its spans; the last proof of each setting
    verified.  For QUOTIENT, the verdict: "device" when its step is
    shorter in at least nine tenths of the adjacent pairs and its median
    shorter than the host's by more than the host steps' interquartile
    distance (SCHEDULER follows the MSM's device and has none).
    Returns ({setting: {metric: [median, min, max] s}}, the launch counts
    of the first device-quotient step)."""
    import statistics

    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.utils import profiling

    F = pcd.ic.main_field
    one, two = F.from_int(1), F.from_int(2)
    default = getattr(msm_dispatch, knob)
    runs, last, dev_counts = {}, {}, None
    profiling.enable()
    try:
        for val in turns:
            setattr(msm_dispatch, knob, val)
            profiling.reset()
            ec.reset_launch_counts()           # this warm step starts
            t0 = time.perf_counter()
            last[val] = pcd.prove(pk, pred, two, one, [one], [proof_1], rng)
            sync(dev)
            wall = time.perf_counter() - t0
            got = counter()                    # this warm step ended
            what = f"warm step, {knob} {val!r}"
            check_once_per_msm(got, forms, what, dev)
            quot = {k: sum(v for (kk, _), v in got.items() if kk == k)
                    for k in QUOTIENT_KERNELS}
            if msm_dispatch.QUOTIENT == "device":
                if not all(quot.values()):
                    raise AssertionError(f"{what}: a device-quotient kernel "
                                         f"never launched: {quot}")
                check_quotient_launches(got, pcd, pk, what)
                if dev_counts is None:
                    dev_counts = got
            elif any(quot.values()):
                raise AssertionError(f"{what}: quotient kernels launched "
                                     f"under the host quotient: {quot}")
            tot = profiling.totals()

            def total(leaf, tot=tot):
                return sum(v[0] for k, v in tot.items()
                           if k.rsplit("/", 1)[-1] == leaf)
            rec = {"step": wall, "stream_dispatch": total("stream_dispatch"),
                   "stream_dispatch_h": total("stream_dispatch_h"),
                   "msm_collect": total("msm")}
            if knob == "SCHEDULER":
                rec["schedule"] = total("schedule_" + val)
            else:
                rec.update(h_poly=total("h_poly"), matvec=total("matvec"),
                           hpoly=total("hpoly"))
            runs.setdefault(val, []).append(rec)
    finally:
        setattr(msm_dispatch, knob, default)
        profiling.enable(False)
    for val, proof in last.items():
        if not pcd.verify(vk, pred, two, proof):
            raise AssertionError(f"the warm step under {knob} {val!r} does "
                                 f"not verify")
    out = {val: {m: [statistics.median(r[m] for r in recs),
                     min(r[m] for r in recs), max(r[m] for r in recs)]
                 for m in recs[0]} for val, recs in runs.items()}
    verdict = None
    if knob == "QUOTIENT" and set(runs) == {"host", "device"}:
        steps = {val: [r["step"] for r in recs] for val, recs in runs.items()}
        it = {val: iter(v) for val, v in steps.items()}
        order = [(val, next(it[val])) for val in turns]
        pairs = [dict(order[i:i + 2]) for i in range(0, len(order) - 1, 2)]
        wins = sum(p.get("device", 1e9) < p.get("host", 0) for p in pairs)
        q1, _, q3 = statistics.quantiles(steps["host"], n=4,
                                         method="inclusive")
        gap = out["host"]["step"][0] - out["device"]["step"][0]
        verdict = ("device" if wins >= 0.9 * len(pairs) and gap > q3 - q1
                   else "host")
        say(phase, f"{knob} verdict: device shorter in {wins} of "
                   f"{len(pairs)} pairs, medians {gap:+.4f} s apart "
                   f"(host interquartile {q3 - q1:.4f} s): {verdict!r}")
    for val, recs in runs.items():
        say(phase, f"{knob} {val!r} warm steps ({len(recs)}, turns "
                   f"{'/'.join(turns)}), each verified or checked once per "
                   f"MSM: " + json.dumps(
                       {m: [round(r[m], 4) for r in recs] for m in recs[0]}))
    say(phase, f"{knob} medians [median, min, max] (s): " + json.dumps(
        {val: {m: [round(x, 4) for x in v] for m, v in ms.items()}
         for val, ms in out.items()}) + f"; default {default!r}")
    if verdict is not None and verdict != default:
        say(phase, f"note: the verdict {verdict!r} is not "
                   f"msm_dispatch.{knob}'s default {default!r}")
    return out, dev_counts


def card_busy(trace_path, wall_s):
    """Busy and idle shares of the card over a traced step of wall_s
    seconds: the union of the trace's kernel, copy and set intervals
    (torch.profiler's Chrome trace, microseconds), with the kernels'
    own union and the five kernels that took longest in all."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans, kern, names = [], [], {}
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            spans.append(iv)
            if cat == "kernel":
                kern.append(iv)
                nm = e.get("name", "?")[:40]
                names[nm] = names.get(nm, 0.0) + float(e["dur"])

    def union(ivs):
        tot, end = 0.0, None
        for a, b in sorted(ivs):
            if end is None or a > end:
                tot += b - a
                end = b
            elif b > end:
                tot += b - end
                end = b
        return tot / 1e6
    busy = union(spans)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    return {"events": len(spans), "kernels": len(kern),
            "busy_s": busy, "kernel_busy_s": union(kern),
            "idle_share": (1 - busy / wall_s) if spans else None,
            "top_kernels_ms": {k: round(v / 1e3, 3) for k, v in top}}


def sched_kernel_ms(trace_path):
    """{P1 or P2 kernel: [launches, summed ms]} in a torch.profiler
    trace, by the kernels' names."""
    from pcd_tpu_torch.ops.msm_stream_dev import SCHED_KERNELS

    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    out = {k: [0, 0.0] for k in SCHED_KERNELS}
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        for k in SCHED_KERNELS:
            if f"{k}_kernel" in e.get("name", ""):
                out[k][0] += 1
                out[k][1] += float(e["dur"]) / 1e3
    return out


def traced_steps(pcd, pk, pred, proof_1, rng, dev, phase):
    """One warm step under each quotient tier, the scheduler as
    msm_dispatch picks it for `dev`, inside device_trace (a
    torch.profiler capture, written under chiprun_out/device_trace/ and
    gzipped): the card's busy and idle shares of each step, and where
    the device schedules, the P1 and P2 kernels' launches and time."""
    import gzip
    import shutil

    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.utils.profiling import device_trace

    F = pcd.ic.main_field
    one, two = F.from_int(1), F.from_int(2)
    default = msm_dispatch.QUOTIENT
    out = {}
    try:
        for tier in ("host", "device"):
            msm_dispatch.QUOTIENT = tier
            logdir = os.path.join(HERE, "chiprun_out", "device_trace", tier)
            sync(dev)
            with device_trace(logdir):
                t0 = time.perf_counter()
                pcd.prove(pk, pred, two, one, [one], [proof_1], rng)
                sync(dev)
                wall = time.perf_counter() - t0
            path = os.path.join(logdir, "trace.json")
            out[tier] = dict(card_busy(path, wall), step_s=wall)
            if msm_dispatch.scheduler_tier(dev) == "device":
                out[tier]["sched_kernels"] = sched_kernel_ms(path)
            with open(path, "rb") as src, gzip.open(path + ".gz",
                                                     "wb") as dst:
                shutil.copyfileobj(src, dst)
            os.remove(path)
    finally:
        msm_dispatch.QUOTIENT = default
    for tier, rec in out.items():
        say(phase, f"device_trace of a warm step, {tier} quotient, "
                   f"{msm_dispatch.scheduler_tier(dev)} scheduler: "
                   + json.dumps({k: (round(v, 4) if isinstance(v, float)
                                     else v) for k, v in rec.items()}))
    return out


def quotient_step(pcd, pk, vk, pred, proof_1, rng, forms, counter, dev,
                  phase):
    """One more warm step under QUOTIENT = "device": K1 and K4 once per
    commitment MSM, K5, K6 and K7 launched, and the proof verifies.
    Returns the step's launch counts."""
    _, counts = knob_turns("QUOTIENT", pcd, pk, vk, pred, proof_1, rng,
                           forms, counter, dev, phase, ("device",))
    return counts


def counter_predicate(F):
    """The chains' predicate over field F: msg = prior msg + witness."""
    from pcd_tpu_torch.pcd.api import FpPredicate

    class Counter(FpPredicate):
        PRIOR_MSG_LEN = 1

        def generate_constraints(self, cs, msg, wit, priors, base):
            (priors[0] + wit).enforce_equal(msg)

    return Counter(F)


def phase_chain(name="mnt4_groth16", phase=4, dev=None, turns=False):
    """The IVC chain of configs.<name> (the real cycle, on the card unless
    `dev` says otherwise).  With `turns` (phase 4): the warm steps in
    scheduler and quotient turns, and a traced warm step under each
    quotient tier; else one more warm step under the device quotient.
    Returns the launch counts of the main path (base case + warm step),
    the probe of the warm step, and {"sched": knob_turns' result or None,
    "quot_counts": the launch counts of a device-quotient warm step,
    "trace": traced_steps' result or None, "chain": (pcd, pk)}."""
    from pcd_tpu_torch import configs
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.ops.msm_stream_dev import SCHED_KERNELS
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.utils import profiling
    from pcd_tpu_torch.utils.rng import ChaChaRng

    secs = {}
    profiling.reset()
    profiling.enable()
    t0 = time.perf_counter()
    pcd = getattr(configs, name)(dev)              # None: the card
    dev = pcd.ic.main_snark.device
    # on the CPU (a rehearsal) the wrappers count plain-version calls
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    F = pcd.ic.main_field
    pred = counter_predicate(F)
    rng = ChaChaRng(b"chip smoke " + name.encode())
    ec.reset_launch_counts()                       # the setup starts
    pk, vk = pcd.circuit_specific_setup(pred, rng)
    secs["setup"] = time.perf_counter() - t0
    keygen = check_keygen_launches(counter(), pcd.ic.cycle, dev,
                                   f"{name}'s setup")
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
    say(phase, f"setup under KEYGEN {msm_dispatch.KEYGEN!r}: K8 launches "
               + json.dumps(keygen))
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
    if msm_dispatch.scheduler_tier(dev) == "device":   # P1, P2 on the path
        missing += [k for k in SCHED_KERNELS
                    if not any(kk == k for kk, _ in counts)]
    if missing:
        raise AssertionError("kernels not launched on the main path: "
                             + ", ".join(missing))
    # every commitment MSM of both proves ran K1 and K4 once: none went to
    # the host; K2 no longer runs on the path
    check_once_per_msm(base_counts, forms, "the base case", dev)
    check_once_per_msm(step2, forms, "the warm step", dev)
    took = {"sched": None, "trace": None, "chain": (pcd, pk),
            "keygen": keygen, "step": (vk, pred, proof_1)}
    if turns:
        pipelined_chain(pcd, pk, vk, pred, forms, counter, dev, phase)
        took["sched"] = knob_turns("SCHEDULER", pcd, pk, vk, pred, proof_1,
                                   rng, forms, counter, dev, phase,
                                   SCHED_TURNS)
        # the device quotient's one-time set-up (matrices, root tables)
        # in a step of its own, outside the turns
        quotient_step(pcd, pk, vk, pred, proof_1, rng, forms, counter, dev,
                      phase)
        with QuotientProbe() as qp:
            took["quot"] = knob_turns("QUOTIENT", pcd, pk, vk, pred,
                                      proof_1, rng, forms, counter, dev,
                                      phase, QUOTIENT_TURNS)
        took["quot_counts"] = took["quot"][1]
        took["captured"] = qp.calls
        if dev.type == "cuda":
            took["trace"] = traced_steps(pcd, pk, pred, proof_1, rng, dev,
                                         phase)
    else:
        took["quot_counts"] = quotient_step(pcd, pk, vk, pred, proof_1, rng,
                                            forms, counter, dev, phase)
    say(phase, "quotient kernel launches per device-quotient warm step: "
        + json.dumps({f"{k}[{f}]": v for (k, f), v in
                      sorted((took["quot_counts"] or {}).items())
                      if k in QUOTIENT_KERNELS}))
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
    sched_path(probe, tag, phase, which)


def sched_path(probe, tag, phase, which):
    """P1's four kernels and P2 on the inputs of their first launch at
    each scalar count of the probe's step (a partial last P1 tile where
    the count is no multiple of it), each exactly against its plain
    version, P1 and P2 timed with CUDA events as launched."""
    from pcd_tpu_torch.ops.msm_stream_dev import P1_TILE

    for (attr, form, n), (dm, args) in sorted(probe.sched.items()):
        dev = args[0].device
        sync(dev)                  # the copies were made on a side stream
        if attr == "p1":
            W, = args
            nt = -(-n // P1_TILE)
            what = (f"{n} scalars, {nt} tile{'s' * (nt > 1)}, the last "
                    f"of {n - (nt - 1) * P1_TILE}")
            p1_kernels_exact(dm, W, f"{which}{tag} ({what})")
            ms = device_ms(lambda: dm.p1(W), 5, dev)
            say(phase, f"P1[{form}]{tag} on {which} ({what}): each kernel "
                       f"and P1 exact against their plain versions; P1 "
                       f"{ms:.3f} ms as launched")
            continue
        order, counts, act, T = args
        what = f"{n} scalars, {len(act)} windows, T = {T}"
        p2_exact(dm, order, counts, act, T, f"{which}{tag} ({what})")
        ms = device_ms(lambda: dm.place(order, counts, act, T), 5, dev)
        say(phase, f"p2_place[{form}]{tag} on {which} ({what}): exact "
                   f"against its plain version and place_plain; "
                   f"{ms:.3f} ms as launched")


class QuotientProbe:
    """While in its `with`, keeps the first C++ quotient of each field
    (keyed by its modulus): the z limbs and the A z, B z, C z limbs of
    SpMatrices.apply_all_limbs, and native.hpoly's arguments and result.
    Leaving the `with` restores both."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        import numpy as np

        from pcd_tpu_torch import native

        self._orig = (native.hpoly, native.SpMatrices.apply_all_limbs)

        def hpoly(modulus, omega, coset_g, zh_inv, a, b, c, check_rows=0):
            out = self._orig[0](modulus, omega, coset_g, zh_inv, a, b, c,
                                check_rows=check_rows)
            rec = self.calls.setdefault(modulus, {})
            if "h" not in rec:
                rec["h"] = (zh_inv, check_rows, out.copy())
            return out

        def apply_all_limbs(mats, z):
            outs = self._orig[1](mats, z)
            rec = self.calls.setdefault(mats.modulus, {})
            if "abc" not in rec:
                rec["z"] = np.array(z, dtype="<u8")
                rec["abc"] = tuple(o.copy() for o in outs)
            return outs

        native.hpoly = hpoly
        native.SpMatrices.apply_all_limbs = apply_all_limbs
        return self

    def __exit__(self, *exc):
        from pcd_tpu_torch import native

        native.hpoly, native.SpMatrices.apply_all_limbs = self._orig


def rand_elems(shape, p, dev, gen):
    """Random field elements below 2^(bits - 1) < p as (*shape, 10) int32
    limbs on dev (any value below p is the Montgomery form of one)."""
    import torch

    w = torch.randint(-(1 << 31), 1 << 31, tuple(shape) + (10,),
                      dtype=torch.int64, device=dev, generator=gen)
    top = (1 << (p.bit_length() - 1 - 288)) - 1
    w[..., 9] &= top
    return w.to(torch.int32)


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def timed_plain(fn, dev):
    """(result, host-clock ms) of one call of a plain version."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


# K5's prologue x epilogue instantiations as ntt_pass takes them: name ->
# (source rows or None for the domain's batch, pre, abc, post), the tables
# by FFTTensorCtx attribute; prologues on the first pass, epilogues on the
# first and the last
K5_MODES = {"plain": (None, None, False, None),
            "pre table": (None, "coset_tbl", False, None),
            "pre scalar": (None, "n_inv", False, None),
            "abc 3 rows": (3, None, True, None),
            "abc 2 rows": (2, None, True, None),
            "post table": (None, None, False, "ninv_coset_inv_tbl"),
            "post scalar": (None, None, False, "n_inv"),
            "pre + post": (None, "coset_tbl", False, "ninv_coset_tbl"),
            "abc + post plain": (3, None, True, "ninv_coset_inv_plain"),
            "abc 2 rows + post scalar": (2, None, True, "n_inv")}


def plain_transform(fctx, x, tbl, pre=None, abc=None, post=None):
    """_transform on K5's plain version, pass by pass."""
    perm, last = fctx.perm, len(fctx.passes) - 1
    for i, ps in enumerate(fctx.passes):
        x = fctx.ntt_pass_plain(x, tbl, perm, ps,
                                pre if i == 0 else None,
                                abc if i == 0 else None,
                                post if i == last else None)
        perm = None
    return x


def quotient_transforms(fctx, x, s, tr=None):
    """hpoly's three transforms of x (rows, n, 10) with the element s as
    the ABC prologue's, through `tr` (FFTTensorCtx._transform, or
    plain_transform)."""
    tr = tr or fctx._transform
    ev = tr(x, fctx.tbl_inv, post=fctx.ninv_coset_tbl)
    ev = tr(ev, fctx.tbl_fwd)
    return tr(ev, fctx.tbl_inv, abc=s, post=fctx.ninv_coset_inv_plain)


# the real domains of the quotient: (side, points, transform batch)
QUOTIENT_DOMAINS = (("main", 225_792, 3, "mnt4_groth16"),
                    ("help", 31_360, 3, "mnt4_groth16"),
                    ("main", 688_128, 2, "mnt4_gm17"),
                    ("help", 107_520, 2, "mnt4_gm17"))


def phase_quotient(results, took=None, dev="cuda", phase=10):
    """The device quotient (ops/fft_tensor.py, ops/matvec_tensor.py): K5
    pass by pass and K7 in every op exactly against their plain versions
    on the four real domains, random inputs from a seed; K6 on the real
    Groth16 circuits' matrices of phase 4's pk against its plain version
    and the C++ matvec on a real warm step's z; the device h against the
    C++ hpoly's h of that step, main and help; CUDA-event ms per kernel
    and per quotient.  Appends the K5-K7 records and returns [(record,
    chain, kernel, field name)] for their launches."""
    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops import kernels
    from pcd_tpu_torch.ops.ec import launch_counts, plain_counts
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx, hpoly, ntt_tile
    from pcd_tpu_torch.ops.field import limbs_host, upload_limbs
    from pcd_tpu_torch.ops.matvec_tensor import WARP_MIN

    dev = torch.device(dev)
    counted = launch_counts if dev.type == "cuda" else plain_counts
    for name in ("ntt", "spmv"):
        inst = ""
        for line in kernels.BUILD_INFO.get(name, {}).get("ptxas",
                                                         "").splitlines():
            m = re.search(r"Compiling entry function '_Z\d+(\w+?)ILi(\d)"
                          r"ELi(\d)E", line)
            if m:                   # K5's <prologue, epilogue> modes
                inst = f" {m.group(1)}<{m.group(2)}, {m.group(3)}>"
            if any(w in line for w in ("registers", "spill")):
                say(phase, f"ptxas {name}{inst}: {line.strip()}")
                if name == "ntt" and re.search(r"[1-9]\d* bytes spill st",
                                               line):
                    raise AssertionError(f"K5{inst} spills: {line.strip()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    cyc = M.mnt_cycle()
    sides = {"main": cyc.main.Fr, "help": cyc.help.Fr}
    pend = []
    ops1 = PRODUCTS[1] * 2                     # multiply-adds per product
    for side, n, batch, chain in QUOTIENT_DOMAINS:
        F = sides[side]
        t0 = time.perf_counter()
        fctx = fft_ctx(F, n, dev)
        f = fctx.f
        t_ctx = time.perf_counter() - t0
        a = rand_elems((batch, n), F.MODULUS, dev, gen)
        src, perm, plain_ms = a, fctx.perm, 0.0
        nbytes = (2 * batch * n + n) * 40 + n * 4
        for i, ps in enumerate(fctx.passes):
            got = fctx.ntt_pass(src, fctx.tbl_fwd, perm, ps)
            want, ms_p = timed_plain(lambda: fctx.ntt_pass_plain(
                src, fctx.tbl_fwd, perm, ps), dev)
            plain_ms += ms_p
            if not torch.equal(got, want):
                raise AssertionError(f"K5 {F.NAME} n={n} pass {i} "
                                     f"({ps.M}, {ps.Q}): kernel != plain")
            src, perm = got, None
        if not torch.equal(fctx.ifft(src), a):
            raise AssertionError(f"K5 {F.NAME} n={n}: ifft(fft(a)) != a")
        # every prologue x epilogue instantiation on the first pass, the
        # epilogues on the last pass too
        x3 = rand_elems((3, n), F.MODULUS, dev, gen)
        first, last = fctx.passes[0], fctx.passes[-1]
        for name, (rows, pre, abc, post) in K5_MODES.items():
            kw = {"pre": pre and getattr(fctx, pre),
                  "abc": x3[0, :1] if abc else None,
                  "post": post and getattr(fctx, post)}
            x = x3[:rows or batch]
            for ps, pm in [(first, fctx.perm)] + (
                    [(last, None)] if pre is None and not abc else []):
                got = fctx.ntt_pass(x, fctx.tbl_inv, pm, ps, **kw)
                if not torch.equal(got, fctx.ntt_pass_plain(
                        x, fctx.tbl_inv, pm, ps, **kw)):
                    raise AssertionError(f"K5 {F.NAME} n={n} {name} at M = "
                                         f"{ps.M}: kernel != plain")
        per = {}
        for fn in ("fft", "ifft", "coset_fft", "coset_ifft"):
            before = counted().get(("ntt_pass", F.NAME), 0)
            getattr(fctx, fn)(a)
            per[fn] = counted()[("ntt_pass", F.NAME)] - before
        if any(v > 3 for v in per.values()):
            raise AssertionError(f"K5 {F.NAME} n={n}: more than 3 ntt_pass "
                                 f"launches a transform: {per}")
        ms = device_ms(lambda: fctx.fft(a), 3, dev)
        # the products the transform needs: one a pair at radix 2, r - 1
        # an output above; the per-level count, r - 1 at every level, too
        prods = sum(n // 2 if r == 2 else n * (r - 1)
                    for r, _ in fctx.levels)
        mads = batch * ops1 * prods
        mads_old = batch * ops1 * n * sum(r - 1 for r, _ in fctx.levels)
        form = (f"{F.NAME} n={n} x{batch}, one transform of "
                f"{len(fctx.levels)} levels in {len(fctx.passes)} passes")
        rec = record("ntt_pass", form, 0, 0, ms, plain_ms, nbytes, mads)
        old = record("ntt_pass", form, 0, 0, ms, plain_ms, nbytes, mads_old)
        results.append(rec)
        pend.append((rec, chain, "ntt_pass", F.NAME))
        say(phase, f"K5 ntt_pass {form}, tile {ntt_tile(n)} points: passes "
                   + "; ".join(f"M {ps.M} Q {ps.Q} C {ps.C} radixes "
                               f"{[r for r, *_ in ps.levels]}"
                               for ps in fctx.passes)
            + f"; launches a transform {json.dumps(per)}; every pass "
              f"exact against plain, ifft(fft) = id, every prologue and "
              f"epilogue ({', '.join(K5_MODES)}) exact against plain; "
              f"{ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
              f"{rec['bound_ms'] / ms:.1%}; by the earlier count "
              f"{old['bound_ms']:.4f} ms, {old['bound_ms'] / ms:.1%}), "
              f"plain {plain_ms:.0f} ms; context with tables {t_ctx:.2f}s")
        # hpoly's three transforms (batch rows in, the ABC pass to one):
        # the first's epilogue and the last's prologue and epilogue
        # products, the ABC pass's extra source rows and the scaling
        # tables counted
        xq, sq = x3[:batch], x3[0, :1]
        got = quotient_transforms(fctx, xq, sq)
        want, plain_ms = timed_plain(lambda: quotient_transforms(
            fctx, xq, sq, lambda x, tbl, **kw: plain_transform(
                fctx, x, tbl, **kw)), dev)
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {F.NAME} n={n}: hpoly's transforms "
                                 f"!= plain")
        ms = device_ms(lambda: quotient_transforms(fctx, xq, sq), 3, dev)
        mads = ops1 * (2 * batch * prods + batch * n + prods + 3 * n)
        nbytes_q = ((2 * batch * n + 2 * n) + (2 * batch * n + n)
                    + (batch * n + 3 * n)) * 40 + 3 * n * 4 + 40
        form = (f"{F.NAME} n={n} x{batch}, hpoly's three transforms "
                f"({3 * len(fctx.passes)} passes, the scalings and "
                f"(a b - c) s in their loads and stores)")
        rec = record("ntt_pass", form, 0, 0, ms, plain_ms, nbytes_q, mads)
        results.append(rec)
        pend.append((rec, chain, "ntt_pass", F.NAME))
        say(phase, f"K5 ntt_pass {form}: exact against plain; {ms:.3f} ms, "
                   f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                   f"{rec['bound_ms'] / ms:.1%}), plain {plain_ms:.0f} ms")
        # K7: every op against its plain version; the record is the
        # replayed-witness check, (a b - c) s over n rows
        x, y, z = (rand_elems((n,), F.MODULUS, dev, gen) for _ in range(3))
        nc, ni = (n - 64) // 2, 40
        r2, one = f.const(f.r * f.r, dev), f.const(1, dev)
        zi = x[nc:nc + ni]
        cases = {                      # (kernel, plain version)
            "check": (lambda: f.abc(x, y, z, fctx.n_inv),
                      lambda: f.abc_plain(x, y, z, fctx.n_inv)),
            "table": (lambda: f.vmul(a, fctx.coset_tbl),
                      lambda: f.vmul_plain(a, fctx.coset_tbl)),
            "scalar": (lambda: f.vmul(x, fctx.n_inv),
                       lambda: f.vmul_plain(x, fctx.n_inv)),
            "to_mont": (lambda: f.to_mont(x), lambda: f.vmul_plain(x, r2)),
            "from_mont": (lambda: f.from_mont(x),
                          lambda: f.vmul_plain(x, one)),
            "sap": (lambda: f.sap(x[:nc], y[:nc], z[:nc], zi, n),
                    lambda: f.sap_plain(x[:nc], y[:nc], z[:nc], zi, n)),
        }
        for name, (kern, plain) in cases.items():
            got = kern()
            want, ms_p = timed_plain(plain, dev)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                if not torch.equal(g, w):
                    raise AssertionError(f"K7 {F.NAME} n={n} {name}: "
                                         f"kernel != plain")
            if name == "check":
                plain_ms = ms_p
        ms = device_ms(cases["check"][0], 5, dev)
        form = f"{F.NAME} n={n}, the replayed-witness check (a b - c) s"
        rec = record("fp_vec", form, 0, 0, ms, plain_ms, 4 * n * 40 + 40,
                     2 * n * ops1)
        results.append(rec)
        pend.append((rec, chain, "fp_vec", F.NAME))
        say(phase, f"K7 fp_vec {F.NAME} n={n}: every op ({', '.join(cases)})"
                   f" exact against plain; the check over {n} rows "
                   f"{ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
                   f"({rec['bound_by']}), plain {plain_ms:.0f} ms")
    if took is None or "captured" not in took:
        say(phase, "no phase 4 run: K6 and the quotients against the C++ "
                   "tier need its pk and warm step; skipped")
        return pend
    pcd, pk = took["chain"]
    captured = took["captured"]
    cyc = pcd.ic.cycle
    for side, spk in (("main", pk.main_pk), ("help", pk.help_pk)):
        F = getattr(cyc, side).Fr
        cap = captured[F.MODULUS]
        mats = spk._dev_mats[str(dev)]
        n = spk.domain_size
        fctx = fft_ctx(F, n, dev)
        f = fctx.f
        z_mont = f.to_mont(upload_limbs(cap["z"], dev))
        evs = torch.empty((3, n, 10), dtype=torch.int32, device=dev)
        for k, m in enumerate(mats):
            m.apply(z_mont, out=evs[k])
            want, ms_p = timed_plain(lambda: m.apply_plain(z_mont), dev)
            if not torch.equal(evs[k], want):
                raise AssertionError(f"K6 {F.NAME} {side} matrix {k}: "
                                     f"kernel != plain")
            if not np.array_equal(limbs_host(f.from_mont(evs[k])),
                                  cap["abc"][k]):
                raise AssertionError(f"K6 {F.NAME} {side} matrix {k} != "
                                     f"the C++ matvec")
            lens = torch.diff(m.rowptr).cpu().numpy()
            shape = (f"{m.n_rows} rows, {m.nnz} entries, row lengths mean "
                     f"{lens.mean():.2f}, max {m.max_row}, "
                     f"{int((lens == 0).sum())} empty, "
                     f"{int((lens == 1).sum())} single, {m.n_warp} rows of "
                     f"more than {WARP_MIN} a warp each, unit entries "
                     f"{m.n_units} ({m.n_units / max(m.nnz, 1):.1%})")
            out_k = torch.empty_like(evs[0])
            ms = device_ms(lambda: m.apply(z_mont, out=out_k), 5, dev)
            # the work these inputs need: the products of entries that are
            # not units; the count of one per entry, too
            prods = m.nnz - m.n_units
            nbytes = (m.n_rows * 52 + 4 + m.nnz * 4 + prods * 40
                      + m.n_cols * 40)
            form = f"{F.NAME} Groth16 {side} {'ABC'[k]}: {shape}"
            rec = record("spmv_rows", form, 0, 0, ms, ms_p, nbytes,
                         prods * ops1)
            old = record("spmv_rows", form, 0, 0, ms, ms_p,
                         (m.n_rows + 1) * 4 + m.nnz * 44 + m.n_cols * 40
                         + m.n_rows * 40, m.nnz * ops1)
            if k == 0:
                results.append(rec)
                pend.append((rec, "mnt4_groth16", "spmv_rows", F.NAME))
            say(phase, f"K6 spmv_rows {form}: exact against plain and the "
                       f"C++ CSR matvec; {ms:.4f} ms, bound "
                       f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                       f"{rec['bound_ms'] / ms:.1%}; by the earlier count "
                       f"{old['bound_ms']:.4f} ms, "
                       f"{old['bound_ms'] / ms:.1%}), plain {ms_p:.0f} ms")
        zh_inv, check_rows, h_cpp = cap["h"]
        h = hpoly(fctx, evs[0], evs[1], evs[2], zh_inv, check_rows)
        if not np.array_equal(limbs_host(h), h_cpp):
            raise AssertionError(f"device h != C++ hpoly's h ({side})")

        def quotient():
            zm = f.to_mont(upload_limbs(cap["z"], dev))
            ev = torch.empty((3, n, 10), dtype=torch.int32, device=dev)
            for k, m in enumerate(mats):
                m.apply(zm, out=ev[k])
            return hpoly(fctx, ev[0], ev[1], ev[2], zh_inv, check_rows)
        from pcd_tpu_torch.ops import ec

        counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
        ec.reset_launch_counts()
        quotient()
        per = {f"{k}[{fm}]": v for (k, fm), v in counter().items()}
        q_ms = device_ms(quotient, 3, dev)
        hp_ms = device_ms(lambda: hpoly(fctx, evs[0], evs[1], evs[2],
                                        zh_inv, check_rows), 3, dev)
        # kernel time (profiler): every kernel of a call, torch's copies
        # and reductions too, host gaps and the z upload left out
        q_kern = hp_kern = None
        if dev.type == "cuda":
            logdir = os.path.join(HERE, "build", "quotient_trace", side)
            q_kern = kernel_ms(quotient, logdir + "_quotient")
            hp_kern = kernel_ms(lambda: hpoly(fctx, evs[0], evs[1], evs[2],
                                              zh_inv, check_rows),
                                logdir + "_hpoly")
        t0 = time.perf_counter()
        native.hpoly(F.MODULUS, fctx.domain.omega, fctx.domain.coset_shift,
                     zh_inv, *cap["abc"], check_rows=check_rows)
        cpp_ms = (time.perf_counter() - t0) * 1e3
        say(phase, f"Groth16 {side} quotient n={n}: device h == C++ "
                   f"hpoly's h on the warm step's z; device quotient (z "
                   f"upload, K7, 3 x K6, hpoly) {q_ms:.3f} ms CUDA events, "
                   f"{fmt_ms(q_kern)} kernel time; hpoly {hp_ms:.3f} ms "
                   f"CUDA events, {fmt_ms(hp_kern)} kernel time; C++ hpoly "
                   f"{cpp_ms:.1f} ms wall; launches per quotient "
                   + json.dumps(per))
    return pend


# phase 12, part 2: the sharded stream MSMs of two gloo ranks sharing the
# card (curve, points) and the sharded quotient's domain
SHARDED_MSMS = (("mnt4_298", "g1", (1 << 14) + 3), ("mnt6_298", "g2",
                                                   (1 << 12) + 1))
SHARDED_H_N = (1 << 12) * 3


def sharded_launches(dctx, pcd, pk):
    """The quotient kernels' launches a sharded device-quotient warm step
    must show, per field: K5 once a pass of the n1 and n2 transforms of
    the three 4-step transforms (two inverse, one forward), K6 once a
    matrix, K7 eight times (z to Montgomery, the replayed-witness check,
    three twiddle products, the coset scale, (a b - c) Z_H^-1 and the
    unscale).  {(kernel, field): launches}, and the (n1, n2) of each
    side."""
    want, splits = {}, {}
    ic = pcd.ic
    for side, F, spk in (("main", ic.main_field, pk.main_pk),
                         ("help", ic.help_field, pk.help_pk)):
        dh = dctx.h_poly(F, spk.domain_size)
        if dh is None:
            raise AssertionError(f"{side}: no split of {spk.domain_size} "
                                 f"for world size {dctx.ndev}")
        fs = dh.fs
        want[("ntt_pass", F.NAME)] = 3 * (len(fs.ctx1.passes)
                                          + len(fs.ctx2.passes))
        want[("spmv_rows", F.NAME)] = 3
        want[("fp_vec", F.NAME)] = 8
        splits[side] = (dh.n1, dh.n2)
    return want, splits


def sharded_part2(card, phase, dev="cuda"):
    """Two gloo ranks, threads of this process sharing the card: the
    sharded stream MSMs of SHARDED_MSMS against the C++ Pippenger, K1 and
    K4 once a rank an MSM, and DistHPoly on MNT4-298's Fr at SHARDED_H_N
    against the single-card hpoly on the same evaluations."""
    import numpy as np
    import torch

    from pcd_tpu_torch import native
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.msm.host import fixed_base_many
    from pcd_tpu_torch.msm.host import msm as host_msm
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx, hpoly
    from pcd_tpu_torch.ops.field import limbs_host
    from pcd_tpu_torch.parallel.dist import DistHPoly
    from pcd_tpu_torch.parallel.mesh import run_ranks, thread_meshes
    from pcd_tpu_torch.parallel.stream_dist import ShardedStreamMSM

    dev = torch.device(dev)
    meshes = thread_meshes(2, dev)
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    rng = random.Random(12)
    for model, grp, n in SHARDED_MSMS:
        cfg = getattr(M, model)()
        curve = getattr(cfg, grp)
        gen = getattr(cfg, grp + "_gen")
        r, bits = cfg.Fr.MODULUS, cfg.Fr.BITS
        pts = fixed_base_many(gen, [rng.randrange(1, r) for _ in range(n)],
                              bits)
        pts[3] = curve.infinity()
        enc = native.encode_points(pts)
        scalars = [rng.randrange(r) for _ in range(n)]
        scalars[5], scalars[6] = 0, r - 1
        limbs = native.scalars_to_limbs(scalars)
        want = host_msm(enc, scalars)

        def rank(mesh, curve=curve, bits=bits, enc=enc, limbs=limbs):
            smsm = ShardedStreamMSM(curve, bits, mesh)
            table, _ = smsm.table_from_limbs(enc.xs, enc.ys, enc.inf)
            return smsm.msm_limbs(table, limbs)

        ec.reset_launch_counts()
        t0 = time.perf_counter()
        got = run_ranks(meshes, rank, timeout_s=300)
        secs = time.perf_counter() - t0
        counts = counter()
        if got != [want, want]:
            raise AssertionError(f"sharded stream MSM {curve.name}: a rank "
                                 f"differs from the C++ Pippenger")
        for k in ("madd_accumulate", "bucket_finish"):
            if counts.get((k, curve.name), 0) != 2:
                raise AssertionError(f"sharded MSM {curve.name}: {k} "
                                     f"launched {counts.get((k, curve.name))}"
                                     f" times on 2 ranks, expected 2")
        say(phase, f"2 gloo ranks on one card ({card}): sharded stream MSM "
                   f"of {n} {curve.name} points == C++ Pippenger on both "
                   f"ranks, K1 and K4 once a rank, {secs:.2f}s wall")
    F = M.mnt4_298().Fr
    p, N = F.MODULUS, SHARDED_H_N
    evs = [[rng.randrange(p) for _ in range(N)] for _ in range(3)]

    def hrank(mesh):
        dh = DistHPoly(F, N, mesh)
        blk = dh.h_block(torch.stack([dh.encode_evals(v) for v in evs]))
        return (dh.n1, dh.n2), limbs_host(dh.gather(blk))

    got = run_ranks(meshes, hrank, timeout_s=300)
    fctx = fft_ctx(F, N, dev)
    dom = fctx.domain
    zh = pow(dom.vanishing_poly_at(dom.coset_shift), -1, p)
    want = limbs_host(hpoly(fctx, *(fctx.encode(v) for v in evs), zh))
    for split, h in got:
        if not np.array_equal(h, want):
            raise AssertionError(f"DistHPoly n={N} at 2 ranks != the "
                                 f"single-card hpoly")
    say(phase, f"2 gloo ranks on one card ({card}): DistHPoly MNT4-298 Fr "
               f"n={N} ({got[0][0][0]} x {got[0][0][1]}) == the single-card "
               f"hpoly on the same evaluations, on both ranks")


def phase_sharded(card, took=None, dev=None, phase=12):
    """The sharded prover (parallel/dist.py) at world size 1 under NCCL:
    `.dist` on both Groth16 provers of mnt4_groth16, a warm step from the
    same ChaCha seed as an unsharded one, proofs byte-equal, verified and
    the negative check rejected, K1 and K4 once per commitment MSM, K5,
    K6 and K7 as sharded_launches says; then sharded_part2.  Reuses
    phase 4's pk, else sets the chain up itself.  Returns the launch
    counts of the sharded warm step."""
    import torch.distributed as dist

    from pcd_tpu_torch import configs
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.parallel.dist import DistContext
    from pcd_tpu_torch.parallel.mesh import make_mesh
    from pcd_tpu_torch.utils import serialize
    from pcd_tpu_torch.utils.rng import ChaChaRng

    t_phase = time.perf_counter()
    if took is None:
        pcd = configs.mnt4_groth16(dev)
        pred = counter_predicate(pcd.ic.main_field)
        rng = ChaChaRng(b"chip smoke sharded setup")
        pk, vk = pcd.circuit_specific_setup(pred, rng)
        one = pcd.ic.main_field.from_int(1)
        proof_1 = pcd.prove(pk, pred, one, one, [], [], rng)
        say(phase, f"mnt4_groth16 set up, base case proved: "
                   f"{time.perf_counter() - t_phase:.1f}s")
    else:
        pcd, pk = took["chain"]
        vk, pred, proof_1 = took["step"]
    dev = pcd.ic.main_snark.device
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    F = pcd.ic.main_field
    one, two = F.from_int(1), F.from_int(2)
    cyc = pcd.ic.cycle
    kinds = (type(pcd.ic.main_snark).__name__,
             type(pcd.ic.help_snark).__name__)
    forms = [(c.name, grp, kind) for cfg, kind in zip((cyc.main, cyc.help),
                                                      kinds)
             for grp, c in (("g1", cfg.g1), ("g2", cfg.g2))]
    mesh = make_mesh(dev)
    dctx = DistContext(mesh)
    snarks = (pcd.ic.main_snark, pcd.ic.help_snark)
    seed = b"chip smoke sharded step"
    steps, secs, counts = {}, {}, {}
    try:
        for tag, d in (("unsharded", None), ("sharded set-up", dctx),
                       ("sharded", dctx)):
            for s in snarks:
                s.dist = d
            ec.reset_launch_counts()
            t0 = time.perf_counter()
            steps[tag] = pcd.prove(pk, pred, two, one, [one], [proof_1],
                                   ChaChaRng(seed))
            sync(dev)
            secs[tag] = time.perf_counter() - t0
            counts[tag] = counter()
    finally:
        for s in snarks:
            s.dist = None
    blobs = {tag: serialize.pcd_proof_to_bytes(pcd, pr)
             for tag, pr in steps.items()}
    if len(set(blobs.values())) != 1:
        raise AssertionError("the sharded warm step's proof bytes differ "
                             "from the unsharded step's")
    if not pcd.verify(vk, pred, two, steps["sharded"]):
        raise AssertionError("the sharded warm step does not verify")
    if pcd.verify(vk, pred, one, steps["sharded"]):
        raise AssertionError("sharded step: negative check accepted an old "
                             "message")
    if dctx.unsharded:
        raise AssertionError(f"a quotient ran unsharded: {dctx.unsharded}")
    want, splits = sharded_launches(dctx, pcd, pk)
    for tag in ("sharded set-up", "sharded"):
        check_once_per_msm(counts[tag], forms, f"the {tag} warm step",
                           dev)
    # the set-up step also builds the n1 and n2 root tables (K7)
    got = {k: v for k, v in counts["sharded"].items() if k in want}
    if got != want:
        raise AssertionError(f"the sharded warm step's quotient launches "
                             f"{got}, expected {want}")
    say(phase, f"world size {mesh.size} ({mesh.backend}, {mesh.device}, "
               f"{card}): {pcd.ic.cycle.name} warm step with .dist on both "
               f"provers (main {splits['main'][0]} x {splits['main'][1]}, "
               f"help {splits['help'][0]} x {splits['help'][1]}) byte-equal "
               f"to the unsharded step from the same ChaCha seed, verifies, "
               f"negative check rejects; K1 and K4 once per commitment MSM")
    say(phase, "sharded warm step quotient launches (K5 a pass of every "
               "n1 and n2 transform, K6 a matrix, K7 eight a field): "
               + json.dumps({f"{k}[{f}]": v for (k, f), v
                             in sorted(want.items())}))
    say(phase, "warm step seconds (one card, no verdict): " + json.dumps(
        {k: round(v, 3) for k, v in secs.items()}) + f"; {card}")
    sharded_part2(card, phase, dev)
    dist.destroy_process_group()
    say(phase, f"sharded prover: {time.perf_counter() - t_phase:.1f}s; "
               f"{card}")
    return counts["sharded"]


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


class FftProbe:
    """While on, wraps snark/marlin/ahp.fft_any: records the size of each
    transform it ran on the device (those that counted in
    ahp.DEVICE_FFTS) and, while `check`, holds each one's values to the
    host path's on the same input.  A domain's first device transform
    builds its FFTTensorCtx first, apart: the K7 launches of its tables
    are counted as `setup`, not as the transform's.  Leaving the `with`
    restores it."""

    def __init__(self, counter):
        self.sizes, self.setup, self.check = [], {}, True
        self.counter = counter

    def __enter__(self):
        from pcd_tpu_torch.ops.fft_tensor import fft_ctx
        from pcd_tpu_torch.snark.marlin import ahp

        self._orig = ahp.fft_any

        def probed(F, vec, size, direction, coset=False, device=None):
            if size >= ahp._DEVICE_FFT_THRESHOLD \
                    and ahp.on_card(device):
                b = self.counter()
                fft_ctx(F, size, device)
                for k, v in self.counter().items():
                    if v != b.get(k, 0):
                        self.setup[k] = self.setup.get(k, 0) + v - b.get(k, 0)
            before = sum(ahp.DEVICE_FFTS.values())
            out = self._orig(F, vec, size, direction, coset, device)
            if sum(ahp.DEVICE_FFTS.values()) > before:
                self.sizes.append(size)
                if self.check and out != self._orig(F, vec, size, direction,
                                                    coset):
                    raise AssertionError(f"fft_any {F.NAME} n={size} "
                                         f"{direction}: device != host")
            return out

        ahp.fft_any = probed
        return self

    def __exit__(self, *exc):
        from pcd_tpu_torch.snark.marlin import ahp

        ahp.fft_any = self._orig

    def take(self):
        """(sizes, setup launches) since the last take."""
        out = (self.sizes, self.setup)
        self.sizes, self.setup = [], {}
        return out


def marlin_k5(results, F, sizes, dev, phase):
    """K5 on the domains of Marlin's transforms (fft_any's ifft: K7 to
    Montgomery form, the passes with n^-1 in the last one's stores, K7
    back): each domain's plan, each pass and K7's conversions exactly
    against their plain versions, the whole ifft against the plain one,
    CUDA-event ms, bound and plain ms.  Appends one ntt_pass record a
    domain and returns them by size."""
    import torch

    from pcd_tpu_torch.ops.fft_tensor import fft_ctx, ntt_tile

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    recs = {}
    for n in sorted(set(sizes)):
        fctx = fft_ctx(F, n, dev)
        f = fctx.f
        a = rand_elems((1, n), F.MODULUS, dev, gen)
        src, perm, last = a, fctx.perm, len(fctx.passes) - 1
        for i, ps in enumerate(fctx.passes):
            post = fctx.n_inv if i == last else None
            got = fctx.ntt_pass(src, fctx.tbl_inv, perm, ps, post=post)
            if not torch.equal(got, fctx.ntt_pass_plain(
                    src, fctx.tbl_inv, perm, ps, None, None, post)):
                raise AssertionError(f"K5 {F.NAME} n={n} Marlin ifft pass "
                                     f"{i}: kernel != plain")
            src, perm = got, None
        for op in ("to_mont", "from_mont"):
            b = f.const(f.r * f.r if op == "to_mont" else 1, dev)
            if not torch.equal(getattr(f, op)(a), f.vmul_plain(a, b)):
                raise AssertionError(f"K7 {F.NAME} {op}: kernel != plain")
        want, plain_ms = timed_plain(lambda: plain_transform(
            fctx, a, fctx.tbl_inv, post=fctx.n_inv), dev)
        if not torch.equal(fctx.ifft(a), want):
            raise AssertionError(f"K5 {F.NAME} n={n}: ifft != plain")
        ms = device_ms(lambda: fctx.ifft(a), 5, dev)
        prods = sum(n // 2 if r == 2 else n * (r - 1)
                    for r, _ in fctx.levels) + n       # + the n^-1 stores
        form = f"{F.NAME} n={n} x1, Marlin's ifft"
        rec = record("ntt_pass", form, 0, 0, ms, plain_ms, 3 * n * 40 + n * 4,
                     PRODUCTS[1] * 2 * prods)
        results.append(rec)
        recs[n] = rec
        say(phase, f"K5 ntt_pass {form}, tile {ntt_tile(n)} points: passes "
                   + "; ".join(f"M {ps.M} Q {ps.Q} C {ps.C} radixes "
                               f"{[r for r, *_ in ps.levels]}"
                               for ps in fctx.passes)
            + f"; every pass of the ifft (the last with the n^-1 "
              f"epilogue) and K7's to_mont and from_mont exact against "
              f"plain; {ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}, {rec['bound_ms'] / ms:.1%}), plain "
              f"{plain_ms:.0f} ms")
    return recs


# phase 7's warm proves in turns on the main side: the AHP's transforms on
# the host ("host": no device) or on K5 ("device"); one pair, as the route
# is the reference's threshold's and the turns decide no setting
MARLIN_TURNS = ("host", "device")
MARLIN_IFFT_SPANS = ("marlin/round1/r1/ifft_mz", "marlin/round2/r2/ifft_r",
                     "marlin/round3/r3/ifft_f")


def marlin_turns(snark, pk, circ, rng, dev, phase):
    """Warm proves in MARLIN_TURNS: the three ifft spans, the whole prove,
    and under "device" fft_any's encode, transform and decode apart (their
    spans); 8 device transforms a device turn, none a host turn."""
    from pcd_tpu_torch.snark.marlin import ahp
    from pcd_tpu_torch.utils import profiling

    rows = {"host": [], "device": []}
    try:
        for tier in MARLIN_TURNS:
            snark.ahp.device = dev if tier == "device" else None
            ahp.DEVICE_FFTS.clear()
            profiling.reset()
            profiling.enable()
            t0 = time.perf_counter()
            snark.prove(pk, circ, rng)
            sync(dev)
            wall = time.perf_counter() - t0
            profiling.enable(False)
            tot = profiling.totals()
            n = sum(ahp.DEVICE_FFTS.values())
            if n != (8 if tier == "device" else 0):
                raise AssertionError(f"Marlin {tier} turn: {n} device "
                                     f"transforms")
            row = {"prove": wall}
            for k in MARLIN_IFFT_SPANS:
                row[k.rsplit("/", 1)[1]] = tot.get(k, (0.0,))[0]
            for part in ("encode", "transform", "decode"):
                row[part] = sum(v[0] for k, v in tot.items()
                                if k.endswith(f"fft_any/{part}"))
            rows[tier].append(row)
    finally:
        snark.ahp.device = dev
    med = {t: {k: [round(sorted(r[k] for r in rs)[len(rs) // 2], 4),
                   round(min(r[k] for r in rs), 4),
                   round(max(r[k] for r in rs), 4)] for k in rs[0]}
           for t, rs in rows.items()}
    pairs = list(zip(*[iter(MARLIN_TURNS)] * 2))
    order = {"host": iter(rows["host"]), "device": iter(rows["device"])}
    wins = 0
    for pair in pairs:
        got = {t: next(order[t])["prove"] for t in pair}
        wins += got["device"] < got["host"]
    say(phase, f"Marlin warm proves in turns {'/'.join(MARLIN_TURNS)}, "
               f"medians [median, min, max] (s): " + json.dumps(med)
        + f"; the device transforms' prove shorter in {wins} of "
          f"{len(pairs)} pairs")


def marlin_stage(what, calls, before, after, form, stream_min, most, dev,
                 ffts=None):
    """Hold one stage's launches to its KZG MSMs: K1 and K4 of `form` once
    per stream MSM (and each P1 and P2 kernel where msm_dispatch schedules
    on `dev`, the MSMs' device), each of at least stream_min scalars, the
    host MSMs all below it; and, with
    ffts = (Fr, sizes of the AHP's device transforms, device), K5 once a
    pass and K7 twice (to and from Montgomery form) for each of those
    transforms, besides the set-up launches of their contexts (the
    fourth item of ffts); no other launch.  Returns the number of stream
    MSMs."""
    from pcd_tpu_torch.ops.fft_tensor import fft_ctx
    from pcd_tpu_torch.ops.msm_stream_dev import SCHED_KERNELS
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
    if ffts is not None:
        F, sizes, dev, setup = ffts
        for k, v in setup.items():
            delta[k] = delta.get(k, 0) - v
            if not delta[k]:
                del delta[k]
        got = (delta.pop(("ntt_pass", F.NAME), 0),
               delta.pop(("fp_vec", F.NAME), 0))
        want = (sum(len(fft_ctx(F, n, dev).passes) for n in sizes),
                2 * len(sizes))
        if got != want:
            raise AssertionError(f"{what}: K5 and K7 launches {got} for "
                                 f"{len(sizes)} device transforms, expected "
                                 f"{want}")
    p1 = {k: sum(delta.pop(kk) for kk in list(delta) if kk[0] == k)
          for k in SCHED_KERNELS}
    tier = msm_dispatch.scheduler_tier(dev)
    each = len(streamed) if tier == "device" else 0
    if p1 != dict.fromkeys(SCHED_KERNELS, each):
        raise AssertionError(f"{what}: P1 and P2 launches {p1} for "
                             f"{len(streamed)} stream MSMs under the "
                             f"{tier!r} scheduler")
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
    ("@marlin-open3"), their launches those of the warm prove, and K5's
    on Marlin's domains.  Returns the universal setups' K8 launches by
    form."""
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.snark.marlin import ahp
    from pcd_tpu_torch.snark.marlin.kzg import KZG10
    from pcd_tpu_torch.snark.marlin.native import MarlinBound, MarlinSNARK
    from pcd_tpu_torch.snark.msm_dispatch import host_query, msm_any, subrange
    from pcd_tpu_torch.utils import profiling
    from pcd_tpu_torch.utils.rng import ChaChaRng

    cyc = M.mnt_cycle()
    stream_min = KZG10.STREAM_MIN
    keygens = {}
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
        fft_dev = ahp.on_card(dev_)       # the card (rehearsals:
        with KZGProbe() as kp, \
                FftProbe(counter) as fp:          # patched for the CPU)
            t0 = time.perf_counter()
            need = snark.circuit_degree(circ)
            srs = snark.universal_setup(MarlinBound(need), rng)
            secs["setup"] = time.perf_counter() - t0
            before = counter()
            keygen = {f: v for (k, f), v in before.items()
                      if k == "fixed_base_mul"}
            want = {form: 1} if msm_dispatch.KEYGEN == "device" \
                and msm_dispatch.on_card(dev_) else {}
            if keygen != want:
                raise AssertionError(f"Marlin {side}'s universal setup: K8 "
                                     f"launches {keygen}, expected {want}")
            keygens.update(keygen)
            t0 = time.perf_counter()
            pk, vk = snark.index(srs, circ, rng)
            sync(dev_)
            secs["index"] = time.perf_counter() - t0
            idx = pk.index
            # every transform of the index and the prove is at least the
            # device threshold here: all on K5 on the card
            big = min(idx.n, idx.k_size) >= ahp._DEVICE_FFT_THRESHOLD
            want = (9, 8) if fft_dev and big else (0, 0)
            ffts, setup = {}, {}
            ffts["index"], setup["index"] = fp.take()
            stages["index"] = marlin_stage(
                "index", kp.take(), before, counter(), form, stream_min, 9,
                dev_, (Fr, ffts["index"], dev_, setup["index"]))
            before = counter()
            t0 = time.perf_counter()
            proof_1 = snark.prove(pk, circ, rng)
            sync(dev_)
            secs["prove_cold"] = time.perf_counter() - t0
            ffts["prove_cold"], setup["prove_cold"] = fp.take()
            stages["prove_cold"] = marlin_stage(
                "cold prove", kp.take(), before, counter(), form,
                stream_min, 20, dev_, (Fr, ffts["prove_cold"], dev_,
                                       setup["prove_cold"]))
            spans_cold = profiling.totals()
            profiling.reset()
            fp.check = False                       # the warm prove: timed
            ec.reset_launch_counts()               # the warm prove starts
            with LaunchProbe() as probe:
                probe.on = True
                t0 = time.perf_counter()
                proof_2 = snark.prove(pk, circ, rng)
                sync(dev_)
                secs["prove_warm"] = time.perf_counter() - t0
                probe.on = False
            warm = counter()                       # the warm prove ended
            ffts["prove_warm"], setup["prove_warm"] = fp.take()
            if setup["prove_warm"]:
                raise AssertionError(f"Marlin {side}: the warm prove built "
                                     f"a transform context")
            stages["prove_warm"] = marlin_stage(
                "warm prove", kp.take(), {}, warm, form, stream_min, 20,
                dev_, (Fr, ffts["prove_warm"], dev_, {}))
            got = tuple(len(ffts[k]) for k in ("index", "prove_cold"))
            if got != want or len(ffts["prove_warm"]) != want[1]:
                raise AssertionError(f"Marlin {side}: device transforms "
                                     f"{ {k: len(v) for k, v in ffts.items()} }"
                                     f", expected {want[0]} an index and "
                                     f"{want[1]} a prove")
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
                         form, stream_min, 2, dev_)
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
        say(phase, f"universal setup under KEYGEN {msm_dispatch.KEYGEN!r}: "
                   f"K8 launches {json.dumps(keygen)}; the AHP's transforms "
                   f"on K5 (each held to the host path's values in the "
                   f"index and the cold prove): "
                   + json.dumps({k: len(v) for k, v in ffts.items()}))
        if ffts["prove_warm"]:
            for rec in marlin_k5(results, Fr, ffts["index"]
                                 + ffts["prove_warm"], dev_, phase).values():
                rec["launches"] = warm.get(("ntt_pass", Fr.NAME), 0)
            if side == "main":
                marlin_turns(snark, pk, circ, rng, dev_, phase)
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
        say(phase, "the warm prove's event brackets [launches, event ms, "
                   "longest event ms, host ms between the records]: "
            + json.dumps({f"{k}[{f}]": [n, round(ev, 3), round(top, 3),
                                        round(host, 3)]
                          for (k, f), (n, ev, top, host)
                          in sorted(probe.brackets().items())}))
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
    return keygens


class ProbeInputs:
    """Kernel inputs for phase_path, as a LaunchProbe holds them: `first`
    {(kernel, curve name): (ECCtx, args)} and `firsts` [(StreamMSMCtx,
    finish args)]; no schedule's (`sched` empty)."""

    def __init__(self, first, firsts):
        self.first, self.firsts, self.sched = first, firsts, {}


def phase_marlin_chain(dev=None, phase=8):
    """The real mnt4_marlin PCD chain through the universal setup
    (reference tests/mnt4_marlin.rs:141-204); K1 and K4 must run on both
    curves' G1, no kernel on G2 (Marlin has no G2 MSM)."""
    from pcd_tpu_torch import configs
    from pcd_tpu_torch.ops import ec
    from pcd_tpu_torch.snark.marlin.native import MarlinBound
    from pcd_tpu_torch.utils.rng import ChaChaRng

    secs = {}
    pcd = configs.mnt4_marlin(dev)
    dev = pcd.ic.main_snark.device
    counter = ec.launch_counts if dev.type == "cuda" else ec.plain_counts
    F = pcd.ic.main_field
    pred = counter_predicate(F)
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
    phases = {1, 2, 3, 4, 6, 7, 9, 10, 11, 12}
    if "--phases" in argv:
        asked = {int(x) for x in argv[argv.index("--phases") + 1].split(",")}
        if asked - phases - {8} or (8 in asked and asked - {1, 8}):
            print(f"chip_smoke: phases to choose: 1, 2, 3, 4, 6, 7, 9, 10, "
                  f"11, 12, or 8 alone (5 runs with 4 and 6); asked "
                  f"{sorted(asked)}", file=sys.stderr)
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
    from pcd_tpu_torch.ops.msm_stream_dev import SCHED_KERNELS
    t_start = time.perf_counter()
    results = []

    def keygen():                  # before the chains, whose setups run K8
        t0 = time.perf_counter()
        k8, _ = phase_keygen(results)
        say(11, f"device keygen: {time.perf_counter() - t0:.1f}s, while "
                f"the other kernels built")
        return k8
    card, k8 = phase_build(keygen if 11 in phases else None)
    k8 = k8 or {}
    k3 = phase_kernels() if 2 in phases else []
    results += k3
    if 3 in phases:
        phase_msm()
    if 9 in phases:                # before the chains: they run it too
        t0 = time.perf_counter()
        phase_devsched(results)
        say(9, f"device scheduler: {time.perf_counter() - t0:.1f}s")
    chain_counts, quot_counts, took4, pend = [], {}, None, []
    keygens = {}                   # K8 launches of the setups, by form
    after4 = {10: 4.5, 12: 4.7}    # after phase 4: its pk and warm step
    for ph in sorted(set(CHAINS) & phases | (set(after4) & phases),
                     key=lambda ph: after4.get(ph, ph)):
        if ph == 10:
            t0 = time.perf_counter()
            pend = phase_quotient(results, took4)
            say(10, f"device quotient: {time.perf_counter() - t0:.1f}s")
            continue
        if ph == 12:
            phase_sharded(card, took4)
            continue
        for name in CHAINS[ph]:
            t0 = time.perf_counter()
            counts, probe, took = phase_chain(name, ph, turns=ph == 4)
            chain_counts.append(counts)
            quot_counts[name] = took["quot_counts"]
            for f, v in took["keygen"].items():
                keygens[f] = keygens.get(f, 0) + v
            if ph == 4:
                took4 = took
            phase_path(results, probe, counts, name, 5 if ph == 4 else ph)
            say(ph, f"{name}: {time.perf_counter() - t0:.1f}s with its "
                    f"first-launch kernel checks")
    for rec, chain, kernel, field in pend:   # K5-K7 on a device-quotient
        got = quot_counts.get(chain)         # warm step of their chain
        rec["launches"] = None if got is None else sum(
            v for (k, f), v in got.items() if k == kernel and f == field)
    if 7 in phases:
        t0 = time.perf_counter()
        for f, v in phase_marlin(results).items():
            keygens[f] = keygens.get(f, 0) + v
        say(7, f"Marlin on both curves: {time.perf_counter() - t0:.1f}s "
               f"with its kernel checks")
    if 8 in phases:
        phase_marlin_chain()
    ran = chain_counts or 7 in phases
    for form, rec in k8.items():   # K8's launches in the setups run
        rec["launches"] = keygens.get(form, 0) if ran else None
    for rec in results:            # P1's, P2's on the chains' main paths
        kernel = rec["name"].split("[")[0]
        if kernel in SCHED_KERNELS and chain_counts:
            form = rec["name"][len(kernel) + 1:-1]
            rec["launches"] = sum(c.get((kernel, form), 0)
                                  for c in chain_counts)
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
