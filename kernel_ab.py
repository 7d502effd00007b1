#!/usr/bin/env python3
"""Kernel A/B measurements on one NVIDIA card.  Run from the root of a
checkout:

    python3 kernel_ab.py --other DIR [--sweep] [--k4]
    python3 kernel_ab.py --k4
    python3 kernel_ab.py --quotient --other DIR
    python3 kernel_ab.py --sched --other DIR
    python3 kernel_ab.py --keygen --other DIR [--sweep]
    python3 kernel_ab.py --trace --other ROOT
    python3 kernel_ab.py --ec --other DIR [--sweep]

--other DIR: K1 (madd_accumulate) of this checkout against K1 of another
copy of pcd_tpu_torch/csrc, and the integer multiply-adds one field
product issues in SASS in each.  DIR is e.g. the parent commit's csrc,
unpacked with `git archive <commit> pcd_tpu_torch/csrc | tar -x -C
build/parent`.

  sass   a probe kernel per tree calls fp_mul (D = 1) and ext_mul<2>,
         ext_mul<3> once; `cuobjdump -sass` counts its IMAD-family
         instructions (moves, IMAD.MOV, apart) and all instructions;
  time   for the four field forms of the main path, K1 on inputs shaped
         like the Groth16 warm step's first launch (25 windows x 8192
         lanes, every lane full: T = 24 for MNT4, 4 for MNT6; a 2^18-row
         table of random field elements, random signs), CUDA events, in
         the order other, this, this, other; the two outputs must agree
         limb for limb;
  sweep  this tree's K1 built again with each `__launch_bounds__` minimum
         of SWEEP (K1_MINB1..3 of madd_accumulate.cu) and timed the same
         way, with ptxas' registers and spills per build.

--k4: the stream-MSM finish, K4 (bucket_finish) against the running-sum
design of kernel_ab_runsum.cu at M = 2, 4, 8, 16 buckets a thread, for
each form on chip_smoke.py phase 2's inputs (finish_inputs: 2^16 scalars,
c = 12, an all-zero window, a one-bucket window, P and -P) and on dense
ones (the same without the edge cases: about four lanes a bucket, as in
the chains' MSMs); the variant must give K4's affine window sums; CUDA
events in the order K4, variant Ms, variant Ms reversed, K4.  Then one thread's chain of 32 dependent complete adds through
K4's add (pcd_add_chain) in 1, 132, 264 and 400 blocks of 128 threads
(400: K4's grid at c = 12), which gives the latency of one add.

--quotient --other DIR: the device quotient `hpoly` of this checkout
against the one of another copy of pcd_tpu_torch/csrc (DIR, e.g. the
parent's: its ntt.cu has the entry pcd_ntt_pass without a prologue or
an epilogue, so every scaling is a launch of its fp_vec.cu's K7), in
place of K1, on chip_smoke.py phase 10's four domains at the provers'
batch (the GM17 domains in the squaring form), random evaluations from
a seed.  Both
trees launch through their raw C entries into buffers allocated once:
the other the K7 check, ifft (K5 passes, n^-1), coset_fft (the coset
table, K5 passes), (a b - c) Z_H^-1, coset_ifft (K5 passes, n^-1, the
inverse coset table) and from_mont; this tree the K7 check and three
transforms, the scalings in K5's prologues and epilogues.  Both equal
fft_tensor.hpoly limb for limb.  Each is timed twice in the order
other, this, this, other: by CUDA events around five calls, and by the
kernels' busy time in a torch.profiler trace of six calls, the last
five calls' worth of kernels recorded (host gaps between launches left
out).

--sched --other DIR: the device scheduler's P1 + P2 of this checkout
(csrc/sched_digits.cu's four kernels, p1_scatter storing each digit's
sign in bit 31 of order, then csrc/sched_place.cu's one launch) against
another copy of pcd_tpu_torch/csrc (DIR, one whose p1_scatter takes no
signs and whose P2 is p2_buckets, one block a window, then p2_place,
which gathers each placed entry's sign: the parent of this design),
both trees through their raw C entries, on chip_smoke.py phase 9's 2^18
298-bit scalars at c = 12, dense and low-entropy; then P2 alone, this
tree's against the other's and against the two-launch variant of
kernel_ab_p2split.cu (p2_buckets' split kept but spread over several
blocks a window, on this tree's signed order).  Every result equals
this tree's (the other's order with bit 31 masked); CUDA events around
five calls enqueued behind a spinning kernel (the card's time back to
back) and around five calls as the host launches them, in the order
other, this[, split], then reversed, three times; medians.

--keygen --other DIR [--sweep]: K8 (fixed_base_mul) of this checkout
against another copy's csrc/fixed_base.cu (DIR; one whose entry takes
no SmallA, e.g. the one-thread-a-scalar kernel before this design),
both built here into build/kernel_ab and called through their raw C
entries on the four forms' window tables, at 2^14 random scalars and at
chip_smoke.KEYGEN_LOG_N (the setups' size: 2^18 MNT4 G1, 2^16 the
others); the outputs equal limb for limb; CUDA events around three
calls in the order other, this, this, other, three times, and the
medians, with the pairs in which this tree is faster; ptxas' lines of
every build.  --sweep: this tree's K8 built again with each launch
shape of K8_SWEEP (csrc/fixed_base.cuh K8_SHAPE: splits a scalar, lanes
an add at D = 1, 2, 3, threads a block, minimum blocks; in a header the
build pre-includes), each timed twice more after the turns.  Each build
prints its launch at each size (splits, tile, grid) from its own
pcd_fixed_base_info.

--trace --other ROOT: one warm step of the real mnt4_groth16 chain under
msm_dispatch.SCHEDULER = "device" inside utils/profiling.device_trace,
for another checkout (ROOT, its root: e.g. the parent commit, unpacked
with `git archive <commit> | tar -x -C build/parent`) and for this one,
in that order, each in a process of its own that imports that tree's
pcd_tpu_torch: setup, the base case and one warm step, then the traced
warm step, which must verify.  For each: the step, stream_dispatch_h,
and for every histogram fetch of a schedule (a device-to-host copy of
nwin x (B + 2) int32) the host's wait from the copy's runtime call to
its start on the card, its stream, and the kernels that ran in that
wait on its stream and on the others (ms of overlap by kernel name).
The traces are kept, gzipped, under chiprun_out/device_trace/.

--ec --other DIR: K2 (complete_add, the four forms of the main path)
and K3 (madd, the G1 forms) of this checkout against those of another
copy of pcd_tpu_torch/csrc (DIR, e.g. one with one thread an add:
`git archive c0dd5d2 pcd_tpu_torch/csrc`), each tree's sources built here
into build/kernel_ab and called through its raw C entry, on chip_smoke.py
phase 2's inputs (k1_inputs, folded by K1's plain version; pair_inputs
and madd_inputs); the two outputs must agree limb for limb (K3: each
tree on its own copy of the accumulators); CUDA events in the order
other, this, this, other (then each --sweep build); ptxas' registers and
spills of every build.  Then one add's latency by chains of EC_CHAIN
dependent adds (kernel_ab_chain.cu: pcd_chain_one, the one-thread body
before the redesign, and pcd_chain_group, K2's group add built at each
of CHAIN_GS lanes) at 1 and at EC_CHAINS chains, the chains' results
equal limb for limb.  --sweep:
this tree's K2 and K3 built again with each launch shape of EC_SWEEP
(group sizes, block size, minimum blocks an SM).  K1's and K4's sources of both
trees are built too, and their ptxas lines must agree.

Prints one line per measurement and a JSON summary as the last line.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
# variants of this tree's K1: minimum blocks of 128 threads per SM for
# every D (register caps 255, 168, 128: 8, 12, 16 warps per SM)
SWEEP = {f"minb{b}": [f"-DK1_MINB{d}={b}" for d in (1, 2, 3)]
         for b in (1, 3, 4)}
RUNSUM = os.path.join(HERE, "kernel_ab_runsum.cu")
RUNSUM_M = (2, 4, 8, 16)
CHAIN_GRIDS, CHAIN_N = (1, 132, 264, 400), 32
# --ec --sweep: this tree's K2 and K3 built again with these launch
# shapes (csrc/ec_group.cuh K2_SHAPE: lanes an add at D = 1, 2, 3, 0 for
# one thread through rcb_add, threads, minimum blocks at D = 1, 2;
# K3_SHAPE: lanes an add, threads, minimum blocks), both in a header that
# the build pre-includes; each kernel reads only its own
EC_SWEEP = {
    "k2g1_k3g2": ("1, 1, 1, 128, 4, 2", "2, 128, 4"),
    "g3": ("3, 3, 3, 128, 4, 2", "3, 128, 4"),
    "k2d2g0_g6": ("6, 0, 6, 128, 4, 2", "6, 128, 4"),
    "k2g1_t96": ("1, 1, 0, 96, 4, 2", "1, 96, 4"),
    "t64": ("2, 1, 0, 64, 4, 2", "1, 64, 4"),
    "minb3": ("2, 1, 0, 128, 3, 2", "1, 128, 3"),
    "minb5": ("2, 1, 0, 128, 5, 2", "1, 128, 5"),
}
# --keygen --sweep: this tree's K8 built again with these launch shapes
# (csrc/fixed_base.cuh K8_SHAPE: the most splits a scalar, lanes an add
# at D = 1, 2, 3, threads a block, minimum blocks), in a header the build
# pre-includes
K8_SWEEP = {
    "s4": "4, 1, 1, 1, 128, 3",
    "m2": "2, 1, 1, 1, 128, 2",
    "t64": "2, 1, 1, 1, 64, 6",
    "g123": "2, 1, 2, 3, 128, 3",
}
P2SPLIT_SRC = os.path.join(HERE, "kernel_ab_p2split.cu")
# the add chains' group sizes (kernel_ab_chain.cu CHAIN_G)
CHAIN_GS = (1, 2, 3, 6)
EC_CHAIN, EC_CHAINS = 32, 264 * 128
# kernels --ec builds in both trees only to compare ptxas' lines: K1 and
# K4 and the device functions they call are not edited
UNCHANGED = ("madd_accumulate", "bucket_finish")
CHAIN_SRC = os.path.join(HERE, "kernel_ab_chain.cu")
FORMS = (("mnt4_298.G1", "main", "g1", 24), ("mnt4_298.G2", "main", "g2", 24),
         ("mnt6_298.G1", "help", "g1", 4), ("mnt6_298.G2", "help", "g2", 4))
PROBE = r"""
#include "field.cuh"
__global__ void probe_fp_mul(const uint32_t* a, uint32_t* r, FieldConsts k) {
  uint32_t x[NL], y[NL], z[NL];
  for (int l = 0; l < NL; ++l) { x[l] = a[l]; y[l] = a[NL + l]; }
  fp_mul(z, x, y, k);
  for (int l = 0; l < NL; ++l) r[l] = z[l];
}
template <int D>
__global__ void probe_ext(const uint32_t* a, uint32_t* r, FieldConsts k) {
  Fe<D> x, y, z;
  for (int i = 0; i < D; ++i)
    for (int l = 0; l < NL; ++l) {
      x.c[i][l] = a[i * NL + l];
      y.c[i][l] = a[(D + i) * NL + l];
    }
  ext_mul<D>(z, x, y, k);
  for (int i = 0; i < D; ++i)
    for (int l = 0; l < NL; ++l) r[i * NL + l] = z.c[i][l];
}
template __global__ void probe_ext<2>(const uint32_t*, uint32_t*, FieldConsts);
template __global__ void probe_ext<3>(const uint32_t*, uint32_t*, FieldConsts);
"""
INS = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def nvcc(args):
    from pcd_tpu_torch.ops.kernels import nvcc_path

    return subprocess.Popen([nvcc_path(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def sass_counts(cubin):
    """{function: {"imad": n, "all": n, "ops": {opcode: n}}} of a cubin."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = Counter()
            continue
        m = INS.search(line)
        if fn and m:
            out[fn][m.group(1)] += 1
    res = {}
    for fn, ops in out.items():
        imad = {o: n for o, n in ops.items()
                if o.startswith("IMAD") and not o.startswith("IMAD.MOV")}
        res[fn] = {"imad": sum(imad.values()), "all": sum(ops.values()),
                   "ops": dict(sorted(imad.items()))}
    return res


def short(fn):
    for key, name in (("probe_fp_mul", "fp_mul<1> (in its probe)"),
                      ("ext_mulILi2", "ext_mul<2>"),
                      ("ext_mulILi3", "ext_mul<3>"),
                      ("probe_extILi2", "ext_mul<2> (in its probe)"),
                      ("probe_extILi3", "ext_mul<3> (in its probe)")):
        if key in fn:
            return name
    return None


def load_k1(so):
    from pcd_tpu_torch.ops.kernels import load

    return load(so, "madd_accumulate")


def load_runsum(so):
    from pcd_tpu_torch.ops.kernels import load

    L = load(so, "bucket_finish")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    L.pcd_bucket_finish_runsum.restype = ci
    L.pcd_bucket_finish_runsum.argtypes = [ci, ci] + [vp] * 7 + [ci] * 3 \
        + [vp, vp]
    L.pcd_add_chain.restype = ci
    L.pcd_add_chain.argtypes = [ci, vp, vp, ci, ci, vp, vp]
    return L


def inputs(ec, T, nwin=25, L=8192, m=1 << 18, seed=7):
    """Random field elements below p as table rows, random rows and signs,
    every lane full."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    top = int(ec.f.p_limbs[-1])
    tab = torch.randint(0, 1 << 32, (m, 2, ec.d, 10), generator=g,
                        device="cuda", dtype=torch.int64)
    tab[..., 9] = torch.randint(0, top, (m, 2, ec.d), generator=g,
                                device="cuda", dtype=torch.int64)
    tab = torch.where(tab >= 1 << 31, tab - (1 << 32), tab).to(torch.int32)
    perm = (torch.randint(0, m, (nwin, T, L), generator=g, device="cuda",
                          dtype=torch.int64)
            | (torch.randint(0, 2, (nwin, T, L), generator=g, device="cuda",
                             dtype=torch.int64) << 31))
    perm = torch.where(perm >= 1 << 31, perm - (1 << 32), perm).to(
        torch.int32)
    loads = torch.full((nwin, L), T, dtype=torch.int32, device="cuda")
    return tab.contiguous(), perm.contiguous(), loads


def run_k1(lib, ec, tab, perm, loads):
    import torch

    nwin, T, L = perm.shape
    out = torch.empty((nwin, L, 3, ec.d, 10), dtype=torch.int32,
                      device="cuda")
    rc = lib.pcd_madd_accumulate(
        ec.d, tab.data_ptr(), perm.data_ptr(), loads.data_ptr(),
        out.data_ptr(), nwin * L, T, L,
        ec.kconsts.ctypes.data_as(ctypes.c_void_p),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    return out


def ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def k4_ab(lib, summary):
    """K4 against the running-sum variant on phase 2's inputs and on
    dense ones, then the add chain (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from pcd_tpu_torch.ops.ec import ec_ctx

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    summary["k4"], summary["chain_us_per_add"] = {}, {}
    for (form, cfg, which), edges in itertools.product(cs.form_cases(),
                                                      (True, False)):
        ec = ec_ctx(getattr(cfg, which))
        kc = ec.kconsts.ctypes.data_as(ctypes.c_void_p)
        _, sched, accs, bidx, runrem = cs.finish_inputs(
            ec, cfg, which, rng, dev, edges=edges)
        what = "phase 2" if edges else "dense"
        nwin, L = runrem.shape
        B = bidx.shape[1]
        want = [ec.decode_point(w)
                for w in ec.bucket_finish(accs, bidx, runrem).cpu().numpy()]

        def variant(M):
            out = torch.empty((nwin, 3, ec.d, 10), dtype=torch.int32,
                              device=dev)
            part = torch.empty((nwin, B // (128 * M), 2, 3, ec.d, 10),
                               dtype=torch.int32, device=dev)
            scratch = torch.empty_like(accs)
            done = torch.empty((nwin,), dtype=torch.int32, device=dev)
            rc = lib.pcd_bucket_finish_runsum(
                ec.d, M, accs.data_ptr(), bidx.data_ptr(), runrem.data_ptr(),
                scratch.data_ptr(), part.data_ptr(), done.data_ptr(),
                out.data_ptr(), nwin, L, B, kc,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"runsum M={M}: CUDA error {rc}")
            return out

        for M in RUNSUM_M:
            got = [ec.decode_point(w) for w in variant(M).cpu().numpy()]
            if got != want:
                raise AssertionError(f"runsum M={M} {form}: != K4")
        fns = {"k4": lambda: ec.bucket_finish(accs, bidx, runrem)}
        for M in RUNSUM_M:
            fns[f"runsum_m{M}"] = lambda M=M: variant(M)
        order = list(fns) + list(reversed(list(fns)))
        times = {}
        for name in order:
            times.setdefault(name, []).append(ms(fns[name], reps=3))
        res = {k: sum(v) / len(v) for k, v in times.items()}
        summary["k4"][f"{form} {what}"] = res
        print(f"K4 {form} ({what} inputs, maxrun {sched.maxrun}): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in res.items()),
              flush=True)
        if not edges:
            continue
        pts = accs.reshape(-1, 3, ec.d, 10)[:max(CHAIN_GRIDS) * 128]
        pts = pts.contiguous()
        out = torch.empty_like(pts)
        chain = {}
        for g in CHAIN_GRIDS:
            def run(g=g):
                rc = lib.pcd_add_chain(
                    ec.d, pts.data_ptr(), out.data_ptr(), g * 128, CHAIN_N,
                    kc, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"add chain: CUDA error {rc}")
            chain[g] = ms(run, reps=3) * 1e3 / CHAIN_N
        P = ec.decode_point(pts[0].cpu().numpy())
        if ec.decode_point(out[0].cpu().numpy()) != P * (CHAIN_N + 1):
            raise AssertionError(f"add chain {form}: != (N + 1) P")
        summary["chain_us_per_add"][form] = chain
        print(f"add chain {form}, us per add by blocks of 128: " + ", ".join(
            f"{g}: {v:.2f}" for g, v in chain.items()), flush=True)
        del accs, pts, out
        torch.cuda.empty_cache()


def load_ec(so2, so3, old):
    """K2's and K3's libraries of one tree: this tree's entries
    (ops/kernels.py), or with old=True the entries before the redesign
    (no SmallA argument)."""
    from pcd_tpu_torch.ops.kernels import load

    if not old:
        return load(so2, "complete_add"), load(so3, "madd")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    L2, L3 = ctypes.CDLL(so2), ctypes.CDLL(so3)
    L2.pcd_complete_add.restype = L3.pcd_madd.restype = ci
    L2.pcd_complete_add.argtypes = [ci, vp, vp, vp, cl, vp, vp]
    L3.pcd_madd.argtypes = [ci, vp, vp, vp, vp, cl, vp, vp]
    return L2, L3


def ec_ab(libs, old, chain_sos, summary):
    """--ec: K2 and K3 of each build in `libs` ({name: (K2 lib, K3 lib)};
    the names in `old` take the entries before the redesign) in turns on
    phase 2's inputs, then the add chains ({group size: library}; see the
    module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from pcd_tpu_torch.ops.ec import ec_ctx

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rng = np.random.default_rng(2026)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    chains = {g: ctypes.CDLL(so) for g, so in chain_sos.items()}
    for chain in chains.values():
        chain.pcd_chain_one.restype = chain.pcd_chain_group.restype = ci
        chain.pcd_chain_one.argtypes = [ci, vp, vp, ci, ci, vp, vp]
        chain.pcd_chain_group.argtypes = [ci, vp, vp, ci, ci, vp, vp, vp]
    one = chains[min(chains)]
    summary["ec_ms"], summary["chain_us_per_add"] = {}, {}
    order = ["other", "this", "this", "other"] + [
        n for n in libs if n not in ("other", "this")]
    for form, cfg, which in cs.form_cases():
        ec = ec_ctx(getattr(cfg, which))
        kc = ec.kconsts.ctypes.data_as(ctypes.c_void_p)
        ks = ec.ksmall.ctypes.data_as(ctypes.c_void_p)
        table, perm, loads = cs.k1_inputs(ec, cfg, which, rng, dev)
        acc0 = ec.madd_accumulate_plain(table, perm, loads)
        P, Q, _ = cs.pair_inputs(ec, acc0)
        n = P.shape[0]
        outs = {name: torch.empty_like(P) for name in libs}

        def k2(name):
            args = (ec.d, P.data_ptr(), Q.data_ptr(), outs[name].data_ptr(),
                    n, kc) + (() if name in old else (ks,)) + (stream(),)
            rc = libs[name][0].pcd_complete_add(*args)
            if rc:
                raise RuntimeError(f"K2 {name} {form}: CUDA error {rc}")

        jobs = {"K2": k2}
        if which == "g1":
            acc, q, sign, active = cs.madd_inputs(
                ec, table, acc0.reshape(-1, 3, 1, 10), rng)[:4]
            accs = {name: acc.clone() for name in libs}

            def k3(name):
                args = (1, accs[name].data_ptr(), q.data_ptr(),
                        sign.data_ptr(), active.data_ptr(), n, kc) + (
                    () if name in old else (ks,)) + (stream(),)
                rc = libs[name][1].pcd_madd(*args)
                if rc:
                    raise RuntimeError(f"K3 {name} {form}: CUDA error {rc}")

            jobs["K3"] = k3
        for kern, fn in jobs.items():
            for name in libs:
                fn(name)
            torch.cuda.synchronize()
            res = outs if kern == "K2" else accs
            for name in libs:
                if not torch.equal(res[name], res["other"]):
                    raise AssertionError(f"{kern} {form}: {name} != other")
            times = {}
            for name in order:
                times.setdefault(name, []).append(
                    ms(lambda: fn(name), reps=10))
            avg = {k: sum(v) / len(v) for k, v in times.items()}
            summary["ec_ms"][f"{kern} {form}"] = {"turns": times, "ms": avg}
            print(f"{kern} {form} ({n} rows): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in avg.items()) + "; turns "
                + json.dumps({k: [round(x, 4) for x in v]
                              for k, v in times.items()}), flush=True)
        # one add's latency: chains through both designs, the group add
        # at each of CHAIN_GS lanes
        res = {}
        designs = ["one"] + [f"g{g}" for g in chains]
        for nch in (1, EC_CHAINS):
            pts = P[:nch].contiguous()
            got = {}
            for design in designs + designs[::-1]:
                out = torch.empty_like(pts)

                def run(design=design, out=out):
                    if design == "one":
                        rc = one.pcd_chain_one(
                            ec.d, pts.data_ptr(), out.data_ptr(), nch,
                            EC_CHAIN, kc, stream())
                    else:
                        rc = chains[int(design[1:])].pcd_chain_group(
                            ec.d, pts.data_ptr(), out.data_ptr(), nch,
                            EC_CHAIN, kc, ks, stream())
                    if rc:
                        raise RuntimeError(f"chain {design}: CUDA error "
                                           f"{rc}")

                t = ms(run, reps=3) * 1e3 / EC_CHAIN
                res.setdefault(f"{design} x{nch}", []).append(t)
                got[design] = out
            for design in designs[1:]:
                if not torch.equal(got["one"], got[design]):
                    raise AssertionError(f"chains {form}: {design} != one")
        P0 = ec.decode_point(P[0].cpu().numpy())
        if ec.decode_point(got["one"][0].cpu().numpy()) != P0 * (
                EC_CHAIN + 1):
            raise AssertionError(f"chain {form}: != (N + 1) P")
        avg = {k: sum(v) / len(v) for k, v in res.items()}
        summary["chain_us_per_add"][form] = avg
        print(f"add chain {form}, us per add (design x chains): " + ", ".join(
            f"{k}: {v:.3f}" for k, v in avg.items()), flush=True)
        del table, perm, loads, acc0, P, Q, outs
        torch.cuda.empty_cache()


def load_other_quotient(ntt_so, fpv_so):
    """The other tree's K5 entry without prologue or epilogue and its K7
    (csrc/ntt.cu, csrc/fp_vec.cu of DIR)."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    ntt, fpv = ctypes.CDLL(ntt_so), ctypes.CDLL(fpv_so)
    ntt.pcd_ntt_pass.restype = ci
    ntt.pcd_ntt_pass.argtypes = [vp] * 4 + [cl, ci, vp, vp, vp]
    fpv.pcd_fp_vec.restype = ci
    fpv.pcd_fp_vec.argtypes = [ci, cl, cl, cl] + [vp] * 9
    return ntt, fpv


def in_turns(fns, order, logdir):
    """Mean CUDA-event ms and mean kernel ms (None where no trace of it
    held its kernels) of each fns[name] = (fn, launches a call) over the
    names of `order` (each timed once per appearance)."""
    import chip_smoke as cs

    ev, dv = {}, {}
    for i, name in enumerate(order):
        fn, launches = fns[name]
        ev.setdefault(name, []).append(ms(fn))
        t = cs.kernel_ms(fn, os.path.join(logdir, f"{i}"), launches)
        dv.setdefault(name, [])
        if t is not None:
            dv[name].append(t)
    return ({k: sum(v) / len(v) for k, v in ev.items()},
            {k: sum(v) / len(v) if v else None for k, v in dv.items()})


def quotient_ab(libs, summary, out_dir):
    """hpoly, this tree against the other, both launched through their
    raw C entries into buffers allocated once (see the module
    docstring)."""
    import torch

    import chip_smoke as cs
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops.fft_tensor import (EPI_MUL, EPI_NONE, PRO_ABC,
                                              PRO_NONE, fft_ctx, hpoly)
    from pcd_tpu_torch.ops.field import FieldCtx

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    cyc = M.mnt_cycle()
    summary["hpoly"] = {}
    for side, n, batch, _ in cs.QUOTIENT_DOMAINS:
        F = getattr(cyc, side).Fr
        fctx = fft_ctx(F, n, dev)
        f = fctx.f
        kc = f.kconsts.ctypes.data_as(ctypes.c_void_p)
        geoms = [ps.geom() for ps in fctx.passes]
        d = fctx.domain
        zh_inv = pow(d.vanishing_poly_at(d.coset_shift), -1, f.p)
        zh, one = f.mont(zh_inv, dev), f.const(1, dev)
        coset_inv = fctx._pow_table(d.coset_shift_inv)
        x = cs.rand_elems((batch, n), F.MODULUS, dev, gen)
        sq = batch == 2                         # GM17: b is a
        rows = (x[0], x[0], x[1]) if sq else (x[0], x[1], x[2])
        bufs = [torch.empty_like(x) for _ in range(4)]
        chk = torch.empty((n, 10), dtype=torch.int32, device=dev)
        h1 = (torch.empty((1, n, 10), dtype=torch.int32, device=dev),
              torch.empty((1, n, 10), dtype=torch.int32, device=dev))

        def fpv(lib, op, nn, nb, a, b, c, s, out):
            rc = lib.pcd_fp_vec(op, nn, nb, 0, a.data_ptr(), b.data_ptr(),
                                None if c is None else c.data_ptr(),
                                None if s is None else s.data_ptr(),
                                out.data_ptr(), None, None, kc, stream)
            if rc:
                raise RuntimeError(f"fp_vec: CUDA error {rc}")
            return out

        def transform(src, tbl, nb, outs, pro=PRO_NONE, pv=None, np_=0,
                      post=None, other=False):
            perm, last = fctx.perm.data_ptr(), len(geoms) - 1
            for i, geom in enumerate(geoms):
                args = (src.data_ptr(), outs[i % 2].data_ptr(),
                        tbl.data_ptr(), perm, n, nb,
                        geom.ctypes.data_as(ctypes.c_void_p), kc, stream)
                if other:
                    rc = libs["ntt_other"].pcd_ntt_pass(*args)
                else:
                    e = post if i == last else None
                    rc = libs["ntt"].pcd_ntt_pass(
                        *args, pro if i == 0 else PRO_NONE,
                        None if i or pv is None else pv.data_ptr(), np_,
                        EPI_NONE if e is None else EPI_MUL,
                        None if e is None else e.data_ptr(),
                        0 if e is None else e.shape[0])
                if rc:
                    raise RuntimeError(f"ntt_pass: CUDA error {rc}")
                src, perm = outs[i % 2], None
            return src

        mul, abc = FieldCtx.FPV_MUL, FieldCtx.FPV_ABC

        def other():
            lib = libs["fpv_other"]
            fpv(lib, abc, n, 1, *rows, one, chk)
            t = transform(x, fctx.tbl_inv, batch, bufs[:2], other=True)
            u = fpv(lib, mul, batch * n, 1, t, fctx.n_inv, None, None,
                    bufs[2])
            v = fpv(lib, mul, batch * n, n, u, fctx.coset_tbl, None, None,
                    bufs[3])
            w = transform(v, fctx.tbl_fwd, batch, bufs[:2], other=True)
            hq = fpv(lib, abc, n, 1, w[0], w[0] if sq else w[1], w[-1], zh,
                     bufs[2][0])
            y = transform(hq[None], fctx.tbl_inv, 1, h1, other=True)
            y = fpv(lib, mul, n, 1, y, fctx.n_inv, None, None, bufs[3][0])
            y = fpv(lib, mul, n, n, y, coset_inv, None, None, bufs[2][0])
            return fpv(lib, mul, n, 1, y, one, None, None, bufs[3][0])

        def this():
            fpv(libs["fp_vec"], abc, n, 1, *rows, one, chk)
            t = transform(x, fctx.tbl_inv, batch, bufs[:2],
                          post=fctx.ninv_coset_tbl)
            w = transform(t, fctx.tbl_fwd, batch, bufs[2:])
            return transform(w, fctx.tbl_inv, 1, h1, PRO_ABC, zh, batch,
                             post=fctx.ninv_coset_inv_plain)[0]

        npass = len(geoms)
        fns = {"other": (other, 1 + 3 * npass + 6),
               "this": (this, 1 + 3 * npass)}
        want = hpoly(fctx, *rows, zh_inv)
        for name, (fn, _) in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"hpoly n={n}: {name} != fft_tensor."
                                     f"hpoly")
        tag = (f"{F.NAME} n={n} x{batch}{' (b is a)' if sq else ''}, "
               f"{npass} passes a transform")
        logdir = os.path.join(out_dir, "trace", f"hpoly_{n}")
        evs, dvs = in_turns(fns, ("other", "this", "this", "other"), logdir)
        summary["hpoly"][tag] = {"events_ms": evs, "kernel_ms": dvs,
                                 "launches": {k: v[1] for k, v in
                                              fns.items()}}
        print(f"hpoly {tag}: " + ", ".join(
            f"{k} ({fns[k][1]} launches) {evs[k]:.4f} ms events, "
            f"{cs.fmt_ms(dvs[k])} kernels" for k in evs), flush=True)
        del x, rows, bufs, chk, h1, want, coset_inv
        torch.cuda.empty_cache()


def load_other_sched(p1_so, p2_so):
    """The other tree's P1 and P2 entries (csrc/sched_digits.cu and
    csrc/sched_place.cu of DIR) as the parent of the sign-carrying
    order has them: p1_scatter without the signs, P2 as p2_buckets then
    p2_place, which gathers the signs."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    p1, p2 = ctypes.CDLL(p1_so), ctypes.CDLL(p2_so)
    for f, args in ((p1.pcd_p1_digits, [vp, cl, ci, ci, ci, ci, ci, vp, vp,
                                        vp]),
                    (p1.pcd_p1_hist, [vp, ci, cl, ci, vp, vp]),
                    (p1.pcd_p1_scan, [vp, ci, ci, ci, vp, vp]),
                    (p1.pcd_p1_scatter, [vp, ci, cl, ci, vp, vp, vp, vp]),
                    (p2.pcd_p2_buckets, [vp, ci, ci, vp, ci, ci, ci, ci, vp,
                                         vp, vp, vp, vp]),
                    (p2.pcd_p2_place, [vp, vp, ci, cl, vp, ci, ci, ci, vp,
                                       vp, vp, vp])):
        f.restype, f.argtypes = ci, args
    return p1, p2


def sched_ab(other_sos, split_so, summary):
    """P1 + P2 of this tree against the other's, and P2 alone against the
    other's and against the two-launch variant (see the module
    docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from pcd_tpu_torch import native
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops.kernels import load
    from pcd_tpu_torch.ops.msm_stream import StreamMSMCtx
    from pcd_tpu_torch.ops.msm_stream_dev import P1_TILE, DevSchedMSM, _wins

    o1, o2 = load_other_sched(*other_sos)
    split = load(split_so, "sched_place")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    split.pcd_p2_split.restype = ci
    split.pcd_p2_split.argtypes = [vp, vp, ci, cl, ci, vp, ci, ci, ci, ci,
                                   vp, vp, vp, vp, vp, vp]
    dev = torch.device("cuda")
    cfg = M.mnt_cycle().main
    s = StreamMSMCtx(cfg.g1, cfg.Fr.BITS)
    dm = DevSchedMSM(s)
    n, nwin, B, L = 1 << 18, s.nwin, s.B, s.L
    K, nt = B + 2, -(-n // P1_TILE)
    rng = np.random.default_rng(9)
    r = cfg.Fr.MODULUS
    dense = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    new = lambda *shape, dt=torch.int32: torch.empty(  # noqa: E731
        shape, dtype=dt, device=dev)

    def ok(rc, what):
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    summary["sched"] = {}
    for kind, sc in (("dense", dense), ("low-entropy", cs.low_entropy(n))):
        W = dm.upload(native.ints_to_limbs(sc), dev)
        order, signs, counts = dm.p1(W)
        act, T, _ = dm._pick_shapes(counts.cpu().numpy())
        nact, wins = len(act), _wins(act)

        def other_p1():
            mags, sg = new(nwin, n, dt=torch.int16), new(nwin, n,
                                                          dt=torch.int8)
            ok(o1.pcd_p1_digits(W.data_ptr(), n, W.shape[1], s.c,
                                s.base_windows, int(s.carry_win), B,
                                mags.data_ptr(), sg.data_ptr(), stream()),
               "other p1_digits")
            hist, cnt = new(nwin, nt, K), new(nwin, K)
            ok(o1.pcd_p1_hist(mags.data_ptr(), nwin, n, K, hist.data_ptr(),
                              stream()), "other p1_hist")
            ok(o1.pcd_p1_scan(hist.data_ptr(), nwin, nt, K, cnt.data_ptr(),
                              stream()), "other p1_scan")
            o = new(nwin, n)
            ok(o1.pcd_p1_scatter(mags.data_ptr(), nwin, n, K,
                                 hist.data_ptr(), cnt.data_ptr(),
                                 o.data_ptr(), stream()), "other p1_scatter")
            return o, sg, cnt

        def other_p2(o, sg, cnt):
            bidx, loads, runrem = new(nact, B), new(nact, L), new(nact, L)
            lanes, perm = new(nact, L, 2), new(nact, T, L)
            ok(o2.pcd_p2_buckets(cnt.data_ptr(), nwin, K, wins, nact, B, T, L,
                                 bidx.data_ptr(), loads.data_ptr(),
                                 runrem.data_ptr(), lanes.data_ptr(),
                                 stream()), "other p2_buckets")
            ok(o2.pcd_p2_place(o.data_ptr(), sg.data_ptr(), nwin, n, wins,
                               nact, T, L, loads.data_ptr(),
                               lanes.data_ptr(), perm.data_ptr(), stream()),
               "other p2_place")
            return perm, loads, bidx, runrem

        def split_p2():
            perm, loads, bidx, runrem = (new(nact, T, L), new(nact, L),
                                         new(nact, B), new(nact, L))
            lanes = new(nact, L, 2)
            ok(split.pcd_p2_split(order.data_ptr(), counts.data_ptr(), nwin,
                                  n, K, wins, nact, B, T, L, perm.data_ptr(),
                                  loads.data_ptr(), bidx.data_ptr(),
                                  runrem.data_ptr(), lanes.data_ptr(),
                                  stream()), "p2_split")
            return perm, loads, bidx, runrem

        o_out = other_p1()
        if not (torch.equal(o_out[0], order & 0x7FFFFFFF)
                and torch.equal(o_out[1], signs)
                and torch.equal(o_out[2], counts)):
            raise AssertionError(f"P1 {kind}: this tree != the other")
        want = dm.place(order, counts, act, T)
        for name, got in (("other", other_p2(*o_out)),
                          ("split", split_p2())):
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"P2 {kind}: {name} != this tree")
        mags, sg = dm.digits(W)
        starts, cnt = dm.tile_scan(dm.tile_hist(mags))
        if not torch.equal(dm.scatter(mags, sg, starts, cnt), order):
            raise AssertionError(f"p1_scatter {kind}: != P1's order")

        def other_scatter():
            o = new(nwin, n)
            ok(o1.pcd_p1_scatter(mags.data_ptr(), nwin, n, K,
                                 starts.data_ptr(), cnt.data_ptr(),
                                 o.data_ptr(), stream()), "other p1_scatter")
            return o

        if not torch.equal(other_scatter(), order & 0x7FFFFFFF):
            raise AssertionError(f"p1_scatter {kind}: other != this")
        fns = {"p1_scatter other": other_scatter,
               "p1_scatter this": lambda: dm.scatter(mags, sg, starts, cnt),
               "P1+P2 other": lambda: other_p2(*other_p1()),
               "P1+P2 this": lambda: dm.place(dm.p1(W)[0], counts, act, T),
               "P2 other": lambda: other_p2(*o_out),
               "P2 this": lambda: dm.place(order, counts, act, T),
               "P2 split": split_p2}
        times = {}
        for what in ("p1_scatter", "P1+P2", "P2"):
            names = [f"{what} other", f"{what} this"] + (
                ["P2 split"] if what == "P2" else [])
            for name in (names + names[::-1]) * 3:
                times.setdefault(name, []).append(cs.device_ms(
                    fns[name], 5, dev, queued=True))
                times.setdefault(name + " as launched", []).append(
                    ms(fns[name]))
        res = {k: statistics.median(v) for k, v in times.items()}
        summary["sched"][kind] = {"median_ms": res, "all_ms": times,
                                  "act": len(act), "T": T}
        print(f"p1_scatter, P1 + P2 and P2, 2^18 {kind}, c = 12, "
              f"{len(act)} windows, "
              f"T = {T}; medians (ms, CUDA events queued behind a spinning "
              f"kernel, then as launched), 6 turns each: " + json.dumps(
                  {k: round(v, 4) for k, v in res.items()}) + "; all "
              + json.dumps({k: [round(x, 4) for x in v]
                            for k, v in times.items()}), flush=True)


K8_LOG_N = 14


def keygen_ab(libs, summary):
    """K8 of each build in `libs` ({name: library}; "other" through the
    entry without the SmallA argument) on the four forms at 2^K8_LOG_N and
    at chip_smoke.KEYGEN_LOG_N random scalars: outputs equal limb for
    limb, CUDA events in turns (see the module docstring)."""
    import random

    import torch

    import chip_smoke as cs
    from pcd_tpu_torch.ops.field import NLIMB
    from pcd_tpu_torch.ops.fixed_base import fixed_base_device

    dev = torch.device("cuda")
    rng = random.Random(14)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    summary["keygen"] = {}
    order = ["other", "this", "this", "other"] * 3
    order += [n for n in libs if n not in ("other", "this")] * 2
    for form, cfg, grp in cs.form_cases():
        curve, gen = getattr(cfg, grp), getattr(cfg, grp + "_gen")
        fb = fixed_base_device(curve, gen, cfg.Fr.BITS)
        ec, tbl = fb.ec, fb.table(dev)
        kc = ec.kconsts.ctypes.data_as(ctypes.c_void_p)
        ks = ec.ksmall.ctypes.data_as(ctypes.c_void_p)
        for log_n in (K8_LOG_N, cs.KEYGEN_LOG_N[form]):
            n = 1 << log_n
            digits = torch.from_numpy(fb.digits_from_ints(
                [rng.randrange(cfg.Fr.MODULUS) for _ in range(n)])).to(dev)
            outs = {name: torch.empty((n, 2, ec.d, NLIMB), dtype=torch.int32,
                                      device=dev) for name in libs}

            def run(name):
                args = (ec.d, tbl.data_ptr(), digits.data_ptr(),
                        outs[name].data_ptr(), n, fb.nwin, kc) + (
                    () if name == "other" else (ks,)) + (stream(),)
                rc = libs[name].pcd_fixed_base_mul(*args)
                if rc:
                    raise RuntimeError(f"K8 {name} {form}: CUDA error {rc}")

            for name in libs:
                run(name)
            torch.cuda.synchronize()
            for name in libs:
                if not torch.equal(outs[name], outs["other"]):
                    raise AssertionError(f"K8 {form} 2^{log_n}: {name} != "
                                         f"other")
            times = {}
            for name in order:
                times.setdefault(name, []).append(
                    ms(lambda: run(name), reps=3))
            pairs = list(zip(times["other"], times["this"]))
            plans = {}
            for name, lib in libs.items():
                if name != "other":
                    info = (ctypes.c_int * 11)()
                    lib.pcd_fixed_base_info(ec.d, int(ec.small_a), n, info)
                    plans[name] = list(info)
            res = {k: statistics.median(v) for k, v in times.items()}
            key = f"{form} 2^{log_n}"
            summary["keygen"][key] = {"median_ms": res, "all_ms": times,
                                      "info": plans}
            faster = sum(t < o for o, t in pairs)
            print(f"K8 {key}: medians " + json.dumps(
                {k: round(v, 4) for k, v in res.items()})
                + f"; this faster than other in {faster} of {len(pairs)} "
                  f"pairs; (group, threads, minb, blocks/SM, regs, local, "
                  f"smem, tile, splits, tree, grid) " + json.dumps(plans)
                + "; all " + json.dumps(
                      {k: [round(x, 4) for x in v]
                       for k, v in times.items()}), flush=True)
            del digits, outs
        torch.cuda.empty_cache()


def fetch_waits(trace_path, nbytes):
    """Each device-to-host copy of `nbytes` in a torch.profiler trace (a
    schedule's histogram fetch), in time order: the host's wait from the
    copy's runtime call to its start on the card, its stream, and the
    kernels that ran in that wait on the same stream and on the others
    (ms of overlap by kernel name)."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    calls, copies, kern = {}, [], []
    for e in events:
        a, cat = e.get("args") or {}, e.get("cat", "")
        if cat == "cuda_runtime" and "correlation" in a:
            calls[a["correlation"]] = e
        elif cat == "gpu_memcpy" and a.get("bytes") == nbytes:
            copies.append(e)
        elif cat == "kernel" and "dur" in e:
            kern.append(e)
    out = []
    for cp in sorted(copies, key=lambda e: float(e["ts"])):
        call = calls.get(cp["args"].get("correlation"))
        if call is None:
            continue
        t0, t1 = float(call["ts"]), float(cp["ts"])
        same, other = {}, {}
        for k in kern:
            a, b = float(k["ts"]), float(k["ts"]) + float(k["dur"])
            if b <= t0 or a >= t1:
                continue
            d = same if k["args"].get("stream") == cp["args"].get(
                "stream") else other
            nm = k.get("name", "?")[:40]
            d[nm] = round(d.get(nm, 0.0) + (min(b, t1) - max(a, t0)) / 1e3,
                          3)
        out.append({"wait_ms": round((t1 - t0) / 1e3, 3),
                    "stream": cp["args"].get("stream"),
                    "same_stream_ms": same, "other_streams_ms": other})
    return out


def trace_step(root, logdir):
    """--trace's traced warm step of the checkout at `root`, in this
    process (see the module docstring); prints its record as the last
    line."""
    sys.path[:] = [root] + sys.path[1:]      # that tree's package only
    import gzip
    import shutil

    import torch

    import pcd_tpu_torch
    from pcd_tpu_torch import configs
    from pcd_tpu_torch.ops.msm_stream import stream_ctx
    from pcd_tpu_torch.pcd.api import FpPredicate
    from pcd_tpu_torch.snark import msm_dispatch
    from pcd_tpu_torch.utils import profiling
    from pcd_tpu_torch.utils.profiling import device_trace
    from pcd_tpu_torch.utils.rng import ChaChaRng

    class Counter(FpPredicate):              # chip_smoke.counter_predicate
        PRIOR_MSG_LEN = 1

        def generate_constraints(self, cs, msg, wit, priors, base):
            (priors[0] + wit).enforce_equal(msg)

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    msm_dispatch.SCHEDULER = "device"
    pcd = configs.mnt4_groth16()
    F = pcd.ic.main_field
    pred = Counter(F)
    rng = ChaChaRng(b"chip smoke mnt4_groth16")
    pk, vk = pcd.circuit_specific_setup(pred, rng)
    one, two = F.from_int(1), F.from_int(2)
    proof_1 = pcd.prove(pk, pred, one, one, [], [], rng)
    pcd.prove(pk, pred, two, one, [one], [proof_1], rng)
    cfg = pcd.ic.cycle.main
    sctx = stream_ctx(cfg.g1, cfg.Fr.BITS, msm_dispatch.WINDOW_BITS,
                      msm_dispatch.LANES)
    profiling.reset()
    profiling.enable()
    sync()
    with device_trace(logdir):
        t0 = time.perf_counter()
        proof_2 = pcd.prove(pk, pred, two, one, [one], [proof_1], rng)
        sync()
        wall = time.perf_counter() - t0
    profiling.enable(False)
    if not pcd.verify(vk, pred, two, proof_2):
        raise AssertionError("the traced warm step does not verify")
    path = os.path.join(logdir, "trace.json")
    rec = {"package": os.path.dirname(pcd_tpu_torch.__file__),
           "step_s": wall, "stream_dispatch_h_s": [
               v[0] for k, v in sorted(profiling.totals().items())
               if k.endswith("stream_dispatch_h")],
           "fetches": fetch_waits(path, sctx.nwin * (sctx.B + 2) * 4)}
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    print(json.dumps(rec), flush=True)


def trace_ab(other_root, summary):
    """--trace: trace_step for the other tree, then this one."""
    summary["trace"] = {}
    for name, root in (("other", other_root), ("this", HERE)):
        logdir = os.path.join(HERE, "chiprun_out", "device_trace",
                              f"sched_{name}")
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--trace-step", root, logdir],
                             capture_output=True, text=True, cwd=root)
        if out.returncode:
            raise RuntimeError(f"--trace-step {name} failed:\n"
                               f"{out.stdout[-4000:]}{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        summary["trace"][name] = rec
        print(f"device-scheduled warm step, {name} tree: "
              + json.dumps(rec), flush=True)


def main(argv):
    if "--trace-step" in argv:
        at = argv.index("--trace-step")
        trace_step(os.path.abspath(argv[at + 1]), argv[at + 2])
        return 0
    other = (os.path.abspath(argv[argv.index("--other") + 1])
             if "--other" in argv else None)
    k4 = "--k4" in argv
    quotient = "--quotient" in argv
    sched = "--sched" in argv
    trace = "--trace" in argv
    ec_mode = "--ec" in argv
    keygen = "--keygen" in argv
    if (other is None and not k4) or (
            (quotient or sched or trace or ec_mode or keygen)
            and other is None):
        print(__doc__, file=sys.stderr)
        return 2
    sweep = ("--sweep" in argv and other is not None and not quotient
             and not sched and not ec_mode and not keygen)
    ec_sweep = "--sweep" in argv and ec_mode
    k8_sweep = "--sweep" in argv and keygen
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from pcd_tpu_torch.curves import models as M
    from pcd_tpu_torch.ops import kernels
    from pcd_tpu_torch.ops.ec import ec_ctx
    from pcd_tpu_torch.ops.kernels import CSRC, NVCC_FLAGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    if trace:
        summary = {}
        trace_ab(other, summary)
        print(json.dumps(summary))
        return 0
    out_dir = os.path.join(HERE, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "probe.cu"), "w") as fh:
        fh.write(PROBE)
    builds = ({"other": (other, []), "this": (CSRC, [])}
              if other and not quotient and not sched and not ec_mode
              and not keygen else {})
    if sweep:
        for name, defs in SWEEP.items():
            builds["this_" + name] = (CSRC, defs)
    t0 = time.perf_counter()
    procs = {}
    for name, (src, defs) in builds.items():
        so = os.path.join(out_dir, f"k1_{name}.so")
        procs[name] = (nvcc([*NVCC_FLAGS, *defs, "-o", so, os.path.join(
            src, "madd_accumulate.cu")]), so)
        if not defs:
            cub = os.path.join(out_dir, f"probe_{name}.cubin")
            procs["probe_" + name] = (nvcc([
                "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-I", src, "-o", cub,
                os.path.join(out_dir, "probe.cu")]), cub)
    if quotient:
        qbuilds = {"ntt_other": (os.path.join(other, "ntt.cu"), []),
                   "fpv_other": (os.path.join(other, "fp_vec.cu"), [])}
        for name, (src, defs) in qbuilds.items():
            so = os.path.join(out_dir, f"{name}.so")
            procs[name] = (nvcc([*NVCC_FLAGS, *defs, "-o", so, src]), so)
    if sched:
        for name, src in (("sched_other", os.path.join(other,
                                                        "sched_digits.cu")),
                          ("place_other", os.path.join(other,
                                                        "sched_place.cu"))):
            so = os.path.join(out_dir, f"{name}.so")
            procs[name] = (nvcc([*NVCC_FLAGS, "-o", so, src]), so)
        so = os.path.join(out_dir, "p2split.so")
        procs["p2split"] = (nvcc([*NVCC_FLAGS, "-I", CSRC, "-o", so,
                                  P2SPLIT_SRC]), so)
    k8_builds = {}
    if keygen:
        k8_builds = {"other": (other, []), "this": (CSRC, [])}
        if k8_sweep:
            for name, shape in K8_SWEEP.items():
                hdr = os.path.join(out_dir, f"k8shape_{name}.h")
                with open(hdr, "w") as fh:
                    fh.write(f"#define K8_SHAPE {shape}\n")
                k8_builds["this_" + name] = (CSRC, ["-include", hdr])
        for name, (src, defs) in k8_builds.items():
            so = os.path.join(out_dir, f"fixed_base_{name}.so")
            procs[f"k8_{name}"] = (nvcc([*NVCC_FLAGS, *defs, "-o", so,
                                         os.path.join(src, "fixed_base.cu")]),
                                   so)
    ec_builds = {}
    if ec_mode:
        ec_builds = {"other": (other, []), "this": (CSRC, [])}
        if ec_sweep:
            for name, (k2, k3) in EC_SWEEP.items():
                hdr = os.path.join(out_dir, f"shape_{name}.h")
                with open(hdr, "w") as fh:
                    fh.write(f"#define K2_SHAPE {k2}\n#define K3_SHAPE {k3}\n")
                ec_builds["this_" + name] = (CSRC, ["-include", hdr])
        for name, (src, defs) in ec_builds.items():
            for kern in ("complete_add", "madd"):
                so = os.path.join(out_dir, f"{kern}_{name}.so")
                procs[f"{kern}_{name}"] = (nvcc([*NVCC_FLAGS, *defs, "-o", so,
                                                 os.path.join(src, kern
                                                              + ".cu")]), so)
        for g in CHAIN_GS:
            so = os.path.join(out_dir, f"chain_g{g}.so")
            procs[f"chain_g{g}"] = (nvcc([*NVCC_FLAGS, f"-DCHAIN_G={g}", "-I",
                                          CSRC, "-o", so, CHAIN_SRC]), so)
        for tree, src in (("other", other), ("this", CSRC)):
            for kern in UNCHANGED:
                so = os.path.join(out_dir, f"{kern}_{tree}_ref.so")
                procs[f"{kern}_{tree}_ref"] = (nvcc([
                    *NVCC_FLAGS, "-o", so, os.path.join(src, kern + ".cu")]),
                    so)
    if k4:
        so = os.path.join(out_dir, "runsum.so")
        procs["runsum"] = (nvcc([*NVCC_FLAGS, "-I", CSRC, "-o", so, RUNSUM]),
                           so)
    if k4 or quotient or sched:
        kernels.build()     # the port's kernels, meanwhile
    logs, libs, summary = {}, {}, {"sass": {}, "ms": {}, "ptxas": {}}
    for name, (proc, path) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    print(f"built {len(procs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name in builds:
        regs = [ln.strip() for ln in logs[name].splitlines()
                if "madd_accumulate_kernel" in ln or "registers" in ln
                or "spill" in ln]
        summary["ptxas"][name] = regs
        for ln in regs:
            print(f"ptxas {name}: {ln}")
        libs[name] = load_k1(procs[name][1])
    if quotient:
        for name in qbuilds:
            regs = [ln.strip() for ln in logs[name].splitlines()
                    if "registers" in ln or "spill" in ln]
            summary["ptxas"][name] = regs
            for ln in regs:
                print(f"ptxas {name}: {ln}")
        for name in ("ntt", "fp_vec"):
            regs = [ln.strip() for ln in kernels.BUILD_INFO.get(
                name, {}).get("ptxas", "").splitlines()
                if "registers" in ln or "spill" in ln]
            summary["ptxas"][name] = regs
            for ln in regs:
                print(f"ptxas {name} (this tree): {ln}")
        libs["ntt_other"], libs["fpv_other"] = load_other_quotient(
            procs["ntt_other"][1], procs["fpv_other"][1])
        libs["ntt"], libs["fp_vec"] = kernels.lib("ntt"), kernels.lib(
            "fp_vec")
        quotient_ab(libs, summary, out_dir)
    if sched:
        for name, log in (
                ("sched_other", logs["sched_other"]),
                ("place_other", logs["place_other"]),
                ("p2split", logs["p2split"]),
                ("sched_digits", kernels.BUILD_INFO.get("sched_digits", {})
                 .get("ptxas", "")),
                ("sched_place", kernels.BUILD_INFO.get("sched_place", {})
                 .get("ptxas", ""))):
            regs = [ln.strip() for ln in log.splitlines()
                    if "Compiling" in ln or "registers" in ln
                    or "spill" in ln]
            summary["ptxas"][name] = regs
            for ln in regs:
                print(f"ptxas {name}: {ln}")
        sched_ab((procs["sched_other"][1], procs["place_other"][1]),
                 procs["p2split"][1], summary)
    if keygen:
        from pcd_tpu_torch.ops.kernels import load

        k8_libs = {}
        for name in k8_builds:
            regs = [ln.strip() for ln in logs[f"k8_{name}"].splitlines()
                    if "Compiling" in ln or "registers" in ln
                    or "spill" in ln]
            summary["ptxas"][f"k8_{name}"] = regs
            for ln in regs:
                print(f"ptxas k8_{name}: {ln}")
            path = procs[f"k8_{name}"][1]
            if name == "other":
                lib = ctypes.CDLL(path)
                lib.pcd_fixed_base_mul.restype = ctypes.c_int
                lib.pcd_fixed_base_mul.argtypes = [
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p]
                k8_libs[name] = lib
            else:
                k8_libs[name] = load(path, "fixed_base")
        keygen_ab(k8_libs, summary)
    if k4:
        regs = [ln.strip() for ln in logs["runsum"].splitlines()
                if "Compiling" in ln or "registers" in ln or "spill" in ln]
        summary["ptxas"]["runsum"] = regs
        for ln in regs:
            print(f"ptxas runsum: {ln}")
        k4_ab(load_runsum(procs["runsum"][1]), summary)
    if ec_mode:
        libs = {}
        for name in ec_builds:
            for kern in ("complete_add", "madd"):
                regs = [ln.strip() for ln in logs[f"{kern}_{name}"]
                        .splitlines() if "Compiling" in ln
                        or "registers" in ln or "spill" in ln]
                summary["ptxas"][f"{kern}_{name}"] = regs
                for ln in regs:
                    print(f"ptxas {kern}_{name}: {ln}")
            libs[name] = load_ec(procs[f"complete_add_{name}"][1],
                                 procs[f"madd_{name}"][1], name == "other")
        for g in CHAIN_GS:
            for ln in logs[f"chain_g{g}"].splitlines():
                if "Compiling" in ln or "registers" in ln or "spill" in ln:
                    print(f"ptxas chain_g{g}: {ln.strip()}")
        for kern in UNCHANGED:
            got = [[ln.strip() for ln in logs[f"{kern}_{tree}_ref"]
                    .splitlines() if "Compiling" in ln or "registers" in ln
                    or "spill" in ln] for tree in ("other", "this")]
            summary["ptxas"][kern + "_same"] = got[0] == got[1]
            print(f"ptxas {kern}: this tree's lines "
                  f"{'equal' if got[0] == got[1] else 'DIFFER FROM'} the "
                  f"other's ({len(got[1])} lines)", flush=True)
            if got[0] != got[1]:
                raise AssertionError(f"{kern}: ptxas differs from the "
                                     f"other tree's")
        ec_ab(libs, {"other"}, {g: procs[f"chain_g{g}"][1] for g in CHAIN_GS},
              summary)
    if not other or quotient or sched or ec_mode or keygen:
        print(json.dumps(summary))
        return 0
    for tree in ("other", "this"):
        for fn, c in sass_counts(procs["probe_" + tree][1]).items():
            if short(fn):
                summary["sass"][f"{tree} {short(fn)}"] = c
                print(f"sass {tree} {short(fn)}: {c['imad']} IMAD-family "
                      f"of {c['all']} instructions {c['ops']}", flush=True)
    cyc = M.mnt_cycle()
    for form, side, grp, T in FORMS:
        ec = ec_ctx(getattr(getattr(cyc, side), grp))
        tab, perm, loads = inputs(ec, T)
        want = run_k1(libs["other"], ec, tab, perm, loads)
        got = run_k1(libs["this"], ec, tab, perm, loads)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {form}: this tree != the other")
        order = ["other", "this", "this", "other"]
        if sweep:
            order += ["this_" + name for name in SWEEP]
        times = {}
        for name in order:
            times.setdefault(name, []).append(ms(
                lambda: run_k1(libs[name], ec, tab, perm, loads)))
        res = {k: sum(v) / len(v) for k, v in times.items()}
        summary["ms"][form] = res
        print(f"K1 {form} T={T}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in res.items()), flush=True)
        del tab, perm, loads, want, got
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
