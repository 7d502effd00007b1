"""ctypes bindings for the C++ host runtime (pcd_native.cpp).

The library is compiled on first import (g++ -O3, cached next to the
source); set PCD_NATIVE=0 to force the pure-Python host paths.  All
marshalling is little-endian 5x64-bit limbs (canonical, not Montgomery).

Dispatch points that consume this module:
  - pcd_tpu/msm/host.py      variable-base MSM + fixed-base tables
  - pcd_tpu/poly/domain.py   (i)FFT / coset transforms over smooth domains

The port's copy of `pcd_tpu/native/__init__.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

from ..utils.profiling import span

NL = 5
_BYTES = NL * 8

_lib = None
_field_handles: dict = {}
_curve_handles: dict = {}


def _build() -> str | None:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "pcd_native.cpp")
    so = os.path.join(here, "libpcdnative.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    # one temporary per process: test workers that start together each
    # build and atomically rename their own complete library
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", src,
             "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            sys.stderr.write("pcd_native build failed:\n" + r.stderr[-2000:]
                             + "\n")
            return None
        os.replace(tmp, so)
        return so
    except Exception as e:  # no toolchain — fall back to Python
        sys.stderr.write(f"pcd_native build unavailable: {e}\n")
        return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("PCD_NATIVE", "1") == "0":
        return None
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pcd_field_new.restype = ctypes.c_long
    lib.pcd_field_new.argtypes = [u64p]
    lib.pcd_curve_new.restype = ctypes.c_long
    lib.pcd_curve_new.argtypes = [u64p, ctypes.c_int, u64p, u64p, u64p]
    lib.pcd_msm.restype = ctypes.c_int
    lib.pcd_msm.argtypes = [ctypes.c_long, ctypes.c_long, u64p, u64p, u8p,
                            u64p, u64p, u8p]
    lib.pcd_fixed_base.restype = ctypes.c_int
    lib.pcd_fixed_base.argtypes = [ctypes.c_long, u64p, ctypes.c_int,
                                   ctypes.c_long, u64p, u64p, u64p, u8p]
    lib.pcd_ntt.restype = ctypes.c_int
    lib.pcd_ntt.argtypes = [ctypes.c_long, ctypes.c_long, u64p, u64p, u64p,
                            u64p]
    lib.pcd_geom_scale.restype = ctypes.c_int
    lib.pcd_geom_scale.argtypes = [ctypes.c_long, ctypes.c_long, u64p, u64p,
                                   u64p]
    lib.pcd_hpoly.restype = ctypes.c_int
    lib.pcd_hpoly.argtypes = [ctypes.c_long, ctypes.c_long, u64p, u64p,
                              u64p, ctypes.c_long, u64p, u64p, u64p, u64p]
    lib.pcd_vec_op.restype = ctypes.c_int
    lib.pcd_vec_op.argtypes = [ctypes.c_long, ctypes.c_long, ctypes.c_int,
                               u64p, u64p, u64p]
    lib.pcd_vec_axpy.restype = ctypes.c_int
    lib.pcd_vec_axpy.argtypes = [ctypes.c_long, ctypes.c_long, u64p, u64p,
                                 u64p]
    lib.pcd_poly_div_linear.restype = ctypes.c_int
    lib.pcd_poly_div_linear.argtypes = [ctypes.c_long, ctypes.c_long, u64p,
                                        u64p, u64p, u64p]
    i64p = ctypes.POINTER(ctypes.c_long)
    lib.pcd_spmat_new.restype = ctypes.c_long
    lib.pcd_spmat_new.argtypes = [ctypes.c_long, ctypes.c_long, i64p, i64p,
                                  u64p]
    lib.pcd_spmat_apply.restype = ctypes.c_int
    lib.pcd_spmat_apply.argtypes = [ctypes.c_long, ctypes.c_long, u64p, u64p]
    lib.pcd_wprog_new.restype = ctypes.c_long
    lib.pcd_wprog_new.argtypes = [ctypes.c_long, ctypes.c_long,
                                  ctypes.c_long, ctypes.c_long, i64p,
                                  ctypes.c_long, i64p, i64p, u64p, u64p]
    lib.pcd_wprog_run.restype = ctypes.c_int
    lib.pcd_wprog_run.argtypes = [ctypes.c_long, ctypes.c_long, i64p, u64p,
                                  u64p]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pcd_msm_schedule.restype = ctypes.c_long
    lib.pcd_msm_schedule.argtypes = [
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_int, u64p, ctypes.c_long,
        u8p, u32p, i32p, i32p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _u64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def ints_to_limbs(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(_BYTES, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u8").reshape(len(vals), NL).copy()


def limbs_to_ints(arr: np.ndarray) -> list:
    flat = np.ascontiguousarray(arr.reshape(-1, NL), dtype="<u8")
    raw = flat.tobytes()
    return [int.from_bytes(raw[i * _BYTES:(i + 1) * _BYTES], "little")
            for i in range(flat.shape[0])]


def field_handle(modulus: int) -> int:
    lib = _load()
    h = _field_handles.get(modulus)
    if h is None:
        mod = ints_to_limbs([modulus])
        h = lib.pcd_field_new(_u64p(mod))
        _field_handles[modulus] = h
    return h


def _coeffs(elem, deg):
    if deg == 1:
        return [int(elem.n)]
    return [int(c.n) for c in elem.to_prime_coeffs()]


def curve_handle(curve) -> tuple:
    """Returns (handle, deg, prime_modulus)."""
    key = id(curve)
    hit = _curve_handles.get(key)
    if hit is not None:
        return hit
    lib = _load()
    F = curve.F
    prime = F.prime_subfield()
    deg = F.extension_degree_over_prime()
    if deg > 3 or prime.MODULUS.bit_length() > 320:
        raise ValueError("curve outside native support")
    nr = 0
    if deg > 1:
        # binomial tower: F = prime[v]/(v^deg - NR) with NR in the prime
        # field (fields/tower.py); native support covers exactly the G2
        # coordinate fields Fp2/Fp3 built directly over the prime field
        nr_el = F.NR
        if hasattr(nr_el, "to_prime_coeffs"):
            raise ValueError("nested towers unsupported natively")
        nr = int(nr_el.n)
    mod = ints_to_limbs([prime.MODULUS])
    nr_l = ints_to_limbs([nr])
    a_l = ints_to_limbs(_coeffs(curve.a, deg))
    b_l = ints_to_limbs(_coeffs(curve.b, deg))
    h = lib.pcd_curve_new(_u64p(mod), deg, _u64p(nr_l), _u64p(a_l),
                          _u64p(b_l))
    out = (h, deg, prime.MODULUS)
    _curve_handles[key] = out
    return out


def _points_to_arrays(points, deg):
    n = len(points)
    xs = np.zeros((n, deg * NL), dtype="<u8")
    ys = np.zeros((n, deg * NL), dtype="<u8")
    inf = np.zeros(n, dtype=np.uint8)
    for i, pt in enumerate(points):
        if pt.is_infinity():
            inf[i] = 1
            continue
        cx = _coeffs(pt.x, deg)
        cy = _coeffs(pt.y, deg)
        for d in range(deg):
            xs[i, d * NL:(d + 1) * NL] = np.frombuffer(
                int(cx[d]).to_bytes(_BYTES, "little"), "<u8")
            ys[i, d * NL:(d + 1) * NL] = np.frombuffer(
                int(cy[d]).to_bytes(_BYTES, "little"), "<u8")
    return xs, ys, inf


def _point_from_limbs(curve, deg, xy: np.ndarray):
    F = curve.F
    prime = F.prime_subfield()
    raw = xy.tobytes()

    def elem(off):
        cs = [prime.from_int(int.from_bytes(
            raw[(off + d) * _BYTES:(off + d + 1) * _BYTES], "little"))
            for d in range(deg)]
        return F.from_prime_coeffs(cs) if deg > 1 else cs[0]

    return curve.point(elem(0), elem(deg), check=False)


class EncodedPoints:
    """Affine point table pre-marshalled for pcd_msm.  Fixed query tables
    (pk queries, KZG SRS powers) pay the Python-int -> limb conversion
    once per process instead of on every prove — at production sizes the
    per-call marshalling of a 2^18-point table costs more than the MSM."""

    __slots__ = ("curve", "handle", "deg", "n", "xs", "ys", "inf", "_nz")

    def __init__(self, curve, points):
        self.curve = curve
        self.handle, self.deg, _ = curve_handle(curve)
        self.n = len(points)
        self.xs, self.ys, self.inf = _points_to_arrays(points, self.deg)

    def __len__(self):
        return self.n

    @classmethod
    def from_affine_words(cls, curve, words) -> "EncodedPoints":
        """The table of affine canonical 32-bit words as the keygen kernel
        returns them (ops/fixed_base.py `mul_digits`, a tensor or array):
        (n, 2, d, 10), x then y, the point at infinity zero with bit 31
        of x's top word set.  Builds no host point objects."""
        if hasattr(words, "cpu"):
            words = words.cpu().numpy()
        w = np.array(words).view(np.uint32)              # a copy
        n, two, d, nw = w.shape
        out = object.__new__(cls)
        out.curve = curve
        out.handle, out.deg, _ = curve_handle(curve)
        if (two, d, nw) != (2, out.deg, 2 * NL):
            raise ValueError(f"affine words of {curve.name}: (n, 2, "
                             f"{out.deg}, {2 * NL}), not {w.shape}")
        out.inf = (w[:, 0, 0, -1] >> 31).astype(np.uint8)
        w[:, 0, 0, -1] &= np.uint32(0x7FFFFFFF)
        xy = w.reshape(n, -1).view("<u8")
        out.xs = np.ascontiguousarray(xy[:, : NL * d])
        out.ys = np.ascontiguousarray(xy[:, NL * d:])
        out.n = n
        return out

    def pad_front(self, k: int) -> "EncodedPoints":
        """k points at infinity, then this table's rows (a copy)."""
        out = object.__new__(EncodedPoints)
        out.curve, out.handle, out.deg = self.curve, self.handle, self.deg
        pad = np.zeros((k, self.xs.shape[1]), dtype=self.xs.dtype)
        out.xs = np.concatenate([pad, self.xs])
        out.ys = np.concatenate([pad, self.ys])
        out.inf = np.concatenate([np.ones(k, np.uint8), self.inf])
        out.n = self.n + k
        return out

    def slice(self, start: int, stop: int) -> "EncodedPoints":
        """Zero-copy subrange view (KZG shifted-power rows)."""
        out = object.__new__(EncodedPoints)
        out.curve, out.handle, out.deg = self.curve, self.handle, self.deg
        out.xs = self.xs[start:stop]
        out.ys = self.ys[start:stop]
        out.inf = self.inf[start:stop]
        out.n = out.xs.shape[0]
        return out

    def nonzero_view(self):
        """(filtered EncodedPoints, index array) dropping the points at
        infinity, cached.  Groth16/GM17 a/b query tables are 20-35%
        infinities at production scale (variables absent from a matrix),
        and s*O contributes nothing — the MSM only needs the rest."""
        cached = getattr(self, "_nz", None)
        if cached is not None:
            return cached
        idx = np.nonzero(self.inf == 0)[0]
        if idx.shape[0] == self.n:
            out = (self, None)
        else:
            sub = object.__new__(EncodedPoints)
            sub.curve, sub.handle, sub.deg = (self.curve, self.handle,
                                              self.deg)
            sub.xs = np.ascontiguousarray(self.xs[idx])
            sub.ys = np.ascontiguousarray(self.ys[idx])
            sub.inf = np.zeros(idx.shape[0], dtype=np.uint8)
            sub.n = idx.shape[0]
            out = (sub, idx)
        try:
            self._nz = out
        except AttributeError:
            pass
        return out


def encode_points(points) -> EncodedPoints:
    return EncodedPoints(points[0].curve, points)


def msm(points, scalars):
    """Native variable-base MSM; `points` is a host point list or an
    EncodedPoints table.  Returns a host point."""
    if isinstance(points, EncodedPoints):
        if len(scalars) != points.n:
            raise ValueError("MSM length mismatch")
        sub, idx = points.nonzero_view()
        if idx is not None:
            if sub.n == 0:
                return points.curve.infinity()
            if isinstance(scalars, np.ndarray):
                scalars = np.ascontiguousarray(scalars[idx])
            else:
                scalars = [scalars[i] for i in idx]
            points = sub
        curve, h, deg = points.curve, points.handle, points.deg
        xs, ys, inf, n = points.xs, points.ys, points.inf, points.n
    else:
        curve = points[0].curve
        h, deg, _ = curve_handle(curve)
        xs, ys, inf = _points_to_arrays(points, deg)
        n = len(points)
    lib = _load()
    sc = scalars_to_limbs(scalars)
    if sc.shape[0] != n:
        raise ValueError("MSM length mismatch")
    out_xy = np.zeros(2 * deg * NL, dtype="<u8")
    out_inf = np.zeros(1, dtype=np.uint8)
    rc = lib.pcd_msm(h, n, _u64p(xs), _u64p(ys), _u8p(inf),
                     _u64p(sc), _u64p(out_xy), _u8p(out_inf))
    if rc != 0:
        raise RuntimeError("pcd_msm failed")
    if out_inf[0]:
        return curve.infinity()
    return _point_from_limbs(curve, deg, out_xy)


def fixed_base_batch(base, scalars, max_bits: int):
    """[s*G for s in scalars] via the native windowed table."""
    curve = base.curve
    h, deg, _ = curve_handle(curve)
    lib = _load()
    bxy = np.zeros(2 * deg * NL, dtype="<u8")
    cx = _coeffs(base.x, deg)
    cy = _coeffs(base.y, deg)
    for d in range(deg):
        bxy[d * NL:(d + 1) * NL] = np.frombuffer(
            int(cx[d]).to_bytes(_BYTES, "little"), "<u8")
        bxy[(deg + d) * NL:(deg + d + 1) * NL] = np.frombuffer(
            int(cy[d]).to_bytes(_BYTES, "little"), "<u8")
    n = len(scalars)
    sc = ints_to_limbs([int(s) for s in scalars])
    oxs = np.zeros((n, deg * NL), dtype="<u8")
    oys = np.zeros((n, deg * NL), dtype="<u8")
    oinf = np.zeros(n, dtype=np.uint8)
    rc = lib.pcd_fixed_base(h, _u64p(bxy), max_bits, n, _u64p(sc),
                            _u64p(oxs), _u64p(oys), _u8p(oinf))
    if rc != 0:
        raise RuntimeError("pcd_fixed_base failed")
    out = []
    for i in range(n):
        if oinf[i]:
            out.append(curve.infinity())
        else:
            xy = np.concatenate([oxs[i], oys[i]])
            out.append(_point_from_limbs(curve, deg, xy))
    return out


class WProgNative:
    """Native replay of a compiled WitnessProgram (r1cs/program.py).
    Returns None from compile() when the program uses hint ops (Marlin's
    nonnative escape hatch calls back into Python) — callers keep the
    Python interpreter for those.  NOTE: native inversion of 0 yields 0
    instead of raising; recorded programs never invert 0 on valid inputs,
    and invalid witnesses are caught by the prover's satisfiability
    check."""

    __slots__ = ("handle", "n_inst", "n_wit", "ext_slots", "p")

    def __init__(self, handle, n_inst, n_wit, ext_slots, p):
        self.handle = handle
        self.n_inst = n_inst
        self.n_wit = n_wit
        self.ext_slots = np.asarray(ext_slots, dtype=np.int64)
        self.p = p

    @classmethod
    def compile(cls, prog):
        """prog: r1cs.program.WitnessProgram -> WProgNative | None."""
        lib = _load()
        if lib is None or prog.hints or prog.p.bit_length() > 320:
            return None
        fh = field_handle(prog.p)
        ops = np.zeros((len(prog.ops), 5), dtype=np.int64)
        lc_off = [0]
        lc_idx: list = []
        lc_coeff: list = []
        lc_const: list = []

        def lc_id(lc):
            idxs, coeffs, const = lc
            lc_idx.extend(idxs)
            lc_coeff.extend(coeffs)
            lc_const.append(const)
            lc_off.append(len(lc_idx))
            return len(lc_const) - 1

        # opcodes mirror r1cs/program.py (_MUL_VV..._LC); _HINT (9) bails
        for k, e in enumerate(prog.ops):
            code = e[0]
            if code == 9:  # _HINT
                return None
            row = ops[k]
            row[0] = code
            row[1] = e[1]
            if code == 0:       # MUL_VV
                row[2], row[3] = e[2], e[3]
            elif code == 1:     # MUL_VG
                row[2], row[3] = e[2], lc_id(e[3])
            elif code == 2:     # MUL_GG
                row[2], row[3] = lc_id(e[2]), lc_id(e[3])
            elif code == 3:     # INV_V
                row[2] = e[2]
            elif code in (5, 6):  # BITS_V / BITS_G
                row[2], row[3] = e[2], e[3]
                row[4] = e[4] if code == 5 else lc_id(e[4])
            else:               # INV_G / ISZERO / INV0 / LC
                row[2] = lc_id(e[2])
        nlc = len(lc_const)
        h = lib.pcd_wprog_new(
            fh, prog.n_inst, prog.n_wit, len(prog.ops),
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            nlc,
            np.asarray(lc_off, dtype=np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_long)),
            np.asarray(lc_idx, dtype=np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_long)),
            _u64p(ints_to_limbs(lc_coeff) if lc_coeff else
                  np.zeros((0, NL), dtype="<u8")),
            _u64p(ints_to_limbs(lc_const) if lc_const else
                  np.zeros((0, NL), dtype="<u8")))
        if h < 0:
            return None
        return cls(h, prog.n_inst, prog.n_wit, prog.ext_slots, prog.p)

    def run(self, ext_vals) -> list:
        lib = _load()
        if len(ext_vals) != len(self.ext_slots):
            raise ValueError(
                f"external input count mismatch: got {len(ext_vals)}, "
                f"program expects {len(self.ext_slots)}")
        ev = ints_to_limbs([int(v) % self.p for v in ext_vals])
        nz = self.n_inst + self.n_wit
        out = np.zeros((nz, NL), dtype="<u8")
        rc = lib.pcd_wprog_run(
            self.handle, len(ext_vals),
            self.ext_slots.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            _u64p(ev), _u64p(out))
        if rc != 0:
            raise RuntimeError(f"pcd_wprog_run failed rc={rc}")
        return limbs_to_ints(out)


class SpMatrices:
    """CSR R1CS matrices (A, B, C) registered with the native runtime for
    repeated Az/Bz/Cz evaluations — the host tier of the prover matvec
    (device tier: pcd_tpu/ops/matvec_tensor.py).  `rows` is the prover's
    list of (a_lc, b_lc, c_lc) sparse column->coeff dicts."""

    __slots__ = ("handles", "nrows", "modulus")

    def __init__(self, modulus: int, rows, nrows: int | None = None):
        lib = _load()
        fh = field_handle(modulus)
        self.modulus = modulus
        self.nrows = len(rows) if nrows is None else nrows
        self.handles = []
        for k in range(3):
            rowptr = np.zeros(self.nrows + 1, dtype=np.int64)
            cols_l: list = []
            vals_l: list = []
            for r, row in enumerate(rows):
                lc = row[k]
                for col, co in lc.items():
                    cols_l.append(col)
                    vals_l.append(co % modulus)
                rowptr[r + 1] = len(cols_l)
            rowptr[len(rows):] = len(cols_l)
            cols = np.asarray(cols_l, dtype=np.int64)
            vals = ints_to_limbs(vals_l) if vals_l else np.zeros(
                (0, NL), dtype="<u8")
            h = lib.pcd_spmat_new(
                fh, self.nrows,
                rowptr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                _u64p(vals))
            if h < 0:
                raise RuntimeError("pcd_spmat_new failed")
            self.handles.append(h)

    def apply_all_limbs(self, z) -> tuple:
        """(Az, Bz, Cz) as (nrows, NL) limb arrays; z may be an int list
        or a pre-marshalled (nvars, NL) limb array.  Limb-in/limb-out is
        the prover fast path — the quotient pipeline (hpoly) and the MSM
        scalars consume the limbs directly, so production proves never
        round-trip through Python ints."""
        lib = _load()
        zl = scalars_to_limbs(z)
        outs = []
        for h in self.handles:
            out = np.zeros((self.nrows, NL), dtype="<u8")
            rc = lib.pcd_spmat_apply(h, zl.shape[0], _u64p(zl), _u64p(out))
            if rc != 0:
                raise RuntimeError("pcd_spmat_apply failed")
            outs.append(out)
        return tuple(outs)

    def apply_all(self, z) -> tuple:
        """(Az, Bz, Cz) as lists of canonical ints for a z of ints."""
        return tuple(limbs_to_ints(o) for o in self.apply_all_limbs(z))


def ntt(modulus: int, omega: int, values, scale: int | None = None) -> list:
    """out[k] = sum_j values[j] omega^{jk} (* scale), canonical ints."""
    lib = _load()
    h = field_handle(modulus)
    n = len(values)
    x = ints_to_limbs([int(v) % modulus for v in values])
    out = np.zeros((n, NL), dtype="<u8")
    sc = None if scale is None else ints_to_limbs([scale % modulus])
    rc = lib.pcd_ntt(h, n, _u64p(ints_to_limbs([omega % modulus])), _u64p(x),
                     _u64p(out), _u64p(sc) if sc is not None else None)
    if rc != 0:
        raise RuntimeError("pcd_ntt failed")
    return limbs_to_ints(out)


def scalars_to_limbs(scalars) -> np.ndarray:
    """Pre-marshal an int scalar vector for repeated native calls
    (spmat apply / hpoly / msm all accept the limb form directly)."""
    if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint64:
        arr = np.ascontiguousarray(scalars)
        if arr.ndim != 2 or arr.shape[1] != NL:
            raise ValueError(
                f"limb scalars must be (n, {NL}) u64, got {arr.shape}")
        return arr
    return ints_to_limbs([int(s) for s in scalars])


def hpoly(modulus: int, omega: int, coset_g: int, zh_inv: int,
          a, b, c, check_rows: int = 0) -> np.ndarray:
    """Fused quotient pipeline h = coset_ifft((fft_coset(ifft(A)) *
    fft_coset(ifft(B)) - fft_coset(ifft(C))) * zh_inv) in ONE native
    call; a/b/c are (n, NL) u64 limb arrays (or int lists) of domain
    evaluations; returns h as (n, NL) canonical limbs.  check_rows > 0
    raises if A[j]*B[j] != C[j] for some j < check_rows (replayed-witness
    satisfiability)."""
    lib = _load()
    h = field_handle(modulus)
    al, bl, cl = (v if isinstance(v, np.ndarray) else scalars_to_limbs(v)
                  for v in (a, b, c))
    n = al.shape[0]
    if bl.shape[0] != n or cl.shape[0] != n:
        raise ValueError("hpoly: a/b/c row counts differ")
    out = np.zeros((n, NL), dtype="<u8")
    rc = lib.pcd_hpoly(
        h, n, _u64p(ints_to_limbs([omega % modulus])),
        _u64p(ints_to_limbs([coset_g % modulus])),
        _u64p(ints_to_limbs([zh_inv % modulus])), check_rows,
        _u64p(np.ascontiguousarray(al)), _u64p(np.ascontiguousarray(bl)),
        _u64p(np.ascontiguousarray(cl)), _u64p(out))
    if rc == -2:
        raise ValueError("unsatisfied constraint (replayed witness)")
    if rc != 0:
        raise RuntimeError("pcd_hpoly failed")
    return out


def vec_op(modulus: int, op: str, a, b) -> np.ndarray:
    """Elementwise (a op b) mod p over canonical (n, NL) limb arrays
    (or int lists); op in {'add','sub','mul'}.  Returns limbs."""
    lib = _load()
    h = field_handle(modulus)
    al = a if isinstance(a, np.ndarray) else scalars_to_limbs(a)
    bl = b if isinstance(b, np.ndarray) else scalars_to_limbs(b)
    n = al.shape[0]
    out = np.zeros((n, NL), dtype="<u8")
    code = {"add": 0, "sub": 1, "mul": 2}[op]
    rc = lib.pcd_vec_op(h, n, code, _u64p(np.ascontiguousarray(al)),
                        _u64p(np.ascontiguousarray(bl)), _u64p(out))
    if rc != 0:
        raise RuntimeError("pcd_vec_op failed")
    return out


def msm_schedule(limbs: np.ndarray, inf, c: int, nwin: int, L: int,
                 B: int, carry_win: bool = True):
    """Stream-MSM gather schedule (ops/msm_stream.py) computed natively:
    signed digits + proportional lane placement in threaded C++.
    carry_win False = the top window absorbs the signed carry unsigned
    (StreamMSMCtx.carry_win decides when that has headroom).
    Returns (perm (nwin,T,L) u32, loads (nwin,L) i32, bidx (nwin,B) i32,
    T) or None when the native tier is unavailable."""
    lib = _load()
    if lib is None:
        return None
    limbs = np.ascontiguousarray(limbs, dtype="<u8")
    n, nl = limbs.shape
    inf_p = None
    if inf is not None:
        inf_arr = np.ascontiguousarray(np.asarray(inf, dtype=np.uint8))
        inf_p = _u8p(inf_arr)
    nullp = ctypes.POINTER(ctypes.c_uint32)()
    nulli = ctypes.POINTER(ctypes.c_int32)()
    cw = 1 if carry_win else 0
    with span("sched_fit"):
        T = lib.pcd_msm_schedule(n, c, nwin, L, B, 0, cw, _u64p(limbs), nl,
                                 inf_p, nullp, nulli, nulli)
    if T <= 0:
        return None
    with span("sched_alloc"):
        perm = np.zeros((nwin, T * L), dtype=np.uint32)
        loads = np.zeros((nwin, L), dtype=np.int32)
        bidx = np.zeros((nwin, B), dtype=np.int32)
    with span("sched_place"):
        rc = lib.pcd_msm_schedule(
            n, c, nwin, L, B, T, cw, _u64p(limbs), nl, inf_p,
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            loads.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise RuntimeError(f"pcd_msm_schedule failed rc={rc}")
    return perm.reshape(nwin, T, L), loads, bidx, T


def geom_scale(modulus: int, g: int, values) -> list:
    """[values[i] * g^i mod p]."""
    lib = _load()
    h = field_handle(modulus)
    n = len(values)
    x = ints_to_limbs([int(v) % modulus for v in values])
    out = np.zeros((n, NL), dtype="<u8")
    rc = lib.pcd_geom_scale(h, n, _u64p(ints_to_limbs([g % modulus])),
                            _u64p(x), _u64p(out))
    if rc != 0:
        raise RuntimeError("pcd_geom_scale failed")
    return limbs_to_ints(out)


def vec_axpy(modulus: int, acc: np.ndarray, x, s: int) -> None:
    """acc += s * x mod p, in place; acc is a canonical (n, NL) u64 limb
    array, x a limb array or int list of the same length.  The KZG batch
    opens' polynomial linear combinations run here instead of a
    Python-bigint loop over SRS-length coefficient lists."""
    lib = _load()
    h = field_handle(modulus)
    xl = x if isinstance(x, np.ndarray) else scalars_to_limbs(x)
    n = xl.shape[0]
    if acc.shape[0] < n:
        raise ValueError("vec_axpy: acc shorter than x")
    rc = lib.pcd_vec_axpy(h, n, _u64p(ints_to_limbs([s % modulus])),
                          _u64p(np.ascontiguousarray(xl)), _u64p(acc))
    if rc != 0:
        raise RuntimeError("pcd_vec_axpy failed")


def poly_div_linear(modulus: int, coeffs, z: int):
    """Synthetic division of the polynomial with coefficient vector
    `coeffs` by (X - z): returns (quotient limbs (n-1, NL), c(z) int).
    Sequential C++ Horner (the KZG witness-polynomial scan)."""
    lib = _load()
    h = field_handle(modulus)
    cl = coeffs if isinstance(coeffs, np.ndarray) \
        else scalars_to_limbs([int(v) % modulus for v in coeffs])
    n = cl.shape[0]
    q = np.zeros((max(n - 1, 1), NL), dtype="<u8")
    ev = np.zeros((1, NL), dtype="<u8")
    rc = lib.pcd_poly_div_linear(h, n, _u64p(np.ascontiguousarray(cl)),
                                 _u64p(ints_to_limbs([z % modulus])),
                                 _u64p(q), _u64p(ev))
    if rc != 0:
        raise RuntimeError("pcd_poly_div_linear failed")
    return q[: n - 1] if n > 1 else q[:0], limbs_to_ints(ev)[0]


def poly_eval_mod(modulus: int, coeffs, z: int) -> int:
    """c(z) mod p via the C++ Horner scan (no quotient materialized)."""
    lib = _load()
    h = field_handle(modulus)
    cl = coeffs if isinstance(coeffs, np.ndarray) \
        else scalars_to_limbs([int(v) % modulus for v in coeffs])
    n = cl.shape[0]
    ev = np.zeros((1, NL), dtype="<u8")
    rc = lib.pcd_poly_div_linear(h, n, _u64p(np.ascontiguousarray(cl)),
                                 _u64p(ints_to_limbs([z % modulus])),
                                 None, _u64p(ev))
    if rc != 0:
        raise RuntimeError("pcd_poly_div_linear failed")
    return limbs_to_ints(ev)[0]


def ntt_limbs(modulus: int, omega: int, x: np.ndarray,
              scale: int | None = None) -> np.ndarray:
    """ntt() staying in canonical (n, NL) limb space end-to-end — the
    polynomial-product pipeline (snark/marlin/ahp.poly_mul_fft) chains
    NTT -> pointwise vec_op -> inverse NTT without Python-int detours."""
    lib = _load()
    h = field_handle(modulus)
    x = np.ascontiguousarray(x)
    n = x.shape[0]
    out = np.zeros((n, NL), dtype="<u8")
    sc = None if scale is None else ints_to_limbs([scale % modulus])
    rc = lib.pcd_ntt(h, n, _u64p(ints_to_limbs([omega % modulus])),
                     _u64p(x), _u64p(out),
                     _u64p(sc) if sc is not None else None)
    if rc != 0:
        raise RuntimeError("pcd_ntt failed")
    return out
