"""Witness-program compilation: record synthesis once, replay per proof.

The reference regenerates every witness by re-running compiled-Rust circuit
synthesis on each prove (src/ec_cycle_pcd/mod.rs:171,179 — milliseconds in
Rust, 27-35 s for the Python gadget DSL at MNT-298 scale).  TPU-first
answer: circuit *structure* is fixed per config, so synthesis is executed
once at setup while the ConstraintSystem records, for every witness
variable, a `recipe` describing how its value derives from earlier
variables.  Proving then replays the straight-line recipe tape over the new
external inputs — no gadget objects, no dict churn, no constraint re-build.

Recipe tape entries (set by the gadget layer via cs.set_last_recipe /
cs.set_recipe_for; None = external input):
  ('mul', lc_a, lc_b)      out = eval(a) * eval(b)
  ('inv', lc)              out = eval(lc)^-1
  ('bit', lc, i)           out = bit i of eval(lc)   (grouped when the SAME
                           lc object yields consecutive bits)
  ('iszero', lc)           out = 1 if eval(lc) == 0 else 0
  ('inv0', lc)             out = eval(lc)^-1, or 0 when eval(lc) == 0
  ('hint', group, i)       out = group.fn(eval(lcs))[i]  (evaluated once per
                           replay per group — multi-output escape hatch)

External inputs are provided per proof by the circuit's
`external_inputs()` (flattened leaf values in allocation order); the
program verifies at compile time that replaying the recorded inputs
reproduces the recorded witness exactly.

The port's copy of `pcd_tpu/r1cs/program.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations


class HintGroup:
    """A multi-output witness hint: fn(values of input_lcs) -> list[int]."""

    __slots__ = ("fn", "input_lcs")

    def __init__(self, fn, input_lcs):
        self.fn = fn
        self.input_lcs = list(input_lcs)


# compiled opcodes
_MUL_VV = 0   # (op, tgt, ia, ib)
_MUL_VG = 1   # (op, tgt, ia, lcB)
_MUL_GG = 2   # (op, tgt, lcA, lcB)
_INV_V = 3    # (op, tgt, ia)
_INV_G = 4    # (op, tgt, lcA)
_BITS_V = 5   # (op, tgt0, n, start, ia)
_BITS_G = 6   # (op, tgt0, n, start, lcA)
_ISZERO = 7   # (op, tgt, lcA)
_INV0 = 8    # (op, tgt, lcA)
_HINT = 9    # (op, tgt, gid, out_idx)
_LC = 10     # (op, tgt, lcA)


class WitnessProgram:
    """Compiled replayable witness generator for one circuit structure."""

    def __init__(self, p, n_inst, n_wit, ext_slots, ops, hints, record_ext):
        self.p = p
        self.n_inst = n_inst
        self.n_wit = n_wit
        self.ext_slots = ext_slots      # z-indices, allocation order
        self.ops = ops
        self.hints = hints              # list of (fn, [compiled lcs])
        self.record_ext = record_ext    # ext values seen at record time
        self._native = None             # lazily-compiled C++ replay
        self._native_tried = False

    @property
    def num_ext(self) -> int:
        return len(self.ext_slots)

    # ------------------------------------------------------------------
    def run(self, ext_vals):
        """Replay: ext_vals (ints, allocation order) -> full assignment z
        (list of ints, [instance..., witness...]).  Hint-free programs
        replay on the C++ tier (pcd_native.pcd_wprog_run, ~10x the
        Python interpreter at MainCircuit scale); hint programs and
        wide-modulus fields stay on the Python interpreter below."""
        if not self._native_tried:
            self._native_tried = True
            try:
                from .. import native as _nat

                if _nat.available():
                    self._native = _nat.WProgNative.compile(self)
            except Exception:
                self._native = None
        if self._native is not None:
            return self._native.run(ext_vals)
        p = self.p
        if len(ext_vals) != len(self.ext_slots):
            raise ValueError(
                f"external input count mismatch: got {len(ext_vals)}, "
                f"program expects {len(self.ext_slots)}")
        z = [0] * (self.n_inst + self.n_wit)
        z[0] = 1
        for slot, v in zip(self.ext_slots, ext_vals):
            z[slot] = v % p
        hints = self.hints
        hcache = {}
        for e in self.ops:
            op = e[0]
            if op == _MUL_VV:
                z[e[1]] = z[e[2]] * z[e[3]] % p
            elif op == _MUL_VG:
                idxs, coeffs, const = e[3]
                s = const
                for i, c in zip(idxs, coeffs):
                    s += c * z[i]
                z[e[1]] = z[e[2]] * s % p
            elif op == _MUL_GG:
                idxs, coeffs, const = e[2]
                a = const
                for i, c in zip(idxs, coeffs):
                    a += c * z[i]
                idxs, coeffs, const = e[3]
                b = const
                for i, c in zip(idxs, coeffs):
                    b += c * z[i]
                z[e[1]] = a * b % p
            elif op == _BITS_V:
                v = z[e[4]]
                t0, n, start = e[1], e[2], e[3]
                if start:
                    v >>= start
                for j in range(n):
                    z[t0 + j] = v & 1
                    v >>= 1
            elif op == _BITS_G:
                idxs, coeffs, const = e[4]
                s = const
                for i, c in zip(idxs, coeffs):
                    s += c * z[i]
                v = (s % p) >> e[3]
                t0, n = e[1], e[2]
                for j in range(n):
                    z[t0 + j] = v & 1
                    v >>= 1
            elif op == _INV_V:
                z[e[1]] = pow(z[e[2]], -1, p)
            elif op == _INV_G:
                idxs, coeffs, const = e[2]
                s = const
                for i, c in zip(idxs, coeffs):
                    s += c * z[i]
                z[e[1]] = pow(s % p, -1, p)
            elif op == _ISZERO:
                idxs, coeffs, const = e[2]
                s = const
                for i, c in zip(idxs, coeffs):
                    s += c * z[i]
                z[e[1]] = 1 if s % p == 0 else 0
            elif op == _INV0:
                idxs, coeffs, const = e[2]
                s = const
                for i, c in zip(idxs, coeffs):
                    s += c * z[i]
                s %= p
                z[e[1]] = pow(s, -1, p) if s else 0
            elif op == _LC:
                idxs, coeffs, const = e[2]
                s = const
                for i, c in zip(idxs, coeffs):
                    s += c * z[i]
                z[e[1]] = s % p
            elif op == _HINT:
                gid = e[2]
                outs = hcache.get(gid)
                if outs is None:
                    fn, lcs = hints[gid]
                    vals = []
                    for idxs, coeffs, const in lcs:
                        s = const
                        for i, c in zip(idxs, coeffs):
                            s += c * z[i]
                        vals.append(s % p)
                    outs = fn(vals)
                    hcache[gid] = outs
                z[e[1]] = outs[e[3]] % p
            else:  # pragma: no cover
                raise RuntimeError(f"bad opcode {op}")
        return z


def compile_witness_program(cs) -> WitnessProgram:
    """Compile the recording in `cs` (tape + alloc order) and verify the
    replay reproduces the recorded assignment bit-for-bit."""
    p = cs.p
    n_inst = cs.num_instance
    n_wit = cs.num_witness
    tape = cs.tape

    def zidx(v: int) -> int:
        return n_inst + (-v - 1) if v < 0 else v

    def comp_lc(lc):
        """lc dict -> ('v', idx) | compiled general (idxs, coeffs, const)."""
        idxs, coeffs = [], []
        const = 0
        for v, c in lc.items():
            c %= p
            if not c:
                continue
            if v == 0:
                const = c
            else:
                idxs.append(zidx(v))
                coeffs.append(c)
        if const == 0 and len(idxs) == 1 and coeffs[0] == 1:
            return ("v", idxs[0])
        return (tuple(idxs), tuple(coeffs), const)

    ops = []
    hints = []
    hint_ids = {}

    k = 0
    while k < n_wit:
        r = tape[k]
        tgt = n_inst + k
        if r is None:
            k += 1
            continue
        kind = r[0]
        if kind == "mul":
            ca, cb = comp_lc(r[1]), comp_lc(r[2])
            if ca[0] == "v" and cb[0] == "v":
                ops.append((_MUL_VV, tgt, ca[1], cb[1]))
            elif ca[0] == "v":
                ops.append((_MUL_VG, tgt, ca[1], cb))
            elif cb[0] == "v":
                ops.append((_MUL_VG, tgt, cb[1], ca))
            else:
                ops.append((_MUL_GG, tgt, ca, cb))
        elif kind == "bit":
            # group consecutive bits of the same lc object
            src = r[1]
            start = r[2]
            n = 1
            while (k + n < n_wit and isinstance(tape[k + n], tuple)
                   and tape[k + n][0] == "bit" and tape[k + n][1] is src
                   and tape[k + n][2] == start + n):
                n += 1
            c = comp_lc(src)
            if c[0] == "v":
                ops.append((_BITS_V, tgt, n, start, c[1]))
            else:
                ops.append((_BITS_G, tgt, n, start, c))
            k += n
            continue
        elif kind == "inv":
            c = comp_lc(r[1])
            if c[0] == "v":
                ops.append((_INV_V, tgt, c[1]))
            else:
                ops.append((_INV_G, tgt, c))
        elif kind == "iszero":
            c = comp_lc(r[1])
            ops.append((_ISZERO, tgt, c if c[0] != "v"
                        else ((c[1],), (1,), 0)))
        elif kind == "inv0":
            c = comp_lc(r[1])
            ops.append((_INV0, tgt, c if c[0] != "v"
                        else ((c[1],), (1,), 0)))
        elif kind == "lc":
            c = comp_lc(r[1])
            ops.append((_LC, tgt, c if c[0] != "v"
                        else ((c[1],), (1,), 0)))
        elif kind == "hint":
            group, out_idx = r[1], r[2]
            gid = hint_ids.get(id(group))
            if gid is None:
                gid = len(hints)
                hint_ids[id(group)] = gid
                lcs = []
                for lc in group.input_lcs:
                    c = comp_lc(lc)
                    lcs.append(c if c[0] != "v" else ((c[1],), (1,), 0))
                hints.append((group.fn, lcs))
            ops.append((_HINT, tgt, gid, out_idx))
        else:  # pragma: no cover
            raise RuntimeError(f"unknown recipe {kind}")
        k += 1

    # external slots in allocation order; record their synthesis values
    ext_slots = []
    record_ext = []
    for v in cs._alloc_seq:
        if v > 0:
            ext_slots.append(v)
            record_ext.append(cs.instance[v])
        elif v < 0 and tape[-v - 1] is None:
            ext_slots.append(n_inst + (-v - 1))
            record_ext.append(cs.witness[-v - 1])

    prog = WitnessProgram(p, n_inst, n_wit, ext_slots, ops, hints,
                          record_ext)

    # self-check: replaying the recorded inputs must reproduce synthesis
    z = prog.run(record_ext)
    expect = cs.full_assignment()
    if z != expect:
        bad = next(i for i in range(len(z)) if z[i] != expect[i])
        kindname = ("instance" if bad < n_inst else
                    f"witness[{bad - n_inst}] recipe="
                    f"{tape[bad - n_inst]!r}")
        raise RuntimeError(
            f"witness program replay diverged at z[{bad}] ({kindname}): "
            f"replay={z[bad]} synthesis={expect[bad]}")
    return prog
