"""R1CS constraint system (replaces ark-relations, reference Cargo.toml:23;
API surface pinned by use-sites listed in SURVEY.md D7).

Design (TPU-first, not a port):
  - Synthesis is *eager*: every variable always carries a concrete value
    (the reference synthesizes setup circuits with default values too —
    src/ec_cycle_pcd/mod.rs:58-68 passes None and every gadget substitutes
    defaults, so values are always available).  One synthesis pass therefore
    yields both the sparse A/B/C matrices (for setup) and the full witness
    (for proving).
  - Variables are encoded as plain ints for speed: instance k -> k
    (0 is the constant ONE), witness k -> -(k+1).  Linear combinations are
    dicts {var_int: coeff_int}.  Matrix export remaps witness columns to
    follow instance columns, matching the Groth16/GM17 QAP convention.
  - The bulk consumers (witness vector, sparse matrices) are exported as
    numpy arrays feeding the JAX device path.

The port's copy of `pcd_tpu/r1cs/system.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from functools import lru_cache


class SynthesisError(Exception):
    pass


def _var_is_witness(v: int) -> bool:
    return v < 0


class ConstraintSystem:
    """Eager R1CS builder over a host prime field class."""

    def __init__(self, field):
        self.F = field
        self.p = field.MODULUS
        self.instance = [1]          # values; index 0 is the constant 1
        self.witness = []            # values
        self.constraints = []        # list of (a, b, c) lc-dicts
        self._ns = []                # namespace path (debugging only)
        self.constraint_names = None  # set to [] to record names
        # witness-program recording (see r1cs/program.py): one tape slot per
        # witness; None = external input, else a recipe tuple describing how
        # to recompute the value from earlier variables.  _alloc_seq keeps
        # the combined instance/witness allocation order (var ints).
        self.tape = []
        self._alloc_seq = []

    # -- allocation ----------------------------------------------------
    ONE = 0

    def new_instance(self, value: int) -> int:
        self.instance.append(value % self.p)
        v = len(self.instance) - 1
        self._alloc_seq.append(v)
        return v

    def new_witness(self, value: int) -> int:
        self.witness.append(value % self.p)
        v = -len(self.witness)
        self.tape.append(None)
        self._alloc_seq.append(v)
        return v

    # -- witness-program recording --------------------------------------
    def set_last_recipe(self, recipe):
        """Attach a replay recipe to the most recently allocated witness."""
        self.tape[-1] = recipe

    def set_recipe_for(self, var: int, recipe):
        """Attach a replay recipe to witness `var` (var < 0), possibly
        after later allocations happened (retroactive tagging)."""
        self.tape[-var - 1] = recipe

    def value_of(self, var: int) -> int:
        if var < 0:
            return self.witness[-var - 1]
        return self.instance[var]

    # -- constraints ---------------------------------------------------
    def enforce(self, a: dict, b: dict, c: dict):
        self.constraints.append((a, b, c))
        if self.constraint_names is not None:
            self.constraint_names.append("/".join(self._ns))

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    @property
    def num_instance(self) -> int:
        return len(self.instance)

    @property
    def num_witness(self) -> int:
        return len(self.witness)

    # -- namespaces (debug) --------------------------------------------
    class _NS:
        def __init__(self, cs, name):
            self.cs, self.name = cs, name

        def __enter__(self):
            self.cs._ns.append(self.name)
            return self.cs

        def __exit__(self, *exc):
            self.cs._ns.pop()

    def ns(self, name: str):
        return ConstraintSystem._NS(self, name)

    # -- evaluation ----------------------------------------------------
    def eval_lc(self, lc: dict) -> int:
        p = self.p
        acc = 0
        inst = self.instance
        wit = self.witness
        for v, coeff in lc.items():
            val = wit[-v - 1] if v < 0 else inst[v]
            acc += coeff * val
        return acc % p

    def is_satisfied(self) -> bool:
        return self.first_unsatisfied() is None

    def first_unsatisfied(self):
        p = self.p
        for i, (a, b, c) in enumerate(self.constraints):
            if (self.eval_lc(a) * self.eval_lc(b) - self.eval_lc(c)) % p != 0:
                return i
        return None

    def which_is_unsatisfied(self):
        i = self.first_unsatisfied()
        if i is None:
            return None
        if self.constraint_names is not None:
            return f"#{i} [{self.constraint_names[i]}]"
        return f"#{i}"

    # -- export for the prover -----------------------------------------
    def full_assignment(self):
        """z = (instance..., witness...) as list of ints."""
        return list(self.instance) + list(self.witness)

    def col_of(self, var: int) -> int:
        if var < 0:
            return len(self.instance) + (-var - 1)
        return var

    def matrices_coo(self):
        """(A, B, C) as (rows, cols, vals) int-lists (COO).  Columns:
        [1, x_1..x_l, w_1..w_m]."""
        out = []
        n_inst = len(self.instance)
        for k in range(3):
            rows, cols, vals = [], [], []
            for i, cons in enumerate(self.constraints):
                for v, coeff in cons[k].items():
                    rows.append(i)
                    cols.append(n_inst + (-v - 1) if v < 0 else v)
                    vals.append(coeff % self.p)
            out.append((rows, cols, vals))
        return tuple(out)
