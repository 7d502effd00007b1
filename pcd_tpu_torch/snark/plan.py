"""Per-proving-key circuit plans: synthesize once, replay thereafter.

The reference re-runs compiled-Rust synthesis on every prove
(src/ec_cycle_pcd/mod.rs:171,179); the Python gadget DSL pays 30+ s for the
same work at MNT-298 scale.  Since the circuit *structure* is fixed per
proving key (shape stability is already a hard requirement of the
construction), the first prove records a witness program
(r1cs/program.py) plus the sparse matrix rows; every later prove replays
the straight-line program over the circuit's `external_inputs()` — no
gadget objects, no constraint rebuild.

Circuits opt in by implementing `external_inputs() -> list[int]` (flat
per-proof values in allocation order).  Circuits without it (or whose
predicate raises NotImplementedError) transparently fall back to full
re-synthesis on every prove.

The port's copy of `pcd_tpu/snark/plan.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from ..r1cs.program import WitnessProgram, compile_witness_program
from ..utils.profiling import span


class CircuitPlan:
    """Compiled structure for one proving key: witness program + matrix
    rows (+ prover-specific device caches hung on `self` by the backend)."""

    def __init__(self, prog: WitnessProgram, n_inst: int, n_constraints: int):
        self.prog = prog
        self.n_inst = n_inst
        self.n_constraints = n_constraints
        self.rows = None          # backend-specific row structure
        self.replay_count = 0


def circuit_external_inputs(circuit):
    """The circuit's replay inputs, or None if it doesn't support replay."""
    fn = getattr(circuit, "external_inputs", None)
    if fn is None:
        return None
    try:
        return fn()
    except NotImplementedError:
        return None


def plan_for(pk, cs_factory, circuit):
    """Returns (z, cs_or_None, plan_or_None).

    - replay hit: (assignment from the recorded program, None, plan)
    - first prove / no replay support: synthesizes and (if the circuit
      supports external_inputs) compiles + verifies the program, attaching
      it to `pk._plan`.  The caller still gets the full ConstraintSystem to
      derive its matrix structure from (and should stash that structure on
      the plan for later replays).
    """
    plan = getattr(pk, "_plan", None)
    ext = circuit_external_inputs(circuit)
    if plan is not None and ext is not None \
            and len(ext) == plan.prog.num_ext:
        with span("plan/replay"):
            try:
                z = plan.prog.run(ext)
            except ValueError as e:
                # e.g. modular inverse of zero: the inputs cannot satisfy
                # the circuit (same failure synthesis would raise)
                from .api import SNARKError

                raise SNARKError(f"witness replay failed: {e}") from e
        plan.replay_count += 1
        return z, None, plan

    with span("plan/synthesize"):
        cs = cs_factory()
        circuit.generate_constraints(cs)
    z = cs.full_assignment()
    if ext is not None:
        with span("plan/compile"):
            prog = compile_witness_program(cs)
            if ext != prog.record_ext:
                # flatten order disagrees with allocation order: surface
                # loudly rather than silently re-synthesizing forever
                n = min(len(ext), len(prog.record_ext))
                bad = next((i for i in range(n)
                            if ext[i] != prog.record_ext[i]), n)
                raise RuntimeError(
                    f"external_inputs() mismatch at flat index {bad} "
                    f"(len {len(ext)} vs recorded {len(prog.record_ext)}) "
                    f"for {type(circuit).__name__}")
            plan = CircuitPlan(prog, cs.num_instance, cs.num_constraints)
            pk._plan = plan
        return z, cs, plan
    return z, cs, None
