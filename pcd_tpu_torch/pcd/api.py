"""PCD public API (replaces reference src/lib.rs — the abstract
proof-carrying-data interface).

`PCDPredicate` is the user-supplied compliance predicate
(reference lib.rs:15-32): messages + local witness + constraint generator
with compile-time arity PRIOR_MSG_LEN.  Message/witness variable handling is
part of the predicate (the reference expresses this through the
MessageVar/LocalWitnessVar associated types).

The `PCD` surface (lib.rs:34-59) is provided by implementations
(pcd_tpu.pcd.ec_cycle.ECCyclePCD): circuit_specific_setup / prove / verify,
plus the universal-setup variant (lib.rs:63-77).

The port's copy of `pcd_tpu/pcd/api.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations


class PCDError(Exception):
    pass


class PCDPredicate:
    """Subclass and override.  The synthesized constraint *structure* must
    not depend on the loaded values (same contract as the reference's
    circuits, which synthesize with defaults during setup)."""

    PRIOR_MSG_LEN: int = 1

    # -- native message/witness handling --------------------------------
    def default_message(self):
        raise NotImplementedError

    def default_witness(self):
        raise NotImplementedError

    # -- circuit variable handling --------------------------------------
    def new_message_var(self, cs, msg):
        """Allocate a message as circuit witness; returns MessageVar."""
        raise NotImplementedError

    def new_witness_var(self, cs, witness):
        raise NotImplementedError

    def message_var_to_bytes(self, msg_var):
        """list[UInt8] — the byte image hashed into the PCD input hash."""
        raise NotImplementedError

    def flatten_message(self, msg):
        """Flat ints in new_message_var's raw-witness allocation order —
        enables the recorded witness-program fast path (r1cs/program.py).
        Optional: predicates without it fall back to full re-synthesis."""
        raise NotImplementedError

    def flatten_witness(self, witness):
        """Flat ints mirroring new_witness_var (see flatten_message)."""
        raise NotImplementedError

    def generate_constraints(self, cs, msg_var, witness_var, prior_msg_vars,
                             base_case_bool):
        raise NotImplementedError


class FpPredicate(PCDPredicate):
    """Convenience base: Message = LocalWitness = one field element of the
    main field (covers the reference's TestPredicate and
    BoundTestingPredicate shapes)."""

    def __init__(self, field):
        self.F = field

    def default_message(self):
        return self.F.zero()

    def default_witness(self):
        return self.F.zero()

    def new_message_var(self, cs, msg):
        from ..gadgets.fp import fpvar_class

        return fpvar_class(cs).new_witness(msg)

    def new_witness_var(self, cs, witness):
        from ..gadgets.fp import fpvar_class

        return fpvar_class(cs).new_witness(witness)

    def message_var_to_bytes(self, msg_var):
        return msg_var.to_bytes()

    def flatten_message(self, msg):
        return [msg.n if hasattr(msg, "n") else int(msg)]

    def flatten_witness(self, witness):
        return [witness.n if hasattr(witness, "n") else int(witness)]
