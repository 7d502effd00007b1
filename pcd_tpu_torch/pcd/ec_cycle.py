"""EC-cycle PCD construction (replaces reference src/ec_cycle_pcd/ —
ECCyclePCDConfig + ECCyclePCD + Main/Help/Default circuits).

Construction summary (reference data_structures.rs:85-393):
  - MainCircuit (over MainField): public input x = H(H(help_vk) || msg);
    runs the predicate; verifies PRIOR_MSG_LEN prior help-proofs in-circuit
    against x_prev = H(H(vk) || prior_msg); enforces base_case OR all-verified.
  - HelpCircuit (over HelpField): verifies ONE main proof against the
    repacked input hash under a constant processed main-vk.
  - The PCD proof is just the help proof; the PCD vk is (crh_pp, help_vk)
    — succinctness by hashing everything else into one field element.

Shape stability: both circuits synthesize identical structure for default
and real values (the reference's setup path relies on the same property:
mod.rs:58-68 passes None everywhere).

The port's copy of `pcd_tpu/pcd/ec_cycle.py`; the pcd_tpu paths
named here are the JAX package's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..gadgets.fp import Boolean, UInt8, fpvar_class
from ..gadgets.inputs import repacked_len
from ..r1cs.system import ConstraintSystem
from ..utils.profiling import request, span
from ..utils.rng import test_rng
from .api import PCDError, PCDPredicate


# ======================================================================
@dataclass
class ECCyclePCDConfig:
    """The 'plugin board' (reference ec_cycle_pcd/mod.rs:24-33): a CRH over
    MainField + two SNARKs + their verifier gadgets over the other field."""

    cycle: object          # CycleConfig
    crh: object            # VariableLengthCRH over cycle.crh_te
    main_snark: object     # SNARK over cycle.main (circuit field MainField)
    help_snark: object     # SNARK over cycle.help (circuit field HelpField)
    main_gadget: object    # verifier gadget for main_snark (runs over HelpField)
    help_gadget: object    # verifier gadget for help_snark (runs over MainField)

    @property
    def main_field(self):
        return self.cycle.main.Fr

    @property
    def help_field(self):
        return self.cycle.help.Fr


@dataclass
class ECCyclePCDPK:
    crh_pp: object
    main_pk: object
    main_pvk: object
    help_pk: object
    help_vk: object


@dataclass
class ECCyclePCDVK:
    crh_pp: object
    help_vk: object


# ======================================================================
class DefaultCircuit:
    """Dummy circuit minting well-formed placeholder proofs for the base
    case (reference data_structures.rs:60-83): allocates
    `public_input_size` public inputs equal to 1 and bit-decomposes them."""

    def __init__(self, public_input_size: int):
        self.public_input_size = public_input_size

    def generate_constraints(self, cs):
        V = fpvar_class(cs)
        for _ in range(self.public_input_size):
            g = V.new_instance(1)
            g.to_bits_le()


def placeholder_proof(snark, public_input_size: int):
    """Deterministic (fixed-rng) placeholder (vk, proof) for DefaultCircuit,
    cached per (snark, size) — the reference recomputes this inside *every*
    synthesis (data_structures.rs:135-143); we cache since it's
    deterministic per config."""
    cache = getattr(snark, "_placeholder_cache", None)
    if cache is None:
        cache = {}
        snark._placeholder_cache = cache
    if public_input_size not in cache:
        import os
        import struct as _struct

        from ..utils import serialize as _ser

        cdir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".placeholder_cache")
        # the package name leads the key: the JAX package writes the same
        # (scheme, curve, size) placeholders into this directory, and two
        # packages' test workers must never race on one file
        key = ("pcd_tpu_torch", type(snark).__name__, snark.cfg.name,
               public_input_size)
        fname = os.path.join(cdir, "_".join(str(k) for k in key) + ".bin")
        loaded = False
        if os.path.exists(fname):
            try:
                with open(fname, "rb") as f:
                    blob = f.read()
                (nvk,) = _struct.unpack_from("<I", blob, 0)
                vk = _ser.snark_vk_from_bytes(snark, blob[4 : 4 + nvk])
                proof = _ser.snark_proof_from_bytes(snark, blob[4 + nvk:])
                cache[public_input_size] = (vk, proof)
                loaded = True
            except Exception:
                loaded = False
        if not loaded:
            rng = test_rng()
            circ = DefaultCircuit(public_input_size)
            pk, vk = snark.circuit_specific_setup(circ, rng)
            proof = snark.prove(pk, circ, rng)
            cache[public_input_size] = (vk, proof)
            try:
                vb = _ser.snark_vk_to_bytes(snark, vk)
                pb = _ser.snark_proof_to_bytes(snark, proof)
                os.makedirs(cdir, exist_ok=True)
                tmp = f"{fname}.{os.getpid()}.tmp"   # one per process
                with open(tmp, "wb") as f:
                    f.write(_struct.pack("<I", len(vb)) + vb + pb)
                os.replace(tmp, fname)
            except Exception:
                pass
    return cache[public_input_size]


# ======================================================================
class MainCircuit:
    """Reference data_structures.rs:85-311."""

    def __init__(self, ic: ECCyclePCDConfig, predicate: PCDPredicate, crh_pp,
                 input_hash=None, help_vk=None, msg=None, witness=None,
                 prior_msgs=(), prior_proofs=(), base_case_bit=None,
                 help_vk_shape=None):
        self.ic = ic
        self.predicate = predicate
        self.crh_pp = crh_pp
        self.input_hash = input_hash
        self.help_vk = help_vk
        self.msg = msg
        self.witness = witness
        self.prior_msgs = list(prior_msgs)
        self.prior_proofs = list(prior_proofs)
        self.base_case_bit = base_case_bit
        # optional structural hint: shape-sensitive help-SNARK gadgets
        # (Marlin: domain sizes are structural) get the real vk's shape in
        # setup mode so synthesis matches prove-time structure
        self.help_vk_shape = help_vk_shape

    def _resolved(self):
        """Substitute defaults for unset values (setup mode) — shared by
        generate_constraints and external_inputs so the replay inputs match
        synthesis allocation order exactly."""
        ic, pred = self.ic, self.predicate
        crh = ic.crh
        input_hash = (self.input_hash if self.input_hash is not None
                      else crh.default_output())
        main_public_input = crh.convert_output_to_field_elements(input_hash)
        n_help_inputs = repacked_len(ic.main_field, ic.help_field,
                                     len(main_public_input))
        default_vk, default_proof = placeholder_proof(ic.help_snark,
                                                      n_help_inputs)
        help_vk = self.help_vk if self.help_vk is not None else default_vk
        if self.help_vk is None and self.help_vk_shape is not None \
                and hasattr(ic.help_gadget, "reshape_vk"):
            help_vk = ic.help_gadget.reshape_vk(default_vk, self.help_vk_shape)
        msg = self.msg if self.msg is not None else pred.default_message()
        witness = (self.witness if self.witness is not None
                   else pred.default_witness())
        if self.base_case_bit is False:
            prior_msgs = list(self.prior_msgs)
            prior_proofs = list(self.prior_proofs)
        else:
            dm = pred.default_message()
            prior_msgs = [dm] * pred.PRIOR_MSG_LEN
            prior_proofs = [default_proof] * pred.PRIOR_MSG_LEN
        return input_hash, help_vk, msg, witness, prior_msgs, prior_proofs

    def external_inputs(self):
        """Flat per-proof inputs (allocation order) for witness-program
        replay — see r1cs/program.py."""
        ic, pred = self.ic, self.predicate
        (input_hash, help_vk, msg, witness,
         prior_msgs, prior_proofs) = self._resolved()
        out = list(ic.crh.flatten_output(input_hash))
        out += ic.help_gadget.flatten_vk(help_vk)
        out += pred.flatten_message(msg)
        out += pred.flatten_witness(witness)
        for m in prior_msgs:
            out += pred.flatten_message(m)
        for pf in prior_proofs:
            out += ic.help_gadget.flatten_proof(pf)
        out.append(1 if self.base_case_bit else 0)
        return out

    def generate_constraints(self, cs: ConstraintSystem):
        ic, pred = self.ic, self.predicate
        crh = ic.crh
        V = fpvar_class(cs)
        if self.base_case_bit is False:
            assert len(self.prior_msgs) == pred.PRIOR_MSG_LEN
            assert len(self.prior_proofs) == pred.PRIOR_MSG_LEN

        # -- allocation (order mirrors the reference) -------------------
        (input_hash, help_vk, msg, witness,
         prior_msgs, prior_proofs) = self._resolved()
        input_hash_g = crh.new_output_input(V, input_hash)
        help_vk_g = ic.help_gadget.alloc_vk(cs, help_vk, mode="witness")
        msg_g = pred.new_message_var(cs, msg)
        witness_g = pred.new_witness_var(cs, witness)

        prior_msg_gs = [pred.new_message_var(cs, m) for m in prior_msgs]
        prior_proof_gs = [ic.help_gadget.alloc_proof(cs, pf)
                          for pf in prior_proofs]

        b_base = Boolean.new_witness(V, bool(self.base_case_bit))

        # -- vk hash ----------------------------------------------------
        help_vk_bytes_g = ic.help_gadget.vk_to_bytes(help_vk_g)
        vk_hash_g = crh.check_evaluation_gadget(V, self.crh_pp, help_vk_bytes_g)
        vk_hash_bytes_g = crh.output_var_to_bytes(vk_hash_g)

        # -- input hash check -------------------------------------------
        msg_bytes_g = pred.message_var_to_bytes(msg_g)
        committed_input = list(vk_hash_bytes_g) + list(msg_bytes_g)
        input_hash_supposed = crh.check_evaluation_gadget(V, self.crh_pp,
                                                          committed_input)
        crh.output_var_enforce_equal(input_hash_supposed, input_hash_g)

        # -- predicate ---------------------------------------------------
        pred.generate_constraints(cs, msg_g, witness_g, prior_msg_gs, b_base)

        # -- prior proof verification ------------------------------------
        all_verified = Boolean.constant(V, True)
        for pm_g, pp_g in zip(prior_msg_gs, prior_proof_gs):
            pm_bytes = pred.message_var_to_bytes(pm_g)
            committed_prior = list(vk_hash_bytes_g) + list(pm_bytes)
            prior_hash_g = crh.check_evaluation_gadget(V, self.crh_pp,
                                                       committed_prior)
            prior_fields = crh.convert_output_to_field_gadgets(prior_hash_g)
            input_var = ic.help_gadget.input_var_from_field_elements(prior_fields)
            ok = ic.help_gadget.verify(cs, help_vk_g, input_var, pp_g)
            all_verified = all_verified & ok

        (b_base | all_verified).enforce_true()


class HelpCircuit:
    """Reference data_structures.rs:314-393."""

    def __init__(self, ic: ECCyclePCDConfig, main_pvk, input_hash=None,
                 main_proof=None):
        self.ic = ic
        self.main_pvk = main_pvk
        self.input_hash = input_hash
        self.main_proof = main_proof

    def _resolved(self):
        ic = self.ic
        crh = ic.crh
        input_hash = (self.input_hash if self.input_hash is not None
                      else crh.default_output())
        hash_fields = crh.convert_output_to_field_elements(input_hash)
        _, default_proof = placeholder_proof(ic.main_snark, len(hash_fields))
        main_proof = (self.main_proof if self.main_proof is not None
                      else default_proof)
        return hash_fields, main_proof

    def external_inputs(self):
        """Flat per-proof inputs (allocation order) for witness-program
        replay — see r1cs/program.py."""
        hash_fields, main_proof = self._resolved()
        out = self.ic.main_gadget.flatten_input(hash_fields)
        out += self.ic.main_gadget.flatten_proof(main_proof)
        return out

    def generate_constraints(self, cs: ConstraintSystem):
        ic = self.ic
        hash_fields, main_proof = self._resolved()

        input_var = ic.main_gadget.input_var_new_input(cs, hash_fields)
        pvk_var = ic.main_gadget.alloc_pvk(cs, self.main_pvk)
        proof_var = ic.main_gadget.alloc_proof(cs, main_proof)
        ok = ic.main_gadget.verify_with_processed_vk(cs, pvk_var, input_var,
                                                     proof_var)
        ok.enforce_true()


# ======================================================================
class ECCyclePCD:
    """Reference ec_cycle_pcd/mod.rs:35-246."""

    def __init__(self, ic: ECCyclePCDConfig):
        self.ic = ic

    # -- input hash simulation (reference mod.rs:101-142: computed via the
    # gadgets on a scratch system so native/gadget byte layouts agree) ----
    def _vk_hash_bytes(self, crh_pp, help_vk) -> bytes:
        """H(help_vk) serialized — a pure function of (crh_pp, help_vk),
        cached per instance: the gadget-layout vk serialization plus the
        CRH over it cost ~1.2 s/prove at production scale and never
        change between proves under the same key."""
        cache = getattr(self, "_vkh_cache", None)
        if cache is None:
            cache = {}
            self._vkh_cache = cache
        # hold strong refs to the keyed objects so an id() is never reused
        # by a different (freed) object while its entry is alive; bounded
        # so instances cycling through many keys don't retain key material
        # forever (advisor r3)
        key = (id(crh_pp), id(help_vk))
        hit = cache.get(key)
        if hit is not None:
            return hit[2]
        if len(cache) >= 8:
            cache.pop(next(iter(cache)))
        ic = self.ic
        scratch = ConstraintSystem(ic.main_field)
        help_vk_g = ic.help_gadget.alloc_vk(scratch, help_vk, mode="witness")
        committed_vk = bytes(b.value
                             for b in ic.help_gadget.vk_to_bytes(help_vk_g))
        vk_hash = ic.crh.evaluate(crh_pp, committed_vk)
        out = ic.crh.output_to_bytes(vk_hash)
        cache[key] = (crh_pp, help_vk, out)
        return out

    def _input_hash(self, crh_pp, help_vk, predicate, msg):
        ic = self.ic
        vk_hash_bytes = self._vk_hash_bytes(crh_pp, help_vk)
        scratch = ConstraintSystem(ic.main_field)
        msg_g = predicate.new_message_var(scratch, msg)
        msg_bytes = bytes(b.value for b in predicate.message_var_to_bytes(msg_g))
        return ic.crh.evaluate(crh_pp, vk_hash_bytes + msg_bytes)

    # ------------------------------------------------------------------
    def circuit_specific_setup(self, predicate: PCDPredicate, rng):
        ic = self.ic
        crh_pp = ic.crh.setup(rng)
        shape_fn = getattr(ic.help_gadget, "vk_shape", None)
        shape = None
        floor = None  # (min_n, min_k) padding floor for the help SNARK
        for _ in range(8):
            main_circuit = MainCircuit(ic, predicate, crh_pp,
                                       help_vk_shape=shape)
            main_pk, main_vk = ic.main_snark.circuit_specific_setup(
                main_circuit, rng)
            main_pvk = ic.main_snark.process_vk(main_vk)

            help_circuit = HelpCircuit(ic, main_pvk)
            kw = {"min_shape": floor} if floor is not None else {}
            help_pk, help_vk = ic.help_snark.circuit_specific_setup(
                help_circuit, rng, **kw)
            if shape_fn is None:
                break
            real_shape = shape_fn(help_vk)
            if real_shape == shape:
                break
            # shape-sensitive gadget (Marlin): re-run setup with the real
            # help-vk shape so MainCircuit structure matches prove time
            # (the reference resolves the same circular dependency with its
            # universal-setup retry loop, ec_cycle_pcd/mod.rs:345-470).
            # The raw iteration can oscillate (period-2 between two nearby
            # domain shapes): once we see a second mismatch, raise a
            # monotone padding floor — the help domains are padded up to
            # the running max, making the vk shape non-decreasing, so the
            # iteration converges.
            if shape is not None:
                floor = (max(floor[0] if floor else 0, real_shape[0],
                             shape[0]),
                         max(floor[1] if floor else 0, real_shape[1],
                             shape[1]))
            shape = real_shape
        else:
            raise PCDError("help-vk shape fixed point did not converge")

        pk = ECCyclePCDPK(crh_pp=crh_pp, main_pk=main_pk, main_pvk=main_pvk,
                          help_pk=help_pk, help_vk=help_vk)
        vk = ECCyclePCDVK(crh_pp=crh_pp, help_vk=help_vk)
        pk.help_vk_shape = shape
        vk.help_vk_shape = shape
        return pk, vk

    # ------------------------------------------------------------------
    @request()
    def prove(self, pk: ECCyclePCDPK, predicate: PCDPredicate, msg, witness,
              prior_msgs, prior_proofs, rng):
        ic = self.ic
        if len(prior_msgs) != len(prior_proofs):
            raise PCDError("prior_msgs/prior_proofs length mismatch")
        with span("pcd/input_hash"):
            input_hash = self._input_hash(pk.crh_pp, pk.help_vk, predicate,
                                          msg)

        base = len(prior_msgs) == 0
        main_circuit = MainCircuit(
            ic, predicate, pk.crh_pp, input_hash=input_hash,
            help_vk=pk.help_vk, msg=msg, witness=witness,
            prior_msgs=prior_msgs, prior_proofs=prior_proofs,
            base_case_bit=base)
        with span("pcd/main_prove"):
            main_proof = ic.main_snark.prove(pk.main_pk, main_circuit, rng)

        help_circuit = HelpCircuit(ic, pk.main_pvk, input_hash=input_hash,
                                   main_proof=main_proof)
        with span("pcd/help_prove"):
            help_proof = ic.help_snark.prove(pk.help_pk, help_circuit, rng)
        return help_proof

    # ------------------------------------------------------------------
    def verify(self, vk: ECCyclePCDVK, predicate: PCDPredicate, msg, proof):
        ic = self.ic
        input_hash = self._input_hash(vk.crh_pp, vk.help_vk, predicate, msg)
        main_public_input = ic.crh.convert_output_to_field_elements(input_hash)
        help_public_input = ic.main_gadget.repack_input(main_public_input)
        return ic.help_snark.verify(vk.help_vk, help_public_input, proof)


# ======================================================================
class BoundTestingPredicate(PCDPredicate):
    """Synthetic predicate wrapping a size-bound circuit — used by the
    universal setup to size the SRS (reference ec_cycle_pcd/mod.rs:256-302:
    msg = witness + prior_msg, plus the bound circuit's constraints)."""

    PRIOR_MSG_LEN = 1

    def __init__(self, field, bound_circuit):
        self.F = field
        self.bound_circuit = bound_circuit

    def default_message(self):
        return self.F.zero()

    def default_witness(self):
        return self.F.zero()

    def new_message_var(self, cs, msg):
        return fpvar_class(cs).new_witness(msg)

    new_witness_var = new_message_var

    def message_var_to_bytes(self, msg_var):
        return msg_var.to_bytes()

    def generate_constraints(self, cs, msg_var, witness_var, prior_msg_vars,
                             base_case_bool):
        assert len(prior_msg_vars) == self.PRIOR_MSG_LEN
        (witness_var + prior_msg_vars[0]).enforce_equal(msg_var)
        self.bound_circuit.generate_constraints(cs)


class BoundCircuit:
    """Default bound circuit: ~`size` R1CS constraints worth of work
    (role of UniversalSetupSNARKGadget::BoundCircuit, which converts a
    ComputationBound into a circuit of that size)."""

    def __init__(self, size: int):
        self.size = max(int(size), 1)

    def generate_constraints(self, cs):
        V = fpvar_class(cs)
        x = V.new_witness(3)
        cs.set_last_recipe(("lc", {0: 3}))
        acc = x
        for _ in range(self.size):
            acc = acc * x
        out = V.new_witness(acc.val)
        cs.set_last_recipe(("lc", acc._as_lc()))
        acc.enforce_equal(out)


class UniversalSetupMixin:
    """UniversalSetupPCD surface (reference lib.rs:63-77 and the SRS-sizing
    retry loop ec_cycle_pcd/mod.rs:319-471 / index :473-584).

    PublicParameters = (main_bound, crh_pp, main_pp, help_pp).
    Both SNARKs must expose universal_setup(bound, rng) / index(pp, circuit)
    raising NeedLargerBound (Marlin does; Groth16/GM17 are circuit-specific
    and use circuit_specific_setup instead)."""

    def universal_setup(self, predicate_bound, rng):
        from ..snark.api import NeedLargerBound

        ic = self.ic
        crh_pp = ic.crh.setup(rng)
        bound_pred = BoundTestingPredicate(
            ic.main_field, BoundCircuit(getattr(predicate_bound, "max_degree",
                                                predicate_bound)))
        main_bound = predicate_bound.clone() if hasattr(predicate_bound, "clone") \
            else predicate_bound
        help_bound = type(main_bound)() if hasattr(main_bound, "clone") else 16

        shape = None
        floor = None  # monotone padding floor (see circuit_specific_setup)
        for _ in range(16):
            main_pp = ic.main_snark.universal_setup(main_bound, rng)
            help_pp = ic.help_snark.universal_setup(help_bound, rng)
            try:
                main_circuit = MainCircuit(ic, bound_pred, crh_pp,
                                           help_vk_shape=shape)
                main_pk, main_vk = ic.main_snark.index(main_pp, main_circuit,
                                                       rng)
            except NeedLargerBound as e:
                main_bound = e.bound
                continue
            main_pvk = ic.main_snark.process_vk(main_vk)
            try:
                help_circuit = HelpCircuit(ic, main_pvk)
                kw = {"min_shape": floor} if floor is not None else {}
                help_pk, help_vk = ic.help_snark.index(help_pp, help_circuit,
                                                       rng, **kw)
            except NeedLargerBound as e:
                help_bound = e.bound
                continue
            shape_fn = getattr(ic.help_gadget, "vk_shape", None)
            if shape_fn is not None:
                real_shape = shape_fn(help_vk)
                if real_shape != shape:
                    if shape is not None:
                        floor = (max(floor[0] if floor else 0, real_shape[0],
                                     shape[0]),
                                 max(floor[1] if floor else 0, real_shape[1],
                                     shape[1]))
                    shape = real_shape
                    continue
            return (main_bound, crh_pp, main_pp, help_pp, shape, floor)
        raise PCDError("universal setup did not converge")

    def index(self, pp, predicate, rng):
        from ..snark.api import NeedLargerBound

        ic = self.ic
        if len(pp) == 6:
            main_bound, crh_pp, main_pp, help_pp, shape, floor = pp
        else:  # pre-floor public parameters
            main_bound, crh_pp, main_pp, help_pp, shape = pp
            floor = None
        try:
            main_circuit = MainCircuit(ic, predicate, crh_pp,
                                       help_vk_shape=shape)
            main_pk, main_vk = ic.main_snark.index(main_pp, main_circuit, rng)
            main_pvk = ic.main_snark.process_vk(main_vk)
            help_circuit = HelpCircuit(ic, main_pvk)
            kw = {"min_shape": floor} if floor is not None else {}
            help_pk, help_vk = ic.help_snark.index(help_pp, help_circuit, rng,
                                                   **kw)
        except NeedLargerBound as e:
            raise PCDError(
                f"the bound is not correctly chosen (need {e.bound})") from e
        shape_fn = getattr(ic.help_gadget, "vk_shape", None)
        if shape_fn is not None and shape_fn(help_vk) != shape:
            raise PCDError("the bound is not correctly chosen (vk shape)")
        pk = ECCyclePCDPK(crh_pp=crh_pp, main_pk=main_pk, main_pvk=main_pvk,
                          help_pk=help_pk, help_vk=help_vk)
        vk = ECCyclePCDVK(crh_pp=crh_pp, help_vk=help_vk)
        pk.help_vk_shape = shape
        vk.help_vk_shape = shape
        return pk, vk


# mix the universal surface into ECCyclePCD
ECCyclePCD.universal_setup = UniversalSetupMixin.universal_setup
ECCyclePCD.index = UniversalSetupMixin.index
