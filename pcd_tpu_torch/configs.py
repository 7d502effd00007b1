"""Named PCD configurations of the port: the Groth16, GM17, mixed and
Marlin factories of `pcd_tpu/configs.py` (the reference's
PCDGroth16Mnt4, tests/mnt4_groth16.rs:22-30, PCDGm17Mnt4,
tests/mnt4_gm17.rs:23-31, the mixed tests/mnt4_mix_*.rs:24-32, PCDMarlin,
tests/mnt4_marlin.rs:68-94, and their toy-cycle twins).  Each takes
the device its provers' commitment MSMs run on: None means the card.
"""

from __future__ import annotations

from functools import lru_cache

from .crh.bowe_hopwood import BoweHopwoodCRH
from .curves import models as M
from .device import resolve_device
from .pcd.ec_cycle import ECCyclePCD, ECCyclePCDConfig
from .snark.gm17.gadget import GM17VerifierGadget
from .snark.gm17.native import GM17
from .snark.groth16.gadget import Groth16VerifierGadget
from .snark.groth16.native import Groth16
from .snark.marlin.gadget import MarlinVerifierGadget
from .snark.marlin.native import MarlinSNARK

# SNARK kind -> (prover, verifier gadget)
_SNARKS = {"groth16": (Groth16, Groth16VerifierGadget),
           "gm17": (GM17, GM17VerifierGadget),
           "marlin": (MarlinSNARK, MarlinVerifierGadget)}


def _config(cycle, main_kind: str, help_kind: str,
            device) -> ECCyclePCDConfig:
    (main_snark, main_gadget), (help_snark, help_gadget) = (
        _SNARKS[main_kind], _SNARKS[help_kind])
    return ECCyclePCDConfig(
        cycle=cycle,
        crh=BoweHopwoodCRH(cycle.crh_te),
        main_snark=main_snark(cycle.main, device=device),
        help_snark=help_snark(cycle.help, device=device),
        main_gadget=main_gadget(cycle.main),
        help_gadget=help_gadget(cycle.help),
    )


@lru_cache(maxsize=None)
def _pcd(cycle_name: str, main_kind: str, help_kind: str,
         device) -> ECCyclePCD:
    cycle = M.toy_cycle() if cycle_name == "toy" else M.mnt_cycle()
    return ECCyclePCD(_config(cycle, main_kind, help_kind, device))


def toy_groth16(device=None) -> ECCyclePCD:
    """Toy-cycle Groth16 PCD (fast tests)."""
    return _pcd("toy", "groth16", "groth16", resolve_device(device))


def mnt4_groth16(device=None) -> ECCyclePCD:
    """The reference's PCDGroth16Mnt4 (tests/mnt4_groth16.rs:22-30):
    Groth16<MNT4-298> main / Groth16<MNT6-298> help, Bowe-Hopwood CRH."""
    return _pcd("mnt", "groth16", "groth16", resolve_device(device))


def toy_gm17(device=None) -> ECCyclePCD:
    """Toy-cycle GM17 PCD (fast tests)."""
    return _pcd("toy", "gm17", "gm17", resolve_device(device))


def mnt4_gm17(device=None) -> ECCyclePCD:
    """The reference's PCDGm17Mnt4 (tests/mnt4_gm17.rs:23-31): GM17 on
    both sides of the MNT4-298/MNT6-298 cycle."""
    return _pcd("mnt", "gm17", "gm17", resolve_device(device))


def toy_mix_groth16_gm17(device=None) -> ECCyclePCD:
    """Toy-cycle Groth16 main / GM17 help PCD."""
    return _pcd("toy", "groth16", "gm17", resolve_device(device))


def toy_mix_gm17_groth16(device=None) -> ECCyclePCD:
    """Toy-cycle GM17 main / Groth16 help PCD."""
    return _pcd("toy", "gm17", "groth16", resolve_device(device))


def mnt4_mix_groth16_gm17(device=None) -> ECCyclePCD:
    """Reference tests/mnt4_mix_groth16gm17.rs:24-32: Groth16<MNT4-298>
    main / GM17<MNT6-298> help."""
    return _pcd("mnt", "groth16", "gm17", resolve_device(device))


def mnt4_mix_gm17_groth16(device=None) -> ECCyclePCD:
    """Reference tests/mnt4_mix_gm17groth16.rs:24-32: GM17<MNT4-298> main
    / Groth16<MNT6-298> help."""
    return _pcd("mnt", "gm17", "groth16", resolve_device(device))


def toy_marlin(device=None) -> ECCyclePCD:
    """Toy-cycle Marlin PCD."""
    return _pcd("toy", "marlin", "marlin", resolve_device(device))


def mnt4_marlin(device=None) -> ECCyclePCD:
    """The reference's PCDMarlin (tests/mnt4_marlin.rs:68-94): Marlin +
    KZG10 on both sides of the cycle, Poseidon Fiat-Shamir, universal
    setup."""
    return _pcd("mnt", "marlin", "marlin", resolve_device(device))
