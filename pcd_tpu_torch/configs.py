"""Named PCD configurations of the port: the Groth16 factories of
`pcd_tpu/configs.py` (the reference's PCDGroth16Mnt4,
tests/mnt4_groth16.rs:22-30, and its toy-cycle twin).  Each takes the
device its provers' commitment MSMs run on: None means the card.
"""

from __future__ import annotations

from functools import lru_cache

from .crh.bowe_hopwood import BoweHopwoodCRH
from .curves import models as M
from .device import resolve_device
from .pcd.ec_cycle import ECCyclePCD, ECCyclePCDConfig
from .snark.groth16.gadget import Groth16VerifierGadget
from .snark.groth16.native import Groth16


def _groth16_config(cycle, device) -> ECCyclePCDConfig:
    return ECCyclePCDConfig(
        cycle=cycle,
        crh=BoweHopwoodCRH(cycle.crh_te),
        main_snark=Groth16(cycle.main, device=device),
        help_snark=Groth16(cycle.help, device=device),
        main_gadget=Groth16VerifierGadget(cycle.main),
        help_gadget=Groth16VerifierGadget(cycle.help),
    )


@lru_cache(maxsize=None)
def _toy_groth16(device) -> ECCyclePCD:
    return ECCyclePCD(_groth16_config(M.toy_cycle(), device))


@lru_cache(maxsize=None)
def _mnt4_groth16(device) -> ECCyclePCD:
    return ECCyclePCD(_groth16_config(M.mnt_cycle(), device))


def toy_groth16(device=None) -> ECCyclePCD:
    """Toy-cycle Groth16 PCD (fast tests)."""
    return _toy_groth16(resolve_device(device))


def mnt4_groth16(device=None) -> ECCyclePCD:
    """The reference's PCDGroth16Mnt4 (tests/mnt4_groth16.rs:22-30):
    Groth16<MNT4-298> main / Groth16<MNT6-298> help, Bowe-Hopwood CRH."""
    return _mnt4_groth16(resolve_device(device))
