"""Carry the JAX package's state into the port.  The "weights" of this
system are its keys: a PCD proving key and a PCD verifying key (u32
CRH-seed length, the seed, then the help SNARK's vk bytes) in the layouts
of `pcd_tpu_torch/utils/serialize.py`.  For the Groth16 configs the pk
blob is `pcd_tpu.utils.serialize.pcd_pk_to_bytes`'s; for the GM17 and
mixed configs, which the JAX package does not checkpoint, the caller
writes the same frame from the reference key with the JAX package's point
and query writers (serialize.gm17_pk_to_bytes gives the layout).  A
Marlin index key goes the same way: the caller writes the reference key
in the layout of serialize.marlin_pk_to_bytes with the JAX package's
point, query and vk writers, and the vk in the reference's own layout.
The conversion is a parse through the port's copy of serialize; the blobs
arrive as uint8 numpy arrays and nothing of the JAX package is imported.
"""

from __future__ import annotations

import numpy as np

from .utils import serialize


def _bytes(blob) -> bytes:
    arr = np.asarray(blob)
    if arr.dtype != np.uint8 or arr.ndim != 1:
        raise ValueError("expected a 1-D uint8 array")
    return arr.tobytes()


def pcd_pk_from_reference(pcd, blob: np.ndarray):
    """uint8 bytes of pcd_tpu's pcd_pk_to_bytes -> the port's
    ECCyclePCDPK for `pcd` (an ECCyclePCD of pcd_tpu_torch.configs)."""
    return serialize.pcd_pk_from_bytes(pcd, _bytes(blob))


def pcd_vk_from_reference(pcd, blob: np.ndarray):
    """uint8 bytes of a PCD verifying key (serialize.pcd_vk_to_bytes
    layout) -> the port's ECCyclePCDVK."""
    return serialize.pcd_vk_from_bytes(pcd, _bytes(blob))


def marlin_pk_from_reference(snark, blob: np.ndarray):
    """uint8 bytes of a Marlin index key (serialize.marlin_pk_to_bytes
    layout) -> the port's MarlinIndexPK for `snark` (a MarlinSNARK)."""
    return serialize.marlin_pk_from_bytes(snark.cfg, _bytes(blob))


def marlin_vk_from_reference(snark, blob: np.ndarray):
    """uint8 bytes of pcd_tpu's marlin_vk_to_bytes -> the port's
    MarlinIndexVK for `snark`."""
    return serialize.marlin_vk_from_bytes(snark.cfg, _bytes(blob))
