"""pcd_tpu_torch: the PyTorch/CUDA port of pcd_tpu, the proof-carrying-data
(PCD/IVC) proving framework over the MNT4-298/MNT6-298 cycle.

It keeps pcd_tpu's layout module for module.  The framework-free modules
(fields, curves, pairing, r1cs, gadgets, crh, pcd, snark plans, the C++ host
tier) are copies; the ones that touched JAX are ported: the commitment
MSMs run on hand-written CUDA kernels for sm_90a (csrc/) on an NVIDIA
H100, with a plain torch version of every kernel beside it.  Entry points
run on the card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
