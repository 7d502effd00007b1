"""assemble_ms (ms a batch, program spans): the proofs' assembly on the
host once their MSMs are collected (span proof_assemble of the Groth16
prover's `_prove_commit`: A, B, B1 and C from the MSMs and the key's
alpha, beta and delta), both sides of a step, over the traced window's
batches.  Nothing where the program keeps no such span."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("proof_assemble",), scale=1e3)
