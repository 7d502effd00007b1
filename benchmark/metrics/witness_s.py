"""witness_s (s a step, program spans): the SNARK provers' witness (replay
or synthesis), spans groth16/witness and gm17/witness, main and help, over
the traced window's steps."""

from benchlib.trace import span_per_request


def read(run):
    return span_per_request(run, ("groth16/witness", "gm17/witness"))
