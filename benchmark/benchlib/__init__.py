"""The benchmark harness of the PyTorch/CUDA port (`pcd_tpu_torch`): one
run of one cell of BENCHMARK.json (see benchmark/run.py).

Driven by data, found by name:
  configs/<config>.json     a deployment: the port's factory, sizes, cuts
  traffic/<traffic>.json    a traffic mix: its generator's parameters
  benchlib/kinds/<kind>.py  a generator, named by a mix's "kind"
  metrics/<metric>.py       one metric's reader, `read(run)` (a name
                            a.b with no file of its own: metrics/a.py)
"""
