"""`assemble.host_ms` in the cells whose end-to-end reading is
device_ms_per_proof: the same reading (metrics/assemble.host_ms.py) under a
name of its own."""


def read(run):
    from snarkbench.harness import metric_reader

    return metric_reader("assemble.host_ms", run.data)(run)
