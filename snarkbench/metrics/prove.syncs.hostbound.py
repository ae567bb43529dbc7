"""`prove.syncs` in the cells whose end-to-end reading is device_ms_per_proof:
the same reading (metrics/prove.syncs.py) under a name of its own."""


def read(run):
    from snarkbench.harness import metric_reader

    return metric_reader("prove.syncs", run.data)(run)
