"""`proofs_per_s` in the cells whose end-to-end reading is device_ms_per_proof:
the same reading (metrics/proofs_per_s.py) under a name of its own."""


def read(run):
    from snarkbench.harness import metric_reader

    return metric_reader("proofs_per_s", run.data)(run)
