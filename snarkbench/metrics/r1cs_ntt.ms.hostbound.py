"""`r1cs_ntt.ms` in the cells whose end-to-end reading is device_ms_per_proof:
the same reading (metrics/r1cs_ntt.ms.py) under a name of its own."""


def read(run):
    from snarkbench.harness import metric_reader

    return metric_reader("r1cs_ntt.ms", run.data)(run)
