"""The witness_ingest phase (PhaseTimer): the .wtns read and checked, the
witness on the device; median over the traced run's window proves, ms."""


def read(run):
    from snarkbench.metrics import phase_median_ms

    return phase_median_ms(run, "witness_ingest")
