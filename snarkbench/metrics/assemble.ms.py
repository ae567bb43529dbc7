"""The randomize_assemble and serialize phases: the host's randomisation,
assembly and public signals; median over the traced run's window proves, ms."""


def read(run):
    from snarkbench.metrics import phase_median_ms

    return phase_median_ms(run, "randomize_assemble", "serialize")
