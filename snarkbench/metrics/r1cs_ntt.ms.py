"""The r1cs_ntt phase: K2's R1CS evaluation and K5's coset passes with h;
median over the traced run's window proves, ms."""


def read(run):
    from snarkbench.metrics import phase_median_ms

    return phase_median_ms(run, "r1cs_ntt")
