"""The msm phase: the five MSMs (sort, K4 accumulate and reduce, the host's
window combine); median over the traced run's window proves, ms."""


def read(run):
    from snarkbench.metrics import phase_median_ms

    return phase_median_ms(run, "msm")
