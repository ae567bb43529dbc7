"""Self time of the port's `msm.combine` span: the host's window combine
(window_points_to_host_g1/g2 and horner_combine in Python integers) of the
five MSMs; median over the traced run's window requests, ms."""


def read(run):
    from snarkbench import spans

    return spans.self_ms(run, "msm.combine")
