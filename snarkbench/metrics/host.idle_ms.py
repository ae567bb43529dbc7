"""The card's idle time that the host's own work accounts for: the summed
self time of a request's host-only spans (`host`) that opened with the
card's stream empty (`stream_idle`); median over the traced run's window
requests, ms."""


def read(run):
    from snarkbench import spans

    return spans.self_ms(run, spans.host_on_idle_card)
