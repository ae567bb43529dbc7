"""Self time of the port's `ingest.copy` span: the witness's (8, n) limbs
copied from pageable host memory to the card, one blocking copy; median
over the traced run's window requests, ms."""


def read(run):
    from snarkbench import spans

    return spans.self_ms(run, "ingest.copy")
