"""Self time of the port's randomisation spans, `assemble.precompute` (the
products that need no MSM result) and `assemble.randomize` (those that need
them): the host's Python-integer randomisation of the proof, wherever in the
prove it runs; median over the traced run's window requests, ms. A program
that randomises in one `assemble.randomize` span reads the same work."""

NAMES = ("assemble.precompute", "assemble.randomize")


def read(run):
    from snarkbench import spans

    return spans.self_ms(run, lambda s: s.name in NAMES)
