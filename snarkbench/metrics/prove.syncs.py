"""The request's blocking waits on the card: the port's `syncs` counter
(every call that torch.cuda.set_sync_debug_mode flags, the timer's own
marks left out) summed over every span; median over the traced run's
window requests."""


def read(run):
    from snarkbench import spans

    return spans.median(run, spans.syncs)
