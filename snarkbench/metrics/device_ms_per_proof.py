"""The card's busy time a proof over the window: the union of every
device operation's interval in the window's trace (the card's activity
alone; the set-up's warm-up proves start the tracer), over the proofs
completed in the window, in ms. Nothing to read where the trace left out
a port kernel that launched."""


def read(run):
    busy = getattr(run, "window_busy_s", None)
    done = sum(1 for r in run.window_requests if not r["error"])
    return busy / done * 1e3 if busy and done else None
