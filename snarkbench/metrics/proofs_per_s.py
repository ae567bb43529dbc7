"""Proofs completed in the window over the window's seconds (its last
return less its first call): every request, every second."""


def read(run):
    done = [r for r in run.window_requests if not r["error"]]
    return len(done) / run.window_s if run.window_s > 0 else None
