"""The closed loop: one client, sending its next request when the previous
call returns, as the reference's worker protocol does (the caller waits for
COMMAND_COMPLETED).

Parameters of the mix (traffic/<name>.json):
  kind             "closed"
  cache            "warm": one CacheManager for the run, the zkey resident;
                   "cold": a new CacheManager for every request
  warmup_proves    proves in set-up, before the window
  traced_proves    proves of the profiled stretch of a traced run

Requests take the seed's witnesses in turn. The window opens at the first
call and closes at the first return at or after `seconds`: every request in
it counts whole, and the window's length is its last return less its first
call.
"""

from __future__ import annotations

import time


def drive(prover, params: dict, seconds: float, timer_factory=None) -> list:
    if params["cache"] not in ("warm", "cold"):
        raise ValueError(f"unknown cache mode {params['cache']!r}")
    cold = params["cache"] == "cold"
    nw = len(prover.witnesses)
    reqs = []
    end = time.perf_counter() + seconds
    while True:
        cm = prover.api.CacheManager(prover.device) if cold else None
        reqs.append(prover.call(len(reqs) % nw, timer_factory=timer_factory, cm=cm))
        if reqs[-1]["t1"] >= end:
            return reqs
