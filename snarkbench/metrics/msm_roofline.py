"""The MSM layer's share of its roofline: the benchmark's own bound for the
five MSMs of the prove's witness (roofline.py: operations or bytes, the
larger) over the device busy time inside the prove's msm phase; median
over the profiled proves, %."""

import statistics


def read(run):
    from snarkbench import roofline

    vals = []
    for p in run.profiled:
        busy = p["busy"].get("msm", 0.0)
        work = run.work.get(p["req"]["w"])
        if busy > 0 and work:
            vals.append(100.0 * roofline.bound_seconds(work["msm_muls"], work["msm_bytes"])[0]
                        / busy)
    return statistics.median(vals) if vals else None
