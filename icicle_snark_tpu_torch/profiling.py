"""Per-kernel speed-of-light profiling + scaling report on the H100.

The port's counterpart of icicle_snark_tpu/profiling.py, and like it of
the reference's timing hooks (wall-clock `proof took:` in
src/lib.rs:227-244, `MEASURE_MSM_TIMES` in
backend/cpu/src/curve/cpu_msm.hpp:31-33, the criterion benches in
wrappers/rust/icicle-core/src/msm/mod.rs:299-424): each probe times one
hand-written kernel's wrapper at a caller's size with CUDA events, counts
its launches (`kernels.counts()`) and holds the time beside the least time
the card could take for the same work (`bound`).

Usage:
    python -m icicle_snark_tpu_torch.profiling [--msm] [--out FILE]

Prints one JSON line per kernel and (optionally) writes a markdown report.
The probes, and the kernels they time:
  - profile_mont_mul: the Fr Montgomery product over a lane batch (K1);
  - profile_padd: lane-wise G1 point addition of two stacks of points
    (K6, `ops/msm.py` `sum_windows` at S = 2);
  - profile_ntt: the inverse + forward NTT pair on K5's passes, and on K3's
    register passes beside it (`ntt_dit` / `intt_dif`);
  - profile_msm: grouped G1 MSM window sums, 4 groups (K4 accumulate and
    reduce, the prove's shape);
  - scaling_report: the sharded MSM of parallel/ on meshes of this card
    repeated D = 1, 2, 4 times: on one card the shards run one after
    another, so it reads the sharding's overhead, not a speedup.

Speed-of-light model (one H100 SXM at its 700 W limit): 3.35 TB/s of HBM3
(NVIDIA data sheet); 32-bit integer multiplies at 64 per SM per clock
(CUDA C++ Programming Guide, arithmetic instruction throughput, compute
capability 9.0) x 132 SMs x 1.98 GHz boost clock. A probe's compute bound
is its 32-bit multiplies over that rate, its memory bound the bytes it
must move (each input read once, each output written once) over HBM's;
utilization is the larger bound over the measured time. The entry point
runs on the card; `--device cpu` times the kernels' plain versions on the
host clock, for the tests only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 64 * 132 * 1.98e9
MULS_PER_MONT = 264  # 8 CIOS rounds x (16 for a*b_i lo/hi + 1 for m + 16 for m*p)
# Fq products per point operation (csrc/curve.cuh; G1's b3 product is adds)
FQ_MULS = {"g1": {"madd": 11, "add": 12, "dbl": 8}, "g2": {"madd": 39, "add": 42, "dbl": 27}}


def bound(bytes_moved: float, muls: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the 32-bit multiplies over the card's multiply rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, device) -> float:
    """Mean ms of fn() over reps after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def launches(fn) -> dict:
    """The port's kernel launches of one fn() call (kernels.counts())."""
    from . import kernels

    kernels.reset_counts()
    fn()
    return {k: v for k, v in kernels.counts().items() if v}


def _entry(kernel: str, ms: float, n: int, unit: str, muls: float, bytes_moved: float,
           device, counts: dict, extra: dict | None = None) -> dict:
    """One report entry with its roofline bounds (the JAX entry's keys,
    `est_vpu_ops` as the 32-bit multiplies the bound counts)."""
    sol_ms, by = bound(bytes_moved, muls)
    t = ms / 1e3
    e = {
        "kernel": kernel,
        "time_s": t,
        "throughput": n / t,
        "unit": unit,
        "est_int32_muls": muls,
        "bytes_moved": bytes_moved,
        "sol_time_s": sol_ms / 1e3,
        "sol_utilization": sol_ms / ms,
        "bound": "compute" if by == "operations" else "memory",
        "launches": counts,
        "device": device.type,
    }
    if extra:
        e.update(extra)
    return e


def _random_fr(rng, n: int, device):
    from .fields import limbs as lb

    vals = rng.integers(1, 1 << 62, size=(n, 4), dtype=np.uint64)
    words = vals.view(np.uint32).reshape(n, 8).copy()
    words[:, 7] &= 0x0FFFFFFF  # < 2^252 < r
    return lb.words_to_limbs(words, device)


def profile_mont_mul(lanes: int, reps: int, device) -> dict:
    """K1: the Fr Montgomery product of two (8, lanes) batches."""
    from .fields import limbs as lb

    rng = np.random.default_rng(7)
    a = _random_fr(rng, lanes, device)
    b = a.roll(1, dims=1)

    def f():
        return lb.mont_mul(a, b, lb.FR_SPEC)

    return _entry("mont_mul_fr", time_ms(f, reps, device), lanes, "mul/s",
                  muls=lanes * MULS_PER_MONT, bytes_moved=3 * lanes * 32, device=device,
                  counts=launches(f), extra={"lanes": lanes})


def profile_padd(lanes: int, reps: int, device) -> dict:
    """K6: lane-wise G1 complete addition of two stacks of `lanes`
    projective points (`sum_windows` at S = 2, one launch)."""
    import torch

    from . import _testpoints
    from .ops import msm as msm_ops

    p = torch.stack(_testpoints.random_g1_batch(lanes, 3, device))
    q = torch.stack(_testpoints.random_g1_batch(lanes, 4, device))
    stacks = torch.stack([p, q]).unsqueeze(-2).contiguous()  # (2, 3, 8, 1, lanes)

    def f():
        return msm_ops.sum_windows(stacks)

    return _entry("g1_padd", time_ms(f, reps, device), lanes, "add/s",
                  muls=lanes * FQ_MULS["g1"]["add"] * MULS_PER_MONT,
                  bytes_moved=3 * lanes * 3 * 32, device=device, counts=launches(f),
                  extra={"lanes": lanes})


def profile_ntt(log_n: int, reps: int, device) -> list:
    """The inverse + forward NTT pair of size 2^log_n (batch 1) on K5's
    passes, and on K3's register passes (NTT_BLOCK_MIN_LOG raised past
    log_n). Two entries."""
    from .ops import ntt as ntt_ops

    n = 1 << log_n
    dom = ntt_ops.get_domain(log_n, device)
    x = _random_fr(np.random.default_rng(11), n, device).unsqueeze(0)  # (1, 8, n)

    def f():
        return ntt_ops.ntt_dit(ntt_ops.intt_dif(x, dom), dom)

    butterflies = 2 * (n // 2) * log_n
    muls = (butterflies + n) * MULS_PER_MONT  # a product a butterfly; the 1/n
    moved = 2 * 2 * n * 32  # each transform reads and writes the batch once
    out = []
    saved = ntt_ops.NTT_BLOCK_MIN_LOG
    for name, min_log in ((f"ntt_2^{log_n}", saved), (f"ntt_2^{log_n}_radix", log_n + 1)):
        ntt_ops.NTT_BLOCK_MIN_LOG = min_log
        try:
            out.append(_entry(name, time_ms(f, reps, device), butterflies, "butterfly/s",
                              muls=muls, bytes_moved=moved, device=device, counts=launches(f),
                              extra={"log_n": log_n, "transforms": 2}))
        finally:
            ntt_ops.NTT_BLOCK_MIN_LOG = saved
    return out


def profile_msm(log_n: int, reps: int, device, c: int | None = None) -> dict:
    """K4: grouped G1 MSM window sums, 4 groups x 2^log_n points (the
    Groth16 prove's shape); points/s over all groups. The bound counts
    this input's mixed adds (one a nonzero signed digit) and the reduce's
    running sums."""
    import torch

    from . import _testpoints
    from .ops import msm as msm_ops

    n = 1 << log_n
    rng = np.random.default_rng(5)
    sc = _random_fr(rng, 4 * n, device)
    pts = [_testpoints.random_g1_batch(n, 100 + g, device) for g in range(4)]
    records = msm_ops.point_records(tuple(torch.cat([p[i] for p in pts], dim=-1)
                                          for i in range(2)))
    del pts
    c = c or msm_ops.choose_c(4 * n, groups=4)

    def f():
        return msm_ops.msm_window_sums(sc, [n] * 4, records, c)

    digits, _ = msm_ops.window_digits_signed(sc, c)
    windows, madds = digits.shape[0], int((digits != 0).sum())
    del digits
    half = 1 << (c - 1)
    adds = windows * 4 * 2 * (half - 1)
    muls = (madds * FQ_MULS["g1"]["madd"] + adds * FQ_MULS["g1"]["add"]) * MULS_PER_MONT
    moved = 4 * n * (32 + 64) + windows * 4 * 3 * 32
    return _entry(f"msm_g1_grouped_4x2^{log_n}", time_ms(f, reps, device), 4 * n, "point/s",
                  muls=muls, bytes_moved=moved, device=device, counts=launches(f),
                  extra={"c": c, "windows": windows})


def scaling_report(reps: int = 2, device="cuda", log_n: int = 14, c: int = 8) -> list:
    """The sharded MSM (parallel/msm_shard.py: K4 a shard, one K6 combine)
    over 2^log_n lanes on meshes of this device repeated D = 1, 2, 4 times.
    The shards of one device run one after another, so `vs_d1` reads the
    sharding's overhead, not a speedup."""
    import torch

    from . import _testpoints
    from .ops import msm as msm_ops
    from .parallel.mesh import make_mesh
    from .parallel.msm_shard import msm_window_sums_local
    from .runtime import require_device

    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:  # a mesh names its card
        dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 << log_n
    sc = _random_fr(np.random.default_rng(9), n, dev)
    x, y, _ = _testpoints.random_g1_batch(n, 2, dev)
    rows, base = [], None
    for d in (1, 2, 4):
        mesh = make_mesh([dev] * d)
        w = n // d
        scs = [sc[:, i * w:(i + 1) * w].contiguous() for i in range(d)]
        recs = [msm_ops.point_records((x[:, i * w:(i + 1) * w], y[:, i * w:(i + 1) * w]))
                for i in range(d)]

        def f():
            return msm_window_sums_local(mesh, scs, [w], recs, c)

        t = time_ms(f, reps, dev) / 1e3
        base = base or t
        rows.append({"mesh": d, "time_s": t, "vs_d1": t / base, "launches": launches(f),
                     "device": dev.type})
        del recs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu (the kernels' plain versions)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run(include_msm: bool = False, reps: int = 5, out_md: str | None = None,
        device="cuda") -> list:
    from .runtime import require_device

    dev = require_device(device)
    if dev.type == "cuda":
        from . import kernels

        kernels.lib()  # the build stays out of every probe
    entries = [profile_mont_mul(1 << 20, reps, dev), profile_padd(1 << 16, reps, dev),
               *profile_ntt(18, reps, dev)]
    if include_msm:
        entries.append(profile_msm(16, max(2, reps // 2), dev))
    for e in entries:
        print(json.dumps(e), flush=True)
    scaling = scaling_report(device=dev)
    for row in scaling:
        print(json.dumps({"scaling": row}), flush=True)
    if out_md:
        write_md(out_md, card_name(dev), entries, scaling)
    return entries


def write_md(path: str, card: str, entries: list, scaling: list):
    lines = [
        "# PROFILE — per-kernel speed-of-light report",
        "",
        f"Card: {card}. Times: CUDA events over repeated wrapper calls after a warm-up.",
        "",
        "Speed of light: 3.35 TB/s HBM3; 32-bit multiplies at 64 per SM per clock x 132 SMs x",
        "1.98 GHz (an Fr Montgomery product is 264 of them). Utilization: the larger bound",
        "over the measured time.",
        "",
        "| kernel | time | throughput | launches | bound | SoL time | utilization |",
        "|---|---|---|---|---|---|---|",
    ]
    for e in entries:
        lines.append(
            f"| {e['kernel']} | {e['time_s'] * 1e3:.4f} ms | {e['throughput']:.4g} {e['unit']} | "
            f"{json.dumps(e['launches'])} | {e['bound']} | {e['sol_time_s'] * 1e3:.4f} ms | "
            f"{e['sol_utilization'] * 100:.1f}% |")
    lines += ["", "## Mesh scaling (MSM, the shards on this one device)", ""]
    for row in scaling:
        lines.append(f"- {json.dumps(row)}")
    lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--msm", action="store_true", help="include the MSM probe")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="write markdown report here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu times the plain versions, for the tests")
    args = ap.parse_args(argv)
    run(include_msm=args.msm, reps=args.reps, out_md=args.out, device=args.device)


if __name__ == "__main__":
    main()
