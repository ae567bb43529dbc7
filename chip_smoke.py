"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # complex-100k, the full check
    python3 chip_smoke.py --constraints 2000   # a quick rehearsal

Phases, each fatal on failure (nonzero exit, no result line):
  1. build the kernels (csrc/*.cu, nvcc for sm_90a); print the card's name
     and power limit;
  2. make the complex-N fixture with the port's device setup (K1) and build
     the proving-key cache;
  3. hold every kernel against its plain PyTorch version on the card, on
     numpy-seeded inputs at the main path's shapes plus edge values
     (0, 1, p-1; the identity, P+P, P+(-P)); time both with CUDA events;
  4. prove through the port's API: a cold first prove, three warm proves
     with per-phase times, a deterministic and a randomized proof that both
     verify, and launch counts showing every kernel ran during one prove;
  5. complex(40, 50): the port's device setup gives the host oracle's zkey
     byte for byte, and its deterministic proof (through the CLI worker on
     the card) equals the oracle's byte for byte;
  6. print the kernels line, then the result line.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM rates for the bounds: 3.35 TB/s HBM3 (NVIDIA data sheet); 32-bit
# integer multiplies at 64 per SM per clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 64 * 132 * 1.98e9
MULS_PER_MONT = 264  # 8 CIOS rounds x (16 for a*b_i lo/hi + 1 for m + 16 for m*p)
MULS_PER_REDC = 136  # a product with standard 1: 8 rounds x (1 for m + 16 for m*p)
# Fq products per point operation (csrc/curve.cuh; G1's b3 product is adds)
FQ_MULS = {"g1": {"madd": 11, "add": 12, "dbl": 8}, "g2": {"madd": 39, "add": 42, "dbl": 27}}


def log(msg: str):
    print(msg, flush=True)


def bound(bytes_moved: float, muls: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT_MULS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_time(fn, reps: int = 5, warmup: bool = True) -> float:
    """Mean ms of fn() over reps (after one warm-up call), CUDA events."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_word_err(a, b) -> float:
    import torch

    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0


def random_field(rng, modulus: int, shape, device):
    """Canonical field values < modulus as int32 limb tensors (..., 8, n),
    with 0, 1 and p-1 in the first lanes."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb

    *lead, n = shape
    count = int(np.prod(lead, dtype=np.int64)) * n if lead else n
    vals = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64).astype(np.uint32)
    vals[:, 7] = rng.integers(0, modulus >> 224, size=count).astype(np.uint32)  # < p
    for i, v in enumerate((0, 1, modulus - 1)):
        vals[i] = lb.ints_to_words([v])[0]
    t = lb.words_to_limbs(vals, device)  # (8, count)
    if lead:
        t = t.reshape(8, *lead, n).movedim(0, -2).contiguous()
    return t


class Report:
    def __init__(self):
        self.rows = {}

    def add(self, name, **kw):
        self.rows.setdefault(name, {}).update(kw)


# ---------------------------------------------------------------- phase 3

def check_field_vec(rep, rng, n, dev):
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb

    ok = True
    for spec in (lb.FR_SPEC, lb.FQ_SPEC):
        a = random_field(rng, spec.modulus, (3, n), dev)
        b = random_field(rng, spec.modulus, (3, n), dev)
        b[..., 0:3] = a[..., 2:5]
        for op in (lb.OP_MUL, lb.OP_ADD, lb.OP_SUB, lb.OP_NEG):
            bb = None if op == lb.OP_NEG else b
            got = lb.field_op(op, a, bb, spec)
            want = lb.field_op_plain(op, a, bb, spec)
            err = max_word_err(got, want)
            ok &= err == 0
            log(f"  field_vec {spec.name} op{op} (3, 8, {n}): max word err {err}")
        # broadcast forms used by the pipeline: a table over the batch, a constant
        for bshape in ((8, n), (8, 1)):
            bb = b[0] if bshape == (8, n) else b[0, :, :1].contiguous()
            err = max_word_err(lb.mont_mul(a, bb, spec), lb.field_op_plain(lb.OP_MUL, a, bb, spec))
            ok &= err == 0
            log(f"  field_vec {spec.name} mul, b {bshape}: max word err {err}")
    a = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)
    b = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)
    ms = cuda_time(lambda: lb.mont_mul(a, b, lb.FR_SPEC), 20)
    plain_ms = cuda_time(lambda: lb.field_op_plain(lb.OP_MUL, a, b, lb.FR_SPEC), 1, False)
    lanes = 3 * n
    bms, by = bound(lanes * 96, lanes * MULS_PER_MONT)
    rep.add(kernels.FIELD_VEC.name, equal_to_plain=ok, max_abs_err=0.0 if ok else 1.0,
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            timed=f"Fr mont_mul, (3, 8, {n}) int32")
    return ok


def check_r1cs(rep, rng, cache, dev):
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.prover import pipeline

    nv = cache.header.n_vars
    w = random_field(rng, lb.FR_SPEC.modulus, (nv,), dev)
    got = pipeline.r1cs_reduce(w, cache.plan)
    want = pipeline.r1cs_reduce_plain(w, cache.plan)
    err = max_word_err(got, want)
    log(f"  r1cs_reduce nnz {cache.plan.coefs.shape[-1]}, slots {cache.plan.num_slots}: max word err {err}")
    ms = cuda_time(lambda: pipeline.r1cs_reduce(w, cache.plan), 20)
    plain_ms = cuda_time(lambda: pipeline.r1cs_reduce_plain(w, cache.plan), 1, False)
    nnz, slots = cache.plan.coefs.shape[-1], cache.plan.num_slots
    # one product per term and one REDC per nonempty slot; empty slots are 0
    nonempty = int((cache.plan.offsets[1:] != cache.plan.offsets[:-1]).sum())
    bms, by = bound(nnz * 36 + (slots + 1) * 4 + nv * 32 + slots * 32,
                    nnz * MULS_PER_MONT + nonempty * MULS_PER_REDC)
    rep.add(kernels.R1CS.name, equal_to_plain=err == 0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            timed=f"complex fixture plan, nnz {nnz}, {slots} slots")
    return err == 0


def check_ntt(rep, rng, cache, dev):
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import ntt

    dom = cache.domain
    n = dom.n
    x = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)

    def kernel_pair():
        return ntt.ntt_dit(ntt.intt_dif(x, dom), dom)

    def plain_pair():
        y = x.clone()
        for s in range(dom.log_n, 0, -1):
            y = ntt.ntt_stage_plain(y, dom.tw_inv, 1 << s, True,
                                    dom.n_inv_mont if s == 1 else None)
        inv = y
        for s in range(1, dom.log_n + 1):
            y = ntt.ntt_stage_plain(y, dom.tw_fwd, 1 << s, False)
        return inv, y

    inv_k = ntt.intt_dif(x, dom)
    inv_p, fwd_p = plain_pair()
    fwd_k = ntt.ntt_dit(inv_k, dom)
    err = max(max_word_err(inv_k, inv_p), max_word_err(fwd_k, fwd_p))
    roundtrip = bool((fwd_k == x).all())
    log(f"  ntt_stage (3, 8, 2^{dom.log_n}) intt+ntt: max word err {err}, roundtrip {roundtrip}")
    ms = cuda_time(kernel_pair, 10)
    plain_ms = cuda_time(plain_pair, 1, False)
    butterflies = 2 * dom.log_n * 3 * n // 2
    bms, by = bound(2 * 3 * n * 32 + 2 * n * 32, (butterflies + 3 * n) * MULS_PER_MONT)
    ok = err == 0 and roundtrip
    rep.add(kernels.NTT.name, equal_to_plain=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by,
            timed=f"intt_dif + ntt_dit, (3, 8, 2^{dom.log_n}), {2 * dom.log_n} launches")
    return ok


def _edge_msm_inputs(rng, dev, g2: bool):
    """64 lanes for c = 8 whose window-0 buckets hold P+P (one point twice,
    same digit), P+(-P) (digits +7 and -7 on one point) and the identity
    (0, 0); the other scalars are small, so the high windows are empty."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.refmath import curve as cv
    from icicle_snark_tpu_torch.refmath.field import fq_to_mont

    n = 64
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    if g2:
        pts = [cv.g2_to_affine(cv.g2_mul(cv.G2_GEN, k)) for k in ks]
        pts[4] = ((0, 0), (0, 0))
    else:
        pts = [cv.g1_to_affine(cv.g1_mul(cv.G1_GEN, k)) for k in ks]
        pts[4] = (0, 0)
    pts[1], pts[3] = pts[0], pts[2]
    scal = [int(s) for s in rng.integers(0, 1 << 62, size=n)]
    scal[0] = scal[1] = 5
    scal[2], scal[3] = 7, 256 - 7  # +7 and -7 (with a carry into window 1)

    def coord(i, comp=None):
        vals = [fq_to_mont(p[i] if comp is None else p[i][comp]) for p in pts]
        return lb.ints_to_limbs(vals, dev)

    if g2:
        xy = tuple(torch.stack([coord(i, 0), coord(i, 1)]) for i in range(2))
    else:
        xy = (coord(0), coord(1))
    return lb.ints_to_limbs(scal, dev), xy


def timed_once(fn):
    """(fn(), ms) for one call, CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _points_err(ops, a, b):
    """0.0 when the stacked projective points a, b are equal as affine
    points lane by lane, else the largest word difference."""
    from icicle_snark_tpu_torch.curve import jcurve as jc

    # window sums (3, coords..., G, W) compare lane by lane like buckets
    flat = [t.flatten(-2) if t.dim() == (5 if ops.g2 else 4) else t for t in (a, b)]
    same = bool(jc.points_equal(ops, jc.point_unstack(flat[0]), jc.point_unstack(flat[1])).all())
    return 0.0 if same else max(max_word_err(a, b), 1.0)


def check_msm(rep, rng, cache, dev, g2: bool):
    """K4 accumulate and reduce against their plain versions: an edge-case
    MSM, then the prove's own MSM shape (cache points, random scalars)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm

    ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
    tag = "g2" if g2 else "g1"
    if g2:
        sizes, points, c = [cache.points_b2[0].shape[-1]], cache.points_b2, cache.msm_c2
    else:
        sizes, points, c = cache.g1_sizes, cache.g1_points, cache.msm_c
    total = sum(sizes)
    edge_sc, edge_pts = _edge_msm_inputs(rng, dev, g2)
    cases = [
        ("edge", edge_sc, [edge_sc.shape[-1]], edge_pts, 8),
        ("main", random_field(rng, lb.FR_SPEC.modulus, (total,), dev), sizes, points, c),
    ]
    ok = True
    for label, sc, szs, pts, cc in cases:
        half, groups = 1 << (cc - 1), len(szs)
        order, negs, ends = msm.sort_windows(sc, szs, cc)
        windows = order.shape[0]
        t0 = time.perf_counter()
        bk = msm.msm_accumulate(pts[0], pts[1], order, negs, ends, groups, half)
        bp, acc_plain = timed_once(
            lambda: msm.msm_accumulate_plain(pts[0], pts[1], order, negs, ends, groups, half))
        acc_err = _points_err(ops, bk, bp)
        wk = msm.msm_reduce(bp, windows, groups, half)
        wp, red_plain = timed_once(lambda: msm.msm_reduce_plain(bp, windows, groups, half))
        red_err = _points_err(ops, wk, wp)
        log(f"  msm {tag} {label}: lanes {sc.shape[-1]}, c {cc}, W {windows}, G {groups}: "
            f"accumulate err {acc_err} (bitwise equal {bool(torch.equal(bk, bp))}), reduce err "
            f"{red_err} (bitwise equal {bool(torch.equal(wk, wp))}) [{time.perf_counter() - t0:.1f} s]")
        ok &= acc_err == 0 and red_err == 0
        if label != "main":
            continue
        acc_ms = cuda_time(
            lambda: msm.msm_accumulate(pts[0], pts[1], order, negs, ends, groups, half), 3)
        red_ms = cuda_time(lambda: msm.msm_reduce(bp, windows, groups, half), 3)
        # data-dependent work: one mixed add per nonzero digit on a finite point
        digits, _ = msm.window_digits_signed(sc, cc)
        zx, zy = (lb.is_zero(t).all(0) if g2 else lb.is_zero(t) for t in pts)
        madds = int(((digits != 0) & ~(zx & zy)).sum())
        words = 16 if g2 else 8
        nbk = windows * groups * half
        acc_bound = bound(total * 2 * words * 4 + windows * total * 5 + ends.numel() * 4
                          + nbk * 3 * words * 4, madds * FQ_MULS[tag]["madd"] * MULS_PER_MONT)
        # sum_b b * B_b over H buckets: a running-sum triangle, 2(H - 1)
        # general adds per (window, group); K4's segment split adds more
        adds = windows * groups * 2 * (half - 1)
        red_bound = bound(nbk * 3 * words * 4 + windows * groups * 3 * words * 4,
                          adds * FQ_MULS[tag]["add"] * MULS_PER_MONT)
        what = f"{tag}: {total} lanes, {windows} windows, c {cc}"
        _accumulate_row(rep, kernels.MSM_ACCUMULATE.name, acc_err, acc_ms, acc_plain, acc_bound, what)
        _accumulate_row(rep, kernels.MSM_REDUCE.name, red_err, red_ms, red_plain, red_bound, what)
    return ok


def _accumulate_row(rep, name, err, ms, plain_ms, bnd, what):
    """A prove runs K4 once for G1 and once for G2: its row sums the two."""
    prev = rep.rows.get(name)
    if prev is None:
        rep.add(name, equal_to_plain=err == 0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], timed=what)
        return
    rep.add(name, equal_to_plain=prev["equal_to_plain"] and err == 0,
            max_abs_err=max(prev["max_abs_err"], err), ms=prev["ms"] + ms,
            plain_ms=prev["plain_ms"] + plain_ms, bound_ms=prev["bound_ms"] + bnd[0],
            bound_by=prev["bound_by"] if prev["bound_by"] == bnd[1] else "operations",
            timed=prev["timed"] + "; " + what)


# ---------------------------------------------------------------- profile

KERNEL_NAMES = ("field_vec_kernel", "r1cs_reduce_kernel", "ntt_stage_kernel",
                "msm_accumulate_kernel", "msm_reduce_segments_kernel", "msm_reduce_final_kernel")


def profile_prove(paths, cm) -> dict:
    """One warm deterministic prove under torch.profiler: device time per
    kernel (ms, summed over launches), the other device work, the wall
    time and the device's idle share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from icicle_snark_tpu_torch.prover import api

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"], cm,
                          deterministic=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = {}
    other = 0.0
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them would count the same time again
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        if any(k in evt.name for k in KERNEL_NAMES):
            # "void msm_accumulate_kernel<E2>(...)" -> "msm_accumulate_kernel<E2>"
            name = evt.name.split("(")[0].removeprefix("void ")
            per[name] = per.get(name, 0.0) + ms
        else:
            other += ms
    busy = sum(per.values()) + other
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "kernels_ms": per,
            "other_device_ms": other,
            "idle_share": None if busy == 0 else 1.0 - busy / wall_ms}


# ---------------------------------------------------------------- fixtures

def make_fixture(directory: str, n_constraints: int, device):
    from icicle_snark_tpu_torch.io.wtns import write_wtns
    from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device
    from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness

    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, f) for k, f in (
        ("zkey", "circuit_final.zkey"), ("vk", "verification_key.json"),
        ("wtns", "witness.wtns"), ("proof", "proof.json"), ("public", "public.json"))}
    r1cs = complex_circuit(n_constraints, n_constraints)
    if not (os.path.exists(paths["zkey"]) and os.path.exists(paths["vk"])
            and os.path.exists(paths["wtns"])):
        groth16_setup_device(r1cs, paths["zkey"], paths["vk"], device=device)
        write_wtns(paths["wtns"], complex_circuit_witness(r1cs, a=7))
    return r1cs, paths


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--constraints", type=int, default=100000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.prover import api, pipeline
    from icicle_snark_tpu_torch.refmath import groth16 as oracle
    from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness
    from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup
    from icicle_snark_tpu_torch.io.wtns import write_wtns

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    failures = []

    # ---- 1. build
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, card {card}")

    # ---- 2. fixture + cold cache
    n = args.constraints
    fx_dir = os.path.join(HERE, ".fixtures", f"torch_complex_{n}")
    t0 = time.perf_counter()
    _, paths = make_fixture(fx_dir, n, dev)
    log(f"[setup] complex-{n} fixture in {time.perf_counter() - t0:.1f} s")
    cm = api.CacheManager("cuda")
    t0 = time.perf_counter()
    cache = cm.get(paths["zkey"])
    torch.cuda.synchronize()
    cold_cache_s = time.perf_counter() - t0
    log(f"[cache] cold cache {cold_cache_s:.3f} s: n_vars {cache.header.n_vars}, domain "
        f"2^{cache.header.power}, G1 lanes {sum(cache.g1_sizes)} in {len(cache.g1_sizes)} groups, "
        f"G2 lanes {cache.points_b2[0].shape[-1]}, window size c = {cache.msm_c} (G1), "
        f"{cache.msm_c2} (G2)")

    # ---- 3. kernels against their plain versions
    rep = Report()
    t0 = time.perf_counter()
    checks = [
        ("field_vec", lambda: check_field_vec(rep, rng, cache.domain.n, dev)),
        ("r1cs_reduce", lambda: check_r1cs(rep, rng, cache, dev)),
        ("ntt_stage", lambda: check_ntt(rep, rng, cache, dev)),
        ("msm g1", lambda: check_msm(rep, rng, cache, dev, False)),
        ("msm g2", lambda: check_msm(rep, rng, cache, dev, True)),
    ]
    for name, fn in checks:
        if not fn():
            failures.append(f"kernel {name} differs from its plain version")
    log(f"[kernels] checks in {time.perf_counter() - t0:.1f} s")

    # ---- 4. proves through the API
    timer = pipeline.PhaseTimer(dev)
    t0 = time.perf_counter()
    api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"], cm,
                      deterministic=True, timer=timer)
    log(f"[prove] first prove {time.perf_counter() - t0:.3f} s")
    if not api.groth16_verify(paths["proof"], paths["public"], paths["vk"]):
        failures.append("deterministic proof does not verify")
    warm = []
    launches = None
    for i in range(3):
        timer = pipeline.PhaseTimer(dev)
        if i == 0:
            kernels.reset_counts()
        s = api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"], cm,
                              deterministic=False, timer=timer)
        if i == 0:
            launches = kernels.counts()
        warm.append(s)
        log(f"[prove] warm prove {i}: {s:.3f} s, phases "
            + json.dumps({k: round(v, 4) for k, v in timer.phases.items()}))
    log(f"[prove] launches in one prove: {json.dumps(launches)}")
    if not api.groth16_verify(paths["proof"], paths["public"], paths["vk"]):
        failures.append("randomized proof does not verify")
    else:
        log("[prove] deterministic and randomized proofs verify")
    for name, count in launches.items():
        if count == 0:
            failures.append(f"kernel {name} did not launch during the prove")
    prof = profile_prove(paths, cm)
    if prof["device_busy_ms"] == 0:
        log("[profile] the profiler saw no device time")
    else:
        log("[profile] one warm prove: " + json.dumps(prof))
        if prof["idle_share"] < 0:
            log("[profile] WARNING: summed device time exceeds the wall time "
                "(overlapping events); the idle share is not a measurement")

    # ---- 5. small fixture against the oracle
    small = os.path.join(OUT_DIR, "smoke_complex_40_50")
    os.makedirs(small, exist_ok=True)
    r1cs = complex_circuit(40, 50)
    from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device

    groth16_setup(r1cs, os.path.join(small, "host.zkey"), os.path.join(small, "vk.json"))
    groth16_setup_device(r1cs, os.path.join(small, "dev.zkey"), device=dev)
    same_zkey = filecmp.cmp(os.path.join(small, "host.zkey"), os.path.join(small, "dev.zkey"),
                            shallow=False)
    write_wtns(os.path.join(small, "w.wtns"), complex_circuit_witness(r1cs, a=7))
    cmd = (f"prove --witness {small}/w.wtns --zkey {small}/dev.zkey --proof {small}/proof.json "
           f"--public {small}/public.json --device CUDA --deterministic 1\n"
           f"verify --proof {small}/proof.json --public {small}/public.json --vk {small}/vk.json\nexit\n")
    cli = subprocess.run([sys.executable, "-m", "icicle_snark_tpu_torch"], input=cmd, text=True,
                         capture_output=True, cwd=HERE, timeout=300)
    with open(os.path.join(small, "proof.json")) as fh:
        proof = json.load(fh)
    with open(os.path.join(small, "public.json")) as fh:
        public = json.load(fh)
    same_proof = (proof, public) == oracle.prove(os.path.join(small, "host.zkey"),
                                                 os.path.join(small, "w.wtns"), deterministic=True)
    log(f"[small] device zkey == host zkey: {same_zkey}; CLI deterministic proof == oracle: "
        f"{same_proof}; CLI said {cli.stdout.split()!r}")
    if not same_zkey:
        failures.append("device setup zkey differs from the host oracle's")
    if not same_proof or "OK!" not in cli.stdout or cli.returncode:
        failures.append("small deterministic proof differs from the oracle's")

    # ---- 6. report
    rows = []
    for k in kernels.ALL:
        row = rep.rows.get(k.name, {})
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches.get(k.name, 0), "max_abs_err": row.get("max_abs_err"),
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": None,
            "equal_to_plain": row.get("equal_to_plain"), "timed": row.get("timed"),
        })
    summary = {
        "card": card, "constraints": n, "cold_cache_s": cold_cache_s,
        "warm_prove_s": warm, "launches": launches, "profile": prof, "failures": failures,
        "total_s": time.perf_counter() - t_all, "kernels": rows,
    }
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke_{n}.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
