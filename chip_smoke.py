"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # complex-100k and complex-1600k, the full check
    python3 chip_smoke.py --constraints 2000 --large-constraints 20000   # a rehearsal
    python3 chip_smoke.py --bits-only   # the MSM on a bit-valued witness, nothing else
    python3 chip_smoke.py --r1cs-only   # construct_r1cs, the r1cs_ntt phase, the K5 pair
    python3 chip_smoke.py --ops-only    # K9-K11, K4 at small windows, the op surface
    python3 chip_smoke.py --setup-only  # the device setup on K11 and on K1 launches, timed
    python3 chip_smoke.py --curves-only # K12-K14, K16, K17: the other curves' MSMs, NTTs, vec-ops
    python3 chip_smoke.py --multichip-only  # K6, K15 and the sharded prove on meshes of this card
    python3 chip_smoke.py --precompute-only # K7 and K11 against plain, timed, with registers
    python3 chip_smoke.py --curves-msm-only # K13 alone at the six full-width MSMs, by stage
    python3 chip_smoke.py --ntt-only        # K3's register passes, K5 and K14's routes, the sweeps
    python3 chip_smoke.py --family-only     # the reference's benchmark family at full size
    python3 chip_smoke.py --cache-only      # the cold cache at complex-N and complex-M, by phase
    python3 chip_smoke.py --ingest-only     # K18 against plain, timed; the witness ingest A/B
    python3 chip_smoke.py --k4-only [--k4-parent DIR]  # K4 by instantiation at the cells' shapes

Phases, each fatal on failure (nonzero exit, no result line):
  1. build the kernels (csrc/*.cu, nvcc for sm_90a); print the card's name
     and power limit, each kernel's registers and spills, and the SASS
     instruction census (`cuobjdump -sass`) of the K1, K2 and K5 kernels;
  2. make the complex-N fixture with the port's device setup (K11 for the
     fixed-base points, K7 for their affine form; a driven path, timed by
     phase) and build the proving-key cache;
  3. hold every kernel against its plain PyTorch version on the card, on
     numpy-seeded inputs at the main path's shapes plus edge values
     (0, 1, p-1; the identity, P+P, P+(-P)); time both with CUDA events
     (K1-K4, K7 at complex-N shapes; K3's register passes at every R and
     its one-stage entry, driven once more as a counted round trip, beside
     K5 on the same pair (G2 on a pair of threads a lane, with
     its registers), K4 at every lane of both MSMs; K5, K6
     and K4 once more at the large circuit's shapes in phase 7; K9-K11 in
     phase 6; K8 at the probe's; K18 at 2^20 and 1 600 003 rows; K19's pairs
     and radix sort at complex-1600k's G1 shape);
  4. the coset evaluation (K2 rows, then K5's passes with the keys and h
     fused in) against its plain version word for word, on the fixture's
     and on a bit-valued witness, timed, its launches counted (K2 once, K5
     twice per pass, K1 never);
     prove through the port's API: a cold first prove, three warm proves
     with per-phase times, a deterministic and a randomized proof that both
     verify, and launch counts showing the kernels ran during one prove;
     proves with a bit-valued witness (msm phase, K4's device time);
  5. complex-N again with the JAX package's own MSM plan, G1 (13, 1) and
     G2 (13, 4) precomputed bases: the deterministic proof equals phase 4's
     byte for byte; the G1 and G2 MSMs timed at c = 12..16 and a few f;
  6. the op surface (ops/vec_ops.py, ops/ntt.py `ntt`, ops/msm.py
     `msm_g1`/`msm_g2`, config.py, runtime.py): K9 (field_pow) over 2^24 Fr
     lanes, K10 (field_reduce) over 2^24 and on odd, single, batched and
     all-(p-1) rows (the product's grid swept), K11 (fixed_base_msm) at the
     setup's 2^18-lane chunk (G1 and G2), K4 at c = 8, 10, 12, 16, each against its plain version
     word for word and timed; then the op surface driven at users' sizes
     (vec-ops over 2^24, ntt at 2^22 and (3, 2^21) in every ordering with
     and without a coset, msm_g1 over 2^22 and msm_g2 over 2^20 lanes at
     the default window, MSMConfig(c=13) and precompute factor 2), each
     result held against a composition computed another way;
  7. complex-M, the large circuit (default 1 600 000 constraints, domain
     2^21): device setup (timed by phase), cold cache; K5's passes and tile
     sweep, K2 (with fold levels on skewed rows), K1 timed, and the coset
     evaluation of phase 4 at this size, with the fused passes timed beside
     the bare passes and K1 launches they replace; K4 against its plain
     versions on a bit-valued witness (A, B1, C, B2 scalars in {0, 1},
     uniform h) and timed beside uniform scalars; K4's constants swept;
     K6 word for word against its plain version over S = 2, 3, 4 and 8
     stacks of window sums, G1 and G2, timed beside the parent's pairwise
     route and the launch floor (`check_acc_windows`);
     first prove, three warm proves, a profiled prove (profiled again if a
     kernel the port launched left no device record), proves with the
     bit-valued witness; four deterministic proofs (default in-core route
     with K5, NTT forced to K3, MSM forced into slices of 2^21 lanes with
     K6 once for each group that slices, G2 bases precomputed with factor
     2) that must be byte-identical, the K3 route with 2 ceil(log n / R)
     register-pass launches and no K5 launch; a
     deterministic and a randomized proof verify; the MSMs at c = 12..16;
  8. the probe entry point (K8), every (op, W);
  9. complex(40, 50) and `poseidon_bits_circuit` (a Poseidon hash of two
     private inputs bound to 254 bits each by rows whose packing sums sit
     in A, so K2 folds twice; two public signals): the port's device setup
     gives the host oracle's zkey byte for byte, the deterministic proof
     through the CLI worker on the card equals the oracle's byte for byte,
     and one prove through the API launches K2 once a fold level and once
     more;
  10. the other curves (bls12-377, bls12-381, bw6-761; `curves_phase`): K12
     (field_vec_n) on the five fields word for word against its plain
     version at 2^16 lanes with 0, 1, p - 1, timed at 2^24; K13 (the MSM
     accumulate and reduce at the six point types) word for word against
     its plain versions at 2^12 lanes (4096 distinct points), c = 8 and the
     default window, and on bit-valued scalars with BUCKET_PIECE 2; the
     full-width MSMs (G1 2^22 and G2 2^20 lanes on bls12, 2^20 and 2^20 on
     bw6-761) through the pipeline `curves/device.py` `msm` runs, equal in
     affine form to the host's sum over the 64-point pool, timed (K13's
     accumulate levels and reduce stages apart, `k13_times`); `msm()`
     itself at 2^16 lanes from host lists; K14 over the three Fr, its tile
     passes (ntt_block_n, the default route), its register passes
     (ntt_radix_n, forced) and its one-stage entry (ntt_stage_n): the pair
     on each against the others and against the plain stages and plain
     passes at 2^12 (batch 2) and at 2^22, 2^4 against a host DFT, the round
     trip and a coset round trip through `ntt(spec=...)` at 2^22 on the tile
     passes, the round trip on the register passes and at 2^12 on the
     one-stage entry, all three timed, the tile passes at three tiles and
     the register passes at every R;
     K16 (field_pow_n) on the five fields
     word for word against its plain version (the inverse over 2^24, 2^22
     and 2^20 lanes at 8, 12 and 24 words, the plain version on 2^12; other
     exponents, one wider than the kernel's 768 bits; div), timed; K17
     (field_reduce_n): the sum over a 2^24 row at every field and the
     product at the two 8-word Fr, with odd, single, batched and all-(p-1)
     rows, timed, the product's grid swept; inv, div, sum_reduce and
     product_reduce driven over each field and held against compositions;
     the launches counted are those of the driven calls alone;
  11. the sharded prove (parallel/, `multichip_phase`): K15 (the four-step
     NTT's twiddle pass) against its plain version word for word at every
     shard shape the proves below give it (2^M over 2, 4 and 8 shards and
     2^N over 8, the factors in both orders, forward and inverse, 0, 1 and
     r - 1 among the inputs), timed at each and swept over its tiles;
     complex-M proved
     through `prove_multichip` on meshes of this card repeated D = 2, 4 and
     8 times and complex-N at D = 8: each deterministic proof equal to the
     single-device proof byte for byte, each randomized one verified, the
     launches of each deterministic sharded prove counted alone (K15 among
     them, K6 twice: phase C's combine, once for G1 and once for G2), its phases (A: R1CS and coset, B: the G1 MSMs, C: G2, host)
     timed with the peak device memory; then one process joins a
     torch.distributed group over NCCL at world size 1 with two shards on
     the card and proves complex-M D = 2 the same way. The shards of one
     card run one after another: the times are the sharding's overhead;
  12. the reference's benchmark family (`family_phase`, alone with
     --family-only): sha256-512, keccak256, rsa, rsa_sha256, anon_aadhaar
     (1536) and keyless (1024) built by the port's builders on the root
     bench.py's inputs, each witness checked; the fixture by the device
     setup (timed by phase, K11 and K7 counted; under
     <fixture-dir>/family/<name>, reused when present); the cold cache split
     into parse, upload, plan_sort, key_table and records; the coset
     evaluation (K2 with its fold levels, K5's passes) word for word against
     its plain version on the card, its launches counted; a first
     deterministic prove and three warm randomized ones with phases and
     the peak device memory, both kinds verified, a changed public signal
     rejected, the K3-forced proof byte-identical; anon_aadhaar's warm
     prove profiled;
  13. print the kernels line, then the result line.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import filecmp
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# the bounds' rates and per-operation multiply counts, and `bound`: one H100
# SXM at 700 W (icicle_snark_tpu_torch/profiling.py states their sources)
from icicle_snark_tpu_torch.profiling import (  # noqa: E402
    FQ_MULS, INT_MULS_PER_S, MULS_PER_MONT, bound, g2_level0_muls)

MULS_PER_REDC = 136  # a product with standard 1: 8 rounds x (1 for m + 16 for m*p)


def log(msg: str):
    print(msg, flush=True)


def warm_card(dev, seconds: float = 2.0):
    """Keep the card busy for a few seconds (Fr products on a large
    batch), so that the first kernels timed do not meet it at idle clocks."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb

    x = torch.ones((3, 8, 1 << 21), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            lb.mont_mul(x, x, lb.FR_SPEC)
        torch.cuda.synchronize()


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


def counted(total: dict, fn):
    """fn() as one driven call: the kernel counts set to 0 just before it and
    read just after, added into `total`, so that the comparisons and timings
    around it are not counted. Returns fn()'s value."""
    from icicle_snark_tpu_torch import kernels

    kernels.reset_counts()
    out = fn()
    for k, v in kernels.counts().items():
        total[k] = total.get(k, 0) + v
    return out


@contextlib.contextmanager
def patched(*patches):
    """Module constants set to other values for the duration of the block:
    patches are (module, name, value)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


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
        for op in (lb.OP_MUL, lb.OP_ADD, lb.OP_SUB, lb.OP_NEG, lb.OP_RSUB):
            bb = None if op == lb.OP_NEG else b
            got = lb.field_op(op, a, bb, spec)
            want = lb.field_op_plain(op, a, bb, spec)
            err = max_word_err(got, want)
            ok &= err == 0
            log(f"  field_vec {spec.name} op{op} (3, 8, {n}): max word err {err}")
        # broadcast forms used by the pipeline and the op surface: a table over
        # the batch, a constant (the scalar ops, b - a for scalar_sub)
        for bshape in ((8, n), (8, 1)):
            bb = b[0] if bshape == (8, n) else b[0, :, :1].contiguous()
            for op in (lb.OP_MUL, lb.OP_ADD, lb.OP_RSUB):
                err = max_word_err(lb.field_op(op, a, bb, spec),
                                   lb.field_op_plain(op, a, bb, spec))
                ok &= err == 0
                log(f"  field_vec {spec.name} op{op}, b {bshape}: max word err {err}")
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


def _skewed_plan(plan, n, piece):
    """The plan's terms moved into a few long slots: slot 0 takes the
    first 4096 terms, slots 1-3 piece - 1, piece and piece + 1 terms, slot
    n (B's first) 1000: K2's fold levels run, several of them for slot 0."""
    import torch

    from icicle_snark_tpu_torch.prover.cache import build_r1cs_plan

    counts = (plan.offsets[1:] - plan.offsets[:-1]).long()
    slots = torch.repeat_interleave(torch.arange(plan.num_slots, device=counts.device), counts)
    at = 0
    for slot, size in ((0, 4096), (1, piece - 1), (2, piece), (3, piece + 1), (n, 1000)):
        slots[at:at + size] = slot
        at += size
    return build_r1cs_plan(slots, plan.witness_idx.long(), plan.coefs, n)


def check_r1cs(rep, rng, cache, dev, large: bool = False):
    """K2 against its plain version on the prove's plan with a random
    witness, then on the plan's terms moved into long slots with the piece
    patched to 4 (fold levels); timed on the prove's plan. With `large` the
    times go under the row's "large" key."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.prover import pipeline

    plan = cache.plan
    nv, n = cache.header.n_vars, plan.num_slots // 2
    w = random_field(rng, lb.FR_SPEC.modulus, (nv,), dev)
    err = max_word_err(pipeline.r1cs_rows(w, plan), pipeline.r1cs_rows_plain(w, plan))
    skewed = _skewed_plan(plan, n, 4)
    with patched((pipeline, "R1CS_PIECE", 4)):
        levels = len(pipeline.r1cs_fold_plan(skewed, 4)[1])
        fold_err = max_word_err(pipeline.r1cs_rows(w, skewed), pipeline.r1cs_rows_plain(w, skewed))
    log(f"  r1cs_rows nnz {plan.coefs.shape[-1]}, rows {n}: max word err {err}; long slots "
        f"folded in {levels} levels (piece 4): max word err {fold_err}")
    ms = cuda_time(lambda: pipeline.r1cs_rows(w, plan), 20)
    _, plain_ms = timed_once(lambda: pipeline.r1cs_rows_plain(w, plan))
    # the witness gather's share: the same terms reading the witness in order
    in_order = dataclasses.replace(plan, witness_idx=plan.witness_idx.sort().values.contiguous(),
                                   folds={})
    gather_sorted_ms = cuda_time(lambda: pipeline.r1cs_rows(w, in_order), 20)
    nnz, slots = plan.coefs.shape[-1], plan.num_slots
    # one product per term, one REDC per nonempty slot, one product for C a row
    nonempty = int((plan.offsets[1:] != plan.offsets[:-1]).sum())
    bms, by = bound(nnz * 36 + (slots + 1) * 4 + nv * 32 + 3 * n * 32,
                    (nnz + n) * MULS_PER_MONT + nonempty * MULS_PER_REDC)
    worst = max(err, fold_err)
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                  sorted_gather_ms=gather_sorted_ms,
                  timed=f"complex fixture plan, nnz {nnz}, {n} rows (3, 8, {n}) out")
    log(f"  r1cs_rows {ms:.4f} ms (bound {bms:.4f} ms, {by}); the witness read in index order "
        f"{gather_sorted_ms:.4f} ms")
    if large:
        row = rep.rows[kernels.R1CS.name]
        row.update(equal_to_plain=row["equal_to_plain"] and worst == 0,
                   max_abs_err=max(row["max_abs_err"], worst), large=timing)
    else:
        rep.add(kernels.R1CS.name, equal_to_plain=worst == 0, max_abs_err=worst, **timing)
    return worst == 0


def time_field_vec(rep, rng, n, dev):
    """K1's Fr product timed at (3, 8, n) beside its bound, under the row's
    "large" key (the comparison runs at the small circuit's shape)."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb

    a = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)
    b = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)
    ms = cuda_time(lambda: lb.mont_mul(a, b, lb.FR_SPEC), 20)
    bms, by = bound(3 * n * 96, 3 * n * MULS_PER_MONT)
    rep.rows[kernels.FIELD_VEC.name]["large"] = dict(ms=ms, bound_ms=bms, bound_by=by,
                                                     timed=f"Fr mont_mul, (3, 8, {n}) int32")
    log(f"  field_vec Fr mul (3, 8, {n}): {ms:.4f} ms, bound {bms:.4f} ms ({by})")


def check_coset(rng, cache, paths, dev, tag, counts_log) -> tuple:
    """The fused coset evaluation, K2 rows then K5's passes
    (pipeline.construct_r1cs), against its plain version (r1cs_rows_plain,
    then ntt.coset_h_plain), word for word, on the fixture's witness and on
    the bit-valued one; both timed, the kernel path at tiles 2^10 and 2^11
    too. The launches of one construct_r1cs are a driven path of their
    own. Returns (ok, timings)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.io.wtns import WtnsFile
    from icicle_snark_tpu_torch.ops import ntt
    from icicle_snark_tpu_torch.prover import pipeline

    dom = cache.domain
    ok, out = True, {}
    bits = write_bits_witness(paths["wtns"], cache.header.n_public, 7)
    for label, path in (("fixture", paths["wtns"]), ("bits", bits)):
        w = lb.words_to_limbs(WtnsFile(path).witness_limbs(), dev)
        kernels.reset_counts()
        got = pipeline.construct_r1cs(w, cache)
        counts = kernels.counts()
        if label == "fixture":
            counts_log[f"{tag} construct_r1cs"] = counts
            passes = len(ntt.block_passes(dom.log_n))
            if (counts["r1cs_rows"], counts["ntt_block"], counts["field_vec"]) != (1, 2 * passes, 0):
                log(f"  construct_r1cs launched {counts}: want r1cs_rows 1, ntt_block "
                    f"{2 * passes}, field_vec 0")
                ok = False
        want, plain_ms = timed_once(lambda: ntt.coset_h_plain(
            pipeline.r1cs_rows_plain(w, cache.plan), dom, cache.keys_br_scaled))
        err = max_word_err(got, want)
        ok &= err == 0
        row = {"max_word_err": err, "plain_ms": plain_ms, "launches": counts,
               "passes": ntt.block_passes(dom.log_n)}
        for t in (10, 11):
            if t > dom.log_n:
                continue
            with patched((ntt, "NTT_TILE_LOG", t)):
                same = bool(torch.equal(pipeline.construct_r1cs(w, cache), want))
                row[f"tile {t} ms"] = cuda_time(lambda: pipeline.construct_r1cs(w, cache), 10)
            ok &= same
            row[f"tile {t} equal"] = same
        row["ms"] = cuda_time(lambda: pipeline.construct_r1cs(w, cache), 10)
        out[label] = row
        log(f"  coset evaluation (K2 + K5) {tag} {label} witness: max word err {err}; "
            + json.dumps({k: v for k, v in row.items() if k != "launches"})
            + "; launches " + json.dumps({k: v for k, v in counts.items() if v}))
    return ok, out


def fused_pass_times(rng, dom, dev) -> dict:
    """The two fused K5 passes beside what they replace, on (3, 8, n):
    the last inverse pass times the keys against the bare pass and a K1
    product; the last forward pass writing h against the bare pass and
    three K1 launches."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import ntt

    fr = lb.FR_SPEC
    x = random_field(rng, fr.modulus, (3, dom.n), dev)
    keys = random_field(rng, fr.modulus, (dom.n,), dev)
    h = torch.empty_like(x[0])
    (l0, k0, t0), (l1, k1, t1) = ntt.block_passes(dom.log_n)[0], ntt.block_passes(dom.log_n)[-1]

    def keys_fused():
        ntt.ntt_block(x, dom.stw_inv, l0, k0, t0, True, keys)

    def keys_apart():
        ntt.ntt_block(x, dom.stw_inv, l0, k0, t0, True)
        return lb.mont_mul(x, keys, fr)

    def h_fused():
        ntt.ntt_block(x, dom.stw_fwd, l1, k1, t1, False, dom.r2, h_out=h)

    def h_apart():
        ntt.ntt_block(x, dom.stw_fwd, l1, k1, t1, False)
        return lb.mont_mul(lb.sub_mod(lb.mont_mul(x[0], x[1], fr), x[2], fr), dom.r2, fr)

    out = {name: cuda_time(fn, 10) for name, fn in (
        ("keys fused", keys_fused), ("keys bare pass + K1", keys_apart),
        ("h fused", h_fused), ("h bare pass + 3 K1", h_apart),
        ("keys fused again", keys_fused), ("h fused again", h_fused))}
    log(f"  fused K5 passes at (3, 8, 2^{dom.log_n}), ms: " + json.dumps(out))
    return out


def ptxas_parse(text: str, src: str, out: dict) -> dict:
    """Registers, stack and spill bytes of each kernel in one source's
    `-Xptxas -v` output, into `out` by mangled entry name."""
    import re

    entry = props = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {"source": src})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def ptxas_usage() -> dict:
    """Registers, stack and spill bytes of every kernel, from the build's
    `-Xptxas -v` output, by mangled entry name."""
    from icicle_snark_tpu_torch import kernels

    out = {}
    for src, text in kernels.build_logs().items():
        ptxas_parse(text, src, out)
    return out


def sass_census(sources=("ntt_block.cu", "r1cs.cu", "field_vec.cu", "field_pow.cu")) -> dict:
    """Static instruction counts of each kernel of the given sources, from
    `cuobjdump -sass` of the build's object files: the total, each opcode
    without its modifiers, and the IMAD forms apart (IMAD.MOV, .SHL and
    .IADD are moves, shifts and adds issued on the multiply pipe)."""
    import re
    from collections import Counter

    from icicle_snark_tpu_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = {}
    for src in sources:
        obj = os.path.join(kernels.BUILD_DIR, f"{src}.{kernels._tag()}.o")
        text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = out.setdefault(m.group(1), {"source": src, "ops": Counter(), "imad": Counter()})
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if fn is None or not m:
                continue
            op = m.group(1)
            fn["ops"][op.split(".")[0]] += 1
            if op.startswith("IMAD"):
                fn["imad"][op] += 1
    for name, fn in out.items():
        fn["total"] = sum(fn["ops"].values())
        fn["memory"] = {op: fn["ops"].get(op, 0) for op in ("LDL", "STL", "LDS", "STS", "LDG",
                                                             "STG")}
        fn["ops"] = dict(fn["ops"].most_common(12))
        fn["imad"] = dict(fn["imad"].most_common())
        log(f"[sass] {fn['source']} {name}: {fn['total']} instructions; " + json.dumps(fn["ops"])
            + "; IMAD forms " + json.dumps(fn["imad"]) + "; memory " + json.dumps(fn["memory"]))
    return out


def radix_pair(x, dom, r=None):
    """The inverse (1/n fused into its low = 0 pass) and then the forward
    transform of x on K3's register passes (ntt_radix, or ntt_radix_n for
    the other Fr; NTT_BLOCK_MIN_LOG patched past the domain), at r stages a
    pass where given (NTT_RADIX_LOG patched), else at the default."""
    from icicle_snark_tpu_torch.ops import ntt

    patches = [(ntt, "NTT_BLOCK_MIN_LOG", 99)]
    if r is not None:
        patches.append((ntt, "NTT_RADIX_LOG", {**ntt.NTT_RADIX_LOG, dom.spec.words: r}))
    with patched(*patches):
        inv = ntt.intt_dif(x, dom)
        return inv, ntt.ntt_dit(inv, dom)


def one_stage_pair(x, dom):
    """The same pair on the one-stage entries, one launch a stage:
    ntt_stage over the natural power tables (BN254 Fr), ntt_stage_n over
    the stage-major ones (the other Fr)."""
    from icicle_snark_tpu_torch.ops import ntt

    spec = dom.spec

    def stage(y, s, inverse, scale=None):
        if spec.bn254:
            ntt.ntt_stage(y, dom.tw_inv if inverse else dom.tw_fwd, 1 << s, inverse, scale)
        else:
            ntt.ntt_stage_n(y, dom.stw_inv if inverse else dom.stw_fwd, 1 << s, inverse, spec,
                            scale)

    y = x.clone()
    for s in range(dom.log_n, 0, -1):
        stage(y, s, True, dom.n_inv_mont if s == 1 else None)
    inv = y.clone()
    for s in range(1, dom.log_n + 1):
        stage(y, s, False)
    return inv, y


# the struct names of csrc/field_n.cuh by K12 selector (curves/device.py KERNEL_FIELDS)
RADIX_STRUCTS = {0: "Bls377Fr", 1: "Bls377Fq", 2: "Bls381Fr"}


def radix_adapter(spec) -> str:
    """The mangled name of spec's field layer in csrc/ntt_radix.cuh."""
    if spec.bn254:
        return "7RadixFr"
    name = RADIX_STRUCTS[spec.field_id]
    return f"6RadixNI{len(name)}{name}E"


def radix_build(spec, r: int) -> str:
    """Registers, stack and spills of the register pass kernels at r stages
    (both directions) of `spec`'s instance, from the build log."""
    return kernel_usage("ntt.cu" if spec.bn254 else "ntt_n.cu",
                        f"ntt_radix_kernelI{radix_adapter(spec)}Li{r}ELb")


def radix_sweep(x, dom, want, reps: int = 5) -> dict:
    """K3's register passes at every R the field's words take: each pair
    against `want` (the plain pair's words) and timed (CUDA events), with
    its launches and the build's registers and spills."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.ops import ntt

    spec = dom.spec
    name = (kernels.NTT_RADIX if spec.bn254 else kernels.NTT_RADIX_N).name
    out = {}
    for r in range(1, ntt.RADIX_MAX[spec.words] + 1):
        launched = {}
        got = counted(launched, lambda: radix_pair(x, dom, r))
        out[f"R {r}"] = dict(
            equal=all(bool(torch.equal(a, b)) for a, b in zip(got, want)),
            ms=cuda_time(lambda: radix_pair(x, dom, r), reps),
            launches=launched.get(name, 0), build=radix_build(spec, r))
        del got
    return out


def check_ntt(rep, rng, dom, dev, counts_log):
    """K3 at (3, 8, n): the register passes (the default R) and the
    one-stage entry, each transform pair against the plain stages word for
    word and timed, the register passes at every R
    (`radix_sweep`), and K5's passes on the same pair beside them. The
    one-stage entry is driven once more on another input, counted, as a
    round trip that must give the input back."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import ntt

    n = dom.n
    x = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)

    def plain_pair():
        y = x.clone()
        for s in range(dom.log_n, 0, -1):
            y = ntt.ntt_stage_plain(y, dom.tw_inv, 1 << s, True,
                                    dom.n_inv_mont if s == 1 else None)
        inv = y
        for s in range(1, dom.log_n + 1):
            y = ntt.ntt_stage_plain(y, dom.tw_fwd, 1 << s, False)
        return inv, y

    def block_pair():
        with patched((ntt, "NTT_BLOCK_MIN_LOG", 1)):
            inv = ntt.intt_dif(x, dom)
            return inv, ntt.ntt_dit(inv, dom)

    (inv_p, fwd_p), plain_ms = timed_once(plain_pair)
    inv_k, fwd_k = one_stage_pair(x, dom)
    err = max(max_word_err(inv_k, inv_p), max_word_err(fwd_k, fwd_p))
    roundtrip = bool((fwd_k == x).all())
    x2 = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)
    back = counted(counts_log.setdefault(f"2^{dom.log_n}: ntt_stage round trip", {}),
                   lambda: one_stage_pair(x2, dom)[1])
    roundtrip &= bool(torch.equal(back, x2))
    del back, x2
    inv_r, fwd_r = radix_pair(x, dom)
    err_radix = max(max_word_err(inv_r, inv_p), max_word_err(fwd_r, fwd_p))
    inv_b, fwd_b = block_pair()
    err_block = max(max_word_err(inv_b, inv_p), max_word_err(fwd_b, fwd_p))
    del inv_k, fwd_k, inv_r, fwd_r, inv_b, fwd_b
    sweep = radix_sweep(x, dom, (inv_p, fwd_p))
    ms = cuda_time(lambda: one_stage_pair(x, dom), 10)
    radix_ms = cuda_time(lambda: radix_pair(x, dom), 10)
    block_ms = cuda_time(block_pair, 10)
    r = ntt.NTT_RADIX_LOG[8]
    passes = ntt.radix_passes(dom.log_n, r)
    butterflies = 2 * dom.log_n * 3 * n // 2
    bms, by = bound(2 * 3 * n * 32 + 2 * n * 32, (butterflies + 3 * n) * MULS_PER_MONT)
    log(f"  ntt_stage (3, 8, 2^{dom.log_n}) intt+ntt, {2 * dom.log_n} launches: max word err "
        f"{err}, roundtrip {roundtrip}, {ms:.4f} ms; ntt_radix R {r} ({2 * len(passes)} "
        f"launches, passes {passes}): max word err {err_radix}, {radix_ms:.4f} ms; ntt_block "
        f"(K5) max word err {err_block}, {block_ms:.4f} ms; bound {bms:.4f} ({by}); plain "
        f"{plain_ms:.0f} ms")
    log(f"  ntt_radix sweep at (3, 8, 2^{dom.log_n}): " + json.dumps(sweep))
    ok = err == 0 and roundtrip
    ok_radix = err_radix == 0 and err_block == 0 and all(v["equal"] for v in sweep.values())
    timed = f"intt_dif + ntt_dit, (3, 8, 2^{dom.log_n})"
    rep.add(kernels.NTT.name, equal_to_plain=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, timed=f"{timed}, {2 * dom.log_n} launches",
            build=kernel_usage("ntt.cu", "ntt_stage_kernel"))
    rep.add(kernels.NTT_RADIX.name, equal_to_plain=ok_radix, max_abs_err=err_radix, ms=radix_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            timed=f"{timed}, R {r}, {2 * len(passes)} launches", sweep=sweep,
            stage_entry_ms=ms, block_ms=block_ms, build=radix_build(lb.FR_SPEC, r))
    return ok and ok_radix


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


def check_msm(rep, rng, cache, dev, g2: bool, large: bool = False):
    """K4 accumulate and reduce against their plain versions at the prove's
    own MSM shape: the cache's points at every lane, random scalars below
    r, the cache's window size. The smaller circuit also runs an edge-case
    MSM first; its row carries the times. With `large` the comparison and
    the times go under the row's "large" key."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm

    ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
    tag = "g2" if g2 else "g1"
    sizes, records, c = _msm_shape(cache, g2)
    total = sum(sizes)
    full_sc = random_field(rng, lb.FR_SPEC.modulus, (total,), dev)
    cases = [("main", full_sc, sizes, records, c)]
    if not large:
        edge_sc, edge_pts = _edge_msm_inputs(rng, dev, g2)
        cases.insert(0, ("edge", edge_sc, [edge_sc.shape[-1]], msm.point_records(edge_pts), 8))
    ok = True
    for label, sc, szs, rec, cc in cases:
        half, groups = 1 << (cc - 1), len(szs)
        order, negs, ends = msm.sort_windows(sc, szs, cc)
        windows = order.shape[0]
        acc_err, red_err, bp, acc_plain, red_plain = _msm_against_plain(
            ops, rec, order, negs, ends, windows, groups, half, label, tag, sc, cc,
            time.perf_counter())
        ok &= acc_err == 0 and red_err == 0
        if label != "main":
            continue
        acc_ms, red_ms, acc_bound, red_bound, what = _k4_times(rec, sc, order, negs, ends, groups,
                                                               cc, bp, tag)
        _accumulate_row(rep, kernels.MSM_ACCUMULATE.name, acc_err, acc_ms, acc_plain, acc_bound,
                        what, large)
        _accumulate_row(rep, kernels.MSM_REDUCE.name, red_err, red_ms, red_plain, red_bound,
                        what, large)
    return ok


def _msm_shape(cache, g2: bool):
    """(group sizes, point records, window size) of the prove's G1 or G2 MSM."""
    if g2:
        return [cache.b2_records.shape[0]], cache.b2_records, cache.msm_c2
    return cache.g1_sizes, cache.g1_records, cache.msm_c


def k4_finite(rec, order, start, length):
    """Records that are not (0, 0) in each item of a level-0 table (start
    indexes the flattened sorted positions of `order`)."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb

    fin = ~lb.is_zero(rec.T.contiguous())[order.reshape(-1).long()]
    cs = torch.cat([fin.new_zeros(1, dtype=torch.int64), torch.cumsum(fin, 0)])
    return cs[start + length] - cs[start]


def _k4_times(rec, sc, order, negs, ends, groups, c, bp, tag, reps=3):
    """K4 accumulate and reduce timed (CUDA events) on one MSM's sorted
    lanes, with their bounds and a description of the case. G1's bound
    counts one mixed add a finite lane with a nonzero digit; G2's the
    products of its Jacobian level 0 (profiling.g2_level0_muls)."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm

    windows, total = order.shape
    half = 1 << (c - 1)
    acc_ms = cuda_time(lambda: msm.msm_accumulate(rec, order, negs, ends, groups, half), reps)
    red_ms = cuda_time(lambda: msm.msm_reduce(bp, windows, groups, half), reps)
    # data-dependent work: one mixed add per nonzero digit on a finite point
    digits, _ = msm.window_digits_signed(sc, c)
    inf = lb.is_zero(rec.T.contiguous())
    madds = int(((digits != 0) & ~inf).sum())
    del digits, inf
    words = 16 if tag == "g2" else 8
    nbk = windows * groups * half
    plan = msm.bucket_fold_plan(ends, windows, groups, half, total)
    muls = (g2_level0_muls(k4_finite(rec, order, *plan[0])) if tag == "g2"
            else madds * FQ_MULS[tag]["madd"])
    acc_bound = bound(total * 2 * words * 4 + windows * total * 5 + ends.numel() * 4
                      + nbk * 3 * words * 4, muls * MULS_PER_MONT)
    # sum_b b * B_b over H buckets: a running-sum triangle, 2(H - 1)
    # general adds per (window, group)
    adds = windows * groups * 2 * (half - 1)
    red_bound = bound(nbk * 3 * words * 4 + windows * groups * 3 * words * 4,
                      adds * FQ_MULS[tag]["add"] * MULS_PER_MONT)
    runs = torch.diff(ends, dim=1, prepend=torch.zeros_like(ends[:, :1]))
    runs = runs.reshape(windows, groups, half + 1)[..., 1:]  # digit 0 has no bucket
    what = (f"{tag}: {total} lanes, {windows} windows, c {c}, longest bucket run "
            f"{int(runs.max())}, {len(plan)} accumulate levels (L {msm.BUCKET_PIECE}), reduce s "
            f"{msm.REDUCE_SEG} nt {msm.reduce_shape(half)[2]}; kernel and plain version on the "
            f"same lanes; {acc_ms:.3f} ms against a bound of {acc_bound[0]:.3f} ms "
            f"({acc_bound[1]}; {madds} mixed adds, {muls} Fq products)")
    return acc_ms, red_ms, acc_bound, red_bound, what


def _msm_against_plain(ops, rec, order, negs, ends, windows, groups, half, label, tag, sc, cc, t0):
    """K4's two kernels against their plain versions on one MSM; returns
    (accumulate err, reduce err, plain buckets, plain accumulate ms, plain
    reduce ms)."""
    import torch

    from icicle_snark_tpu_torch.ops import msm

    bk = msm.msm_accumulate(rec, order, negs, ends, groups, half)
    bp, acc_plain = timed_once(
        lambda: msm.msm_accumulate_plain(rec, order, negs, ends, groups, half))
    acc_err = _points_err(ops, bk, bp)
    wk = msm.msm_reduce(bp, windows, groups, half)
    wp, red_plain = timed_once(lambda: msm.msm_reduce_plain(bp, windows, groups, half))
    red_err = _points_err(ops, wk, wp)
    log(f"  msm {tag} {label}: lanes {sc.shape[-1]}, c {cc}, W {windows}, G {groups}: "
        f"accumulate err {acc_err} (bitwise equal {bool(torch.equal(bk, bp))}), reduce err "
        f"{red_err} (bitwise equal {bool(torch.equal(wk, wp))}) [{time.perf_counter() - t0:.1f} s]")
    return acc_err, red_err, bp, acc_plain, red_plain


def _accumulate_row(rep, name, err, ms, plain_ms, bnd, what, large=False):
    """A prove runs K4 once for G1 and once for G2: its row sums the two.
    The large circuit's comparison counts in equal_to_plain and
    max_abs_err; its times stand beside the row's, under "large"."""
    if large:
        row = rep.rows[name]
        row["equal_to_plain"] = row["equal_to_plain"] and err == 0
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row = row.setdefault("large", {})
    else:
        row = rep.rows.setdefault(name, {})
    if "ms" not in row:
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], timed=what)
        if not large:
            row.update(equal_to_plain=err == 0, max_abs_err=err)
        return
    if not large:
        row.update(equal_to_plain=row["equal_to_plain"] and err == 0,
                   max_abs_err=max(row["max_abs_err"], err))
    row.update(ms=row["ms"] + ms, plain_ms=row["plain_ms"] + plain_ms,
               bound_ms=row["bound_ms"] + bnd[0],
               bound_by=row["bound_by"] if row["bound_by"] == bnd[1] else "operations",
               timed=row["timed"] + "; " + what)


# ---------------------------------------------------------------- K4 on a bit-valued witness

def write_bits_witness(wtns_path: str, n_public: int, seed: int) -> str:
    """The fixture's witness with every signal past the public ones set to
    a random bit, as most signals of a circom witness are 0 or 1. The
    constraints no longer hold: what this input exercises is the MSM, whose
    scalars are these values and the h they give. Returns the new path."""
    from icicle_snark_tpu_torch.io.wtns import WtnsFile, write_wtns

    wf = WtnsFile(wtns_path)
    head = wf.witness_ints(0, n_public + 1)
    bits = np.random.default_rng(seed).integers(0, 2, size=wf.header.n_witness - n_public - 1)
    path = wtns_path[:-len(".wtns")] + "_bits.wtns"
    write_wtns(path, head + bits.tolist())
    return path


def kernel_device_ms(fn, match) -> tuple:
    """One call of fn under torch.profiler: (device ms per CUDA kernel name
    that `match` accepts, summed over launches; the other device ms; the
    wall ms of the call, ending in a synchronise; what the trace held: its
    device events, the host's kernel-launch calls, the first device event's
    start from the trace's start in us, and the largest unmatched device
    events by name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per, other, unmatched = {}, 0.0, {}
    seen = {"device_events": 0, "launch_calls": 0, "first_device_us": None}
    events = prof.events()
    t_start = min((e.time_range.start for e in events), default=0)
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them would count the same time again
    for evt in events:
        if evt.device_type != DeviceType.CUDA:
            # the host's kernel launches, against the device's kernel records
            seen["launch_calls"] += evt.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                 "cudaLaunchKernelExC")
            continue
        seen["device_events"] += 1
        start = evt.time_range.start - t_start
        if seen["first_device_us"] is None or start < seen["first_device_us"]:
            seen["first_device_us"] = start
        ms = evt.time_range.elapsed_us() / 1e3
        if match(evt.name):
            # "void msm_accumulate_kernel<E2, true>(...)" -> "msm_accumulate_kernel<E2, true>"
            name = evt.name.split("(")[0].removeprefix("void ")
            per[name] = per.get(name, 0.0) + ms
        else:
            other += ms
            key = evt.name[:80]
            n, t = unmatched.get(key, (0, 0.0))
            unmatched[key] = (n + 1, t + ms)
    seen["top_other"] = {k: {"count": n, "ms": t} for k, (n, t) in
                         sorted(unmatched.items(), key=lambda kv: -kv[1][1])[:8]}
    return per, other, wall_ms, seen


def prove_bits(paths, cm, dev, n_public: int, seed: int = 7) -> dict:
    """Proves with the bit-valued witness through the API: a first prove,
    two timed ones (msm phase), and a profiled one (device ms of the MSM
    kernels). Uses only entry points every slice of the port has had, so
    it also measures an earlier tree."""
    from icicle_snark_tpu_torch.prover import api, pipeline

    bits = dict(paths, wtns=write_bits_witness(paths["wtns"], n_public, seed),
                proof=paths["proof"] + ".bits", public=paths["public"] + ".bits")

    def prove(timer=None):
        return api.groth16_prove(bits["wtns"], bits["zkey"], bits["proof"], bits["public"], cm,
                                 deterministic=True, timer=timer)

    first = prove()
    out = {"first_prove_s": first, "prove_s": [], "msm_s": []}
    for _ in range(2):
        timer = pipeline.PhaseTimer(dev)
        out["prove_s"].append(prove(timer))
        out["msm_s"].append(timer.phases["msm"])
    out["msm_kernels_ms"] = kernel_device_ms(prove, lambda name: "msm_" in name)[0]
    return out


def check_msm_bits(rep, rng, cache, paths, dev, seed: int = 7) -> tuple:
    """K4 on the prove's own MSM shapes with the bit-valued witness: A, B1,
    C and B2 scalars in {0, 1} (the public head kept), beside the uniform h
    they give. Kernels against plain versions at every lane, and K4 and the
    window sums timed beside scalars uniform below r at the same shape.
    Returns (equal to plain, timings)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.io.wtns import WtnsFile
    from icicle_snark_tpu_torch.ops import msm
    from icicle_snark_tpu_torch.prover import pipeline

    npub = cache.header.n_public
    path = write_bits_witness(paths["wtns"], npub, seed)
    witness = lb.words_to_limbs(WtnsFile(path).witness_limbs(), dev)
    h = pipeline.construct_r1cs(witness, cache)
    ok, timings = True, {}
    for g2 in (False, True):
        tag = "g2" if g2 else "g1"
        ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
        sizes, rec, c = _msm_shape(cache, g2)
        bits_sc = witness if g2 else torch.cat([witness, witness, witness[:, npub + 1:], h], dim=-1)
        uniform_sc = random_field(rng, lb.FR_SPEC.modulus, (sum(sizes),), dev)
        half, groups = 1 << (c - 1), len(sizes)
        for label, sc in (("bits", bits_sc), ("uniform", uniform_sc)):
            order, negs, ends = msm.sort_windows(sc, sizes, c)
            windows = order.shape[0]
            if label == "bits":
                acc_err, red_err, bp, acc_plain, red_plain = _msm_against_plain(
                    ops, rec, order, negs, ends, windows, groups, half, "bits", tag, sc, c,
                    time.perf_counter())
                ok &= acc_err == 0 and red_err == 0
                for k, err in ((kernels.MSM_ACCUMULATE, acc_err), (kernels.MSM_REDUCE, red_err)):
                    row = rep.rows[k.name]
                    row["equal_to_plain"] = row["equal_to_plain"] and err == 0
                    row["max_abs_err"] = max(row["max_abs_err"], err)
            else:
                bp = msm.msm_accumulate(rec, order, negs, ends, groups, half)
                acc_plain = red_plain = None
            acc_ms, red_ms, _ab, _rb, what = _k4_times(rec, sc, order, negs, ends, groups, c, bp,
                                                       tag)
            del order, negs, ends, bp
            ws_ms = cuda_time(lambda: msm.msm_window_sums(sc, sizes, rec, c), 3)
            timings[f"{tag} {label}"] = {"accumulate_ms": acc_ms, "reduce_ms": red_ms,
                                         "window_sums_ms": ws_ms, "plain_accumulate_ms": acc_plain,
                                         "plain_reduce_ms": red_plain, "case": what}
            log(f"  msm {tag} {label}: accumulate {acc_ms:.3f} ms, reduce {red_ms:.3f} ms, "
                f"window sums {ws_ms:.3f} ms ({what})")
            torch.cuda.empty_cache()
    return ok, timings


def k4_sweep(cache, dev, rng, pieces=(8, 16, 32, 64),
             reduce_shapes=((4, 128), (8, 128), (8, 256), (16, 128), (16, 256), (32, 256))) -> dict:
    """K4's constants timed at the prove's G1 and G2 shapes on uniform
    scalars: accumulate by BUCKET_PIECE (L), reduce by (REDUCE_SEG,
    REDUCE_BLOCK); each variant's output equals the default's as affine
    points. The measurement the defaults are set from."""
    import torch

    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm

    out = {}
    for g2 in (False, True):
        tag = "g2" if g2 else "g1"
        ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
        sizes, rec, c = _msm_shape(cache, g2)
        half, groups = 1 << (c - 1), len(sizes)
        sc = random_field(rng, lb.FR_SPEC.modulus, (sum(sizes),), dev)
        order, negs, ends = msm.sort_windows(sc, sizes, c)
        windows = order.shape[0]
        ref_b = msm.msm_accumulate(rec, order, negs, ends, groups, half)
        ref_w = msm.msm_reduce(ref_b, windows, groups, half)
        for piece in pieces:
            with patched((msm, "BUCKET_PIECE", piece)):
                same = _points_err(ops, msm.msm_accumulate(rec, order, negs, ends, groups, half),
                                   ref_b) == 0
                ms = cuda_time(lambda: msm.msm_accumulate(rec, order, negs, ends, groups, half), 3)
                levels = len(msm.bucket_fold_plan(ends, windows, groups, half, order.shape[1]))
            out[f"{tag} accumulate L {piece}"] = {"ms": ms, "levels": levels, "same": same}
            log(f"  sweep {tag} accumulate L {piece}: {ms:.3f} ms, {levels} levels, same {same}")
        for seg, block in reduce_shapes:
            with patched((msm, "REDUCE_SEG", seg), (msm, "REDUCE_BLOCK", block)):
                same = _points_err(ops, msm.msm_reduce(ref_b, windows, groups, half), ref_w) == 0
                ms = cuda_time(lambda: msm.msm_reduce(ref_b, windows, groups, half), 3)
            out[f"{tag} reduce s {seg} nt {block}"] = {"ms": ms, "same": same}
            log(f"  sweep {tag} reduce s {seg} nt {block}: {ms:.3f} ms, same {same}")
        del order, negs, ends, ref_b
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- K5-K8

def check_ntt_block(rep, rng, dom, dev):
    """K5 at (3, 8, n) against K3 stage by stage (the one-stage entry), K3's
    register passes and the plain stages, word for word; K5 (at tiles of
    2^10 and 2^11, each equal to the default's words; a tile of 2^12 and its
    twiddles would need 256 KB of shared memory), the one-stage entry and
    the register passes (the default, then every R)
    timed on the inverse + forward pair of one coset evaluation."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import ntt

    n, log_n = dom.n, dom.log_n
    x = random_field(rng, lb.FR_SPEC.modulus, (3, n), dev)

    def pair(tile_log):
        with patched((ntt, "NTT_BLOCK_MIN_LOG", 1), (ntt, "NTT_TILE_LOG", tile_log)):
            return ntt.ntt_dit(ntt.intt_dif(x, dom), dom)

    def plain_pair():
        y = x
        for s in range(log_n, 0, -1):
            y = ntt.ntt_stage_plain(y, dom.tw_inv, 1 << s, True, dom.n_inv_mont if s == 1 else None)
        inv = y
        for s in range(1, log_n + 1):
            y = ntt.ntt_stage_plain(y, dom.tw_fwd, 1 << s, False)
        return inv, y

    tile = ntt.NTT_TILE_LOG
    with patched((ntt, "NTT_BLOCK_MIN_LOG", 1)):
        inv_b = ntt.intt_dif(x, dom)
        fwd_b = ntt.ntt_dit(inv_b, dom)
    inv_s, fwd_s = one_stage_pair(x, dom)
    inv_r, fwd_r = radix_pair(x, dom)
    (inv_p, fwd_p), plain_ms = timed_once(plain_pair)
    err_stage = max(max_word_err(inv_b, inv_s), max_word_err(fwd_b, fwd_s))
    err_radix = max(max_word_err(inv_b, inv_r), max_word_err(fwd_b, fwd_r))
    err_plain = max(max_word_err(inv_b, inv_p), max_word_err(fwd_b, fwd_p))
    del inv_s, fwd_s, inv_r, fwd_r, inv_p, fwd_p
    roundtrip = bool((fwd_b == x).all())
    passes = ntt.block_passes(log_n, tile)
    log(f"  ntt_block (3, 8, 2^{log_n}) intt+ntt, passes {passes}: max word err vs K3 stages "
        f"{err_stage}, vs K3's register passes {err_radix}, vs plain stages {err_plain}, "
        f"roundtrip {roundtrip}")
    ok = err_stage == 0 and err_radix == 0 and err_plain == 0 and roundtrip
    times = {}
    for t in (10, 11):
        if t > log_n:
            continue
        same = bool(torch.equal(pair(t), fwd_b))
        ok &= same
        times[t] = cuda_time(lambda t=t: pair(t), 5)
        log(f"  ntt_block tile 2^{t} ({len(ntt.block_passes(log_n, t))} passes each way): "
            f"{times[t]:.3f} ms, equal {same}")
    stage_ms = cuda_time(lambda: one_stage_pair(x, dom), 3)
    radix_ms = cuda_time(lambda: radix_pair(x, dom), 5)
    sweep = radix_sweep(x, dom, (inv_b, fwd_b))
    ok &= all(v["equal"] for v in sweep.values())
    r = ntt.NTT_RADIX_LOG[8]
    rpasses = ntt.radix_passes(log_n, r)
    log(f"  ntt_stage (K3's one-stage entry) the same pair, {2 * log_n} launches: {stage_ms:.3f} "
        f"ms; ntt_radix R {r}, {2 * len(rpasses)} launches: {radix_ms:.3f} ms; sweep "
        + json.dumps(sweep))
    butterflies = 2 * log_n * 3 * n // 2
    bms, by = bound(2 * 3 * n * 32 + 2 * n * 32, (butterflies + 3 * n) * MULS_PER_MONT)
    block_ms = times.get(tile) or cuda_time(lambda: pair(tile), 5)
    rep.add(kernels.NTT_BLOCK.name, equal_to_plain=ok, max_abs_err=max(err_stage, err_plain),
            ms=block_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            timed=f"intt_dif + ntt_dit, (3, 8, 2^{log_n}), {2 * len(passes)} launches, "
                  f"tile 2^{tile}",
            sweep_ms={f"tile {t}": v for t, v in times.items()},
            stage_kernel_ms=stage_ms, radix_ms=radix_ms)
    rep.add(kernels.NTT_RADIX.name, large=dict(
        equal_to_plain=err_radix == 0 and err_plain == 0, ms=radix_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, stage_entry_ms=stage_ms, block_ms=block_ms, sweep=sweep,
        timed=f"intt_dif + ntt_dit, (3, 8, 2^{log_n}), R {r}, {2 * len(rpasses)} launches"))
    rep.add(kernels.NTT.name, large=dict(ms=stage_ms, plain_ms=plain_ms, bound_ms=bms,
                                         bound_by=by, equal_to_plain=err_stage == 0))
    return ok


# the domains of the threshold sweep: K5 against K3's register passes and its
# one-stage entry, the pair at batch 3
NTT_SWEEP_LOGS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 21)


def ntt_threshold_sweep(dev, logs=NTT_SWEEP_LOGS):
    """K3 (its register passes at the default R and its one-stage entry)
    against K5 on the inverse + forward pair at batch 3, by domain size:
    the measurement NTT_BLOCK_MIN_LOG is set from. All three give the same
    words at every size."""
    import torch

    from icicle_snark_tpu_torch.ops import ntt

    out = {}
    for log_n in logs:
        dom = ntt.NTTDomain(log_n, dev)
        x = torch.zeros((3, 8, dom.n), dtype=torch.int32, device=dev)
        x[:, 0] = 5

        def pair():
            with patched((ntt, "NTT_BLOCK_MIN_LOG", 1)):
                return ntt.ntt_dit(ntt.intt_dif(x, dom), dom)

        block = pair()
        if not (torch.equal(block, one_stage_pair(x, dom)[1])
                and torch.equal(block, radix_pair(x, dom)[1])):
            raise RuntimeError(f"K5 differs from K3 at 2^{log_n}")
        out[log_n] = {"stage_ms": cuda_time(lambda: one_stage_pair(x, dom), 10),
                      "radix_ms": cuda_time(lambda: radix_pair(x, dom), 10),
                      "block_ms": cuda_time(pair, 10)}
        log(f"  2^{log_n}: K3 one-stage {out[log_n]['stage_ms']:.4f} ms, K3 register passes "
            f"{out[log_n]['radix_ms']:.4f} ms, K5 {out[log_n]['block_ms']:.4f} ms")
        del x, block, dom
    return out


def _stack_with_edges(ops, acc, new):
    """Put the identity on the left (lane 0), on the right (lane 1), on
    both sides (lane 2), P + P (lane 3) and P + (-P) (lane 4) into two
    stacks of window sums."""
    import torch

    from icicle_snark_tpu_torch.curve import jcurve as jc

    shape = acc.shape
    a, b = acc.flatten(-2).clone(), new.flatten(-2).clone()
    ident = jc.point_stack(jc.identity(ops, 1, acc.device))
    for lane, (left, right) in enumerate(((True, False), (False, True), (True, True))):
        if left:
            a[..., lane:lane + 1] = ident
        if right:
            b[..., lane:lane + 1] = ident
    b[..., 3] = a[..., 3]
    neg = jc.pneg(ops, jc.point_unstack(a[..., 4:5]))
    b[..., 4:5] = torch.stack(neg)
    return a.reshape(shape), b.reshape(shape)


K6_STACKS = (2, 3, 4, 8)  # the sliced route's 2 and 4, the mesh's 2, 4 and 8; 3 pads


def _pairwise(stacks, add):
    """The parent's route for S stacks: `add` (two stacks -> their sum) on
    neighbours, round by round, the odd one carried (combine_windows before
    the one-launch sum)."""
    pts = list(stacks.unbind(0))
    while len(pts) > 1:
        nxt = [add(pts[i], pts[i + 1]) for i in range(0, len(pts) - 1, 2)]
        pts = nxt + pts[len(pts) - len(pts) % 2:]
    return pts[0]


def check_acc_windows(rep, rng, cache, dev):
    """K6 at the (G, W) of the cache's MSM plan, G1 and G2 (the large
    circuit's, which its sliced route and phase C of every sharded prove
    give K6), over S = 2, 3, 4 and 8 stacks of window sums of random MSMs
    over the key's first lanes, the edge lanes put into the first two: word
    for word against its plain version at every S; timed (CUDA events, 20
    calls) beside the parent's pairwise route (S - 1 launches of S = 2,
    round by round, as combine_windows ran) and the launch floor (K6 itself
    at one G1 lane, S = 2: the same wrapper and ctypes path, one addition).
    The row's ms, plain ms and bound are the sliced route's shapes at
    complex-1600k, G1 S = 4 plus G2 S = 2. In a tree whose ops/msm.py has no
    `sum_windows` (an earlier one) only the pairwise route runs, against
    its plain version."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm

    one_launch = hasattr(msm, "sum_windows")
    ok, worst, by_stacks, shapes = True, 0.0, {}, []
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for g2 in (False, True):
        grp = "g2" if g2 else "g1"
        ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
        sizes, rec, c = _msm_shape(cache, g2)
        groups = len(sizes)
        lanes = min(4096, rec.shape[0] // groups)
        cut = rec[:lanes * groups]
        stacks = [msm.msm_window_sums(random_field(rng, lb.FR_SPEC.modulus, (lanes * groups,), dev),
                                      [lanes] * groups, cut, c) for _ in range(max(K6_STACKS))]
        stacks[0], stacks[1] = _stack_with_edges(ops, stacks[0], stacks[1])
        every = torch.stack(stacks)
        if not g2:
            one = every[:2, ..., :1, :1].contiguous()  # one G1 lane, two stacks
        gw = stacks[0].shape[-1] * stacks[0].shape[-2]
        words = 16 if g2 else 8
        for s in K6_STACKS:
            st = every[:s].contiguous()
            if one_launch:
                routes = {"tree": msm.sum_windows,
                          "pairwise": lambda x: _pairwise(x, msm.acc_windows)}
                plain = msm.sum_windows_plain
            else:
                routes = {"pairwise": lambda x: _pairwise(x, msm.acc_windows)}
                plain = lambda x: _pairwise(x, msm.acc_windows_plain)  # noqa: E731
            want, t_plain = timed_once(lambda: plain(st))
            errs = {}
            for name, fn in routes.items():
                got = fn(st)
                torch.cuda.synchronize()
                # the words are the plain version's where the order is (the
                # tree's, or the pairwise route's in an earlier tree)
                exact = name == "tree" or not one_launch
                err = max_word_err(got, want) if exact else 0.0
                affine = _points_err(ops, got, want)
                errs[name] = (err, affine)
                ok &= err == 0 and affine == 0
                worst = max(worst, err, affine)
            times = {name: cuda_time(lambda: fn(st), 20) for name, fn in routes.items()}
            bnd, by = bound((s + 1) * 3 * words * 4 * gw,
                            (s - 1) * gw * FQ_MULS[grp]["add"] * MULS_PER_MONT)
            key = f"{grp} S={s}"
            by_stacks[key] = {"ms": times, "plain_ms": t_plain, "bound_ms": bnd, "bound_by": by,
                              "errors": errs, "shape": list(st.shape)}
            log(f"  point_add {key} (G, W) = {tuple(st.shape[-2:])}: errors (words, affine) "
                f"{errs}; ms " + json.dumps({k: round(v, 5) for k, v in times.items()})
                + f"; plain {t_plain:.2f} ms; bound {bnd:.6f} ms ({by})")
            if (s, g2) in ((4, False), (2, True)):
                shapes.append(f"{grp} S = {s} at (G, W) = {tuple(st.shape[-2:])}")
                row["ms"] += times["tree" if one_launch else "pairwise"]
                row["plain_ms"] += t_plain
                row["bound_ms"] += bnd
    floor_ms = cuda_time(lambda: (msm.sum_windows(one) if one_launch
                                  else msm.acc_windows(one[0], one[1])), 20)
    usage = kernel_usage("point_vec.cu", "")
    log(f"[kernels] point_add: launch floor (one G1 lane, S = 2) {floor_ms:.5f} ms; {usage}")
    rep.add(kernels.POINT_ADD.name, equal_to_plain=ok, max_abs_err=worst, bound_by="operations",
            launch_floor_ms=floor_ms, by_stacks=by_stacks, build=usage,
            timed="one sum each of " + " and ".join(shapes) + ", the sliced route's shapes at "
                  "complex-1600k", **row)
    return ok


def kernel_usage(source: str, fragment: str) -> str:
    """The build's registers, stack and spills of the kernels of `source`
    whose entry name holds `fragment`, as one line."""
    return "; ".join(
        f"{name}: {u.get('registers')} registers, stack {u.get('stack')} B, spills "
        f"{u.get('spill_stores')}/{u.get('spill_loads')} B"
        for name, u in sorted(ptxas_usage().items())
        if u.get("source") == source and fragment in name) or "not in the build log"


FERMAT_PRODUCTS = 364  # fq_inv: 254 squarings and 110 products (the set bits of q - 2)
AFFINE_LANES = (4, 8, 16, 32)  # the L that csrc/precompute.cu instantiates


def affine_lanes(n: int) -> int:
    """K7 point_to_affine's L for n lanes, as csrc/precompute.cu affine_lanes."""
    for lanes in (32, 16, 8):
        if -(-n // lanes) >= 64 * 132:
            return lanes
    return 4


def affine_bounds(n: int, finite: int, g2: bool, lanes: int) -> tuple:
    """The bounds of point_to_affine over n lanes, `finite` of them not at
    infinity: ((ms, by) of the batched inverse at L lanes a thread, (ms, by)
    of the per-lane Fermat inversion it replaced). Both move 5 coordinates a
    lane. The batched one does, a thread, L - 1 products forward, one
    inversion and 2 (L - 1) backward, and a lane G2's norm (2), z^-1 from the
    norm's inverse (G2: 2) and x z^-1, y z^-1 (2 or 6)."""
    words = 16 if g2 else 8
    moved = n * 5 * words * 4
    threads = -(-n // lanes)
    batched = (threads * (3 * (lanes - 1) + FERMAT_PRODUCTS) + finite * (8 if g2 else 2)
               + (2 * n if g2 else 0))
    fermat = n * ((2 + FERMAT_PRODUCTS + 2 + 6) if g2 else (FERMAT_PRODUCTS + 2))
    return bound(moved, batched * MULS_PER_MONT), bound(moved, fermat * MULS_PER_MONT)


def infinity_lanes(n: int) -> list:
    """The lanes a point_to_affine check puts at infinity: lane 0 (the
    identity a zkey plants), a run of 40 from lane 100, and each L's whole
    group of thread 1 (lanes 1 + k ceil(n / L)), so that one thread's lanes
    are all at infinity and others are mixed."""
    lanes = {0, *range(100, 140)}
    for count in AFFINE_LANES:
        t = -(-n // count)
        lanes |= {1 + k * t for k in range(count) if 1 + k * t < n}
    return sorted(lane for lane in lanes if lane < n)


def affine_lane_sweep(cases) -> dict:
    """K7 point_to_affine at each L of AFFINE_LANES on the cases of
    check_precompute (projective points and their plain affine form), through
    the sweep entry of the kernel library: ms (CUDA events over 3 calls, the
    points stacked beforehand) and word-for-word equality. Empty where the
    library has no such entry (a tree before the batched inverse)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc

    if "snark_point_to_affine_lanes" not in kernels._SIGNATURES:
        log("  point_to_affine L sweep: not in this tree's kernel library")
        return {}
    out = {}
    for label, (g2, p, want) in cases.items():
        src = jc.point_stack(p).contiguous()
        n = src.shape[-1]
        ax, ay = torch.empty_like(src[0]), torch.empty_like(src[0])

        def call(lanes):
            stream = torch.cuda.current_stream().cuda_stream
            err = kernels.lib().snark_point_to_affine_lanes(int(g2), lanes, ax.data_ptr(),
                                                            ay.data_ptr(), src.data_ptr(), n,
                                                            stream)
            if err:
                raise RuntimeError(f"point_to_affine_lanes: CUDA error {err}")

        row = {}
        for lanes in AFFINE_LANES:
            ax.fill_(-1)
            call(lanes)
            same = max_word_err(ax, want[0]) == 0 and max_word_err(ay, want[1]) == 0
            row[lanes] = {"ms": cuda_time(lambda: call(lanes), 3), "equal_to_plain": same}
        out[label] = row
        log(f"  point_to_affine L sweep, {label}: " + "; ".join(
            f"L {k} {v['ms']:.4f} ms{'' if v['equal_to_plain'] else ' DIFFERS'}"
            for k, v in row.items()) + f" (the wrapper takes L {affine_lanes(n)})")
    return out


def check_precompute(rep, rng, points, dev, c: int = 13, factor: int = 4, tables=None,
                     chunk: int = 1 << 18, sweep: bool = False):
    """K7's two kernels. point_dbl_k at the shape of the key's G1 and G2
    points (`points`: the (x, y) of G1 and of G2) for the plan (c, f), against
    its plain version word for word, the G2 kernel timed with its registers.
    point_to_affine for G1 and G2 at the key's shape (the doubled points) and
    at the device setup's chunk (K11's points from random scalars, `tables`
    the setup's window tables, made here if not given), each with the lanes
    of `infinity_lanes` at infinity (zero scalars in the chunk; a lane count
    no L divides at the key's shape), word for word against its plain
    version, timed beside the bound of the batched inverse and that of the
    per-lane Fermat inversion it replaced; with `sweep`, each L
    (`affine_lane_sweep`). Then `precompute_bases` (both kernels) against
    host integers on the first G2 lanes. G2's doublings run on a pair of
    threads a lane (csrc/curve_pair.cuh)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm
    from icicle_snark_tpu_torch.refmath import curve as cv
    from icicle_snark_tpu_torch.refmath.field import fq_from_mont
    from icicle_snark_tpu_torch.setup import fast_setup as fs

    ok = True
    shift = c * msm.merged_windows(c, factor)
    cases = {}
    for g2 in (False, True):
        ops, plain = (jc.G2, jc.G2_PLAIN) if g2 else (jc.G1, jc.G1_PLAIN)
        tag = "g2" if g2 else "g1"
        x, y = points[g2]
        n = x.shape[-1]
        x, y = x.clone(), y.clone()
        inf_idx = torch.tensor(infinity_lanes(n), device=dev)
        x[..., inf_idx] = 0
        y[..., inf_idx] = 0  # the identity, as zkeys hold it
        inf = ops.is_zero_lanes(x) & ops.is_zero_lanes(y)
        one = ops.const((1, 0) if g2 else 1, n, dev)
        p = (x, y, torch.where(inf, torch.zeros_like(one), one))
        got = jc.pdbl_k(ops, p, shift)
        want, dbl_plain = timed_once(lambda: jc.pdbl_k_plain(plain, p, shift))
        err_dbl = max(max_word_err(a, b) for a, b in zip(got, want))
        log(f"  point_dbl_k {tag} k = {shift}, {n} lanes: max word err {err_dbl}")
        ok &= err_dbl == 0
        cases[f"{tag}, key's shape, {n} lanes"] = (g2, got)
        if g2:
            dbl_ms = cuda_time(lambda: jc.pdbl_k(ops, p, shift), 3)
            muls = FQ_MULS[tag]["dbl"] * MULS_PER_MONT
            b_dbl = bound(2 * n * 3 * 64, n * shift * muls)
            usage = kernel_usage("precompute.cu", "point_dbl_k")
            log(f"  point_dbl_k g2, {n} lanes, k = {shift}: {dbl_ms:.3f} ms (bound "
                f"{b_dbl[0]:.3f}, {b_dbl[1]}; plain {dbl_plain:.0f} ms); {usage}")
            rep.add(kernels.POINT_DBL_K.name, equal_to_plain=err_dbl == 0, max_abs_err=err_dbl,
                    ms=dbl_ms, plain_ms=dbl_plain, bound_ms=b_dbl[0], bound_by=b_dbl[1],
                    timed=f"g2, {n} lanes, k = {shift} doublings (plan c {c}, f {factor})",
                    build=usage)
        del want
    # the setup's chunk: K11's projective points, zero scalars at infinity
    if tables is None:
        _, tables = setup_tables(dev)
    words = random_scalars(rng, chunk)
    words[infinity_lanes(chunk)] = 0
    sc = lb.words_to_limbs(words, dev)
    for g2 in (False, True):
        ops = jc.G2 if g2 else jc.G1
        cases[f"{'g2' if g2 else 'g1'}, setup chunk, {chunk} lanes"] = (
            g2, fs.fixed_base_msm(sc, tables[g2], ops))
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "fermat_bound_ms": 0.0}
    worst, parts, chunk_by = 0.0, [], None
    for label, (g2, proj) in cases.items():
        ops, plain = (jc.G2, jc.G2_PLAIN) if g2 else (jc.G1, jc.G1_PLAIN)
        n = proj[0].shape[-1]
        inf_at = infinity_lanes(n)
        ax, ay = jc.to_affine(ops, proj)
        (px, py), aff_plain = timed_once(lambda: jc.to_affine_plain(plain, proj))
        err = max(max_word_err(ax, px), max_word_err(ay, py))
        inf_ok = bool(lb.is_zero(ax[..., inf_at]).all() and lb.is_zero(ay[..., inf_at]).all())
        finite = n - int(ops.is_zero_lanes(proj[2]).sum())
        lanes = affine_lanes(n)
        (bms, by), (fms, _) = affine_bounds(n, finite, g2, lanes)
        ms = cuda_time(lambda: jc.to_affine(ops, proj), 3)
        log(f"  point_to_affine {label} ({n - finite} at infinity), L {lanes}: max word err "
            f"{err}, infinity -> (0, 0) {inf_ok}; {ms:.4f} ms (bound {bms:.4f}, {by}; the "
            f"per-lane Fermat design's bound {fms:.4f}; plain {aff_plain:.0f} ms)")
        ok &= err == 0 and inf_ok
        worst = max(worst, err)
        parts.append(f"{label}: {ms:.4f} ms (bound {bms:.4f}, Fermat bound {fms:.4f}, plain "
                     f"{aff_plain:.0f})")
        if "chunk" in label:
            chunk_by = by
            for key, val in (("ms", ms), ("plain_ms", aff_plain), ("bound_ms", bms),
                             ("fermat_bound_ms", fms)):
                row[key] += val
        cases[label] = (g2, proj, (px, py))
    usage = kernel_usage("precompute.cu", "point_to_affine")
    log(f"  point_to_affine build: {usage}")
    rep.add(kernels.POINT_TO_AFFINE.name, equal_to_plain=worst == 0 and ok, max_abs_err=worst,
            bound_by=chunk_by, build=usage,
            timed="G1 + G2 at the setup's chunk of " + str(chunk) + " lanes (ms, plain_ms, "
                  "bound_ms, fermat_bound_ms sum those two); " + "; ".join(parts), **row)
    if sweep:
        rep.add(kernels.POINT_TO_AFFINE.name, lane_sweep=affine_lane_sweep(cases))
    del cases
    torch.cuda.empty_cache()
    # both kernels through precompute_bases, against host integers
    lanes = 6
    x, y = (t[..., :lanes].clone() for t in points[True])
    x[..., 1] = 0
    y[..., 1] = 0
    pre = msm.precompute_bases((x, y), jc.G2, c, factor)

    def host(t, lane):
        return tuple(fq_from_mont(lb.limbs_to_ints(t[comp][:, lane:lane + 1])[0]) for comp in range(2))

    same = pre[0].shape[-1] == lanes * factor
    for i in range(lanes):
        base = (host(x, i), host(y, i))
        for m in range(factor):
            want = base if base == ((0, 0), (0, 0)) else cv.g2_to_affine(
                cv.g2_mul(cv.g2_from_affine(base), 1 << (shift * m)))
            same &= (host(pre[0], i * factor + m), host(pre[1], i * factor + m)) == want
    log(f"  precompute_bases g2 (c {c}, f {factor}) on {lanes} lanes equals host integers: {same}")
    return ok and same


def check_probe(rep, rng, dev, depth: int = 4096):
    """K8: every (op, W) at depth 32 against its plain version on the card
    (integers word for word, the fma chain within 1e-5 relative), then the
    8-chain multiply timed at the probe's own shape."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.tools import throughput_probe as tp

    ok, worst_int, worst_fma = True, 0.0, 0.0
    n = 1 << 16
    for op, name in enumerate(tp.OPS):
        x, y = tp.probe_inputs(n, op, int(rng.integers(1 << 30)), dev)
        if op != 4:
            x[0], y[0], x[1], y[1] = -1, -1, -(1 << 31), 0x7FFFFFFF
        for width in tp.WIDTHS:
            got = tp.probe_chain(x, y, op, width, 32)
            want = tp.probe_chain_plain(x, y, op, width, 32)
            if op == 4:
                g, w = got.view(torch.float32), want.view(torch.float32)
                rel = float(((g - w).abs() / w.abs()).max())
                worst_fma = max(worst_fma, rel)
                ok &= rel <= 1e-5 and bool(torch.isfinite(g).all())
            else:
                err = max_word_err(got, want)
                worst_int = max(worst_int, err)
                ok &= err == 0
    log(f"  probe_chain depth 32, {len(tp.OPS)} ops x W {tp.WIDTHS}: integer max word err "
        f"{worst_int}, fma max relative err {worst_fma:.3g} (tolerance 1e-5)")
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 2048 * 8
    x, y = tp.probe_inputs(lanes, 0, 0, dev)
    ms = cuda_time(lambda: tp.probe_chain(x, y, 0, 8, depth), 3)
    plain_depth = 64
    plain_ms = cuda_time(lambda: tp.probe_chain_plain(x, y, 0, 8, plain_depth), 1, False)
    bms, by = bound(lanes * 4 * (2 + 8), lanes * 8 * depth)
    rep.add(kernels.PROBE.name, equal_to_plain=ok, max_abs_err=max(worst_int, worst_fma), ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            timed=f"u32_mul, W = 8, {lanes} lanes, depth {depth} (plain version timed at depth "
                  f"{plain_depth}); max_abs_err is the fma chain's relative error")
    return ok


WITNESS_ROWS = (1, 31, (1 << 16) + 3, 1 << 20, 1600003)


def check_witness_limbs(rep, rng, dev, timed=(1 << 20, 1600003)):
    """K18: the (n, 8) -> (8, n) turn against its plain version word for
    word at WITNESS_ROWS, timed at `timed` rows (CUDA events; the plain
    version on the host clock, reported at the last of WITNESS_ROWS)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb

    ok, ms = True, {}
    for n in WITNESS_ROWS:
        words = torch.from_numpy(rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32))
        t0 = time.perf_counter()
        want = lb.words_to_device_limbs(words)
        plain_ms = (time.perf_counter() - t0) * 1e3
        w = words.to(dev)
        err = max_word_err(lb.words_to_device_limbs(w).cpu(), want)
        ok &= err == 0
        if n in timed:
            ms[n] = cuda_time(lambda w=w: lb.words_to_device_limbs(w), 50)
            bms, by = bound(64 * n, 0)
            log(f"  witness_limbs {n} rows: max word err {err}; {ms[n]:.4f} ms (bound {bms:.4f}, "
                f"{by}); plain {plain_ms:.2f} ms on the host")
        else:
            log(f"  witness_limbs {n} rows: max word err {err}")
    n = max(timed)
    bms, by = bound(64 * n, 0)
    rep.add(kernels.WITNESS_LIMBS.name, equal_to_plain=ok, max_abs_err=0.0 if ok else 1.0,
            ms=ms[n], ms_by_rows=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            timed=f"(n, 8) -> (8, n) int32 at {sorted(ms)} rows (the plain version on the host)")
    return ok


# complex-1600k's G1 groups (A, B1, C, H lanes) and window size: K19's check
MSM_SORT_SIZES, MSM_SORT_C = (1600003, 1600003, 1600001, 2097152), 16


def check_msm_sort(rep, rng, dev) -> bool:
    """K19 at complex-1600k's G1 shape against its plain versions: the
    pairs word for word (`window_pairs` against `window_pairs_plain`, run on
    the card), then the sorted pairs (`sort_pairs` against
    `sort_pairs_plain`, torch.sort of int64 keys); both timed (CUDA events).
    Bounds by bytes: 36 a lane read and 8 a pair written; 16 a pair sorted
    (each read and written once)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.ops import msm

    sizes, c = MSM_SORT_SIZES, MSM_SORT_C
    n = sum(sizes)
    words = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64)
    words[7] &= (1 << 30) - 1
    sc = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    half = 1 << (c - 1)
    kr = (len(sizes) + 1) * (half + 1)
    base = msm.group_ids(sizes, dev) * (half + 1)
    windows = msm.merged_windows(c)
    bits = (windows * kr - 1).bit_length()
    keys, vals = msm.window_pairs(sc, base, c, 1, kr)
    (pk, pv), keys_plain_ms = timed_once(lambda: msm.window_pairs_plain(sc, base, c, 1, kr))
    keys_ok = bool(torch.equal(keys, pk) and torch.equal(vals, pv))
    del pk, pv
    keys, vals = keys.view(-1), vals.view(-1)
    (wk, wv), sort_plain_ms = timed_once(lambda: msm.sort_pairs_plain(keys, vals))
    sk, sv = msm.sort_pairs(keys.clone(), vals.clone(), bits)
    sort_ok = bool(torch.equal(sk, wk) and torch.equal(sv, wv))
    del wk, wv, sk, sv
    keys_ms = cuda_time(lambda: msm.window_pairs(sc, base, c, 1, kr), 20)
    # the sort overwrites its buffers with a permutation of the same pairs: time it in place
    sort_ms = cuda_time(lambda: msm.sort_pairs(keys, vals, bits), 20)
    pairs = windows * n
    kb, kby = bound(36 * n + 8 * pairs, 0)
    sb, sby = bound(16 * pairs, 0)
    log(f"  msm_sort_keys {n} lanes, c {c}: equal {keys_ok}; {keys_ms:.4f} ms (bound {kb:.4f}, "
        f"{kby}); plain {keys_plain_ms:.2f} ms")
    log(f"  msm_sort {pairs} pairs over {bits} bits: equal {sort_ok}; {sort_ms:.4f} ms (bound "
        f"{sb:.4f}, {sby}); plain {sort_plain_ms:.2f} ms")
    timed = f"complex-1600k's G1, {n} lanes in {len(sizes)} groups, c {c}"
    rep.add(kernels.MSM_SORT_KEYS.name, equal_to_plain=keys_ok, max_abs_err=0.0 if keys_ok else 1.0,
            ms=keys_ms, plain_ms=keys_plain_ms, bound_ms=kb, bound_by=kby, timed=timed)
    rep.add(kernels.MSM_SORT.name, equal_to_plain=sort_ok, max_abs_err=0.0 if sort_ok else 1.0,
            ms=sort_ms, plain_ms=sort_plain_ms, bound_ms=sb, bound_by=sby,
            timed=f"{timed}: {pairs} pairs, {bits} key bits")
    return keys_ok and sort_ok


def write_witness_words(path: str, n: int, seed: int) -> str:
    """A .wtns file of n random values below 2^254 (not reduced: the ingest
    moves words), written as bytes."""
    from icicle_snark_tpu_torch.io.binfile import BinWriter
    from icicle_snark_tpu_torch.refmath.field import R_MOD, int_to_le

    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    words[:, 7] &= (1 << 30) - 1
    w = BinWriter("wtns", version=2)
    w.begin_section(1)
    w.write(int(32).to_bytes(4, "little") + int_to_le(R_MOD, 32) + int(n).to_bytes(4, "little"))
    w.end_section()
    w.begin_section(2)
    w.write(words.astype("<u4").tobytes())
    w.end_section()
    w.save(path)
    return path


# (chunk bytes, reads in flight) of the ingest's sweep
INGEST_ROUTES = ((4 << 20, 1), (1 << 20, 4), (2 << 20, 4), (4 << 20, 4), (8 << 20, 4),
                 (4 << 20, 2), (4 << 20, 8))


def ingest_ab(directory: str, dev, n: int = 1600003, reps: int = 8) -> dict:
    """The witness ingest at n rows from a warm file cache, host clock to a
    synchronised card: the memory-mapped section turned on the host and
    copied from pageable memory (the route before K18), against
    `pipeline.read_witness` at each chunk size and number of reads in
    flight of INGEST_ROUTES, in turns; each route's limbs equal. Also the
    time each route takes to return."""
    import statistics
    from types import SimpleNamespace

    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.io.wtns import WtnsFile
    from icicle_snark_tpu_torch.prover import pipeline
    from icicle_snark_tpu_torch.refmath.field import R_MOD

    os.makedirs(directory, exist_ok=True)
    paths = [write_witness_words(os.path.join(directory, f"ingest_{k}.wtns"), n, k)
             for k in range(2)]
    hdr = SimpleNamespace(r=R_MOD, n_vars=n)

    def host_route(p):
        return lb.words_to_host_limbs(WtnsFile(p).witness_limbs()).to(dev)

    def chunked(chunk, readers):
        def run(p):
            with patched((pipeline, "INGEST_CHUNK", chunk), (pipeline, "INGEST_READERS", readers)):
                return pipeline.read_witness(p, hdr, dev)[1]
        return run

    routes = {"host turn + pageable copy": host_route,
              **{f"chunks of {c / 2**20:g} MB, {r} in flight": chunked(c, r)
                 for c, r in INGEST_ROUTES}}
    times = {name: [] for name in routes}
    returned = {name: [] for name in routes}
    want = [host_route(p).cpu() for p in paths]
    same = True
    for rep_i in range(reps):
        for name, fn in (routes.items() if rep_i % 2 == 0 else reversed(routes.items())):
            p = paths[rep_i % 2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(p)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            times[name].append((t2 - t0) * 1e3)
            returned[name].append((t1 - t0) * 1e3)
            same &= torch.equal(out.cpu(), want[rep_i % 2])
    out = {"rows": n, "bytes": 32 * n, "reps": reps, "same": bool(same),
           "ms": {k: statistics.median(v) for k, v in times.items()},
           "ms_all": times, "returned_ms": {k: statistics.median(v) for k, v in returned.items()}}
    log("[ingest] " + json.dumps({k: out[k] for k in ("rows", "same", "ms", "returned_ms")}))
    return out


# ---------------------------------------------------------------- the op surface, K9-K11

def random_scalars(rng, count: int, bits: int = 254):
    """(count, 8) uint32 words of random integers below 2^bits, with 0, 1
    and 2^bits - 1 in the first lanes."""
    w = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64).astype(np.uint32)
    w[:, 7] &= np.uint32((1 << (bits - 224)) - 1)
    w[0], w[1], w[2] = 0, 0, 0xFFFFFFFF
    w[1, 0] = 1
    w[2, 7] = (1 << (bits - 224)) - 1
    return w


def check_field_pow(rep, rng, dev, n: int = 1 << 24, n_plain: int = 1 << 18):
    """K9 against its plain version: the Fr and Fq inverses (a^(p-2)) of
    random values with 0, 1 and p-1 among them, and other exponents (0, 1,
    2, 5, 2^256 - 1, a random one) on fewer lanes; the kernel runs over n
    Fr lanes (n_plain for Fq), the plain version over the first n_plain.
    Timed: the Fr inverse over n lanes."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb

    ok, worst = True, 0.0
    plain_ms = None
    for spec in (lb.FR_SPEC, lb.FQ_SPEC):
        a = random_field(rng, spec.modulus, (n if spec is lb.FR_SPEC else n_plain,), dev)
        got = lb.mont_inv(a, spec)
        want, ms_p = timed_once(lambda: lb.field_pow_plain(a[:, :n_plain].contiguous(),
                                                           spec.modulus - 2, spec))
        err = max_word_err(got[:, :n_plain], want)
        zero_ok = bool(lb.is_zero(got[:, :1]).all())
        if spec is lb.FR_SPEC:
            plain_ms, a_fr = ms_p, a
        exps = (0, 1, 2, 5, (1 << 256) - 1, int.from_bytes(rng.bytes(32), "little"))
        sub = a[:, :4096].contiguous()
        err_e = max(max_word_err(lb.mont_pow_const(sub, e, spec), lb.field_pow_plain(sub, e, spec))
                    for e in exps)
        log(f"  field_pow {spec.name} inverse, {a.shape[-1]} lanes (plain on {n_plain}): max word "
            f"err {err}, inv(0) = 0 {zero_ok}; exponents 0, 1, 2, 5, 2^256-1, random on 4096 "
            f"lanes: max word err {err_e}")
        worst = max(worst, err, err_e)
        ok &= err == 0 and err_e == 0 and zero_ok
    fr = lb.FR_SPEC
    ms = cuda_time(lambda: lb.mont_inv(a_fr, fr), 3)
    e = fr.modulus - 2
    steps = e.bit_length() + bin(e).count("1")  # squarings and products a lane
    bms, by = bound(n * 64, n * steps * MULS_PER_MONT)
    rep.add(kernels.FIELD_POW.name, equal_to_plain=ok, max_abs_err=worst, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            timed=f"Fr inverse (vec_ops.inv), {n} lanes; plain_ms on the first {n_plain} lanes")
    log(f"  field_pow Fr inverse over {n} lanes: {ms:.3f} ms, bound {bms:.3f} ms ({by}); plain "
        f"version {plain_ms:.1f} ms on {n_plain} lanes")
    return ok


# blocks an SM of the product reduction's first launch, timed beside the default
PRODUCT_SWEEP = (1, 2, 3, 4)


def product_grid(n: int, dev) -> str:
    """The product's first launch over one row of n, as a line; the
    accumulators a thread as csrc/field_product.cuh defines them."""
    import re

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.ops import vec_ops as vo

    with open(os.path.join(kernels.CSRC, "field_product.cuh")) as fh:
        acc = re.search(r"#define PRODUCT_ACC (\d+)", fh.read()).group(1)
    sms = vo.sm_count(dev)
    blocks = vo.product_blocks(1, n, sms)
    return (f"{blocks} blocks of {vo.PRODUCT_THREADS} threads ({vo.PRODUCT_BLOCKS_PER_SM} an SM "
            f"on {sms} SMs), {acc} accumulators a thread, "
            f"{n / (blocks * vo.PRODUCT_THREADS):.1f} elements a thread; then one block over the "
            f"{blocks} partials")


def product_sweep(v, spec, want) -> tuple:
    """The product over the row v at each blocks-an-SM of PRODUCT_SWEEP:
    (every variant equal to `want`, {variant: ms})."""
    import torch

    from icicle_snark_tpu_torch.ops import vec_ops as vo

    ok, times = True, {}
    for per_sm in PRODUCT_SWEEP:
        with patched((vo, "PRODUCT_BLOCKS_PER_SM", per_sm)):
            ok &= bool(torch.equal(vo.field_reduce(1, v, spec), want))
            times[f"{per_sm} an SM"] = cuda_time(lambda: vo.field_reduce(1, v, spec), 10)
    return ok, times


def check_field_reduce(rep, rng, dev, n: int = 1 << 24):
    """K10 against its plain version: the sum and the product over one row
    of n Fr values, an odd row (n - 3), n = 1, a 2-D batch (2, 3, 8, 4097),
    rows of p - 1 only (the largest carries), and an Fq batch; timed over
    the row of n."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import vec_ops as vo

    fr, fq = lb.FR_SPEC, lb.FQ_SPEC
    full = random_field(rng, fr.modulus, (n,), dev)
    top = lb.const(fr.modulus - 1, dev, 5000)
    cases = [("row of n", full, fr), ("odd row", full[:, 3:].contiguous(), fr),
             ("n = 1", full[:, :1].contiguous(), fr),
             ("2-D batch", random_field(rng, fr.modulus, (2, 3, 4097), dev), fr),
             ("p - 1 only", torch.stack([top, top]), fr),
             ("Fq batch", random_field(rng, fq.modulus, (3, 70001), dev), fq)]
    ok, worst, plain, want_row = True, 0.0, {}, None
    for label, v, spec in cases:
        for op in (0, 1):
            got = vo.field_reduce(op, v, spec)
            want, ms_p = timed_once(lambda: vo.field_reduce_plain(op, v, spec))
            err = max_word_err(got, want)
            if label == "row of n":
                plain[op] = ms_p
                want_row = want if op else want_row
            worst = max(worst, err)
            ok &= err == 0 and got.shape == v.shape[:-1] + (1,)
            log(f"  field_reduce {'product' if op else 'sum'} {label} {tuple(v.shape)}: max word "
                f"err {err}")
    sum_ms = cuda_time(lambda: vo.field_reduce(0, full, fr), 10)
    prod_ms = cuda_time(lambda: vo.field_reduce(1, full, fr), 10)
    b_sum = bound(n * 32 + 32, 0)
    b_prod = bound(n * 32 + 32, (n - 1) * MULS_PER_MONT)
    grid = product_grid(n, dev)
    swept, sweep = product_sweep(full, fr, want_row)
    ok &= swept
    usage = kernel_usage("field_reduce.cu", "")
    rep.add(kernels.FIELD_REDUCE.name, equal_to_plain=ok, max_abs_err=worst,
            ms=sum_ms + prod_ms, plain_ms=plain[0] + plain[1], bound_ms=b_sum[0] + b_prod[0],
            bound_by=b_prod[1], product_grid=grid, product_sweep_ms=sweep, build=usage,
            timed=f"Fr sum_reduce + product_reduce over one row of {n}: sum {sum_ms:.4f} ms "
                  f"(bound {b_sum[0]:.4f}, {b_sum[1]}), product {prod_ms:.4f} ms (bound "
                  f"{b_prod[0]:.4f}, {b_prod[1]})")
    log(f"  field_reduce over {n}: sum {sum_ms:.4f} ms (bound {b_sum[0]:.4f}), product "
        f"{prod_ms:.4f} ms (bound {b_prod[0]:.4f}); product grid: {grid}; swept (each equal: "
        f"{swept}): " + json.dumps(sweep))
    log(f"  field_reduce build: {usage}")
    return ok


def setup_tables(dev):
    """The device setup's G1 and G2 window tables, (x, y) on the card."""
    from icicle_snark_tpu_torch.setup import fast_setup as fs
    from icicle_snark_tpu_torch.setup.trusted_setup import _fixed_bases

    fb1, fb2 = _fixed_bases()
    return (fb1, fb2), (fs._table_g1(fb1, dev), fs._table_g2(fb2, dev))


def check_fixed_base(rep, rng, dev, fbs, tables, lanes: int = 1 << 18):
    """K11 against its plain version at the device setup's chunk (2^18
    lanes) for G1 and G2: every projective word equal, on random scalars
    below r with 0, 1, r - 1 and 2^256 - 1 (every digit 255) among them;
    the first lanes made affine (K7) against host scalar multiples. Timed
    beside the plain version and the route the setup took before K11 (the
    plain scan over K1 launches), with the build's registers and spills of
    both kernels. The row sums G1 and G2."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm
    from icicle_snark_tpu_torch.refmath.field import fq_from_mont
    from icicle_snark_tpu_torch.setup import fast_setup as fs

    ok, worst, row = True, 0.0, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "k1_route_ms": 0.0}
    parts = []
    for g2 in (False, True):
        tag = "g2" if g2 else "g1"
        ops, plain = (jc.G2, jc.G2_PLAIN) if g2 else (jc.G1, jc.G1_PLAIN)
        table, fb = tables[g2], fbs[g2]
        words = rng.integers(0, 1 << 32, size=(lanes, 8), dtype=np.uint64).astype(np.uint32)
        words[:, 7] = rng.integers(0, lb.FR_SPEC.modulus >> 224, size=lanes).astype(np.uint32)
        for i, v in enumerate((0, 1, lb.FR_SPEC.modulus - 1, (1 << 256) - 1)):
            words[i] = lb.ints_to_words([v])[0]
        sc = lb.words_to_limbs(words, dev)
        got = fs.fixed_base_msm(sc, table, ops)
        want, plain_ms = timed_once(lambda: fs.fixed_base_msm_plain(sc, table, plain))
        err = max(max_word_err(a, b) for a, b in zip(got, want))
        ax, ay = jc.to_affine(ops, tuple(t[..., :6].contiguous() for t in got))
        host_ok = True
        for i in range(6):
            k = int.from_bytes(words[i].astype("<u4").tobytes(), "little")
            if g2:
                pt = tuple(tuple(fq_from_mont(lb.limbs_to_ints(t[c][:, i:i + 1])[0])
                                 for c in range(2)) for t in (ax, ay))
            else:
                pt = tuple(fq_from_mont(lb.limbs_to_ints(t[:, i:i + 1])[0]) for t in (ax, ay))
            host_ok &= pt == _affine_host(fb.mul(k), g2)
        records = msm.point_records(table)
        ms = cuda_time(lambda: fs.fixed_base_msm(sc, table, ops, records), 5)
        k1_ms = cuda_time(lambda: fs.fixed_base_msm_plain(sc, table, ops), 1)
        digits = fs._digits(sc)
        madds = int((digits != 0).sum())
        out_words = 3 * (16 if g2 else 8)
        bnd = bound(lanes * 32 + lanes * out_words * 4 + records.numel() * 4,
                    madds * FQ_MULS[tag]["madd"] * MULS_PER_MONT)
        log(f"  fixed_base_msm {tag}, {lanes} lanes: max word err {err}, affine == host k * G on "
            f"6 lanes {host_ok}; {ms:.3f} ms (bound {bnd[0]:.3f} ms, {bnd[1]}), plain version "
            f"{plain_ms:.1f} ms, the K1-launch scan {k1_ms:.1f} ms")
        worst = max(worst, err)
        ok &= err == 0 and host_ok
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bnd[0]),
                         ("k1_route_ms", k1_ms)):
            row[key] += val
        parts.append(f"{tag} {ms:.3f} ms (bound {bnd[0]:.3f}, {bnd[1]}; plain {plain_ms:.1f}; "
                     f"K1-launch scan {k1_ms:.1f})")
        del got, want
        torch.cuda.empty_cache()
    usage = kernel_usage("fixed_base.cu", "")
    log(f"  fixed_base_msm build: {usage}")
    rep.add(kernels.FIXED_BASE.name, equal_to_plain=ok, max_abs_err=worst, bound_by="operations",
            timed=f"one setup chunk of {lanes} lanes, G1 + G2: " + "; ".join(parts), build=usage,
            **row)
    return ok


def check_k4_windows(rng, dev, lanes: int = 4096, cs=(8, 10, 12, 16)):
    """K4 (accumulate and reduce) against its plain versions at the op
    surface's small windows (c = 8 gives 128 buckets and 8 reduce threads a
    row), for G1 and G2, on full-width scalars below 2^254 with 0, 1 and
    2^254 - 1 among them and the identity among the points."""
    import torch

    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm

    ok = True
    for g2 in (False, True):
        ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
        _, pts = _edge_msm_inputs(rng, dev, g2)
        reps = -(-lanes // pts[0].shape[-1])
        pts = tuple(torch.cat([t] * reps, dim=-1)[..., :lanes].contiguous() for t in pts)
        rec = msm.point_records(pts)
        sc = lb.words_to_limbs(random_scalars(rng, lanes), dev)
        for c in cs:
            half = 1 << (c - 1)
            order, negs, ends = msm.sort_windows(sc, [lanes], c)
            acc_err, red_err, *_ = _msm_against_plain(
                ops, rec, order, negs, ends, order.shape[0], 1, half, f"c = {c}",
                "g2" if g2 else "g1", sc, c, time.perf_counter())
            ok &= acc_err == 0 and red_err == 0
    return ok


def _affine_host(p, g2: bool):
    from icicle_snark_tpu_torch.refmath import curve as cv

    return cv.g2_to_affine(p) if g2 else cv.g1_to_affine(p)


def drive_op_surface(rng, dev, fbs, tables, counts_log, n_vec: int = 1 << 24,
                     log_ntt: int = 22, n_g1: int = 1 << 22, n_g2: int = 1 << 20) -> tuple:
    """The op surface as a user calls it (ops/vec_ops.py, ops/ntt.py `ntt`,
    ops/msm.py `msm_g1`/`msm_g2`, config.py, runtime.py), each result held
    against a composition computed another way:
      vec-ops over n_vec Fr values: sub(add(a, b), b) == a, div(a, a) == 1
      (a != 0; div(0, 0) == 0), product_reduce of a vector and its inverses
      == 1, from_mont(to_mont(a)) == a, scalar_sub(s, v) == neg(sub(v, s)),
      the sum of a vector and its negation == 0, mixed_mul == two products,
      the batched cfg ops == the plain ones;
      ntt at 2^log_ntt (batch 1) and at (3, 2^(log_ntt - 1)), every ordering
      with and without a coset generator: forward then inverse gives the
      input back, NR == NN gathered by bitrev, the coset NTT == the powers
      g^i (K1) times ntt_natural; columns_batch == the row batch transposed;
      msm_g1 over n_g1 lanes and msm_g2 over n_g2, on points k_i * G made by
      K11 and K7 and random scalars below 2^254, with the default window,
      MSMConfig(c=13) and precompute_factor 2: each == the grouped path's
      MSM over the same lanes at another window, and == (sum s_i k_i) * G
      on the host.
    The counts are set to 0 after the inputs are made and read at the end:
    the op surface's launches. Returns (ok, readings)."""
    import torch

    from icicle_snark_tpu_torch import kernels, runtime
    from icicle_snark_tpu_torch.config import MSMConfig, NTTConfig, Ordering, VecOpsConfig
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm
    from icicle_snark_tpu_torch.ops import ntt as ntt_ops
    from icicle_snark_tpu_torch.ops import vec_ops as vo
    from icicle_snark_tpu_torch.setup import fast_setup as fs

    fr = lb.FR_SPEC
    checks, ms = {}, {}
    runtime.set_device("CUDA")
    runtime.warmup()
    props = runtime.device_properties()
    # inputs: vectors; MSM points k_i * G (K11 then K7) with their k_i
    a = random_field(rng, fr.modulus, (n_vec,), dev)
    b = random_field(rng, fr.modulus, (n_vec,), dev)
    b[:, :3] = lb.const(fr.r_mod, dev, 3)  # b nonzero where a holds 0, 1, p - 1
    ext = random_field(rng, lb.FQ_SPEC.modulus, (2, n_vec // 4), dev)
    base = random_field(rng, lb.FQ_SPEC.modulus, (n_vec // 4,), dev)
    xs = random_field(rng, fr.modulus, (1 << log_ntt,), dev)
    xb = random_field(rng, fr.modulus, (3, 1 << (log_ntt - 1)), dev)
    pts, ks = {}, {}
    for g2, lanes in ((False, n_g1), (True, n_g2)):
        words = rng.integers(0, 1 << 32, size=(lanes, 8), dtype=np.uint64).astype(np.uint32)
        words[:, 7] = rng.integers(0, fr.modulus >> 224, size=lanes).astype(np.uint32)
        words[0] = 0  # the identity among the points
        kt = lb.words_to_limbs(words, dev)
        ops = jc.G2 if g2 else jc.G1
        pts[g2] = jc.to_affine(ops, fs.fixed_base_msm(kt, tables[g2], ops))
        ks[g2] = lb.limbs_to_ints(kt)
    scal = {g2: lb.words_to_limbs(random_scalars(rng, lanes), dev)
            for g2, lanes in ((False, n_g1), (True, n_g2))}
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()

    # ---- vec-ops
    one = lb.one_mont(fr, dev)
    s = vo.sum_reduce(b[:, 5:6].contiguous())  # a scalar (8,)
    checks["sub(add(a, b), b) == a"] = torch.equal(vo.sub(vo.add(a, b), b), a)
    q = vo.div(a, a)
    checks["div(a, a) == 1, div(0, 0) == 0"] = bool(
        torch.equal(q[:, 1:], one.expand(8, n_vec - 1)) and lb.is_zero(q[:, :1]).all())
    nz = a[:, 1:].contiguous()
    both = torch.cat([nz, vo.inv(nz)], dim=-1)
    checks["product_reduce(v, inv(v)) == 1"] = torch.equal(vo.product_reduce(both), one[:, 0])
    checks["from_mont(to_mont(a)) == a"] = torch.equal(vo.from_mont(vo.to_mont(a)), a)
    checks["scalar_sub(s, v) == neg(sub(v, s))"] = torch.equal(
        vo.scalar_sub(s, a), vo.neg(vo.sub(a, s.reshape(8, 1))))
    checks["scalar_add(s, v) - s == v, scalar_mul(1, v) == v"] = bool(
        torch.equal(vo.sub(vo.scalar_add(s, a), s.reshape(8, 1)), a)
        and torch.equal(vo.scalar_mul(one, a), a))
    checks["sum_reduce(v, neg(v)) == 0"] = bool(
        lb.is_zero(vo.sum_reduce(torch.cat([a, vo.neg(a)], dim=-1)).reshape(8, 1)).all())
    acc = a.clone()
    vo.accumulate(acc, b)
    checks["accumulate == add"] = torch.equal(acc, vo.add(a, b))
    mm = vo.mixed_mul(ext, base, lb.FQ_SPEC)
    checks["mixed_mul == two products"] = bool(
        torch.equal(mm[0], vo.mul(ext[0], base, lb.FQ_SPEC))
        and torch.equal(mm[1], vo.mul(ext[1], base, lb.FQ_SPEC)))
    cfg = VecOpsConfig(batch_size=4)
    checks["add/sub/mul_cfg == add/sub/mul"] = bool(
        torch.equal(vo.mul_cfg(a, b, cfg), vo.mul(a, b))
        and torch.equal(vo.add_cfg(a, b, cfg), vo.add(a, b))
        and torch.equal(vo.sub_cfg(a, b, cfg), vo.sub(a, b)))
    for name, fn in (("add", lambda: vo.add(a, b)), ("mul", lambda: vo.mul(a, b)),
                     ("inv", lambda: vo.inv(a)), ("div", lambda: vo.div(a, b)),
                     ("scalar_sub", lambda: vo.scalar_sub(s, a)),
                     ("sum_reduce", lambda: vo.sum_reduce(a)),
                     ("product_reduce", lambda: vo.product_reduce(a))):
        ms[f"vec {name} 2^{n_vec.bit_length() - 1}"] = cuda_time(fn, 3)

    # ---- ntt
    rev_of = {Ordering.NN: Ordering.NN, Ordering.NR: Ordering.RN, Ordering.RN: Ordering.NR,
              Ordering.RR: Ordering.RR, Ordering.NM: Ordering.MN, Ordering.MN: Ordering.NM}
    g = int.from_bytes(rng.bytes(32), "little") % fr.modulus
    for label, x in ((f"2^{log_ntt}", xs), (f"(3, 2^{log_ntt - 1})", xb)):
        log_n = x.shape[-1].bit_length() - 1
        dom = ntt_ops.initialize_domain(log_n, dev)
        nn = {}
        for coset in (None, g):
            for o in Ordering:
                y = ntt_ops.ntt(x, cfg=NTTConfig(ordering=o, coset_gen=coset))
                back = ntt_ops.ntt(y, inverse=True, cfg=NTTConfig(ordering=rev_of[o],
                                                                   coset_gen=coset))
                checks[f"ntt {label} {o.name}{' coset' if coset else ''}: inverse(forward) == "
                       f"x"] = torch.equal(back, x)
                nn[(o, coset)] = y
            checks[f"ntt {label}{' coset' if coset else ''}: NR == NN[bitrev]"] = torch.equal(
                nn[(Ordering.NR, coset)], nn[(Ordering.NN, coset)][..., dom.bitrev])
        want = ntt_ops.ntt_natural(
            lb.mont_mul(x, ntt_ops.powers_mont(g, log_n, dev), fr).reshape(-1, 8, 1 << log_n), dom)
        checks[f"ntt {label} coset == powers x ntt_natural"] = torch.equal(
            nn[(Ordering.NN, g)].reshape(want.shape), want)
        ms[f"ntt {label} NN"] = cuda_time(lambda: ntt_ops.ntt(x), 3)
        ms[f"ntt {label} NN coset"] = cuda_time(
            lambda: ntt_ops.ntt(x, cfg=NTTConfig(coset_gen=g)), 3)
    cols = xb.permute(2, 1, 0).contiguous()  # (n, 8, 3)
    yc = ntt_ops.ntt(cols, cfg=NTTConfig(columns_batch=True))
    checks["ntt columns_batch == row batch"] = torch.equal(
        yc.permute(2, 1, 0), ntt_ops.ntt(xb))
    ntt_inplace_x = xs.clone()
    ntt_ops.ntt_inplace(ntt_inplace_x)
    checks["ntt_inplace == ntt"] = torch.equal(ntt_inplace_x, ntt_ops.ntt(xs))

    # ---- msm
    msm_res = {}
    for g2, fn in ((False, msm.msm_g1), (True, msm.msm_g2)):
        tag = "g2" if g2 else "g1"
        ops = jc.G2 if g2 else jc.G1
        sc, p = scal[g2], pts[g2]
        lanes = sc.shape[-1]
        t1 = time.perf_counter()
        default = fn(sc, p)
        ms[f"msm_{tag} {lanes} default c (host clock, s)"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        c13 = fn(sc, p, cfg=MSMConfig(c=13))
        ms[f"msm_{tag} {lanes} MSMConfig(c=13) (host clock, s)"] = time.perf_counter() - t1
        c_pre = msm.choose_c(min(lanes, msm.MSM_MAX_LANES // 2), factor=2)
        t1 = time.perf_counter()
        pre = msm.precompute_bases(p, ops, c_pre, 2)
        torch.cuda.synchronize()
        ms[f"msm_{tag} precompute_bases f 2 c {c_pre} (host clock, s)"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        f2 = fn(sc, pre, cfg=MSMConfig(c=c_pre, precompute_factor=2))
        ms[f"msm_{tag} {lanes} precompute_factor 2 (host clock, s)"] = time.perf_counter() - t1
        # the grouped path at another window over the same lanes
        c_alt = 12
        ws = msm.msm_window_sums(sc, [lanes], msm.point_records(p), c_alt)
        to_host = msm.window_points_to_host_g2 if g2 else msm.window_points_to_host_g1
        grouped = msm.horner_combine(to_host(ws, 0), c_alt, g2=g2)
        host_k = sum(x * k for x, k in zip(lb.limbs_to_ints(sc), ks[g2])) % fr.modulus
        want = fbs[g2].mul(host_k)
        aff = [_affine_host(v, g2) for v in (default, c13, f2, grouped, want)]
        checks[f"msm_{tag} default == c 13 == precompute f 2 == grouped c {c_alt} == host"] = \
            all(v == aff[-1] for v in aff)
        msm_res[tag] = {"lanes": lanes, "c_default": msm.choose_c(
            min(lanes, msm.MSM_MAX_LANES // (2 if g2 else 1))), "c_pre": c_pre}
        del pre, ws
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts_log["op surface"] = kernels.counts()
    ntt_ops.release_domain()  # the domains this phase built stay off the later peaks
    elapsed = time.perf_counter() - t0
    ok = all(checks.values())
    for name, val in checks.items():
        if not val:
            log(f"  op surface FAILED: {name}")
    log(f"[ops] {sum(checks.values())} of {len(checks)} checks hold; device "
        f"{runtime.get_device()}, {runtime.available_devices()}, {props}; {elapsed:.1f} s; "
        f"launches " + json.dumps(counts_log["op surface"]))
    log("[ops] times (ms, CUDA events, unless named): " + json.dumps(ms))
    return ok, {"checks": checks, "ms": ms, "msm": msm_res, "s": elapsed,
                "launches": counts_log["op surface"]}


def op_surface_phase(rep, rng, dev, counts_log, failures, small: bool = False) -> dict:
    """Phase 6: K9, K10, K11 and K4 at small windows against their plain
    versions, then the op surface driven (drive_op_surface). `small` cuts
    every size for a rehearsal."""
    import torch

    t0 = time.perf_counter()
    fbs, tables = setup_tables(dev)
    log(f"  setup window tables built on the host in {time.perf_counter() - t0:.1f} s")
    sizes = (dict(n_vec=1 << 12, log_ntt=6, n_g1=1 << 10, n_g2=1 << 9) if small else {})
    for name, fn in (
            ("field_pow", lambda: check_field_pow(rep, rng, dev, *((1 << 12, 1 << 10) if small
                                                                  else ()))),
            ("field_reduce", lambda: check_field_reduce(rep, rng, dev, *((1 << 12,) if small
                                                                        else ()))),
            ("fixed_base_msm", lambda: check_fixed_base(rep, rng, dev, fbs, tables,
                                                        *((1 << 10,) if small else ()))),
            ("msm at c = 8, 10, 12, 16", lambda: check_k4_windows(rng, dev,
                                                                  *((256,) if small else ())))):
        t1 = time.perf_counter()
        if not fn():
            failures.append(f"kernel {name} differs from its plain version")
        torch.cuda.empty_cache()
        log(f"[kernels] {name} checked in {time.perf_counter() - t1:.1f} s")
    ok, readings = drive_op_surface(rng, dev, fbs, tables, counts_log, **sizes)
    if not ok:
        failures.append("an op-surface result differs from its composition")
    for k in ("field_vec", "field_pow", "field_reduce", "ntt_block", "msm_accumulate",
              "msm_reduce", "point_dbl_k", "point_to_affine"):
        if not readings["launches"].get(k):
            failures.append(f"the op surface did not launch {k}")
    torch.cuda.empty_cache()
    readings["phase_s"] = time.perf_counter() - t0
    return readings


# ---------------------------------------------------------------- the other curves (K12-K14)

CURVES = ("bls12_377", "bls12_381", "bw6_761")
# Full-width MSM lanes (G1, G2) per curve
CURVE_MSM_LANES = {"bls12_377": (1 << 22, 1 << 20), "bls12_381": (1 << 22, 1 << 20),
                   "bw6_761": (1 << 20, 1 << 20)}
# The point formulas' products (csrc/curve.cuh): coordinate products and b3
# multiplications per mixed add, add and doubling
E_MULS = {"madd": (11, 2), "add": (12, 2), "dbl": (8, 1)}


def muls_per_product(words: int) -> int:
    """32-bit multiplies of one CIOS product at `words` words: words rounds
    of 2 words for a * b_i (lo and hi), 1 for m and 2 words for m * p
    (MULS_PER_MONT at 8 words)."""
    return words * (4 * words + 1)


def group_products(grp, op: str) -> int:
    """Fq products of one point operation of a K13 group: 3 a coordinate
    product over Fq2 (Karatsuba), 1 over Fq; b3 by addition chains except
    bls12-377 G2's (two products by a constant, ops/point_programs.py)."""
    e_muls, b3s = E_MULS[op]
    per = 3 if len(grp.coords) == 2 else 1
    b3 = 2 if grp.name == "bls12_377_g2" else 0
    return e_muls * per + b3s * b3


def random_field_n(gen, spec, shape, dev, edges: bool = True):
    """Field values as (..., words, n) int32 limbs, uniform over [0, t 2^(32
    (words - 1))) with t the top word of p (so below p), made on `dev` by
    `gen`; with `edges`, 0, 1 and p - 1 in the first lanes."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb

    *lead, n = shape
    w = spec.words
    x = torch.randint(-(1 << 31), 1 << 31, tuple(lead) + (w, n), dtype=torch.int32,
                      device=dev, generator=gen)
    x[..., w - 1, :] = torch.randint(0, spec.modulus >> (32 * (w - 1)), tuple(lead) + (n,),
                                     dtype=torch.int32, device=dev, generator=gen)
    if edges:
        x[..., :3] = lb.ints_to_limbs([0, 1, spec.modulus - 1], dev, w)
    return x


# K16's lanes by words: the inverse timed over 2^24, 2^22 and 2^20 elements
POW_N_LANES = {8: 1 << 24, 12: 1 << 22, 24: 1 << 20}


def kernel_field_specs() -> list:
    """The five fields of K12, K16 and K17, in the kernels' selector order
    (curves/device.py KERNEL_FIELDS)."""
    from icicle_snark_tpu_torch.curves import device as cdev

    return [cdev.curve_specs(c)[0 if f == "q" else 1] for c, f in cdev.KERNEL_FIELDS]


def check_field_vec_n(rep, gen, dev, n: int = 1 << 24, n_plain: int = 1 << 16) -> tuple:
    """K12 against its plain version word for word on every op and field at
    n_plain lanes (0, 1, p - 1 among them; b equal to a in some lanes; b
    broadcast as a constant), then timed at n lanes beside its bound."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb

    specs = kernel_field_specs()
    ok, fields = True, {}
    for spec in specs:
        a = random_field_n(gen, spec, (2, n_plain), dev)
        b = random_field_n(gen, spec, (2, n_plain), dev)
        b[..., 3:6] = a[..., 3:6]
        errs = {}
        for op in (lb.OP_MUL, lb.OP_ADD, lb.OP_SUB, lb.OP_NEG, lb.OP_RSUB):
            bb = None if op == lb.OP_NEG else b
            errs[op] = max_word_err(lb.field_op(op, a, bb, spec), lb.field_op_plain(op, a, bb, spec))
        errs["mul const"] = max_word_err(lb.mont_mul(a, b[0, :, 7:8].contiguous(), spec),
                                         lb.field_op_plain(lb.OP_MUL, a, b[0, :, 7:8], spec))
        field_ok = all(e == 0 for e in errs.values())
        ok &= field_ok
        _, plain_ms = timed_once(lambda: lb.field_op_plain(lb.OP_MUL, a[0], b[0], spec))
        del a, b
        x = random_field_n(gen, spec, (n,), dev)
        y = random_field_n(gen, spec, (n,), dev)
        mul_ms = cuda_time(lambda: lb.mont_mul(x, y, spec), 10)
        add_ms = cuda_time(lambda: lb.add_mod(x, y, spec), 10)
        del x, y
        torch.cuda.empty_cache()
        w = spec.words
        mul_b, by = bound(n * 3 * 4 * w, n * muls_per_product(w))
        add_b, _ = bound(n * 3 * 4 * w, 0)
        fields[spec.name] = dict(words=w, equal_to_plain=field_ok, mul_ms=mul_ms, add_ms=add_ms,
                                 mul_bound_ms=mul_b, mul_bound_by=by, add_bound_ms=add_b,
                                 plain_mul_ms=plain_ms, lanes=n, plain_lanes=n_plain)
        log(f"  field_vec_n {spec.name} ({w} words): max word err "
            f"{max(errs.values())} over mul/add/sub/neg/rsub/const; 2^{n.bit_length() - 1} "
            f"lanes: mul {mul_ms:.4f} ms (bound {mul_b:.4f}, {by}), add {add_ms:.4f} ms "
            f"(bound {add_b:.4f}); plain mul at {n_plain} lanes {plain_ms:.1f} ms")
    widest = fields[specs[-1].name]
    rep.add(kernels.FIELD_VEC_N.name, equal_to_plain=ok, max_abs_err=0.0 if ok else 1.0,
            ms=widest["mul_ms"], plain_ms=widest["plain_mul_ms"],
            bound_ms=widest["mul_bound_ms"], bound_by=widest["mul_bound_by"],
            timed=f"{specs[-1].name} mont_mul over {n} lanes (plain at {n_plain}); every field "
                  f"under by_field", by_field=fields)
    return ok, fields


def _pool_points(name: str, g2: bool, rng, count: int = 64):
    """`count` multiples k G (k random below r) of the curve's G1 or G2
    generator, affine, made on the host: the pool that the MSMs tile."""
    from icicle_snark_tpu_torch.curves import host
    from icicle_snark_tpu_torch.curves.params import get_curve

    p = get_curve(name)
    hc = host.g2_curve(p) if g2 else host.g1_curve(p)
    gen = hc.from_affine(p.g2 if g2 else p.g1)
    ks = [int.from_bytes(rng.bytes(48), "little") % p.r for _ in range(count)]
    return hc, [hc.to_affine(hc.mul_scalar(gen, k)) for k in ks]


def _chain_points(name: str, g2: bool, count: int) -> list:
    """G, 2G, ..., count G of the curve's G1 or G2 generator, affine, one host
    addition each: `count` distinct points."""
    from icicle_snark_tpu_torch.curves import host
    from icicle_snark_tpu_torch.curves.params import get_curve

    p = get_curve(name)
    hc = host.g2_curve(p) if g2 else host.g1_curve(p)
    gen = hc.from_affine(p.g2 if g2 else p.g1)
    pts, cur = [], gen
    for _ in range(count):
        pts.append(hc.to_affine(cur))
        cur = hc.add(cur, gen)
    return pts


def _class_sums(words_np: np.ndarray, period: int, r: int) -> list:
    """(words, n) uint32 scalars -> the exact sums, mod r, of the scalars of
    each residue class i mod `period` (column sums in uint64, then ints)."""
    w, n = words_np.shape
    cols = words_np.reshape(w, n // period, period).astype(np.uint64).sum(axis=1)
    return [sum(int(cols[k, j]) << (32 * k) for k in range(w)) % r for j in range(period)]


def _host_msm(hc, scalars, points):
    acc = hc.zero_pt
    for s, a in zip(scalars, points):
        if a is not None and s:
            acc = hc.add(acc, hc.mul_scalar(hc.from_affine(a), s))
    return acc


def check_msm_n(gen, dev, lanes: int = 1 << 12) -> tuple:
    """K13 accumulate and reduce against their plain versions word for word,
    for the six groups at `lanes` lanes (`lanes` distinct points G, 2G, ...,
    two of them (0, 0)): random scalars below r at c = 8 and at the default
    window, and bit-valued scalars (half of all lanes in bucket 1 of window
    0) at c = 8 with BUCKET_PIECE patched to 2, so that every fold level
    runs. Returns (ok, readings)."""
    import torch

    from icicle_snark_tpu_torch.curves import device as cdev
    from icicle_snark_tpu_torch.ops import msm

    ok, out = True, {}
    for name in CURVES:
        fr = cdev.curve_specs(name)[1]
        bits = 32 * fr.words
        for g2 in (False, True):
            grp = cdev.g2_group(name) if g2 else cdev.g1_group(name)
            pts = _chain_points(name, g2, lanes)
            pts[5] = pts[lanes // 2 + 40] = None
            rec = msm.point_records(cdev.affine_to_device(pts, grp.ops, dev))
            rand = random_field_n(gen, fr, (lanes,), dev)
            bit_sc = torch.zeros_like(rand)
            bit_sc[0] = torch.randint(0, 2, (lanes,), dtype=torch.int32, device=dev,
                                      generator=gen)
            cases = [("c 8", rand, 8, msm.BUCKET_PIECE),
                     ("default c", rand, msm.choose_c(lanes, bits=bits), msm.BUCKET_PIECE),
                     ("bits, c 8, L 2", bit_sc, 8, 2)]
            for label, sc, c, piece in cases:
                with patched((msm, "BUCKET_PIECE", piece)):
                    half = 1 << (c - 1)
                    order, negs, ends = msm.sort_windows(sc, [lanes], c)
                    windows = order.shape[0]
                    levels = len(msm.bucket_fold_plan(ends, windows, 1, half, lanes))
                    bk = msm.msm_accumulate(rec, order, negs, ends, 1, half, grp)
                    bp, acc_plain = timed_once(
                        lambda: msm.msm_accumulate_plain(rec, order, negs, ends, 1, half, grp))
                    wk = msm.msm_reduce(bp, windows, 1, half, grp)
                    wp, red_plain = timed_once(
                        lambda: msm.msm_reduce_plain(bp, windows, 1, half, grp))
                same = bool(torch.equal(bk, bp)) and bool(torch.equal(wk, wp))
                ok &= same
                out[f"{grp.name} {label}"] = dict(
                    c=c, windows=windows, levels=levels, equal_to_plain=same,
                    acc_plain_ms=acc_plain, reduce_plain_ms=red_plain)
                log(f"  msm_n {grp.name} {label}: {lanes} lanes, c {c}, W {windows}, {levels} "
                    f"accumulate levels: accumulate and reduce equal to their plain versions "
                    f"word for word: {same} (plain {acc_plain:.0f} + {red_plain:.0f} ms)")
    return ok, out


def k13_times(rec, sc, n: int, c: int, grp, reps: int = 2) -> dict:
    """K13 alone on one MSM's lanes (sorted here): accumulate and reduce
    over `reps` calls each (CUDA events), then one call of each under
    torch.profiler for the device ms of every kernel (the accumulate's
    level 0 and its fold levels, the reduce's stages), and the window sums
    for a comparison in affine form. It calls only entry points that earlier
    trees of the port have too (msm.sort_windows, msm_accumulate and
    msm_reduce with a PointGroup)."""
    import torch

    from icicle_snark_tpu_torch.ops import msm

    half = 1 << (c - 1)
    order, negs, ends = msm.sort_windows(sc, [n], c)
    windows = order.shape[0]
    bk = msm.msm_accumulate(rec, order, negs, ends, 1, half, grp)
    acc_ms = cuda_time(lambda: msm.msm_accumulate(rec, order, negs, ends, 1, half, grp), reps)
    red_ms = cuda_time(lambda: msm.msm_reduce(bk, windows, 1, half, grp), reps)
    kms = {}
    for fn in (lambda: msm.msm_accumulate(rec, order, negs, ends, 1, half, grp),
               lambda: msm.msm_reduce(bk, windows, 1, half, grp)):
        per, _other, _wall, _seen = kernel_device_ms(fn, lambda name: "msm" in name)
        kms.update(per)
    digits, _ = msm.window_digits_signed(sc, c)
    madds = int((digits != 0).sum())
    ws = msm.msm_reduce(bk, windows, 1, half, grp)
    del digits, order, negs, ends, bk
    torch.cuda.empty_cache()
    return dict(windows=windows, mixed_adds=madds, accumulate_ms=acc_ms, reduce_ms=red_ms,
                kernel_ms=kms, window_sums=ws)


def _affine_digest(ws, grp, hc) -> str:
    """A digest of the window sums in affine form (equal for two designs
    that add the same points in another order)."""
    import hashlib

    from icicle_snark_tpu_torch.curves import device as cdev

    pts = [hc.to_affine(p) for p in cdev.window_points_to_host(ws, grp.ops, 0)]
    return hashlib.sha256(repr(pts).encode()).hexdigest()[:16]


def drive_curve_msms(gen, rng, dev, counts_log, sizes=None, api_lanes: int = 1 << 16) -> tuple:
    """The curves' MSMs at users' sizes: for each curve and group, scalars
    below r (made on the card) and points tiled from a pool of 64 multiples
    k G, through the device pipeline that `curves/device.py` `msm` runs
    (`msm_window_sums` on K13, Horner on the host) at the default window,
    held in AFFINE form against sum_j (sum_{i = j mod 64} s_i mod r) P_j
    computed on the host; K13 timed with CUDA events beside its bounds, the
    call on the host clock, the peak device memory. Then `msm()` itself at
    `api_lanes`, host lists in and a host point out, against the same sum.
    Each driven call is counted alone (`counted`): the timings are not.
    Returns (ok, readings)."""
    import torch

    from icicle_snark_tpu_torch.curves import device as cdev
    from icicle_snark_tpu_torch.curves.params import get_curve
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm

    sizes = sizes or CURVE_MSM_LANES
    ok, out = True, {}
    pools = {(name, g2): _pool_points(name, g2, rng, 64) for name in CURVES for g2 in (False, True)}
    launched = counts_log["curves: MSMs and msm()"] = {}
    for name in CURVES:
        p = get_curve(name)
        fr = cdev.curve_specs(name)[1]
        bits = 32 * fr.words
        for g2 in (False, True):
            hc, pool = pools[(name, g2)]
            grp = cdev.g2_group(name) if g2 else cdev.g1_group(name)
            n = sizes[name][int(g2)]
            c = msm.choose_c(n, bits=bits)
            rec = msm.point_records(cdev.affine_to_device(pool, grp.ops, dev)).repeat(n // 64, 1)
            sc = random_field_n(gen, fr, (n,), dev, edges=False)
            want = _host_msm(hc, _class_sums(sc.cpu().numpy().view(np.uint32), 64, p.r), pool)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ws = counted(launched, lambda: msm.msm_window_sums(sc, [n], rec, c, group=grp))
            got = hc.zero_pt
            for wp in reversed(cdev.window_points_to_host(ws, grp.ops, 0)):
                for _ in range(c):
                    got = hc.dbl(got)
                got = hc.add(got, wp)
            call_ms = (time.perf_counter() - t0) * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            same = hc.to_affine(got) == hc.to_affine(want)
            ok &= same
            # K13 alone, on this MSM's sorted lanes
            k13 = k13_times(rec, sc, n, c, grp)
            del k13["window_sums"]
            windows, madds, half = k13["windows"], k13["mixed_adds"], 1 << (c - 1)
            mp = muls_per_product(grp.coords[-1])
            nbk = windows * half
            acc_b = bound(n * 2 * grp.words * 4 + windows * n * 5 + windows * (half + 1) * 4
                          + nbk * 3 * grp.words * 4, madds * group_products(grp, "madd") * mp)
            red_b = bound(nbk * 3 * grp.words * 4 + windows * 3 * grp.words * 4,
                          windows * 2 * (half - 1) * group_products(grp, "add") * mp)
            del ws, rec, sc
            torch.cuda.empty_cache()
            acc_ms, red_ms = k13["accumulate_ms"], k13["reduce_ms"]
            out[grp.name] = dict(lanes=n, c=c, windows=windows, same_affine=same,
                                 call_ms=call_ms, accumulate_bound_ms=acc_b[0],
                                 accumulate_bound_by=acc_b[1], reduce_bound_ms=red_b[0],
                                 reduce_bound_by=red_b[1], peak_memory_gb=peak_gb,
                                 **{k: v for k, v in k13.items() if k != "windows"})
            log(f"  msm {grp.name}: {n} lanes, c {c}, W {windows}: affine result == host sum: "
                f"{same}; accumulate {acc_ms:.2f} ms (bound {acc_b[0]:.2f}, {acc_b[1]}), reduce "
                f"{red_ms:.2f} ms (bound {red_b[0]:.2f}, {red_b[1]}); by kernel (device ms) "
                f"{json.dumps(k13['kernel_ms'])}; the call {call_ms:.1f} ms (host clock, Horner "
                f"included); peak device memory {peak_gb:.2f} GB")
    # the entry point itself, host lists in
    py_rng = np.random.default_rng(int(rng.integers(1 << 31)))
    for name in CURVES:
        p = get_curve(name)
        fr = cdev.curve_specs(name)[1]
        for g2 in (False, True):
            hc, pool = pools[(name, g2)]
            grp = cdev.g2_group(name) if g2 else cdev.g1_group(name)
            n = api_lanes
            scalars = [int.from_bytes(py_rng.bytes(4 * fr.words), "little") % p.r
                       for _ in range(n)]
            points = [pool[i % 64] for i in range(n)]
            points[64 + 3] = None  # one infinity lane
            sums = [sum(scalars[j::64]) % p.r for j in range(64)]
            sums[3] = (sums[3] - scalars[64 + 3]) % p.r
            want = _host_msm(hc, sums, pool)
            t0 = time.perf_counter()
            cdev.affine_to_device(points, grp.ops, dev)
            lb.ints_to_limbs(scalars, dev, fr.words)
            torch.cuda.synchronize()
            conv_ms = (time.perf_counter() - t0) * 1e3
            c = msm.choose_c(n, bits=32 * fr.words)
            t0 = time.perf_counter()
            got = counted(launched, lambda: cdev.msm(name, scalars, points, g2=g2, c=c, device=dev))
            call_ms = (time.perf_counter() - t0) * 1e3
            same = hc.to_affine(got) == hc.to_affine(want)
            ok &= same
            out[f"{grp.name} msm()"] = dict(lanes=n, c=c, same_affine=same, call_ms=call_ms,
                                            host_conversion_ms=conv_ms)
            log(f"  msm() {grp.name}: {n} lanes from host lists, c {c}: == host sum in affine: "
                f"{same}; {call_ms:.1f} ms on the host clock, of which the host conversions "
                f"take about {conv_ms:.1f} ms")
    log("  launches of the driven MSMs and msm() calls: "
        + json.dumps({k: v for k, v in launched.items() if v}))
    return ok, out


def _plain_pair(x, dom, spec):
    """The forward and the inverse transform of x through the plain stages
    (ntt_stage_n_plain) on x's device: what ntt_dit and intt_dif give."""
    from icicle_snark_tpu_torch.ops import ntt as ntt_ops

    f, i = x, x
    for s in range(1, dom.log_n + 1):
        f = ntt_ops.ntt_stage_n_plain(f, dom.stw_fwd, 1 << s, False, spec)
    for s in range(dom.log_n, 0, -1):
        i = ntt_ops.ntt_stage_n_plain(i, dom.stw_inv, 1 << s, True, spec,
                                      dom.n_inv_mont if s == 1 else None)
    return f, i


def _pass_plain_pair(x, dom, spec):
    """The same pair through the plain passes (ntt_block_n_plain), pass by
    pass as K14's passes run it."""
    from icicle_snark_tpu_torch.ops import ntt as ntt_ops

    passes = ntt_ops.ntt_n_passes(dom.log_n)
    f, i = x, x
    for low, k, _ in passes:
        f = ntt_ops.ntt_block_n_plain(f, dom.stw_fwd, low, k, False, spec)
    for low, k, _ in reversed(passes):
        i = ntt_ops.ntt_block_n_plain(i, dom.stw_inv, low, k, True, spec,
                                      dom.n_inv_mont if low == 0 else None)
    return f, i


# K14's passes timed at these (tile, fewest columns) logs beside the default
NTT_N_TILES = ((10, 4), (10, 5), (11, 5))


def check_ntt_n(rep, gen, dev, counts_log, log_n: int = 22, plain_log: int = 12) -> tuple:
    """K14 for the three Fr: the transform pair through the tile passes (the
    default from NTT_BLOCK_MIN_LOG up) against the register passes (K3's
    template at N words, `ntt_radix_n`: the constant patched past the
    domain), the one-stage entry (`ntt_stage_n`, a launch a stage), the
    plain stages and the plain passes, word for word, at 2^plain_log (batch
    2) and at 2^log_n (the plain versions run on the card); at 2^4 against a
    host DFT; then driven at 2^log_n: forward then inverse = identity, and
    `ntt(x, spec=fr, cfg=NTTConfig(coset_gen))` forward then inverse =
    identity, on the tile passes, the round trip once more on the register
    passes, and at 2^plain_log on the one-stage entry; the routes' pairs
    timed at 2^log_n beside the bound, the tile passes at the tiles of
    NTT_N_TILES and the register passes at every R
    (`radix_sweep`). The domains' power tables and the coset products run
    on K12. Only the driven calls are counted (`counted`)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.config import NTTConfig
    from icicle_snark_tpu_torch.curves import device as cdev
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import ntt as ntt_ops

    def radix_route():
        return patched((ntt_ops, "NTT_BLOCK_MIN_LOG", 99))

    def pair(x, dom):
        return ntt_ops.ntt_dit(x, dom), ntt_ops.intt_dif(x, dom)

    def same(a, b):
        return all(bool(torch.equal(u, v)) for u, v in zip(a, b))

    ok, out = True, {}
    launched = counts_log["curves: NTTs"] = {}
    launched_radix = counts_log["curves: NTTs, register-pass route"] = {}
    launched_stage = counts_log["curves: NTTs, one-stage entry"] = {}
    for name in CURVES:
        fr = cdev.curve_specs(name)[1]
        w = fr.words
        passes = ntt_ops.ntt_n_passes(log_n)
        tile = ntt_ops.NTT_N_TILE_LOG
        r = ntt_ops.NTT_RADIX_LOG[w]
        rpasses = ntt_ops.radix_passes(log_n, r)
        mode = "lazy in [0, 2p)" if ntt_ops.block_n_lazy(fr) else "canonical"
        # against the register passes, the one-stage entry and both plain
        # versions, batched; the one-stage entry driven as a round trip
        dom = ntt_ops.get_domain(plain_log, dev, fr)
        x = random_field_n(gen, fr, (2, 1 << plain_log), dev)
        got = pair(x, dom)
        with radix_route():
            staged = pair(x, dom)
        inv_s, fwd_s = one_stage_pair(x, dom)
        same_small = (same(got, staged) and same(got, _plain_pair(x, dom, fr))
                      and same(got, _pass_plain_pair(x, dom, fr))
                      and torch.equal(inv_s, got[1]))
        back = counted(launched_stage, lambda: one_stage_pair(x, dom)[1])
        same_stage_trip = bool(torch.equal(back, x) and torch.equal(fwd_s, x))
        del x, got, staged, inv_s, fwd_s, back
        # against a host DFT at 2^4
        d4 = ntt_ops.get_domain(4, dev, fr)
        x4 = random_field_n(gen, fr, (1, 16), dev)
        vals = [v * fr.rinv % fr.modulus for v in lb.limbs_to_ints(x4[0])]
        y4 = [v * fr.rinv % fr.modulus for v in lb.limbs_to_ints(ntt_ops.ntt_natural(x4, d4)[0])]
        same_dft = y4 == [sum(vals[j] * pow(d4.w, i * j, fr.modulus) for j in range(16))
                          % fr.modulus for i in range(16)]
        # users' size: the same, the plain versions on the same input
        big = ntt_ops.get_domain(log_n, dev, fr)
        xb = random_field_n(gen, fr, (1, 1 << log_n), dev)
        got = pair(xb, big)
        with radix_route():
            staged = pair(xb, big)
        same_radix = same(got, staged)
        del staged
        same_stage = bool(torch.equal(one_stage_pair(xb, big)[0], got[1]))
        plain, plain_ms = timed_once(lambda: _plain_pair(xb, big, fr))
        same_big = same_radix and same_stage and same(got, plain)
        del plain
        plain, pass_plain_ms = timed_once(lambda: _pass_plain_pair(xb, big, fr))
        same_big &= same(got, plain)
        del plain
        torch.cuda.empty_cache()
        # the driven calls: the round trip and a coset on the tile passes, the
        # round trip on the register passes
        back = counted(launched, lambda: ntt_ops.ntt_natural(ntt_ops.ntt_natural(xb, big), big,
                                                             inverse=True))
        same_trip = bool(torch.equal(back, xb))
        cfg = NTTConfig(coset_gen=5)
        coset = counted(launched, lambda: ntt_ops.ntt(ntt_ops.ntt(xb[0], cfg=cfg, spec=fr),
                                                      inverse=True, cfg=cfg, spec=fr))
        same_coset = bool(torch.equal(coset, xb[0]))
        with radix_route():
            back = counted(launched_radix, lambda: ntt_ops.ntt_natural(
                ntt_ops.ntt_natural(xb, big), big, inverse=True))
        same_trip &= bool(torch.equal(back, xb))
        del back, coset
        pair_ms = cuda_time(lambda: pair(xb, big), 5)
        with radix_route():
            radix_ms = cuda_time(lambda: pair(xb, big), 5)
        stage_ms = cuda_time(lambda: one_stage_pair(xb, big), 5)
        # every R, on radix_pair's (inverse, then forward) order
        sweep = radix_sweep(xb, big, (got[1], xb))
        same_big &= all(v["equal"] for v in sweep.values())
        tiles = {}
        for t, c in NTT_N_TILES:
            with patched((ntt_ops, "NTT_N_TILE_LOG", t), (ntt_ops, "NTT_N_TILE_MIN_COLS_LOG", c)):
                count = len(ntt_ops.ntt_n_passes(log_n))
                equal = same(pair(xb, big), got)
                tiles[f"tile 2^{t}, columns >= 2^{c}"] = dict(
                    passes=count, equal=equal, ms=cuda_time(lambda: pair(xb, big), 5))
            same_big &= equal
        del got
        n = 1 << log_n
        mp = muls_per_product(w)
        # per transform: n/2 log n products, n more in the scaled inverse stage;
        # the values in and out once, the twiddles once
        pair_b = bound(2 * (2 * n * 4 * w + n * 4 * w),
                       (n * log_n + n) * mp)
        del xb
        ntt_ops.release_domain(log_n, dev)
        torch.cuda.empty_cache()
        fine = same_small and same_big and same_dft and same_trip and same_coset and \
            same_stage_trip
        ok &= fine
        out[fr.name] = dict(words=w, equal_to_plain=same_small and same_big,
                            equal_to_plain_small=same_small, equal_to_radix_route=same_radix,
                            equal_to_stage_entry=same_stage, dft=same_dft, round_trip=same_trip,
                            stage_entry_round_trip=same_stage_trip, coset_round_trip=same_coset,
                            pair_ms=pair_ms, radix_pair_ms=radix_ms, stage_pair_ms=stage_ms,
                            bound_ms=pair_b[0], bound_by=pair_b[1], plain_pair_ms=plain_ms,
                            pass_plain_pair_ms=pass_plain_ms, log_n=log_n, plain_log_n=plain_log,
                            passes=passes, tile_log=tile, arithmetic=mode, tiles=tiles,
                            radix_log=r, radix_passes=rpasses, radix_sweep=sweep,
                            radix_build=radix_build(fr, r),
                            stage_build=radix_build(fr, 1))
        log(f"  ntt_block_n {fr.name} ({w} words, {mode}): passes {passes} at 2^{log_n}, tile "
            f"2^{tile}; pair == register passes == one-stage entry == plain stages == plain "
            f"passes word for word at 2^{plain_log} (batch 2): {same_small}, at 2^{log_n}: "
            f"{same_big}; 2^4 == host DFT: {same_dft}; 2^{log_n} round trip (both routes): "
            f"{same_trip}, coset round trip: {same_coset}, one-stage entry round trip at "
            f"2^{plain_log}: {same_stage_trip}; pair at 2^{log_n}: tile passes {pair_ms:.3f} ms "
            f"({2 * len(passes)} launches), register passes R {r} {radix_ms:.3f} ms "
            f"({2 * len(rpasses)} launches), one-stage entry {stage_ms:.3f} ms ({2 * log_n} "
            f"launches), bound {pair_b[0]:.3f} ({pair_b[1]}); plain pair {plain_ms:.0f} ms "
            f"(stages), {pass_plain_ms:.0f} ms (passes); tiles " + json.dumps(tiles))
        log(f"  ntt_radix_n {fr.name} sweep at 2^{log_n}: " + json.dumps(sweep))
    log("  launches of the driven NTT calls: tile passes "
        + json.dumps({k: v for k, v in launched.items() if v}) + "; register passes "
        + json.dumps({k: v for k, v in launched_radix.items() if v}) + "; one-stage entry "
        + json.dumps({k: v for k, v in launched_stage.items() if v}))
    last = out[cdev.curve_specs(CURVES[-1])[1].name]
    common = dict(equal_to_plain=ok, max_abs_err=0.0 if ok else 1.0, bound_ms=last["bound_ms"],
                  bound_by=last["bound_by"], by_field=out)
    rep.add(kernels.NTT_BLOCK_N.name, ms=last["pair_ms"], plain_ms=last["pass_plain_pair_ms"],
            build=kernel_usage("ntt_block_n.cu", ""),
            timed=f"bw6_761_fr forward + inverse over 2^{log_n} on the passes (plain passes on "
                  f"the card at the same size); every Fr under by_field", **common)
    rep.add(kernels.NTT_RADIX_N.name, ms=last["radix_pair_ms"], plain_ms=last["plain_pair_ms"],
            build=last["radix_build"],
            timed=f"bw6_761_fr forward + inverse over 2^{log_n} on the register passes, R "
                  f"{last['radix_log']} (plain stages on the card at the same size); every Fr "
                  "under by_field", **common)
    rep.add(kernels.NTT_N.name, ms=last["stage_pair_ms"], plain_ms=last["plain_pair_ms"],
            build=last["stage_build"],
            timed=f"bw6_761_fr inverse then forward over 2^{log_n} on the one-stage entry (plain "
                  f"stages on the card at the same size); every Fr under by_field", **common)
    return ok, out


def check_field_pow_n(rep, gen, dev, lanes=None, n_plain: int = 1 << 12) -> tuple:
    """K16 against its plain version word for word on the five fields: the
    inverse (a^(p-2); 0, 1 and p - 1 among the inputs) over POW_N_LANES
    lanes, the plain version on the first n_plain; the exponents 0, 1, 2
    and 5 on 256 lanes, and (p - 2) + (p - 1) 2^800, wider than the
    kernel's 768 bits (fields/limbs.py kernel_exponent reduces it to p - 2),
    against the plain inverse; div(x, a) against x times the plain inverse
    on n_plain lanes. The inverse timed beside its bound."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import vec_ops as vo

    lanes = lanes or POW_N_LANES
    ok, worst, fields = True, 0.0, {}
    for spec in kernel_field_specs():
        w, p = spec.words, spec.modulus
        n = lanes[w]
        a = random_field_n(gen, spec, (n,), dev)
        got = lb.mont_inv(a, spec)
        want, plain_ms = timed_once(lambda: lb.field_pow_plain(a[:, :n_plain].contiguous(),
                                                              p - 2, spec))
        err = max_word_err(got[:, :n_plain], want)
        zero_ok = bool(lb.is_zero(got[:, :1]).all())
        m = min(256, n_plain)
        sub = a[:, :m].contiguous()
        err_e = max(max_word_err(lb.mont_pow_const(sub, e, spec), lb.field_pow_plain(sub, e, spec))
                    for e in (0, 1, 2, 5))
        wide = (p - 2) + ((p - 1) << 800)
        err_e = max(err_e, max_word_err(lb.mont_pow_const(sub, wide, spec), want[:, :m]))
        x = random_field_n(gen, spec, (n_plain,), dev)
        # a holds 0 in lane 0: x / 0 = 0
        err_div = max_word_err(vo.div(x, a[:, :n_plain].contiguous(), spec),
                               lb.field_op_plain(lb.OP_MUL, x, want, spec))
        ms = cuda_time(lambda: lb.mont_inv(a, spec), 3)
        # square-and-multiply from the top bit, the first square (of one) left out
        steps = (p - 2).bit_length() + bin(p - 2).count("1") - 1
        bms, by = bound(n * 8 * w, n * steps * muls_per_product(w))
        fine = err == 0 and err_e == 0 and err_div == 0 and zero_ok
        ok &= fine
        worst = max(worst, err, err_e, err_div)
        fields[spec.name] = dict(words=w, lanes=n, plain_lanes=n_plain, equal_to_plain=fine,
                                 inv_ms=ms, bound_ms=bms, bound_by=by, plain_ms=plain_ms,
                                 products=steps)
        log(f"  field_pow_n {spec.name} ({w} words): inverse over {n} lanes max word err {err} "
            f"(plain on {n_plain}), inv(0) = 0 {zero_ok}; exponents 0, 1, 2, 5, (p - 2) + (p - 1) "
            f"2^800 on {m} lanes: max word err {err_e}; div on {n_plain}: max word err {err_div}; "
            f"inverse {ms:.3f} ms (bound {bms:.3f}, {by}: {steps} products a lane), plain "
            f"{plain_ms:.0f} ms on {n_plain} lanes")
        del a, got, want, x
        torch.cuda.empty_cache()
    widest = fields[kernel_field_specs()[-1].name]
    usage = kernel_usage("field_pow_n.cu", "")
    log(f"  field_pow_n build: {usage}")
    rep.add(kernels.FIELD_POW_N.name, equal_to_plain=ok, max_abs_err=worst,
            ms=widest["inv_ms"], plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"],
            bound_by=widest["bound_by"], build=usage, by_field=fields,
            timed=f"bw6_761_fq inverse (vec_ops.inv) over {widest['lanes']} lanes (plain on "
                  f"{widest['plain_lanes']}); every field under by_field")
    return ok, fields


def check_field_reduce_n(rep, gen, dev, n: int = 1 << 24) -> tuple:
    """K17 against its plain version word for word: the sum over one row of
    n at the five fields and the product at the two 8-word Fr, then on an
    odd row (n - 3), n = 1, a (2, 3, 4097) batch and rows of p - 1 only;
    the row of n timed beside its bound."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import vec_ops as vo

    ok, worst, fields = True, 0.0, {}
    for spec in kernel_field_specs():
        w = spec.words
        ops = (0, 1) if w == lb.NLIMB else (0,)
        full = random_field_n(gen, spec, (n,), dev)
        top = lb.const(spec.modulus - 1, dev, 5000, w)
        cases = [("row of n", full), ("odd row", full[:, 3:].contiguous()),
                 ("n = 1", full[:, :1].contiguous()),
                 ("2-D batch", random_field_n(gen, spec, (2, 3, 4097), dev)),
                 ("p - 1 only", torch.stack([top, top]))]
        reading = {}
        for op in ops:
            name = "product" if op else "sum"
            for label, v in cases:
                got = vo.field_reduce(op, v, spec)
                want, ms_p = timed_once(lambda: vo.field_reduce_plain(op, v, spec))
                err = max_word_err(got, want)
                worst = max(worst, err)
                ok &= err == 0 and got.shape == v.shape[:-1] + (1,)
                if label == "row of n":
                    reading[f"{name}_err"] = err
                    reading[f"{name}_plain_ms"] = ms_p
                    want_row = want
            ms = cuda_time(lambda: vo.field_reduce(op, full, spec), 10)
            b = bound(n * 4 * w + 4 * w, (n - 1) * muls_per_product(w) if op else 0)
            reading.update({f"{name}_ms": ms, f"{name}_bound_ms": b[0],
                            f"{name}_bound_by": b[1]})
            swept = ""
            if op:
                equal, reading["product_sweep_ms"] = product_sweep(full, spec, want_row)
                ok &= equal
                reading["product_grid"] = product_grid(n, dev)
                swept = (f"; product grid: {reading['product_grid']}; swept (each equal: "
                         f"{equal}): " + json.dumps(reading["product_sweep_ms"]))
            log(f"  field_reduce_n {spec.name} ({w} words) {name}: max word err "
                f"{reading[f'{name}_err']} over a row of {n} (and on the odd row, n = 1, the "
                f"batch, p - 1 only: max {worst}); {ms:.4f} ms (bound {b[0]:.4f}, {b[1]}), "
                f"plain {reading[f'{name}_plain_ms']:.1f} ms" + swept)
        fields[spec.name] = dict(words=w, n=n, **reading)
        del full, cases
        torch.cuda.empty_cache()
    head = fields[kernel_field_specs()[2].name]  # bls12-381 Fr: both ops
    usage = kernel_usage("field_reduce_n.cu", "")
    log(f"  field_reduce_n build: {usage}")
    rep.add(kernels.FIELD_REDUCE_N.name, equal_to_plain=ok, max_abs_err=worst,
            ms=head["sum_ms"] + head["product_ms"],
            plain_ms=head["sum_plain_ms"] + head["product_plain_ms"],
            bound_ms=head["sum_bound_ms"] + head["product_bound_ms"],
            bound_by=head["product_bound_by"], build=usage, by_field=fields,
            timed=f"bls12_381_fr sum_reduce + product_reduce over one row of {n}; every field "
                  f"(the sum at 12 and 24 words) under by_field")
    return ok, fields


def drive_curve_vec_ops(gen, dev, counts_log, lanes=None) -> tuple:
    """inv, div, sum_reduce and product_reduce over the five fields as a
    user calls them (ops/vec_ops.py with spec=), at POW_N_LANES elements,
    each held against a composition computed another way: div(a, a) == 1
    with div(0, 0) == 0, sum_reduce(a, neg(a)) == 0, and at 8 words
    product_reduce(v, inv(v)) == 1 (v without the zero). Only these calls
    are counted (`counted`)."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import vec_ops as vo

    lanes = lanes or POW_N_LANES
    launched = counts_log["curves: vec-ops"] = {}
    checks = {}
    for spec in kernel_field_specs():
        w, n = spec.words, lanes[spec.words]
        a = random_field_n(gen, spec, (n,), dev)
        one = lb.one_mont(spec, dev)
        q = counted(launched, lambda: vo.div(a, a, spec))
        checks[f"{spec.name} div(a, a) == 1, div(0, 0) == 0"] = bool(
            torch.equal(q[:, 1:], one.expand(w, n - 1)) and lb.is_zero(q[:, :1]).all())
        s = counted(launched, lambda: vo.sum_reduce(torch.cat([a, vo.neg(a, spec)], dim=-1),
                                                    spec))
        checks[f"{spec.name} sum_reduce(a, neg(a)) == 0"] = bool(lb.is_zero(s[:, None]).all())
        if w == lb.NLIMB:
            nz = a[:, 1:].contiguous()
            pr = counted(launched, lambda: vo.product_reduce(
                torch.cat([nz, vo.inv(nz, spec)], dim=-1), spec))
            checks[f"{spec.name} product_reduce(v, inv(v)) == 1"] = torch.equal(pr, one[:, 0])
        del a, q
        torch.cuda.empty_cache()
    for name, val in checks.items():
        if not val:
            log(f"  curves vec-ops FAILED: {name}")
    log(f"  curves vec-ops: {sum(checks.values())} of {len(checks)} checks hold; launches "
        + json.dumps({k: v for k, v in launched.items() if v}))
    return all(checks.values()), checks


def curves_phase(rep, rng, dev, counts_log, failures, small: bool = False) -> dict:
    """The other curves (bls12-377, bls12-381, bw6-761): K12, K13 and K14
    against their plain versions, then the MSMs, `msm()` and the NTTs driven
    at users' sizes. `small` cuts every size for a rehearsal."""
    import torch

    from icicle_snark_tpu_torch import kernels

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    readings = {}
    t1 = time.perf_counter()
    ok, readings["field_vec_n"] = check_field_vec_n(
        rep, gen, dev, *((1 << 12, 1 << 8) if small else ()))
    if not ok:
        failures.append("kernel field_vec_n differs from its plain version")
    log(f"[kernels] field_vec_n checked in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    ok, readings["msm_n_plain"] = check_msm_n(gen, dev, *((256,) if small else ()))
    if not ok:
        failures.append("kernel msm_accumulate_n or msm_reduce_n differs from its plain version")
    log(f"[kernels] msm_accumulate_n and msm_reduce_n checked in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    small_sizes = {c: (1 << 10, 1 << 9) for c in CURVES}
    ok, readings["msm"] = drive_curve_msms(gen, rng, dev, counts_log,
                                           *((small_sizes, 1 << 8) if small else ()))
    if not ok:
        failures.append("a curve MSM differs from the host sum in affine form")
    log(f"[curves] MSMs and msm() in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    ok, readings["ntt"] = check_ntt_n(rep, gen, dev, counts_log, *((10, 6) if small else ()))
    if not ok:
        failures.append("a curve NTT differs from its plain versions, the other route, the DFT "
                        "or the identity")
    log(f"[kernels] ntt_block_n, ntt_radix_n, ntt_stage_n and the curve NTTs in "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    small_lanes = {8: 1 << 12, 12: 1 << 11, 24: 1 << 10}
    ok, readings["field_pow_n"] = check_field_pow_n(
        rep, gen, dev, *((small_lanes, 1 << 8) if small else ()))
    if not ok:
        failures.append("kernel field_pow_n differs from its plain version")
    ok, readings["field_reduce_n"] = check_field_reduce_n(
        rep, gen, dev, *((1 << 12,) if small else ()))
    if not ok:
        failures.append("kernel field_reduce_n differs from its plain version")
    ok, readings["vec_ops"] = drive_curve_vec_ops(gen, dev, counts_log,
                                                  small_lanes if small else None)
    if not ok:
        failures.append("a curve vec-op differs from its composition")
    log(f"[kernels] field_pow_n, field_reduce_n and the curves' vec-ops in "
        f"{time.perf_counter() - t1:.1f} s")
    # K13's rows: the six full-width MSMs summed, the plain versions at the
    # check's size (c = 8, random scalars)
    msms = [v for k, v in readings["msm"].items() if not k.endswith("msm()")]
    plains = [v for k, v in readings["msm_n_plain"].items() if k.endswith(" c 8")]
    same = all(v["equal_to_plain"] for v in readings["msm_n_plain"].values())
    # device ms by kernel over the six, K13's stages apart (torch.profiler)
    by_kernel = {}
    for v in msms:
        for name, ms in v["kernel_ms"].items():
            stage = name.split("<")[0]
            if "accumulate" in name:
                stage += " level 0" if name.rstrip("> ").endswith("true") else " folds"
            by_kernel[stage] = by_kernel.get(stage, 0.0) + ms
    for kern, key, pkey in ((kernels.MSM_ACCUMULATE_N, "accumulate", "acc_plain_ms"),
                            (kernels.MSM_REDUCE_N, "reduce", "reduce_plain_ms")):
        bnd = sum(v[f"{key}_bound_ms"] for v in msms)
        rep.add(kern.name, equal_to_plain=same, max_abs_err=0.0 if same else 1.0,
                ms=sum(v[f"{key}_ms"] for v in msms), plain_ms=sum(v[pkey] for v in plains),
                bound_ms=bnd, bound_by="operations",
                stages_ms={k: v for k, v in by_kernel.items() if key in k},
                timed="the six full-width MSMs summed (plain versions: the six at "
                      f"{256 if small else 1 << 12} lanes, c 8)")
    log("[curves] K13 device ms by stage over the six MSMs: " + json.dumps(by_kernel))
    for path, names in (("curves: MSMs and msm()", ("msm_accumulate_n", "msm_reduce_n")),
                        ("curves: NTTs", ("ntt_block_n", "field_vec_n")),
                        ("curves: NTTs, register-pass route", ("ntt_radix_n",)),
                        ("curves: NTTs, one-stage entry", ("ntt_stage_n",)),
                        ("curves: vec-ops", ("field_pow_n", "field_reduce_n"))):
        for k in names:
            if not counts_log.get(path, {}).get(k):
                failures.append(f"{path} did not launch {k}")
    readings["phase_s"] = time.perf_counter() - t0
    return readings


# ---------------------------------------------------------------- phase 11

MESH_SIZES = (2, 4, 8)
# the kernels every sharded prove of the phase must launch
SHARDED_KERNELS = ("four_step_twiddle", "ntt_block", "r1cs_rows", "msm_accumulate",
                   "msm_reduce", "point_add", "field_vec")


def check_four_step(rep, rng, dev, cases) -> bool:
    """K15 against its plain version on the card, word for word, at every
    shape of the sharded coset evaluation: for each (log_n, d) of `cases`,
    one shard's (3, n2/d, 8, n1) with the factors of split_logs (the
    inverse pass's orientation) and swapped (the forward pass's), each
    forward and inverse, on the first and the last shard; inputs hold 0, 1
    and r - 1. Timed (CUDA events) at each case's inverse pass, beside its
    bound, and there swept over the tiles (ntt_dist.FOUR_STEP_TILES), each
    held against the plain words too; the row's ms and plain ms are those of
    the first case. A tree without the tiles (an earlier one) runs its one
    kernel."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.parallel import ntt_dist

    tiles = getattr(ntt_dist, "FOUR_STEP_TILES", None)
    ok, err, timed = True, 0.0, []
    for log_n, d in cases:
        log_n1, log_n2 = ntt_dist.split_logs(log_n, d)
        flat = random_field(rng, lb.FR_SPEC.modulus, (3 * (1 << log_n) // d,), dev)
        for l1, l2 in ((log_n1, log_n2), (log_n2, log_n1)):
            n1, n2 = 1 << l1, 1 << l2
            x = flat.reshape(8, 3, n2 // d, n1).permute(1, 2, 0, 3).contiguous()
            for inverse in (False, True):
                tables = ntt_dist.twiddle_tables(log_n, dev, inverse)
                for shard in (0, d - 1):
                    got = ntt_dist.four_step_twiddle(x, tables, shard, d)
                    want = ntt_dist.four_step_twiddle_plain(x, tables, shard, d)
                    torch.cuda.synchronize()
                    err = max(err, max_word_err(got, want))
                    ok &= torch.equal(got, want)
        n1, n2 = 1 << log_n1, 1 << log_n2
        x = flat.reshape(8, 3, n2 // d, n1).permute(1, 2, 0, 3).contiguous()
        tables = ntt_dist.twiddle_tables(log_n, dev, True)
        ms = cuda_time(lambda: ntt_dist.four_step_twiddle(x, tables, d - 1, d), 20)
        # one product an element, one a twiddle (shared by the 3 rows); the
        # element read and written once, the two power tables read once
        lanes = x.numel() // 8
        bnd, by = bound(2 * 32 * lanes + 32 * (tables[0].numel() + tables[1].numel()) // 8,
                        MULS_PER_MONT * (lanes + lanes // 3))
        sweep = {}
        if tiles:
            want = ntt_dist.four_step_twiddle_plain(x, tables, d - 1, d)
            for tile in tiles:
                with patched((ntt_dist, "FOUR_STEP_TILE", tile)):
                    same = torch.equal(ntt_dist.four_step_twiddle(x, tables, d - 1, d), want)
                    ok &= same
                    sweep[f"{tile[0]}x{tile[1]}"] = (
                        cuda_time(lambda: ntt_dist.four_step_twiddle(x, tables, d - 1, d), 20)
                        if same else None)
            log(f"  four_step_twiddle tile sweep (k1 x i2), ms: "
                + json.dumps({k: None if v is None else round(v, 5) for k, v in sweep.items()}))
        timed.append({"log_n": log_n, "d": d, "shape": list(x.shape), "ms": ms,
                      "bound_ms": bnd, "bound_by": by, "sweep_ms": sweep})
        if len(timed) == 1:
            plain_ms = cuda_time(lambda: ntt_dist.four_step_twiddle_plain(x, tables, d - 1, d), 2)
            main = {"ms": ms, "bound_ms": bnd, "bound_by": by, "plain_ms": plain_ms,
                    "timed": f"the inverse twiddle pass of one shard, {tuple(x.shape)}: 2^{log_n}"
                             f" over {d} shards"}
        log(f"[kernels] four_step_twiddle 2^{log_n} over {d}, {tuple(x.shape)}: {ms:.4f} ms "
            f"(bound {bnd:.4f} ms, {by}, {ms / bnd:.2f}x)")
    usage = kernel_usage("four_step.cu", "")
    rep.add("four_step_twiddle", equal_to_plain=ok, max_abs_err=err, shapes=timed, build=usage,
            **main)
    log(f"[kernels] four_step_twiddle: equal to plain {ok} at {len(cases)} x 2 orientations x 2 "
        f"directions x 2 shards; plain {main['plain_ms']:.2f} ms at the first; {usage}")
    return ok


def _sharded_prove(tag, mesh, cache, wtns, single, counts_log, failures) -> dict:
    """One deterministic sharded prove, counted alone (the per-mesh state
    built before it), that must equal the single-device proof; then one
    randomized sharded prove, timed by phase, whose files are returned for
    the caller to verify."""
    import torch

    from icicle_snark_tpu_torch.ops import msm as msm_ops
    from icicle_snark_tpu_torch.parallel import prove_step
    from icicle_snark_tpu_torch.prover import pipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prove_step.pad_cache_for_mesh(cache, mesh)
    torch.cuda.synchronize()
    parts_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    got = counted(counts_log.setdefault(tag, {}),
                  lambda: prove_step.prove_multichip(mesh, wtns, cache, deterministic=True))
    same = got == single
    if not same:
        failures.append(f"{tag}: the sharded proof differs from the single-device proof")
    for k in SHARDED_KERNELS:
        if not counts_log[tag].get(k):
            failures.append(f"{tag} did not launch {k}")
    # phase C's combine: one K6 launch for G1 and one for G2 at every D (a
    # tree with the one-launch sum)
    if hasattr(msm_ops, "sum_windows") and counts_log[tag].get("point_add") != 2:
        failures.append(f"{tag} launched K6 {counts_log[tag].get('point_add')} times, not 2")
    timer = pipeline.PhaseTimer(mesh.local_devices[0])
    t0 = time.perf_counter()
    proof, public = prove_step.prove_multichip(mesh, wtns, cache, timer=timer)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    host = sum(v for k, v in timer.phases.items() if not k.startswith("phase_"))
    out = {"mesh_parts_s": parts_s, "same_as_single": same, "prove_s": secs,
           "phases_s": timer.phases, "host_s": host, "peak_gb": peak,
           "launches": counts_log[tag], "proof": proof, "public": public}
    log(f"[multichip] {tag}: byte-identical to the single-device proof {same}; randomized "
        f"prove {secs:.3f} s, phases " + json.dumps({k: round(v, 4) for k, v in
                                                     timer.phases.items()})
        + f", host {host:.4f} s, peak {peak:.2f} GB, per-mesh state {parts_s:.2f} s; launches "
        + json.dumps({k: v for k, v in counts_log[tag].items() if v}))
    return out


def _verifies(result, directory, vk) -> bool:
    from icicle_snark_tpu_torch.prover import api

    proof_path, public_path = (os.path.join(directory, f) for f in ("mc_proof.json",
                                                                     "mc_public.json"))
    with open(proof_path, "w") as fh:
        json.dump(result.pop("proof"), fh)
    with open(public_path, "w") as fh:
        json.dump(result.pop("public"), fh)
    return api.groth16_verify(proof_path, public_path, vk)


def multichip_phase(rep, rng, dev, big, cache_big, small, counts_log, failures) -> dict:
    """The sharded prove (parallel/) on meshes of this one card repeated:
    K15 against its plain version; complex-M through `prove_multichip` at
    D = 2, 4 and 8 and complex-N at D = 8, each deterministic proof equal
    to the single-device proof and each randomized one verified; one
    process over NCCL at world size 1 holding two shards (the collectives
    of torch.distributed). The shards of one card run one after another,
    so the times measure the sharding's overhead, not scaling."""
    import socket

    import torch
    import torch.distributed as dist

    from icicle_snark_tpu_torch.parallel import mesh as pmesh
    from icicle_snark_tpu_torch.prover import pipeline
    from icicle_snark_tpu_torch.prover.cache import load_zkey_cache

    t0 = time.perf_counter()
    readings = {}
    if dev.type == "cuda":  # the mesh names each shard's card by its index
        dev = torch.device("cuda", torch.cuda.current_device())
    cache_small = load_zkey_cache(small["zkey"], dev)
    # every shape the phase's proves give K15, the one timed first at D = 4
    cases = [(cache_big.header.power, d) for d in sorted(MESH_SIZES, key=lambda d: d != 4)]
    if not check_four_step(rep, rng, dev, cases + [(cache_small.header.power, 8)]):
        failures.append("kernel four_step_twiddle differs from its plain version")
    single_big = pipeline.prove(big["wtns"], cache_big, deterministic=True)
    timer = pipeline.PhaseTimer(dev)  # a warm randomized single-device prove, for comparison
    pipeline.prove(big["wtns"], cache_big, timer=timer)
    readings["single_device_phases_s"] = timer.phases
    log("[multichip] single-device prove, warm: phases "
        + json.dumps({k: round(v, 4) for k, v in timer.phases.items()}))
    runs = [(f"complex-{cache_big.header.n_vars - 3} D={d}", [dev] * d, cache_big, big,
             single_big) for d in MESH_SIZES]
    single_small = pipeline.prove(small["wtns"], cache_small, deterministic=True)
    runs.append((f"complex-{cache_small.header.n_vars - 3} D=8", [dev] * 8, cache_small, small,
                 single_small))
    for tag, devices, cache, paths, single in runs:
        res = _sharded_prove(f"multichip {tag}", pmesh.make_mesh(devices), cache, paths["wtns"],
                             single, counts_log, failures)
        res["verifies"] = _verifies(res, os.path.dirname(paths["zkey"]), paths["vk"])
        if not res["verifies"]:
            failures.append(f"multichip {tag}: the randomized sharded proof does not verify")
        readings[tag] = res
        cache.mesh_parts.clear()
        torch.cuda.empty_cache()
    del cache_small
    # one process over NCCL, world size 1, two shards on the card
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": "0", "WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh = pmesh.make_mesh([dev, dev])
        if not (mesh.distributed and dist.get_backend() == "nccl"):
            failures.append("the NCCL mesh did not join a torch.distributed group")
        tag = f"complex-{cache_big.header.n_vars - 3} D=2 over NCCL"
        res = _sharded_prove(f"multichip {tag}", mesh, cache_big, big["wtns"], single_big,
                             counts_log, failures)
        res["verifies"] = _verifies(res, os.path.dirname(big["zkey"]), big["vk"])
        if not res["verifies"]:
            failures.append(f"multichip {tag}: the randomized sharded proof does not verify")
        readings[tag] = res
        cache_big.mesh_parts.clear()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    readings["phase_s"] = time.perf_counter() - t0
    log(f"[multichip] phase in {readings['phase_s']:.1f} s (the shards of one card run one "
        "after another: the times are the sharding's overhead, not scaling)")
    return readings


# ---------------------------------------------------------------- profile

# the device functions of each kernel of kernels.ALL
KERNEL_FUNCTIONS = {
    "field_vec": ("field_vec_kernel",), "r1cs_rows": ("r1cs_rows_kernel", "r1cs_fold_kernel"),
    "ntt_stage": ("ntt_stage_kernel<RadixFr",), "msm_accumulate": ("msm_accumulate_kernel",),
    "msm_reduce": ("msm_reduce_segments_kernel", "msm_reduce_rows_kernel"),
    "ntt_block": ("ntt_block_kernel",),
    "point_add": ("point_sum_kernel",),
    "point_dbl_k": ("point_dbl_k_kernel", "point_dbl_k_pair_kernel"),
    "point_to_affine": ("point_to_affine_kernel",),
    "probe_chain": ("probe_chain_kernel",), "field_pow": ("field_pow_kernel",),
    "field_reduce": ("field_reduce_kernel", "field_product_kernel"),
    "fixed_base_msm": ("fixed_base_kernel", "fixed_base_g1_kernel"),
    # ntt_stage_n launches the R = 1 kernel of ntt_radix_n: a profile cannot tell them apart
    "field_vec_n": ("field_vec_n_kernel",), "ntt_stage_n": ("ntt_radix_kernel<RadixN",),
    # K4's templates at the curves' types (csrc/curve_n.cuh EF<G>, EF2<G>),
    # the tree of csrc/msm_kernels_n.cuh
    "msm_accumulate_n": ("msm_accumulate_kernel<EF",),
    "msm_reduce_n": ("msm_reduce_segments_kernel<EF", "msm_n_reduce_tree_kernel"),
    "four_step_twiddle": ("four_step_twiddle_kernel",),
    "field_pow_n": ("field_pow_n_kernel",),
    "field_reduce_n": ("field_reduce_n_kernel", "field_product_n_kernel"),
    "ntt_block_n": ("ntt_block_n_kernel",),
    "ntt_radix": ("ntt_radix_kernel<RadixFr",), "ntt_radix_n": ("ntt_radix_kernel<RadixN",),
    "witness_limbs": ("witness_limbs_kernel",),
    # cub's radix sort kernels, which csrc/msm_sort.cu puts in the namespace msm_sort
    "msm_sort_keys": ("msm_sort_keys_kernel",), "msm_sort": ("msm_sort::cub",),
}
KERNEL_NAMES = tuple(f for fs in KERNEL_FUNCTIONS.values() for f in fs)


def profile_prove(paths, cm) -> dict:
    """One warm deterministic prove under torch.profiler: device time per
    kernel (ms, summed over launches), the other device work, the wall
    time and the device's idle share of it; with what the trace held and
    the port's kernels that launched but left no device record there."""
    from icicle_snark_tpu_torch.prover import api

    from icicle_snark_tpu_torch import kernels

    kernels.reset_counts()
    per, other, wall_ms, seen = kernel_device_ms(
        lambda: api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"],
                                  cm, deterministic=True),
        lambda name: any(k in name for k in KERNEL_NAMES))
    busy = sum(per.values()) + other
    # every kernel the port launched must have left a device record
    missing = [k.name for k in kernels.ALL if k.launches
               and not any(f in name for f in KERNEL_FUNCTIONS[k.name] for name in per)]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "kernels_ms": per,
            "other_device_ms": other, "port_launches": sum(kernels.counts().values()),
            "trace": seen, "missing_kernels": missing,
            "idle_share": None if busy == 0 else 1.0 - busy / wall_ms}


# ---------------------------------------------------------------- fixtures

def make_fixture(directory: str, n_constraints: int, device, timer=None, circuit=None):
    """The complex-N fixture (zkey by the port's device setup, vk,
    witness), or the fixture of `circuit`, an (R1CS, witness) pair, made
    unless the directory holds it; `timer` (a pipeline.PhaseTimer) takes
    the setup's phases. Returns (R1CS, paths)."""
    from icicle_snark_tpu_torch.io.wtns import write_wtns
    from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device
    from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness

    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, f) for k, f in (
        ("zkey", "circuit_final.zkey"), ("vk", "verification_key.json"),
        ("wtns", "witness.wtns"), ("proof", "proof.json"), ("public", "public.json"))}
    r1cs, witness = circuit or (complex_circuit(n_constraints, n_constraints), None)
    if not (os.path.exists(paths["zkey"]) and os.path.exists(paths["vk"])
            and os.path.exists(paths["wtns"])):
        # no timer argument unless asked: --bits-only and --r1cs-only run in earlier trees
        groth16_setup_device(r1cs, paths["zkey"], paths["vk"], device=device,
                             **({} if timer is None else {"timer": timer}))
        write_wtns(paths["wtns"], complex_circuit_witness(r1cs, a=7) if witness is None
                   else witness)
    return r1cs, paths


def drive_setup(tag, directory, n_constraints, dev, counts_log, failures, circuit=None) -> dict:
    """make_fixture (of `circuit` when given) as a driven path: the device
    setup's phases (s) and launches (K11 for the fixed-base points, K7 for their affine form, K1
    never), g1_points and g2_points split into the device time of their K11
    and K7 calls (CUDA events around each call) and the host rest. When the
    directory holds the fixture already nothing runs."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.prover import pipeline
    from icicle_snark_tpu_torch.setup import fast_setup as fs

    spans = []

    def timed(kernel, fn, ops_of):
        def call(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((kernel, ops_of(args).g2, start, end))
            return out
        return call

    timer = pipeline.PhaseTimer(dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    with patched((fs, "fixed_base_msm", timed("fixed_base_msm", fs.fixed_base_msm,
                                              lambda a: a[2])),
                 (jc, "to_affine", timed("point_to_affine", jc.to_affine, lambda a: a[0]))):
        _, paths = make_fixture(directory, n_constraints, dev, timer, circuit)
    secs = time.perf_counter() - t0
    split = {}
    if timer.phases:
        counts_log[f"setup {tag}"] = kernels.counts()
        if counts_log[f"setup {tag}"]["fixed_base_msm"] == 0:
            failures.append(f"the setup of {tag} did not launch fixed_base_msm")
        if counts_log[f"setup {tag}"]["field_vec"]:
            failures.append(f"the setup of {tag} launched field_vec")
        torch.cuda.synchronize()
        for phase, g2 in (("g1_points", False), ("g2_points", True)):
            ms = {k: sum(s.elapsed_time(e) for name, is_g2, s, e in spans
                         if name == k and is_g2 == g2)
                  for k in ("fixed_base_msm", "point_to_affine")}
            chunks = sum(1 for name, is_g2, _, _ in spans
                         if name == "fixed_base_msm" and is_g2 == g2)
            split[phase] = {**{f"{k}_ms": v for k, v in ms.items()}, "chunks": chunks,
                            "host_s": timer.phases.get(phase, 0.0) - sum(ms.values()) / 1e3}
    log(f"[setup] {tag} fixture in {secs:.1f} s, phases "
        + json.dumps({k: round(v, 3) for k, v in timer.phases.items()}) + ", kernel / host "
        + json.dumps(split) + ", launches " + json.dumps(counts_log.get(f"setup {tag}")))
    return {"paths": paths, "s": secs, "phases": timer.phases, "split": split}


def setup_routes(args, dev) -> int:
    """--setup-only: the device setup at complex-N and complex-M timed by
    phase on both fixed-base routes, K11 and the plain scan over K1
    launches (the route before K11), in the order K1, K11 at N and K11, K1
    at M; the two routes' zkeys must be byte-identical."""
    from icicle_snark_tpu_torch.prover import pipeline
    from icicle_snark_tpu_torch.setup import fast_setup as fs
    from icicle_snark_tpu_torch.setup.r1cs import complex_circuit

    def k1_route(sc, table, ops, records=None):
        return fs.fixed_base_msm_plain(sc, table, ops)

    out, ok = {}, True
    for n, order in ((args.constraints, ("k1", "k11")), (args.large_constraints, ("k11", "k1"))):
        r1cs = complex_circuit(n, n)
        zkeys = {}
        for route in order:
            d = os.path.join(args.fixture_dir, f"setup_{route}_{n}")
            os.makedirs(d, exist_ok=True)
            zkeys[route] = os.path.join(d, "circuit_final.zkey")
            timer = pipeline.PhaseTimer(dev)
            t0 = time.perf_counter()
            with patched(*([(fs, "fixed_base_msm", k1_route)] if route == "k1" else [])):
                fs.groth16_setup_device(r1cs, zkeys[route], os.path.join(d, "vk.json"),
                                        device=dev, timer=timer)
            secs = time.perf_counter() - t0
            out[f"complex-{n} {route}"] = {"s": secs, "phases": timer.phases}
            log(f"[setup] complex-{n}, fixed base on {route}: {secs:.2f} s, phases "
                + json.dumps({k: round(v, 3) for k, v in timer.phases.items()}))
        same = filecmp.cmp(zkeys["k1"], zkeys["k11"], shallow=False)
        ok &= same
        log(f"[setup] complex-{n}: the two routes' zkeys are byte-identical: {same}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_setup_routes.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if ok else 1


def _prove_bytes(api, paths, cm, **kw):
    """One prove through the API; returns (seconds, proof.json bytes, public.json bytes)."""
    secs = api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"], cm, **kw)
    with open(paths["proof"], "rb") as fh:
        proof = fh.read()
    with open(paths["public"], "rb") as fh:
        public = fh.read()
    return secs, proof, public


def drive_proves(tag, paths, cm, dev, failures, counts_log):
    """First prove (deterministic, verified), three warm randomized proves
    with phases (the last verified), launch counts of the first warm one.
    Returns (first seconds, warm seconds, launches, deterministic proof
    bytes, the warm proves' phases)."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.prover import api, pipeline

    t0 = time.perf_counter()
    _, det, det_pub = _prove_bytes(api, paths, cm, deterministic=True,
                                   timer=pipeline.PhaseTimer(dev))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    log(f"[{tag}] first prove {first:.3f} s")
    if not api.groth16_verify(paths["proof"], paths["public"], paths["vk"]):
        failures.append(f"{tag}: deterministic proof does not verify")
    warm, launches, phases = [], None, []
    for i in range(3):
        timer = pipeline.PhaseTimer(dev)
        if i == 0:
            kernels.reset_counts()
        secs = api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"], cm,
                                 deterministic=False, timer=timer)
        if i == 0:
            launches = kernels.counts()
        warm.append(secs)
        phases.append(timer.phases)
        log(f"[{tag}] warm prove {i}: {secs:.3f} s, phases "
            + json.dumps({k: round(v, 4) for k, v in timer.phases.items()}))
    log(f"[{tag}] launches in one prove: {json.dumps(launches)}")
    counts_log[tag] = launches
    if not api.groth16_verify(paths["proof"], paths["public"], paths["vk"]):
        failures.append(f"{tag}: randomized proof does not verify")
    else:
        log(f"[{tag}] deterministic and randomized proofs verify")
    return first, warm, launches, (det, det_pub), phases


def time_r1cs_ntt(paths, cm, dev) -> dict:
    """construct_r1cs timed alone (CUDA events) with the fixture's witness,
    its launches, the bare K5 inverse + forward pair on the domain, and the
    r1cs_ntt phase of three warm randomized proves.
    Uses only entry points every slice of the port has had, so a copy of
    this script in an unpacked earlier tree measures that tree."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.io.wtns import WtnsFile
    from icicle_snark_tpu_torch.ops import ntt as ntt_ops
    from icicle_snark_tpu_torch.prover import api, pipeline

    cache = cm.get(paths["zkey"])
    w = lb.words_to_limbs(WtnsFile(paths["wtns"]).witness_limbs(), dev)
    ms = cuda_time(lambda: pipeline.construct_r1cs(w, cache), 10)
    kernels.reset_counts()
    pipeline.construct_r1cs(w, cache)
    torch.cuda.synchronize()
    out = {"construct_r1cs_ms": ms, "launches": {k: v for k, v in kernels.counts().items() if v},
           "r1cs_ntt_s": []}
    # the bare inverse + forward pair on a (3, 8, n) batch (check_ntt_block's timing)
    x = random_field(np.random.default_rng(1), lb.FR_SPEC.modulus, (3, cache.domain.n), dev)
    out["ntt_pair_ms"] = cuda_time(
        lambda: ntt_ops.ntt_dit(ntt_ops.intt_dif(x, cache.domain), cache.domain), 5)
    del x
    for _ in range(3):
        timer = pipeline.PhaseTimer(dev)
        api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"], cm,
                          deterministic=False, timer=timer)
        out["r1cs_ntt_s"].append(timer.phases["r1cs_ntt"])
    return out


def key_points(records, g2: bool) -> tuple:
    """The affine (x, y) limb-major points of a cache's K4 records (a
    cache of factor 1 keeps its bases as records alone)."""
    from icicle_snark_tpu_torch.ops import msm

    return tuple(t.contiguous() for t in msm._record_coords(records, g2))


def time_msm_plans(cache, paths, dev, g2_plans, g1_plans, reps: int = 3) -> dict:
    """The prove's own G2 and G1 MSMs (this witness's scalars) at the given
    (c, f) plans (c None: `choose_c` for that f): window sums only, CUDA
    events, bases precomputed beforehand. `cache` must hold f = 1 bases."""
    import torch

    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.io.wtns import WtnsFile
    from icicle_snark_tpu_torch.ops import msm
    from icicle_snark_tpu_torch.prover import pipeline

    witness = lb.words_to_limbs(WtnsFile(paths["wtns"]).witness_limbs(), dev)
    npub = cache.header.n_public
    h = pipeline.construct_r1cs(witness, cache)
    g1_scalars = torch.cat([witness, witness, witness[:, npub + 1:], h], dim=-1)
    n2 = witness.shape[-1]
    out = {}
    points_b2 = key_points(cache.b2_records, True)
    for c, f in g2_plans:
        c = c or msm.choose_c(n2, 1, f)
        pre = msm.point_records(msm.precompute_bases(points_b2, jc.G2, c, f))
        out[f"g2 c{c} f{f}"] = cuda_time(
            lambda: msm.msm_window_sums(witness, [n2], pre, c, f), reps)
        del pre
    del points_b2
    # the copies of a base sit beside it, so the groups precompute as one
    points_g1 = key_points(cache.g1_records, False)
    for c, f in g1_plans:
        c = c or msm.choose_c(sum(cache.g1_sizes), 4, f)
        pre = msm.point_records(msm.precompute_bases(points_g1, jc.G1, c, f))
        out[f"g1 c{c} f{f}"] = cuda_time(
            lambda: msm.msm_window_sums(g1_scalars, cache.g1_sizes, pre, c, f), reps)
        del pre
    for k, v in out.items():
        log(f"  msm window sums {k}: {v:.2f} ms")
    return out


POSEIDON_BITS_INPUTS = (3 ** 150 % (1 << 250), 7 ** 88 % (1 << 247))


def check_against_oracle(tag, directory, r1cs, witness, dev, counts_log, min_fold_levels=0):
    """A small circuit's zkey from the port's device setup against the host
    oracle's, byte for byte; its deterministic proof through the CLI worker
    on the card against the oracle's, byte for byte, and verified; then one
    deterministic prove through the API, a driven path whose K2 launches
    must show at least `min_fold_levels` fold levels. Returns ok."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.io.wtns import write_wtns
    from icicle_snark_tpu_torch.prover import api, pipeline
    from icicle_snark_tpu_torch.refmath import groth16 as oracle
    from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device
    from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup

    d = directory
    os.makedirs(d, exist_ok=True)
    groth16_setup(r1cs, os.path.join(d, "host.zkey"), os.path.join(d, "vk.json"))
    groth16_setup_device(r1cs, os.path.join(d, "dev.zkey"), device=dev)
    same_zkey = filecmp.cmp(os.path.join(d, "host.zkey"), os.path.join(d, "dev.zkey"),
                            shallow=False)
    write_wtns(os.path.join(d, "w.wtns"), witness)
    cmd = (f"prove --witness {d}/w.wtns --zkey {d}/dev.zkey --proof {d}/proof.json "
           f"--public {d}/public.json --device CUDA --deterministic 1\n"
           f"verify --proof {d}/proof.json --public {d}/public.json --vk {d}/vk.json\nexit\n")
    cli = subprocess.run([sys.executable, "-m", "icicle_snark_tpu_torch"], input=cmd, text=True,
                         capture_output=True, cwd=HERE, timeout=300)
    with open(os.path.join(d, "proof.json")) as fh:
        proof = json.load(fh)
    with open(os.path.join(d, "public.json")) as fh:
        public = json.load(fh)
    same_proof = (proof, public) == oracle.prove(os.path.join(d, "host.zkey"),
                                                 os.path.join(d, "w.wtns"), deterministic=True)
    cm = api.CacheManager("cuda")
    levels = len(pipeline.r1cs_fold_plan(cm.get(os.path.join(d, "dev.zkey")).plan,
                                         pipeline.R1CS_PIECE)[1])
    kernels.reset_counts()
    api.groth16_prove(os.path.join(d, "w.wtns"), os.path.join(d, "dev.zkey"),
                      os.path.join(d, "api_proof.json"), os.path.join(d, "api_public.json"), cm,
                      deterministic=True)
    counts_log[f"small {tag}"] = kernels.counts()
    folds_ok = levels >= min_fold_levels and counts_log[f"small {tag}"]["r1cs_rows"] == 1 + levels
    log(f"[small] {tag}: {r1cs.n_constraints} constraints, n_public {r1cs.n_public}; device "
        f"zkey == host zkey: {same_zkey}; CLI deterministic proof == oracle: {same_proof}; K2 "
        f"fold levels {levels} (r1cs_rows launches {counts_log[f'small {tag}']['r1cs_rows']}); "
        f"CLI said {cli.stdout.split()!r}")
    return (same_zkey and same_proof and folds_ok and "OK!" in cli.stdout
            and not cli.returncode)


# ---------------------------------------------------------------- phase 12

def family_builders() -> dict:
    """The reference's benchmark family (BASELINE.md, the family table):
    name -> a call that builds (R1CS, witness) with the port's builders at
    the published size, on the inputs the root bench.py gives them."""
    from icicle_snark_tpu_torch.setup import (aadhaar_circuit, keccak_circuit, keyless_circuit,
                                              rsa_circuit, sha256_circuit)

    def sha256():
        msg = bytes(range(64))  # bits MSB first
        return sha256_circuit.sha256_512_circuit(
            [(msg[i // 8] >> (7 - i % 8)) & 1 for i in range(512)])

    def keccak256():
        msg = bytes(range(32))  # bits LSB first
        return keccak_circuit.keccak256_circuit(
            [(msg[i // 8] >> (i % 8)) & 1 for i in range(256)])

    def anon_aadhaar():
        kwargs, _ = aadhaar_circuit.aadhaar_test_vector(max_data_length=1536)
        return aadhaar_circuit.aadhaar_verifier_circuit(**kwargs)

    def keyless():
        kwargs, _ = keyless_circuit.keyless_test_vector(max_jwt_len=1024)
        return keyless_circuit.keyless_circuit(**kwargs)

    return {
        "sha256": sha256, "keccak256": keccak256,
        "rsa": lambda: rsa_circuit.rsa_verify_circuit(*rsa_circuit.rsa_test_vector()),
        "rsa_sha256": lambda: rsa_circuit.rsa_sha256_verify_circuit(
            *rsa_circuit.rsa_sha256_test_vector()),
        "anon_aadhaar": anon_aadhaar, "keyless": keyless,
    }


def family_coset(cache, paths, dev, tag, counts_log) -> tuple:
    """construct_r1cs on the fixture's witness (K2 with its fold levels,
    then K5's passes with the keys and h fused in) against its plain
    version on the card, word for word; its launches a driven path of their
    own (K2 once a fold level and once more, K5 twice a pass, K1 never);
    timed beside K2 alone. Returns (ok, readings)."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.io.wtns import WtnsFile
    from icicle_snark_tpu_torch.ops import ntt
    from icicle_snark_tpu_torch.prover import pipeline

    plan, dom = cache.plan, cache.domain
    w = lb.words_to_limbs(WtnsFile(paths["wtns"]).witness_limbs(), dev)
    long_slots, levels = pipeline.r1cs_fold_plan(plan, pipeline.R1CS_PIECE)
    kernels.reset_counts()
    got = pipeline.construct_r1cs(w, cache)
    counts = kernels.counts()
    counts_log[f"{tag} construct_r1cs"] = counts
    want_counts = (1 + len(levels), 2 * len(ntt.block_passes(dom.log_n)), 0)
    launches_ok = (counts["r1cs_rows"], counts["ntt_block"], counts["field_vec"]) == want_counts
    want, plain_ms = timed_once(lambda: ntt.coset_h_plain(
        pipeline.r1cs_rows_plain(w, plan), dom, cache.keys_br_scaled))
    err = max_word_err(got, want)
    terms = (plan.offsets[1:] - plan.offsets[:-1]).long()
    n = plan.num_slots // 2
    row = {"max_word_err": err, "launches_ok": launches_ok, "fold_levels": len(levels),
           "fold_pieces": [int(lo.numel()) for lo, _ in levels],
           "long_slots_a": int((terms[:n] > pipeline.R1CS_PIECE).sum()),
           "long_slots_b": int((terms[n:] > pipeline.R1CS_PIECE).sum()),
           "widest_a": int(terms[:n].max()), "widest_b": int(terms[n:].max()),
           "nnz": int(plan.coefs.shape[-1]), "plain_ms": plain_ms,
           "ms": cuda_time(lambda: pipeline.construct_r1cs(w, cache), 10),
           "r1cs_rows_ms": cuda_time(lambda: pipeline.r1cs_rows(w, plan), 10)}
    log(f"  coset evaluation (K2 + K5) {tag}: " + json.dumps(row) + "; launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    if not launches_ok:
        log(f"  construct_r1cs launched {counts}: want r1cs_rows {want_counts[0]}, ntt_block "
            f"{want_counts[1]}, field_vec 0")
    return err == 0 and launches_ok, row


def family_circuit(name, build, fixture_dir, dev, counts_log, failures, profile=False) -> dict:
    """One circuit of the family through the port: built and its witness
    checked, the fixture made by the device setup (`drive_setup`, reused
    when present), the cold cache split by phase, the coset evaluation
    against its plain version, a first deterministic prove and three warm
    randomized ones (`drive_proves`, both kinds verified, the launches of
    one warm prove) with the peak device memory, a changed public signal
    rejected, the K3-forced deterministic proof byte-identical, and with
    `profile` one profiled warm prove."""
    import torch

    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.ops import ntt as ntt_ops
    from icicle_snark_tpu_torch.prover import api, pipeline
    from icicle_snark_tpu_torch.refmath.field import R_MOD

    tag = f"family {name}"
    out = {}
    t0 = time.perf_counter()
    r1cs, witness = build()
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not r1cs.check_witness(witness):
        failures.append(f"{tag}: the builder's witness does not satisfy its R1CS")
    out["check_witness_s"] = time.perf_counter() - t0
    out["constraints"] = r1cs.n_constraints
    setup = drive_setup(tag, os.path.join(fixture_dir, "family", name), None, dev, counts_log,
                        failures, circuit=(r1cs, witness))
    del r1cs, witness
    paths = setup["paths"]
    out.update(setup_s=setup["s"], setup_phases=setup["phases"], setup_split=setup["split"])
    cm = api.CacheManager(dev)
    timer = pipeline.PhaseTimer(dev)
    t0 = time.perf_counter()
    cache = cm.get(paths["zkey"], timer=timer)
    torch.cuda.synchronize()
    out["cold_cache_s"], out["cold_cache_phases"] = time.perf_counter() - t0, timer.phases
    hdr = cache.header
    out["shape"] = {"n_vars": hdr.n_vars, "n_public": hdr.n_public, "domain_log": hdr.power,
                    "g1_lanes": sum(cache.g1_sizes),
                    "g2_lanes": cache.b2_records.shape[0] // cache.msm_pre2,
                    "c": cache.msm_c, "c2": cache.msm_c2}
    log(f"[{tag}] built in {out['build_s']:.1f} s ({out['constraints']} constraints, witness "
        f"checked in {out['check_witness_s']:.1f} s); cold cache {out['cold_cache_s']:.3f} s, "
        "phases " + json.dumps({k: round(v, 4) for k, v in timer.phases.items()}) + "; "
        + json.dumps(out["shape"]))
    ok, out["coset"] = family_coset(cache, paths, dev, tag, counts_log)
    if not ok:
        failures.append(f"{tag}: the coset evaluation differs from its plain version or "
                        "launched other kernels than K2's levels and K5's passes")
    torch.cuda.reset_peak_memory_stats()
    first, warm, launches, det, phases = drive_proves(tag, paths, cm, dev, failures, counts_log)
    out.update(first_prove_s=first, warm_prove_s=warm, warm_phases=phases, launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    public = json.loads(det[1])
    if len(public) != hdr.n_public:
        failures.append(f"{tag}: public.json holds {len(public)} signals, not {hdr.n_public}")
    # the deterministic proof against a public.json with one entry changed
    bad = {k: os.path.join(os.path.dirname(paths["zkey"]), f) for k, f in (
        ("proof", "proof_det.json"), ("public", "public_changed.json"))}
    with open(bad["proof"], "wb") as fh:
        fh.write(det[0])
    with open(bad["public"], "w") as fh:
        json.dump([str((int(public[0]) + 1) % R_MOD)] + public[1:], fh)
    out["changed_public_rejected"] = not api.groth16_verify(bad["proof"], bad["public"],
                                                            paths["vk"])
    if not out["changed_public_rejected"]:
        failures.append(f"{tag}: a proof verified against a changed public signal")
    with patched((ntt_ops, "NTT_BLOCK_MIN_LOG", 99)):
        kernels.reset_counts()
        secs, proof, pub = _prove_bytes(api, paths, cm, deterministic=True)
        counts_log[f"{tag} NTT forced to K3"] = kernels.counts()
    k3 = counts_log[f"{tag} NTT forced to K3"]
    out["k3_forced"] = {"s": secs, "same": (proof, pub) == det, "ntt_radix": k3["ntt_radix"],
                        "ntt_block": k3["ntt_block"]}
    if not out["k3_forced"]["same"] or k3["ntt_block"] or not k3["ntt_radix"]:
        failures.append(f"{tag}: the K3-forced proof differs from the default route's, or that "
                        f"route launched K5 ({k3['ntt_block']}) or no register pass")
    if profile:
        out["profile"] = profile_prove(paths, cm)
        log(f"[{tag}] profile of one warm prove: " + json.dumps(out["profile"]))
    log(f"[{tag}] peak device memory {out['peak_memory_gb']:.2f} GB; changed public signal "
        f"rejected: {out['changed_public_rejected']}; K3-forced proof byte-identical: "
        f"{out['k3_forced']['same']} ({out['k3_forced']['s']:.3f} s)")
    del cm, cache
    torch.cuda.empty_cache()
    return out


def family_phase(fixture_dir, dev, counts_log, failures) -> dict:
    """Every circuit of the family through `family_circuit`; anon_aadhaar's
    warm prove profiled."""
    t0 = time.perf_counter()
    out = {}
    for name, build in family_builders().items():
        t1 = time.perf_counter()
        out[name] = family_circuit(name, build, fixture_dir, dev, counts_log, failures,
                                   profile=name == "anon_aadhaar")
        out[name]["phase_s"] = time.perf_counter() - t1
        log(f"[family] {name} in {out[name]['phase_s']:.1f} s")
    out["phase_s"] = time.perf_counter() - t0
    log(f"[family] phase in {out['phase_s']:.1f} s")
    return out


def cache_only(args, dev) -> int:
    """--cache-only: the complex-N and complex-M fixtures (made unless
    --fixture-dir holds them), then each one's cold cache
    (`load_zkey_cache`, host clock ending in a synchronise) three times,
    split by phase where this tree's load_zkey_cache takes a timer. Uses
    entry points every slice has had, so a copy of this script (with
    icicle_snark_tpu_torch/profiling.py) in an unpacked earlier tree
    measures that tree."""
    import inspect

    import torch

    from icicle_snark_tpu_torch.prover import cache as cache_mod
    from icicle_snark_tpu_torch.prover import pipeline

    split = "timer" in inspect.signature(cache_mod.load_zkey_cache).parameters
    for n in (args.constraints, args.large_constraints):
        _, paths = make_fixture(os.path.join(args.fixture_dir, f"torch_complex_{n}"), n, dev)
        rows = []
        for _ in range(3):
            timer = pipeline.PhaseTimer(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = cache_mod.load_zkey_cache(paths["zkey"], dev,
                                              **({"timer": timer} if split else {}))
            torch.cuda.synchronize()
            rows.append({"s": time.perf_counter() - t0,
                         "phases": {k: round(v, 4) for k, v in timer.phases.items()}})
            del cache
            torch.cuda.empty_cache()
        log(f"[cache] complex-{n} cold cache, three loads: " + json.dumps(rows))
    return 0


def family_only(args, dev, card) -> int:
    """--family-only: the small gadget circuit of phase 9 against the
    oracle, then `family_phase`; the readings written to
    chiprun_out/chip_smoke_family.json."""
    from icicle_snark_tpu_torch.setup.r1cs import poseidon_bits_circuit

    failures, counts = [], {}
    t0 = time.perf_counter()
    if not check_against_oracle("poseidon_bits", os.path.join(OUT_DIR, "smoke_poseidon_bits"),
                                *poseidon_bits_circuit(*POSEIDON_BITS_INPUTS), dev, counts,
                                min_fold_levels=2):
        failures.append("poseidon_bits: the device zkey or the CLI's deterministic proof "
                        "differs from the oracle's, or K2 did not fold")
    readings = family_phase(args.fixture_dir, dev, counts, failures)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_family.json"), "w") as fh:
        json.dump({"card": card, "family": readings, "path_counts": counts,
                   "failures": failures}, fh, indent=1)
    log(f"[family] command {time.perf_counter() - t0:.1f} s after the build")
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def multichip_only(args, dev, rng, card) -> int:
    """--multichip-only: the fixtures (made unless --fixture-dir holds them),
    K6 at the large circuit's shapes (`check_acc_windows`), then
    `multichip_phase` with K15's row; writes chip_smoke_multichip.json into
    OUT_DIR. It calls only entry points every tree with `parallel/` has, so it
    also runs beside an earlier tree's package."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.prover import api

    t0 = time.perf_counter()
    _, small = make_fixture(os.path.join(args.fixture_dir, f"torch_complex_{args.constraints}"),
                            args.constraints, dev)
    _, big = make_fixture(os.path.join(args.fixture_dir,
                                       f"torch_complex_{args.large_constraints}"),
                          args.large_constraints, dev)
    log(f"[multichip] fixtures in {time.perf_counter() - t0:.1f} s")
    cache_big = api.CacheManager("cuda").get(big["zkey"])
    rep, counts, failures = Report(), {}, []
    warm_card(dev)
    if not check_acc_windows(rep, rng, cache_big, dev):
        failures.append("kernel point_add differs from its plain version")
    readings = multichip_phase(rep, rng, dev, big, cache_big, small, counts, failures)
    rows = []
    for k in (kernels.POINT_ADD, kernels.FOUR_STEP):
        ran = [(path, c[k.name]) for path, c in counts.items() if c.get(k.name)]
        rows.append({"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                     "launches": ran[0][1] if ran else 0,
                     "launched_on": ran[0][0] if ran else None, "library_ms": None,
                     **rep.rows.get(k.name, {})})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_multichip.json"), "w") as fh:
        json.dump({"card": card, "multichip": readings, "path_counts": counts, "kernels": rows,
                   "failures": failures, "total_s": time.perf_counter() - t0}, fh, indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def curves_only(dev, rng, card) -> int:
    """--curves-only: the build's register lines, then `curves_phase` with
    its kernel rows; writes chip_smoke_curves.json into OUT_DIR."""
    from icicle_snark_tpu_torch import kernels

    t0 = time.perf_counter()
    for name, u in sorted(ptxas_usage().items()):
        log(f"[build] {u.get('source')} {name}: {u.get('registers')} registers, stack "
            f"{u.get('stack')} B, spill stores {u.get('spill_stores')} B, loads "
            f"{u.get('spill_loads')} B")
    rep, counts, failures = Report(), {}, []
    warm_card(dev)
    readings = curves_phase(rep, rng, dev, counts, failures)
    rows = []
    for k in (kernels.FIELD_VEC_N, kernels.MSM_ACCUMULATE_N, kernels.MSM_REDUCE_N, kernels.NTT_N,
              kernels.FIELD_POW_N, kernels.FIELD_REDUCE_N, kernels.NTT_BLOCK_N,
              kernels.NTT_RADIX_N):
        ran = [(path, c[k.name]) for path, c in counts.items() if c.get(k.name)]
        rows.append({"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                     "launches": ran[0][1] if ran else 0, "launched_on": ran[0][0] if ran else None,
                     "library_ms": None, **rep.rows.get(k.name, {})})
    log(f"[curves] phase in {readings['phase_s']:.1f} s; the command {time.perf_counter() - t0:.1f} "
        "s after the build")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_curves.json"), "w") as fh:
        json.dump({"card": card, "curves": readings, "path_counts": counts, "kernels": rows,
                   "ptxas": ptxas_usage(), "failures": failures}, fh, indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def ntt_only(dev, rng, card) -> int:
    """--ntt-only: the build's register lines of the NTT kernels, then K3
    (its register passes and its one-stage entry) against the plain stages
    and beside K5 at (3, 8, 2^17), K5 against both at (3, 8, 2^21), the
    threshold sweep, and K14's three routes over the three other Fr
    (`check_ntt_n`); no fixture. Writes chip_smoke_ntt.json into OUT_DIR."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.ops import ntt

    t0 = time.perf_counter()
    for name, u in sorted(ptxas_usage().items()):
        if u.get("source") in ("ntt.cu", "ntt_n.cu", "ntt_block.cu", "ntt_block_n.cu"):
            log(f"[build] {u.get('source')} {name}: {u.get('registers')} registers, stack "
                f"{u.get('stack')} B, spill stores {u.get('spill_stores')} B, loads "
                f"{u.get('spill_loads')} B")
    rep, counts, failures = Report(), {}, []
    warm_card(dev)
    if not check_ntt(rep, rng, ntt.NTTDomain(17, dev), dev, counts):
        failures.append("kernel ntt_stage or ntt_radix differs from its plain version")
    if not check_ntt_block(rep, rng, ntt.NTTDomain(21, dev), dev):
        failures.append("kernel ntt_block differs from its plain version or from K3")
    sweep = ntt_threshold_sweep(dev)
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    curves_ok, curves = check_ntt_n(rep, gen, dev, counts)
    if not curves_ok:
        failures.append("a curve NTT differs from its plain versions, another route, the DFT "
                        "or the identity")
    rows = []
    for k in (kernels.NTT, kernels.NTT_RADIX, kernels.NTT_BLOCK, kernels.NTT_N,
              kernels.NTT_RADIX_N, kernels.NTT_BLOCK_N):
        ran = [(path, c[k.name]) for path, c in counts.items() if c.get(k.name)]
        rows.append({"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                     "launches": ran[0][1] if ran else 0, "launched_on": ran[0][0] if ran else None,
                     "library_ms": None, **rep.rows.get(k.name, {})})
    log(f"[ntt] the command {time.perf_counter() - t0:.1f} s after the build")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ntt.json"), "w") as fh:
        json.dump({"card": card, "threshold_sweep": sweep, "curves": curves, "path_counts": counts,
                   "kernels": rows, "failures": failures}, fh, indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def curves_msm_only(dev, rng, card) -> int:
    """--curves-msm-only: K13 alone at the six full-width MSMs of
    CURVE_MSM_LANES (`k13_times`: accumulate and reduce on CUDA events,
    every kernel's device ms), the registers, stack and spills and the SASS
    census of the curve files, and a digest of each MSM's window sums in
    affine form. It calls only entry points that every tree since K13 came
    has: a copy of this script in an unpacked earlier tree measures that
    tree's K13 on the same inputs, and equal digests show that the two
    designs agree. Writes chip_smoke_k13.json into OUT_DIR."""
    import torch

    from icicle_snark_tpu_torch.curves import device as cdev
    from icicle_snark_tpu_torch.ops import msm

    t0 = time.perf_counter()
    sources = tuple(f"msm_{c}.cu" for c in CURVES)
    usage = {k: u for k, u in ptxas_usage().items() if u.get("source") in sources}
    for name, u in sorted(usage.items()):
        log(f"[build] {u.get('source')} {name}: {u.get('registers')} registers, stack "
            f"{u.get('stack')} B, spill stores {u.get('spill_stores')} B, loads "
            f"{u.get('spill_loads')} B")
    sass = sass_census(sources)
    warm_card(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    out = {}
    for name in CURVES:
        fr = cdev.curve_specs(name)[1]
        for g2 in (False, True):
            hc, pool = _pool_points(name, g2, rng, 64)
            grp = cdev.g2_group(name) if g2 else cdev.g1_group(name)
            n = CURVE_MSM_LANES[name][int(g2)]
            c = msm.choose_c(n, bits=32 * fr.words)
            rec = msm.point_records(cdev.affine_to_device(pool, grp.ops, dev)).repeat(n // 64, 1)
            sc = random_field_n(gen, fr, (n,), dev, edges=False)
            k13 = k13_times(rec, sc, n, c, grp, reps=3)
            digest = _affine_digest(k13.pop("window_sums"), grp, hc)
            del rec, sc
            torch.cuda.empty_cache()
            # blocks of the tree kernel an SM holds (trees that have the tree)
            occ = (msm.k13_tree_blocks_per_sm(grp) if hasattr(msm, "k13_tree_blocks_per_sm")
                   else None)
            out[grp.name] = dict(lanes=n, c=c, digest=digest, blocks_per_sm=occ, **k13)
            log(f"  k13 {grp.name}: {n} lanes, c {c}: accumulate {k13['accumulate_ms']:.3f} ms, "
                f"reduce {k13['reduce_ms']:.3f} ms (CUDA events); by kernel (device ms) "
                f"{json.dumps(k13['kernel_ms'])}; window sums' affine digest {digest}; tree "
                f"blocks an SM holds {occ}")
    acc = sum(v["accumulate_ms"] for v in out.values())
    red = sum(v["reduce_ms"] for v in out.values())
    log(f"[k13] the six MSMs: accumulate {acc:.2f} ms, reduce {red:.2f} ms; "
        f"{time.perf_counter() - t0:.1f} s after the build")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_k13.json"), "w") as fh:
        json.dump({"card": card, "k13": out, "accumulate_ms": acc, "reduce_ms": red,
                   "ptxas": usage, "sass": sass}, fh, indent=1)
    return 0


def precompute_only(dev, rng, card, lanes: int = 100003) -> int:
    """--precompute-only: K7 (point_dbl_k at the complex-100k key's G1 and G2
    shape, plan (13, 4); point_to_affine there and at the setup's 2^18-lane
    chunk, G1 and G2, with its L sweep) and K11 (one setup chunk, G1 and G2)
    against their plain versions, timed with their registers and spills.
    The points are k_i * G, made by K11 and K7 from random scalars. Its
    checks call only entry points that earlier trees of the port have too
    (fast_setup.fixed_base_msm, jcurve.to_affine and pdbl_k); the L sweep
    runs where the kernel library has its entry. So a copy of this script
    run in an unpacked earlier tree measures that tree's kernels. Writes
    chip_smoke_precompute.json into OUT_DIR."""
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.curve import jcurve as jc
    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.setup import fast_setup as fs

    t0 = time.perf_counter()
    fbs, tables = setup_tables(dev)
    points = {}
    for g2 in (False, True):
        words = rng.integers(0, 1 << 32, size=(lanes, 8), dtype=np.uint64).astype(np.uint32)
        words[:, 7] = rng.integers(0, lb.FR_SPEC.modulus >> 224, size=lanes).astype(np.uint32)
        ops = jc.G2 if g2 else jc.G1
        points[g2] = jc.to_affine(ops, fs.fixed_base_msm(lb.words_to_limbs(words, dev),
                                                         tables[g2], ops))
    rep, failures = Report(), []
    warm_card(dev)
    if not check_precompute(rep, rng, points, dev, tables=tables, sweep=True):
        failures.append("kernel point_dbl_k or point_to_affine differs from its plain version")
    if not check_fixed_base(rep, rng, dev, fbs, tables):
        failures.append("kernel fixed_base_msm differs from its plain version")
    sweep = rep.rows.get(kernels.POINT_TO_AFFINE.name, {}).get("lane_sweep", {})
    if not all(v["equal_to_plain"] for row in sweep.values() for v in row.values()):
        failures.append("point_to_affine differs from its plain version at some L")
    rows = [{"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
             "library_ms": None, **rep.rows.get(k.name, {})}
            for k in (kernels.POINT_DBL_K, kernels.POINT_TO_AFFINE, kernels.FIXED_BASE)]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_precompute.json"), "w") as fh:
        json.dump({"card": card, "kernels": rows, "ptxas": ptxas_usage(), "failures": failures,
                   "total_s": time.perf_counter() - t0}, fh, indent=1)
    print(json.dumps({"kernels": rows}), flush=True)
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def ingest_only(args, dev, rng, card) -> int:
    """--ingest-only: K18's registers, K18 against its plain version and
    timed (`check_witness_limbs`), then the witness ingest's routes in turns
    at complex-1600k's 1 600 003 rows (`ingest_ab`); no fixture. Writes
    chip_smoke_ingest.json into OUT_DIR."""
    from icicle_snark_tpu_torch import kernels

    usage = {name: u for name, u in ptxas_usage().items() if u.get("source") == "witness_limbs.cu"}
    for name, u in usage.items():
        log(f"[build] witness_limbs.cu {name}: {u.get('registers')} registers, stack "
            f"{u.get('stack')} B, spill stores {u.get('spill_stores')} B")
    rep, failures = Report(), []
    warm_card(dev)
    if not check_witness_limbs(rep, rng, dev):
        failures.append("kernel witness_limbs differs from its plain version")
    ab = ingest_ab(os.path.join(args.fixture_dir, "ingest"), dev)
    if not ab["same"]:
        failures.append("an ingest route gave other limbs")
    row = {"name": kernels.WITNESS_LIMBS.name, "source": kernels.WITNESS_LIMBS.source,
           "replaces": kernels.WITNESS_LIMBS.replaces, "usage": usage,
           **rep.rows.get(kernels.WITNESS_LIMBS.name, {})}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ingest.json"), "w") as fh:
        json.dump({"card": card, "kernel": row, "ingest": ab, "failures": failures}, fh, indent=1)
    print(json.dumps({"kernel": row}), flush=True)
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


# ---------------------------------------------------------------- K4 A/B

# (G1 group sizes, G2 lanes, witness) of the benchmark's two circuits
# (PERF.md section 4): complex-1600k's witness is uniform, anon_aadhaar's
# mostly bits
K4_CASES = {
    "complex-1600k": ([1600003] * 3 + [2097150], 1600003, "uniform"),
    "anon_aadhaar-1536": ([936533] * 3 + [1048566], 936533, "bits"),
}
K4_SOURCES = ("msm.cu", "msm_reduce.cu")
# sources whose kernels K4's change must leave as they were: K13, K11, K4's rows,
# and K4's accumulate but for G2's level 0 (K4_MAY_DIFFER)
K4_SAME = ("msm_bls12_377.cu", "msm_bls12_381.cu", "msm_bw6_761.cu", "fixed_base.cu",
           "msm_reduce.cu", "msm.cu")
K4_MAY_DIFFER = {"msm_reduce.cu": lambda e: "rows" not in e,
                 "msm.cu": lambda e: "msm_accumulate_kernelI2E2Lb1E" in e}
# distinct points G2's records are drawn from (k4_inputs)
K4_G2_POOL = 4096


def k4_builds(variants: dict) -> dict:
    """Compile K4's two sources of each variant ({name: (csrc dir, threads
    or None)}) with `-Xptxas -v`, in parallel, under build/k4/<name>, with
    the accumulate's and the segments stage's block size set to `threads`;
    and the PTX of K4_SAME from the first two variants. A variant whose
    build fails or outlasts 480 s is dropped. Returns {name: (library path,
    ptxas usage, {source: PTX})} and {name: why dropped}."""
    import re
    import shutil

    from icicle_snark_tpu_torch import kernels

    nvcc = kernels._nvcc()
    procs, out = [], {}
    for k, (name, (csrc, threads)) in enumerate(variants.items()):
        d = os.path.join(HERE, "build", "k4", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        if threads:
            hdr = os.path.join(d, "msm_kernels.cuh")
            with open(hdr) as fh:
                text = fh.read()
            text, n_acc = re.subn(r"(struct AccThreads[^\n]*N = )\d+", rf"\g<1>{threads}", text)
            text, n_seg = re.subn(r"#define SEG_THREADS \d+", f"#define SEG_THREADS {threads}",
                                  text)
            assert n_acc and n_seg, "msm_kernels.cuh has no AccThreads / SEG_THREADS"
            with open(hdr, "w") as fh:
                fh.write(text)
        for src in K4_SOURCES:
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", src + ".o"]
            procs.append((name, src, subprocess.Popen(cmd, cwd=d, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
        if k < 2:
            for src in K4_SAME:
                cmd = [nvcc, *kernels.NVCC_FLAGS, "-ptx", src, "-o", src + ".ptx"]
                procs.append((name, src + ".ptx", subprocess.Popen(
                    cmd, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        out[name] = [os.path.join(d, "libk4.so"), {}, {}]
    failed, deadline = {}, time.perf_counter() + 480
    for name, src, proc in procs:
        try:
            text = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0] + "\n(killed at the build's time limit)"
        if proc.returncode:
            failed[name] = f"nvcc failed for {src} (rc {proc.returncode}): {text[-2000:]}"
        elif not src.endswith(".ptx"):
            ptxas_parse(text, src, out[name][1])
    for name, why in failed.items():
        log(f"[k4] variant {name} dropped: {why}")
        del out[name]
    for lib, _usage, ptx in out.values():
        d = os.path.dirname(lib)
        subprocess.run([nvcc, kernels.NVCC_FLAGS[0], "-shared", *[s + ".o" for s in K4_SOURCES],
                        "-o", lib], cwd=d, check=True)
        for src in K4_SAME:
            path = os.path.join(d, src + ".ptx")
            if os.path.exists(path):
                with open(path) as fh:
                    ptx[src] = fh.read()
    return out, failed


def ptx_entries(text: str) -> dict:
    """{kernel or function name: its PTX text} of one PTX file."""
    import re

    head = r"(?:\.visible |\.weak |\.extern )*\.(?:entry|func)\s+(?:\([^)]*\)\s*)?(\w+)"
    found = list(re.finditer(rf"(?m)^{head}", text))
    ends = [m.start() for m in found[1:]] + [len(text)]
    return {m.group(1): text[m.start():end] for m, end in zip(found, ends)}


def k4_lib(path: str):
    import ctypes

    from icicle_snark_tpu_torch import kernels

    lib = ctypes.CDLL(path)
    for name in ("snark_msm_accumulate", "snark_msm_reduce"):
        fn = getattr(lib, name)
        fn.argtypes = kernels._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def k4_g2_pool(gen, dev):
    """K4_G2_POOL consecutive multiples of a random G2 point, as records."""
    import torch

    from icicle_snark_tpu_torch.fields import limbs as lb
    from icicle_snark_tpu_torch.ops import msm
    from icicle_snark_tpu_torch.refmath import curve as cv
    from icicle_snark_tpu_torch.refmath.field import fq_to_mont

    k = int(torch.randint(1, 1 << 62, (1,), generator=gen, device=dev))
    p, pts = cv.g2_mul(cv.G2_GEN, k), []
    for _ in range(K4_G2_POOL):
        pts.append(cv.g2_to_affine(p))
        p = cv.g2_add(p, cv.G2_GEN)
    xy = tuple(torch.stack([lb.ints_to_limbs([fq_to_mont(a[i][c]) for a in pts], dev)
                            for c in range(2)]) for i in range(2))
    return msm.point_records(xy)


def k4_inputs(gen, sizes, kind: str, g2: bool, dev):
    """Scalars and records of one MSM at a circuit's shape, with 1 % (0, 0)
    records: G1's canonical random coordinates, G2's points of the curve
    drawn from a pool (k4_g2_pool), so that designs whose words differ can
    be held to one affine result; uniform scalars, or for `bits` a witness
    of 85 % bits and 15 % uniform values in every group but the last (h,
    uniform)."""
    import torch

    top = 0x30644E72  # the top word of q and of r

    def field(rows, n):
        w = torch.randint(0, 1 << 32, (rows, 8, n), generator=gen, device=dev, dtype=torch.int64)
        w[:, 7] %= top
        return w.to(torch.int32)

    total = sum(sizes)
    sc = field(1, total)[0]
    if kind == "bits":
        n_w = total - sizes[-1]
        bits = torch.rand(n_w, generator=gen, device=dev) < 0.85
        sc[:, :n_w] = torch.where(bits, 0, sc[:, :n_w])
        sc[0, :n_w] = torch.where(bits, torch.randint(0, 2, (n_w,), generator=gen, device=dev,
                                                      dtype=torch.int32), sc[0, :n_w])
    if g2:
        pick = torch.randint(0, K4_G2_POOL, (total,), generator=gen, device=dev)
        rec = k4_g2_pool(gen, dev)[pick]
    else:
        rec = field(2, total).permute(2, 0, 1).reshape(total, 16)
    inf = torch.rand(total, generator=gen, device=dev) < 0.01
    rec[inf] = 0
    return sc, rec.contiguous()


def k4_run(lib, case, reps: int) -> tuple:
    """K4's launches of one MSM through `lib`, CUDA events a launch: level
    0, the fold levels (summed), the segments stage and the rows stage;
    `reps` times after one warm-up. Returns ({launch: [ms, ...]}, the last
    run's (bucket sums, S, T, window sums))."""
    import torch

    from icicle_snark_tpu_torch.ops import msm

    g2, rec, order, negs, plan, windows, groups, half = case
    coords = (2, 8) if g2 else (8,)
    stream = torch.cuda.current_stream().cuda_stream
    seg, n_seg, nt, _q = msm.reduce_shape(half)
    rows = windows * groups
    times = {}

    def once(record: bool):
        src, affine, outs = rec, True, []
        for k, (start, length) in enumerate(plan):
            out = torch.empty((3,) + coords + (start.shape[0],), dtype=torch.int32,
                              device=rec.device)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            n_src = src.shape[0] if affine else src.shape[-1]
            err = lib.snark_msm_accumulate(int(g2), int(affine), out.data_ptr(), src.data_ptr(),
                                           n_src, order.data_ptr(), negs.data_ptr(),
                                           start.data_ptr(), length.data_ptr(), start.shape[0],
                                           stream)
            e1.record()
            assert err == 0, f"accumulate launch failed: {err}"
            outs.append(("level0" if k == 0 else "folds", e0, e1))
            src, affine = out, False
        seg_s, seg_t = (torch.empty((3,) + coords + (rows * n_seg,), dtype=torch.int32,
                                    device=rec.device) for _ in range(2))
        wsum = torch.empty((3,) + coords + (groups, windows), dtype=torch.int32, device=rec.device)
        for stage in (0, 1):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            err = lib.snark_msm_reduce(int(g2), stage, wsum.data_ptr(), seg_s.data_ptr(),
                                       seg_t.data_ptr(), src.data_ptr(), windows, groups, half,
                                       seg, nt, stream)
            e1.record()
            assert err == 0, f"reduce launch failed: {err}"
            outs.append(("segments" if stage == 0 else "rows", e0, e1))
        torch.cuda.synchronize()
        if record:
            step = {}
            for name, e0, e1 in outs:
                step[name] = step.get(name, 0.0) + e0.elapsed_time(e1)
            for name, ms in step.items():
                times.setdefault(name, []).append(ms)
        return src, seg_s, seg_t, wsum

    once(False)
    for _ in range(reps):
        got = once(True)
    return times, got


def k4_edge_check(lib, rng, dev) -> bool:
    """The library's K4 on the edge MSM (P + P, P + (-P), (0, 0)) with L = 2,
    several fold levels, word for word against the plain versions."""
    import torch

    from icicle_snark_tpu_torch.ops import msm

    ok = True
    for g2 in (False, True):
        sc, pts = _edge_msm_inputs(rng, dev, g2)
        rec = msm.point_records(pts)
        with patched((msm, "BUCKET_PIECE", 2)):
            order, negs, ends = msm.sort_windows(sc, [sc.shape[-1]], 8)
            windows, total = order.shape
            plan = msm.bucket_fold_plan(ends, windows, 1, 128, total)
            case = (g2, rec, order.reshape(-1).contiguous(), negs.reshape(-1).contiguous(),
                    [(st.contiguous(), ln.contiguous()) for st, ln in plan], windows, 1, 128)
            _t, (bk, seg_s, seg_t, wsum) = k4_run(lib, case, 1)
            want_b = msm.msm_accumulate_plain(rec, order, negs, ends, 1, 128)
            ops = msm._ops(g2, True)
            seg = msm.reduce_shape(128)[0]
            s_p, t_p = msm.msm_reduce_segments_plain(ops, want_b, windows, 128, seg)
            same = (torch.equal(bk, want_b) and torch.equal(seg_s, torch.stack(s_p))
                    and torch.equal(seg_t, torch.stack(t_p))
                    and torch.equal(wsum, msm.msm_reduce_plain(want_b, windows, 1, 128)))
        log(f"  k4 edge {'g2' if g2 else 'g1'}: {len(plan)} levels, equal to plain {same}")
        ok &= same
    return ok


def k4_affine(wsum) -> list:
    """G2 window sums (3, 2, 8, G, W) as affine host points, group by group."""
    from icicle_snark_tpu_torch.ops import msm
    from icicle_snark_tpu_torch.refmath import curve as cv

    arr = wsum.cpu().numpy()
    return [[cv.g2_to_affine(p) for p in msm.window_points_to_host_g2(arr, g)]
            for g in range(arr.shape[3])]


def k4_sample_check(lib, case, gen, n: int = 4096) -> tuple:
    """Level 0 of `lib` on n items of the case's level-0 table drawn at
    random, word for word against msm_bucket_sums_plain on the card, and the
    plain version's step counts there (G2's Jacobian branches)."""
    import torch

    from icicle_snark_tpu_torch.ops import msm

    g2, rec, order, negs, plan, *_ = case
    start, length = plan[0]
    idx = torch.randperm(start.shape[0], generator=gen, device=start.device)[:n]
    st, ln = start[idx].contiguous(), length[idx].contiguous()
    coords = (2, 8) if g2 else (8,)
    out = torch.empty((3,) + coords + (st.shape[0],), dtype=torch.int32, device=rec.device)
    err = lib.snark_msm_accumulate(int(g2), 1, out.data_ptr(), rec.data_ptr(), rec.shape[0],
                                   order.data_ptr(), negs.data_ptr(), st.data_ptr(),
                                   ln.data_ptr(), st.shape[0],
                                   torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"accumulate launch failed: {err}"
    branches = {}
    want = msm.msm_bucket_sums_plain(g2, True, rec, order, negs.to(torch.bool), st, ln, branches)
    torch.cuda.synchronize()
    return torch.equal(out, want), branches


def k4_only(args, dev, rng, card) -> int:
    """--k4-only: K4's instantiations timed one launch at a time at the two
    cells' MSM shapes, for this tree's sources at the block sizes of
    --k4-threads and, with --k4-parent, for the parent's sources, in turns
    in one process; each library's outputs word for word against the
    first's, this tree's against the plain versions on the edge MSM; the
    `-Xptxas -v` usage of every build; and which kernels of K4_SAME's
    sources differ in PTX from the parent's. Builds only K4's sources (no
    fixture, no package build). Writes chip_smoke_k4.json into OUT_DIR."""
    import statistics

    import torch

    from icicle_snark_tpu_torch.ops import msm

    here = os.path.join(HERE, "icicle_snark_tpu_torch", "csrc")
    variants = {}
    if args.k4_parent:
        variants["parent"] = (args.k4_parent, None)
    variants["change"] = (here, None)
    for t in args.k4_threads:
        variants[f"change_t{t}"] = (here, t)
    t0 = time.perf_counter()
    built, dropped = k4_builds(variants)
    log(f"[k4] {len(variants)} builds in {time.perf_counter() - t0:.1f} s")
    failures = [f"{name} did not build" for name in dropped if name in ("parent", "change")]
    report = {"card": card, "usage": {}, "ptx_differs": {}, "cases": {}, "dropped": dropped}
    for name, (_lib, usage, _ptx) in built.items():
        report["usage"][name] = usage
        for entry, u in sorted(usage.items()):
            if "msm_" in entry:
                log(f"[k4 build] {name} {u['source']} {entry}: {u.get('registers')} registers, "
                    f"stack {u.get('stack')} B, spill stores {u.get('spill_stores')} B, loads "
                    f"{u.get('spill_loads')} B")
    if "parent" in built and "change" in built:
        for src in K4_SAME:
            a, b = (ptx_entries(built[n][2].get(src, "")) for n in ("parent", "change"))
            differ = sorted(e for e in set(a) | set(b) if a.get(e) != b.get(e))
            report["ptx_differs"][src] = differ
            for e in differ:  # for a diff off the card
                for n, entries in (("parent", a), ("change", b)):
                    path = os.path.join(OUT_DIR, "k4_ptx", f"{src}.{e}.{n}.ptx")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "w") as fh:
                        fh.write(entries.get(e, ""))
            log(f"[k4 ptx] {src}: {len(a)} entries, differing from the parent's: {differ}")
            may = K4_MAY_DIFFER.get(src, lambda e: False)
            if any(not may(e) for e in differ):
                failures.append(f"{src}: kernels differ from the parent's: "
                                f"{[e for e in differ if not may(e)]}")
    libs = {name: k4_lib(lib) for name, (lib, _u, _p) in built.items()}
    x = torch.ones((1 << 26,), device=dev)
    for _ in range(200):  # the card's clocks up (warm_card needs the package's build)
        x.mul_(1.0)
    torch.cuda.synchronize()
    for name, lib in libs.items():
        if name != "parent" and not k4_edge_check(lib, rng, dev):
            failures.append(f"{name}: K4 differs from its plain versions on the edge MSM")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    names = list(libs)
    for circuit, (sizes, n2, kind) in K4_CASES.items():
        for g2 in (False, True):
            szs = [n2] if g2 else sizes
            c = msm.choose_c(sum(szs), len(szs))
            sc, rec = k4_inputs(gen, szs, kind, g2, dev)
            order, negs, ends = msm.sort_windows(sc, szs, c)
            windows, total = order.shape
            half = 1 << (c - 1)
            plan = msm.bucket_fold_plan(ends, windows, len(szs), half, total)
            case = (g2, rec, order.reshape(-1).contiguous(), negs.reshape(-1).contiguous(),
                    plan, windows, len(szs), half)
            # level 0's operations bound: the kernel's own products, and at
            # one RCB15 mixed add (39 / 11 products) a finite lane
            fin = k4_finite(rec, order, *plan[0])
            madds = int(fin.sum())
            muls = g2_level0_muls(fin) if g2 else madds * FQ_MULS["g1"]["madd"]
            bounds = {"level0_bound_ms": bound(0, muls * MULS_PER_MONT)[0],
                      "level0_rcb15_bound_ms": bound(
                          0, madds * FQ_MULS["g2" if g2 else "g1"]["madd"] * MULS_PER_MONT)[0]}
            del sc, ends, fin
            tag = f"{circuit} {'g2' if g2 else 'g1'}"
            times, first = {}, {}
            # turns: every library, then again in the reverse order. Words
            # are held equal within the parent's and within this tree's
            # builds; across them G2's window sums as affine points (its
            # level 0 stores other words of the same points), G1's words.
            for name in names + names[::-1]:
                t, got = k4_run(libs[name], case, 3)
                for launch, ms in t.items():
                    times.setdefault(name, {}).setdefault(launch, []).extend(ms)
                family = "parent" if name == "parent" else "change"
                if family not in first:
                    first[family] = got
                elif not all(torch.equal(a, b) for a, b in zip(first[family], got)):
                    failures.append(f"{tag}: {name}'s words differ from its family's first")
                ref = first["parent"] if "parent" in first else first["change"]
                if g2 and ref is not got and k4_affine(ref[3]) != k4_affine(got[3]):
                    failures.append(f"{tag}: {name}'s window sums differ from the parent's")
                elif not g2 and not all(torch.equal(a, b) for a, b in zip(ref, got)):
                    failures.append(f"{tag}: {name}'s words differ from the parent's")
            if "change" in libs:
                same, branches = k4_sample_check(libs["change"], case, gen)
                log(f"[k4] {tag}: change's level 0 on a sample of items equal to the plain "
                    f"version {same}; steps {branches}")
                if not same:
                    failures.append(f"{tag}: level 0 differs from its plain version")
            med = {name: {launch: statistics.median(v) for launch, v in t.items()}
                   for name, t in times.items()}
            report["cases"][tag] = {"c": c, "lanes": total, "levels": len(plan),
                                    "items": [int(st.shape[0]) for st, _ in plan],
                                    "median_ms": med, "ms": times, **bounds,
                                    "sample_steps": branches if "change" in libs else None}
            for name, m in med.items():
                log(f"[k4] {tag}: {name} " + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
                    + f" ms (c {c}, {len(plan)} levels)")
            log(f"[k4] {tag}: level 0 bound {bounds['level0_bound_ms']:.3f} ms at the kernel's "
                f"products, {bounds['level0_rcb15_bound_ms']:.3f} ms at RCB15's")
            del case, plan, order, negs, rec, first
            torch.cuda.empty_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_k4.json"), "w") as fh:
        json.dump({**report, "failures": failures}, fh, indent=1)
    for f in failures:
        print(f"FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--constraints", type=int, default=100000)
    ap.add_argument("--large-constraints", type=int, default=1600000,
                    help="size of the large circuit (complex-1600k by default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bits-only", action="store_true",
                    help="build, prove complex-N with a bit-valued witness, print the MSM times "
                         "and stop (uses only entry points every slice of the port has had)")
    ap.add_argument("--r1cs-only", action="store_true",
                    help="build, time construct_r1cs and the r1cs_ntt phase at complex-N and "
                         "complex-M and stop (uses only entry points every slice has had)")
    ap.add_argument("--ops-only", action="store_true",
                    help="build, check K9-K11 and K4 at small windows against their plain "
                         "versions, drive the op surface, and stop")
    ap.add_argument("--setup-only", action="store_true",
                    help="build, time the device setup at complex-N and complex-M on K11 and on "
                         "the plain scan over K1 launches, and stop")
    ap.add_argument("--curves-only", action="store_true",
                    help="build, check K12-K14, K16 and K17 against their plain versions, "
                         "drive the other curves' MSMs, msm(), NTTs and vec-ops, and stop")
    ap.add_argument("--multichip-only", action="store_true",
                    help="build, check K6 and K15 against their plain versions, prove complex-M "
                         "at D = 2, 4 and 8 and complex-N at D = 8 on meshes of this card, one "
                         "process over NCCL, and stop (usable from an earlier tree)")
    ap.add_argument("--precompute-only", action="store_true",
                    help="build, check and time K7 and K11 (G1 and G2) against their plain "
                         "versions with their registers, and stop (usable from an earlier tree)")
    ap.add_argument("--ntt-only", action="store_true",
                    help="build, check and time K3 (register passes and one-stage entry), K5 "
                         "and K14's routes against their plain versions and each other, the "
                         "threshold sweep, and stop")
    ap.add_argument("--curves-msm-only", action="store_true",
                    help="build, time K13 alone at the six full-width curve MSMs by stage with "
                         "its registers, and stop (usable from an earlier tree)")
    ap.add_argument("--family-only", action="store_true",
                    help="build, then build, set up and prove the reference's benchmark family "
                         "(sha256, keccak256, rsa, rsa_sha256, anon_aadhaar, keyless) at full "
                         "size, and stop")
    ap.add_argument("--cache-only", action="store_true",
                    help="build, time the cold cache of complex-N and complex-M three times each "
                         "(by phase where the tree's load_zkey_cache takes a timer), and stop "
                         "(usable from an earlier tree)")
    ap.add_argument("--ingest-only", action="store_true",
                    help="build, check and time K18 against its plain version with its "
                         "registers, time the witness ingest's routes in turns at 1 600 003 "
                         "rows, and stop")
    ap.add_argument("--k4-only", action="store_true",
                    help="K4 by instantiation at the two cells' shapes, the block-size sweep "
                         "and the parent's sources (--k4-parent) in turns, and stop")
    ap.add_argument("--k4-parent", default=None,
                    help="the csrc directory of the tree to compare K4 with")
    ap.add_argument("--k4-threads", type=lambda v: [int(t) for t in v.split(",") if t],
                    default=[], help="block sizes of K4's sweep, comma-separated")
    ap.add_argument("--fixture-dir", default=os.path.join(HERE, ".fixtures"),
                    help="where the complex-N fixtures are made or found")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from icicle_snark_tpu_torch import kernels
    from icicle_snark_tpu_torch.ops import msm as msm_ops
    from icicle_snark_tpu_torch.ops import ntt as ntt_ops
    from icicle_snark_tpu_torch.prover import api
    from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness
    from icicle_snark_tpu_torch.tools import throughput_probe

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    failures = []
    path_counts = {}

    if args.k4_only:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, card {smi}")
        return k4_only(args, dev, rng, smi)

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
    if args.setup_only:
        return setup_routes(args, dev)
    if args.curves_only:
        return curves_only(dev, rng, card)
    if args.multichip_only:
        return multichip_only(args, dev, rng, card)
    if args.precompute_only:
        return precompute_only(dev, rng, card)
    if args.curves_msm_only:
        return curves_msm_only(dev, rng, card)
    if args.ntt_only:
        return ntt_only(dev, rng, card)
    if args.family_only:
        return family_only(args, dev, card)
    if args.cache_only:
        return cache_only(args, dev)
    if args.ingest_only:
        return ingest_only(args, dev, rng, card)
    if args.ops_only:
        for name, u in sorted(ptxas_usage().items()):
            log(f"[build] {u.get('source')} {name}: {u.get('registers')} registers, stack "
                f"{u.get('stack')} B, spill stores {u.get('spill_stores')} B, loads "
                f"{u.get('spill_loads')} B")
        rep = Report()
        warm_card(dev)
        ops = op_surface_phase(rep, rng, dev, path_counts, failures)
        log("[ops] kernel rows: " + json.dumps(rep.rows))
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_ops.json"), "w") as fh:
            json.dump({"card": card, "rows": rep.rows, "op_surface": ops}, fh, indent=1)
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0

    # ---- 2. fixture + cold cache
    n = args.constraints
    fx_small = os.path.join(args.fixture_dir, f"torch_complex_{n}")
    if args.bits_only or args.r1cs_only:
        _, paths = make_fixture(fx_small, n, dev)
    else:
        setup_small = drive_setup(f"complex-{n}", fx_small, n, dev, path_counts, failures)
        paths = setup_small["paths"]
    cm = api.CacheManager("cuda")
    t0 = time.perf_counter()
    cache = cm.get(paths["zkey"])
    torch.cuda.synchronize()
    cold_cache_s = time.perf_counter() - t0
    log(f"[cache] cold cache {cold_cache_s:.3f} s: n_vars {cache.header.n_vars}, domain "
        f"2^{cache.header.power}, G1 lanes {sum(cache.g1_sizes)} in {len(cache.g1_sizes)} groups, "
        f"G2 lanes {cache.b2_records.shape[0] // cache.msm_pre2}, window size c = "
        f"{cache.msm_c} (G1), {cache.msm_c2} (G2)")
    if args.bits_only:
        log("[bits] " + json.dumps(prove_bits(paths, cm, dev, cache.header.n_public)))
        return 0
    if args.r1cs_only:
        log(f"[r1cs] complex-{n}: " + json.dumps(time_r1cs_ntt(paths, cm, dev)))
        del cm, cache
        m = args.large_constraints
        _, big = make_fixture(os.path.join(args.fixture_dir, f"torch_complex_{m}"), m, dev)
        log(f"[r1cs] complex-{m}: " + json.dumps(time_r1cs_ntt(big, api.CacheManager("cuda"), dev)))
        return 0
    usage = ptxas_usage()
    for name, u in sorted(usage.items()):
        log(f"[build] {u.get('source')} {name}: {u.get('registers')} registers, stack "
            f"{u.get('stack')} B, spill stores {u.get('spill_stores')} B, loads {u.get('spill_loads')} B")
    sass = sass_census()

    # ---- 3. kernels against their plain versions (K5 and K6 follow in
    # phase 7, at the large circuit's shapes, with K4 once more; K9-K11 in
    # phase 6)
    rep = Report()
    warm_card(dev)
    t0 = time.perf_counter()
    checks = [
        ("field_vec", lambda: check_field_vec(rep, rng, cache.domain.n, dev)),
        ("r1cs_reduce", lambda: check_r1cs(rep, rng, cache, dev)),
        ("ntt_stage or ntt_radix", lambda: check_ntt(rep, rng, cache.domain, dev, path_counts)),
        ("msm g1", lambda: check_msm(rep, rng, cache, dev, False)),
        ("msm g2", lambda: check_msm(rep, rng, cache, dev, True)),
        ("precompute", lambda: check_precompute(
            rep, rng, (key_points(cache.g1_records[:cache.g1_sizes[0]], False),
                       key_points(cache.b2_records, True)), dev)),
        ("probe_chain", lambda: check_probe(rep, rng, dev)),
        ("witness_limbs", lambda: check_witness_limbs(rep, rng, dev)),
        ("msm_sort", lambda: check_msm_sort(rep, rng, dev)),
    ]
    for name, fn in checks:
        t1 = time.perf_counter()
        if not fn():
            failures.append(f"kernel {name} differs from its plain version")
        log(f"[kernels] {name} checked in {time.perf_counter() - t1:.1f} s")
    log(f"[kernels] checks in {time.perf_counter() - t0:.1f} s")

    # ---- 4. proves through the API
    coset_ok, coset_small = check_coset(rng, cache, paths, dev, f"complex-{n}", path_counts)
    if not coset_ok:
        failures.append(f"the fused coset evaluation differs from its plain version at complex-{n}")
    first_s, warm, launches, det_small, phases_small = drive_proves(
        f"complex-{n}", paths, cm, dev, failures, path_counts)
    bits_small = prove_bits(paths, cm, dev, cache.header.n_public)
    log(f"[bits] complex-{n}, bit-valued witness: " + json.dumps(bits_small))
    prof = profile_prove(paths, cm)
    if prof["device_busy_ms"] == 0:
        log("[profile] the profiler saw no device time")
    else:
        log("[profile] one warm prove: " + json.dumps(prof))
        if prof["missing_kernels"]:
            log(f"[profile] WARNING: {prof['missing_kernels']} launched but left no device "
                "record: the busy time and idle share leave them out")
        if prof["idle_share"] < 0:
            log("[profile] WARNING: summed device time exceeds the wall time "
                "(overlapping events); the idle share is not a measurement")

    # ---- 5. the same circuit with the JAX package's own MSM plan
    t0 = time.perf_counter()
    kernels.reset_counts()
    cm_plan = api.CacheManager("cuda", msm_plan=((13, 1), (13, 4)))
    cm_plan.get(paths["zkey"])
    torch.cuda.synchronize()
    plan_cache_s = time.perf_counter() - t0
    plan_s, plan_proof, plan_public = _prove_bytes(api, paths, cm_plan, deterministic=True)
    path_counts[f"complex-{n} plan G1 (13, 1), G2 (13, 4)"] = kernels.counts()
    same_plan = (plan_proof, plan_public) == det_small
    log(f"[plan] complex-{n}, G1 (13, 1), G2 (13, 4): cold cache with precompute {plan_cache_s:.3f} "
        f"s, prove {plan_s:.3f} s, deterministic proof == the f = 1 proof: {same_plan}; launches "
        + json.dumps(path_counts[f"complex-{n} plan G1 (13, 1), G2 (13, 4)"]))
    if not same_plan:
        failures.append("precomputed-bases proof differs from the f = 1 proof")
    del cm_plan
    c_sweep = tuple((c, 1) for c in range(12, 17))
    plan_ms = time_msm_plans(cache, paths, dev, g2_plans=c_sweep + ((None, 2), (13, 4)),
                             g1_plans=c_sweep + ((None, 2),))
    sweep = ntt_threshold_sweep(dev)
    del cm, cache
    torch.cuda.empty_cache()

    # ---- 6. the op surface and K9-K11
    ops_readings = op_surface_phase(rep, rng, dev, path_counts, failures)

    # ---- 7. the large circuit
    m = args.large_constraints
    setup_big = drive_setup(f"complex-{m}", os.path.join(args.fixture_dir, f"torch_complex_{m}"),
                            m, dev, path_counts, failures)
    big, big_setup_s = setup_big["paths"], setup_big["s"]
    cm_big = api.CacheManager("cuda")
    t0 = time.perf_counter()
    cache_big = cm_big.get(big["zkey"])
    torch.cuda.synchronize()
    big_cold_s = time.perf_counter() - t0
    g1_lanes = sum(cache_big.g1_sizes)
    g2_lanes = cache_big.b2_records.shape[0] // cache_big.msm_pre2
    log(f"[large] cold cache {big_cold_s:.3f} s: n_vars {cache_big.header.n_vars}, domain "
        f"2^{cache_big.header.power}, G1 lanes {g1_lanes}, G2 lanes {g2_lanes}, c = "
        f"{cache_big.msm_c} (G1), {cache_big.msm_c2} (G2), MSM_MAX_LANES {msm_ops.MSM_MAX_LANES}, "
        f"NTT route {'K5' if cache_big.header.power >= ntt_ops.NTT_BLOCK_MIN_LOG else 'K3'}")
    t1 = time.perf_counter()
    if not check_ntt_block(rep, rng, cache_big.domain, dev):
        failures.append("kernel ntt_block differs from its plain version or from K3")
    log(f"[kernels] ntt_block checked in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    if not check_r1cs(rep, rng, cache_big, dev, large=True):
        failures.append(f"kernel r1cs_rows differs from its plain version at complex-{m}")
    time_field_vec(rep, rng, cache_big.domain.n, dev)
    coset_ok, coset_big = check_coset(rng, cache_big, big, dev, f"complex-{m}", path_counts)
    if not coset_ok:
        failures.append(f"the fused coset evaluation differs from its plain version at complex-{m}")
    fused_ms = fused_pass_times(rng, cache_big.domain, dev)
    torch.cuda.empty_cache()
    log(f"[kernels] r1cs_rows, field_vec and the coset evaluation at complex-{m} in "
        f"{time.perf_counter() - t1:.1f} s")
    for name, fn in (
            ("point_add", lambda: check_acc_windows(rep, rng, cache_big, dev)),
            ("msm g1", lambda: check_msm(rep, rng, cache_big, dev, False, large=True)),
            ("msm g2", lambda: check_msm(rep, rng, cache_big, dev, True, large=True))):
        t1 = time.perf_counter()
        if not fn():
            failures.append(f"kernel {name} differs from its plain version at complex-{m}")
        torch.cuda.empty_cache()
        log(f"[kernels] {name} at complex-{m} checked in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    bits_ok, bits_timing = check_msm_bits(rep, rng, cache_big, big, dev)
    if not bits_ok:
        failures.append(f"K4 differs from its plain version on the bit-valued witness at "
                        f"complex-{m}")
    log(f"[kernels] msm on the bit-valued witness at complex-{m} checked in "
        f"{time.perf_counter() - t1:.1f} s")
    sweep_k4 = k4_sweep(cache_big, dev, rng)
    if not all(v["same"] for v in sweep_k4.values()):
        failures.append("a K4 sweep variant differs from the default as affine points")
    tag = f"complex-{m}"
    torch.cuda.reset_peak_memory_stats()
    big_first_s, big_warm, big_launches, det_big, phases_big = drive_proves(
        tag, big, cm_big, dev, failures, path_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[large] peak device memory over the proves {peak_gb:.2f} GB")
    big_prof = profile_prove(big, cm_big)
    log("[large] profile of one warm prove: " + json.dumps(big_prof))
    if big_prof["missing_kernels"]:
        # once more: does the loss repeat, or was it the first profile's?
        again = profile_prove(big, cm_big)
        log("[large] profile of another warm prove: " + json.dumps(again))
        big_prof = dict(again, first_profile_missing=big_prof["missing_kernels"])
    if big_prof["missing_kernels"]:
        log(f"[large] WARNING: {big_prof['missing_kernels']} launched but left no device record: "
            "the busy time and idle share leave them out")
    bits_big = prove_bits(big, cm_big, dev, cache_big.header.n_public)
    log(f"[bits] complex-{m}, bit-valued witness: " + json.dumps(bits_big))
    variants = {}

    def forced(label, cmgr, patches=()):
        """One deterministic prove with module constants patched for its
        duration; its proof must equal the default route's byte for byte."""
        with patched(*patches):
            kernels.reset_counts()
            secs, proof, public = _prove_bytes(api, big, cmgr, deterministic=True)
            counts = kernels.counts()
        variants[label] = {"s": secs, "launches": counts, "same": (proof, public) == det_big}
        path_counts[f"{tag} {label}"] = counts
        log(f"[large] deterministic prove, {label}: {secs:.3f} s, byte-identical to the first "
            f"deterministic proof: {variants[label]['same']}; launches {json.dumps(counts)}")
        if not variants[label]["same"]:
            failures.append(f"{tag}: the {label} proof differs from the default route's")

    forced("default (in core, K5)", cm_big)
    forced("NTT forced to K3", cm_big, [(ntt_ops, "NTT_BLOCK_MIN_LOG", 99)])
    forced("MSM sliced, max_lanes 2^21", cm_big, [(msm_ops, "MSM_MAX_LANES", 1 << 21)])
    if cache_big.header.power >= ntt_ops.NTT_BLOCK_MIN_LOG:
        if variants["default (in core, K5)"]["launches"]["ntt_block"] == 0:
            failures.append(f"{tag}: the default route did not launch K5")
        k3 = variants["NTT forced to K3"]["launches"]
        radix_launches = 2 * len(ntt_ops.radix_passes(cache_big.header.power,
                                                      ntt_ops.NTT_RADIX_LOG[8]))
        if k3["ntt_block"] != 0 or k3["ntt_radix"] != radix_launches:
            failures.append(f"{tag}: the K3-forced route launched K5 {k3['ntt_block']} times "
                            f"and K3's register passes {k3['ntt_radix']} times, not 0 and "
                            f"{radix_launches}")
    sliced_launches = variants["MSM sliced, max_lanes 2^21"]["launches"]
    slicing = (g1_lanes > (1 << 21)) + (g2_lanes > (1 << 20))  # G2 slices at half the lanes
    if sliced_launches["point_add"] != slicing:
        failures.append(f"{tag}: the sliced route launched K6 {sliced_launches['point_add']} "
                        f"times, not once for each of the {slicing} groups that slice")
    big_plan_ms = time_msm_plans(cache_big, big, dev, reps=2, g2_plans=c_sweep + ((None, 2),),
                                 g1_plans=c_sweep + ((None, 2),))
    cm_f2 = api.CacheManager("cuda", msm_plan=((cache_big.msm_c, 1), (cache_big.msm_c2, 2)))
    kernels.reset_counts()
    t0 = time.perf_counter()
    cm_f2.get(big["zkey"])
    torch.cuda.synchronize()
    path_counts[f"{tag} cold cache, G2 f = 2"] = kernels.counts()
    log(f"[large] cold cache with G2 factor 2: {time.perf_counter() - t0:.3f} s, launches "
        + json.dumps(path_counts[f"{tag} cold cache, G2 f = 2"]))
    forced("G2 bases precomputed, f = 2", cm_f2)
    del cm_f2

    # ---- 8. the probe entry point
    kernels.reset_counts()
    probe_rows = throughput_probe.measure()
    path_counts["throughput probe"] = kernels.counts()
    for r in probe_rows:
        log(f"[probe] {r['op']:13s} W={r['width']}  depth {r['depth']}  {r['ms']:9.3f} ms  "
            f"{r['t_ops_per_s']:8.3f} T op/s")
    mul_rate = throughput_probe.multiply_rate(probe_rows)
    log("[probe] multiply rate: " + json.dumps(mul_rate) + f"; the bounds assume "
        f"{INT_MULS_PER_S / 1e12:.2f} T multiplies/s")

    # ---- 9. small circuits against the oracle
    from icicle_snark_tpu_torch.setup.r1cs import poseidon_bits_circuit

    r1cs = complex_circuit(40, 50)
    for tag, name, circuit, folds in (
            ("complex(40, 50)", "complex_40_50", (r1cs, complex_circuit_witness(r1cs, a=7)), 0),
            ("poseidon_bits", "poseidon_bits", poseidon_bits_circuit(*POSEIDON_BITS_INPUTS), 2)):
        # the CLI worker splits its command lines on whitespace: no space in the directory
        if not check_against_oracle(tag, os.path.join(OUT_DIR, f"smoke_{name}"), *circuit, dev,
                                    path_counts, min_fold_levels=folds):
            failures.append(f"{tag}: the device zkey or the CLI's deterministic proof differs "
                            "from the oracle's, or K2 did not fold")

    # ---- 10. the other curves
    curves = curves_phase(rep, rng, dev, path_counts, failures)
    log(f"[curves] phase in {curves['phase_s']:.1f} s")

    # ---- 11. the sharded prove on meshes of this card
    multi = multichip_phase(rep, rng, dev, big, cache_big, paths, path_counts, failures)
    del cm_big, cache_big
    torch.cuda.empty_cache()

    # ---- 12. the reference's benchmark family at full size
    family = family_phase(args.fixture_dir, dev, path_counts, failures)

    # ---- 13. report: a kernel's launches are those of the first driven path
    # that ran it (each path was driven with the counts set to 0 before it)
    rows = []
    for k in kernels.ALL:
        row = rep.rows.get(k.name, {})
        ran = [(path, c[k.name]) for path, c in path_counts.items() if c.get(k.name)]
        if not ran:
            failures.append(f"kernel {k.name} did not launch on any driven path")
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": ran[0][1] if ran else 0, "launched_on": ran[0][0] if ran else None,
            "launches_by_path": dict(ran), "max_abs_err": row.get("max_abs_err"),
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": None,
            "equal_to_plain": row.get("equal_to_plain"), "timed": row.get("timed"),
            **({"large": row["large"]} if "large" in row else {}),
            **({"fermat_bound_ms": row["fermat_bound_ms"]} if "fermat_bound_ms" in row else {}),
            # device ms in one profiled warm prove, complex-N and complex-M
            "prove_device_ms": [sum(v for name, v in pr["kernels_ms"].items()
                                    if any(f in name for f in KERNEL_FUNCTIONS[k.name]))
                                for pr in (prof, big_prof)],
        })
        if row.get("equal_to_plain") is None:
            failures.append(f"kernel {k.name} was not held against its plain version")
    summary = {
        "card": card, "constraints": n, "setup_s": setup_small["s"],
        "setup_phases": setup_small["phases"], "setup_split": setup_small["split"],
        "op_surface": ops_readings,
        "cold_cache_s": cold_cache_s, "first_prove_s": first_s,
        "warm_prove_s": warm, "warm_phases": phases_small, "launches": launches, "profile": prof,
        "bits_prove": bits_small, "coset": coset_small, "ptxas": usage, "sass": sass,
        "plan_13_4": {"cold_cache_s": plan_cache_s, "prove_s": plan_s, "same_proof": same_plan},
        "msm_plan_ms": plan_ms, "ntt_threshold_sweep": sweep,
        "large": {"constraints": m, "setup_s": big_setup_s, "setup_phases": setup_big["phases"],
                  "setup_split": setup_big["split"],
                  "cold_cache_s": big_cold_s,
                  "first_prove_s": big_first_s, "warm_prove_s": big_warm,
                  "warm_phases": phases_big, "coset": coset_big, "fused_passes_ms": fused_ms,
                  "launches": big_launches, "profile": big_prof, "peak_memory_gb": peak_gb,
                  "deterministic_variants": variants, "msm_plan_ms": big_plan_ms,
                  "bits_prove": bits_big, "msm_bits": bits_timing, "k4_sweep": sweep_k4,
                  "ntt_block": rep.rows.get(kernels.NTT_BLOCK.name)},
        "probe": probe_rows, "multiply_rate": mul_rate, "curves": curves, "multichip": multi,
        "family": family,
        "path_counts": path_counts,
        "failures": failures, "total_s": time.perf_counter() - t_all, "kernels": rows,
    }
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke_{n}_{m}.json"), "w") as fh:
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
