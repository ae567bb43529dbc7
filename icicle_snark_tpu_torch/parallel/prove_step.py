"""The Groth16 prove sharded over a device mesh: three phases, then the host.

The port's counterpart of icicle_snark_tpu/parallel/prove_step.py, bit-exact
with the single-device prove at any mesh size:

  A. R1CS and coset evaluation -> h, natural order, one contiguous chunk a
     shard.
     * R1CS: each shard evaluates exactly the A and B slots of its own
       i2 block of the four-step matrix, slots i1 n2 + i2 for i2 in the
       block, with K2 on a sub-plan of the cache's CSR plan (`shard_plan`,
       built once per cache and mesh, with its own fold tables). No
       collective: the JAX package shards records instead and sums the
       lazy columns of all 2n slots across devices (`psum`), which the
       port's row plan makes unnecessary.
     * Coset evaluation: the inverse four-step transform to the
       intermediate [k1_loc][k2] order (parallel/ntt_dist.py, K5 and K15),
       the coset keys multiplied in that order (K1: each shard's key
       table, 1/n folded in as ZKeyCache.keys_br_scaled has it,
       broadcast over the three rows), the forward transform with its factors swapped, which takes
       the intermediate order as its input. h = (A B - C) R^2 is
       elementwise, so it is computed (K1) before the last exchange, which
       then moves one row instead of three.
     * A domain too small to tile the mesh (n1 % D != 0) takes the
       replicated route: the single-device `construct_r1cs`, and each shard
       keeps its chunk.
  B. The four G1 MSMs: each group padded to a multiple of D (scalars with
     zeros, points with the (0, 0) identity, both exact no-ops), each shard
     runs K4 over its lanes of every group, in core or sliced as ops/msm.py
     `window_sums` routes it; the window sums of all shards are gathered
     and added in a fixed pairwise order with K6 (parallel/msm_shard.py),
     so the result does not depend on the mesh.
  C. The G2 MSM, the same.
Then the single-device prove's host tail: ops/msm.py `host_points` (the
combine), prover/pipeline.py's three randomisation steps, serialization.

Sharded values are lists with one tensor per local shard (parallel/mesh.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import trace
from ..fields import limbs as lb
from ..fields.limbs import FR_SPEC, NLIMB
from ..ops import msm as msm_ops
from ..prover import pipeline
from ..prover.cache import R1CSPlan
from . import msm_shard, ntt_dist
from .mesh import globalize, on_device


# ---------------------------------------------------------------- per-mesh state

@dataclass
class MeshParts:
    """The cache's per-shard state for one mesh: this process's shards."""

    use_dist: bool     # the four-step route (else the replicated one)
    plans: list        # R1CS sub-plans (four-step route)
    keys: list         # (n1/D, 8, n2) coset keys, intermediate order, 1/n in
    g1_records: list   # K4 records: groups A, B1, C, H, each a shard's lanes
    g1_widths: list    # scalar lanes of each G1 group in one shard
    b2_records: list
    b2_width: int


def shard_plan(plan: R1CSPlan, slots: torch.Tensor) -> R1CSPlan:
    """The rows of `plan` for `slots` (A slots, then B slots, in the order
    K2 writes them): a CSR plan of its own, slot i of it is plan's
    slots[i]. Its fold tables are built at its first K2 call."""
    offsets = plan.offsets.long()
    lo, counts = offsets[slots], offsets[slots + 1] - offsets[slots]
    sub = torch.zeros(slots.numel() + 1, dtype=torch.int64, device=slots.device)
    sub[1:] = torch.cumsum(counts, 0)
    owner = torch.repeat_interleave(torch.arange(slots.numel(), device=slots.device), counts)
    idx = lo[owner] + torch.arange(owner.numel(), device=slots.device) - sub[:-1][owner]
    return R1CSPlan(witness_idx=plan.witness_idx[idx].contiguous(),
                    coefs=plan.coefs[:, idx].contiguous(), offsets=sub.to(torch.int32),
                    num_slots=slots.numel())


def _pad_last(t: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-t.shape[-1]) % mult
    return t if pad == 0 else torch.cat([t, t.new_zeros(t.shape[:-1] + (pad,))], dim=-1)


def _shard_records(mesh, records: torch.Tensor, sizes, pre: int) -> tuple:
    """K4 records of concatenated groups (`sizes` scalar lanes each, `pre`
    rows a lane) -> (this process's shards: each shard's rows of every
    group, groups padded with (0, 0) rows to D lanes; the lanes of each
    group in a shard)."""
    d = mesh.size
    widths = [-(-n // d) for n in sizes]
    per_group, lo = [], 0
    for n, w in zip(sizes, widths):
        rec = records[pre * lo: pre * (lo + n)]
        pad = pre * (w * d - n)
        if pad:
            rec = torch.cat([rec, rec.new_zeros((pad, rec.shape[1]))])
        per_group.append(globalize(mesh, rec, 0))
        lo += n
    return [torch.cat(parts) for parts in zip(*per_group)], widths


def pad_cache_for_mesh(cache, mesh) -> MeshParts:
    """The cache's per-shard state for `mesh` (this process's shards),
    built at the first call and kept in cache.mesh_parts: each shard's R1CS
    sub-plan and key table (four-step route), and its K4 records of every
    G1 group and of G2, each group padded to a multiple of the mesh size
    with (0, 0) points (the JAX pad_cache_for_mesh's padding)."""
    if mesh.key in cache.mesh_parts:
        return cache.mesh_parts[mesh.key]
    d, hdr = mesh.size, cache.header
    log_n, n = hdr.power, hdr.domain_size
    use_dist = d > 1 and ntt_dist.can_distribute(log_n, d)
    plans, keys = [], []
    if use_dist:
        log_n1, log_n2 = ntt_dist.split_logs(log_n, d)
        n1, n2 = 1 << log_n1, 1 << log_n2
        dev0 = cache.keys_br_scaled.device
        # natural-order keys with 1/n: keys_br_scaled undone by the bit reversal
        kt = cache.keys_br_scaled[:, cache.domain.bitrev].reshape(NLIMB, n2, n1).permute(2, 0, 1)
        for shard, dev in zip(mesh.local, mesh.local_devices):
            i2 = shard * (n2 // d) + torch.arange(n2 // d, device=dev0)
            a = (torch.arange(n1, device=dev0)[:, None] * n2 + i2[None, :]).flatten()
            p = shard_plan(cache.plan, torch.cat([a, a + n]))
            plans.append(R1CSPlan(p.witness_idx.to(dev), p.coefs.to(dev), p.offsets.to(dev),
                                  p.num_slots))
            keys.append(kt[shard * (n1 // d): (shard + 1) * (n1 // d)].contiguous().to(dev))
    g1, g1_widths = _shard_records(mesh, cache.g1_records, cache.g1_sizes, cache.msm_pre)
    b2, (b2_width,) = _shard_records(mesh, cache.b2_records, [hdr.n_vars], cache.msm_pre2)
    parts = MeshParts(use_dist, plans, keys, g1, g1_widths, b2, b2_width)
    cache.mesh_parts[mesh.key] = parts
    return parts


# ------------------------------------------------------- phase A: R1CS + coset

def coset_h_sharded(mesh, batches: list, keys: list, log_n: int) -> list:
    """The coset evaluation over the mesh: each shard's K2 batch (3, 8,
    n1 n2/D), slots i1 n2 + i2 of its i2 block in [i1][i2_loc] order ->
    its natural-order contiguous chunk of h, (8, n/D)."""
    d = mesh.size
    log_n1, log_n2 = ntt_dist.split_logs(log_n, d)
    n1, n2 = 1 << log_n1, 1 << log_n2
    cols = [x.reshape(3, NLIMB, n1, n2 // d).permute(0, 3, 1, 2).contiguous() for x in batches]
    # 1/n rides on the keys
    t = ntt_dist.ntt_four_step_partial(mesh, cols, log_n1, log_n2, True, unscaled=True)
    for i, (k, dev) in enumerate(zip(keys, mesh.local_devices)):
        with on_device(dev):  # row (b, k1_loc) times key row k1_loc (K1)
            t[i] = lb.mont_mul(t[i].view(3 * (n1 // d), NLIMB, n2), k, FR_SPEC).view(t[i].shape)
    # factors swapped: the forward transform reads [k1_loc][k2] as its columns
    y = ntt_dist.ntt_four_step_partial(mesh, t, log_n2, log_n1, False)
    hs = []
    for yi, dev in zip(y, mesh.local_devices):
        with on_device(dev):
            h = lb.sub_mod(lb.mont_mul(yi[0], yi[1], FR_SPEC), yi[2], FR_SPEC)
            hs.append(lb.mont_mul(h, lb.const(FR_SPEC.r2, dev), FR_SPEC).unsqueeze(0))
    return [h[0] for h in ntt_dist.to_natural(mesh, hs)]


def r1cs_coset_step(mesh, cache, witness: torch.Tensor) -> list:
    """Phase A: (8, n_vars) standard witness -> this process's chunks of h,
    (8, n/D) standard-form scalars each (the JAX build_r1cs_coset_step's
    output sharding)."""
    parts = pad_cache_for_mesh(cache, mesh)
    if not parts.use_dist:
        return globalize(mesh, pipeline.construct_r1cs(witness, cache), -1)
    batches = []
    for plan, dev in zip(parts.plans, mesh.local_devices):
        with on_device(dev):
            batches.append(pipeline.r1cs_rows(witness.to(dev), plan))
    return coset_h_sharded(mesh, batches, parts.keys, cache.header.power)


# ----------------------------------------------------------------- phases B, C

def msm_g1_step(mesh, parts: MeshParts, wit: list, wit_c: list, h: list, c: int,
                max_lanes: int, pre: int = 1) -> torch.Tensor:
    """Phase B: the four grouped G1 MSMs (A, B1 on the witness, C on its
    private part, H on h) over the mesh -> (3, 8, 4, W) window sums."""
    scalars = [torch.cat(s, dim=-1) for s in zip(wit, wit, wit_c, h)]
    return msm_shard.msm_window_sums_local(mesh, scalars, parts.g1_widths, parts.g1_records, c,
                                           max_lanes, pre)


def msm_g2_step(mesh, parts: MeshParts, wit: list, c: int, max_lanes: int,
                pre: int = 1) -> torch.Tensor:
    """Phase C: the G2 MSM over the mesh -> (3, 2, 8, 1, W) window sums."""
    return msm_shard.msm_window_sums_local(mesh, wit, [parts.b2_width], parts.b2_records, c,
                                           max_lanes, pre)


def window_sizes(cache, d: int, max_lanes: int, c: int | None = None,
                 c2: int | None = None) -> tuple:
    """(c, c2), the G1 and G2 window sizes of a prove over d shards.
    Precomputed bases are shifted for exactly the cache's sizes, so they
    fix their own; otherwise c as given, else the cache's (the
    single-device choice), and c2 as given, else the G2 MSM's own optimum:
    one group at half the slice width (the JAX package's _choose_c2)."""
    n_pts = cache.header.n_vars + (-cache.header.n_vars) % d  # scalar lanes, padded
    c = cache.msm_c if cache.msm_pre > 1 else (c or cache.msm_c)
    c2 = cache.msm_c2 if cache.msm_pre2 > 1 else (
        c2 or msm_ops.choose_c(min(n_pts // d, max_lanes // 2), groups=1))
    return c, c2


# ---------------------------------------------------------------- the prove

def run_sharded_prove(mesh, cache, witness: torch.Tensor, c: int | None = None,
                      max_lanes: int | None = None, c2: int | None = None,
                      timer: pipeline.PhaseTimer | None = None):
    """The device phases over the mesh; returns (this process's h chunks,
    G1 window sums (3, 8, 4, W), G2 window sums (3, 2, 8, 1, W)).

    `witness`: (8, n_vars) standard-form limbs (unpadded); c and c2 as
    `window_sizes` settles them; `timer` (a pipeline.PhaseTimer) takes
    each phase's time."""
    mark = (timer or trace.NULL).mark
    d, hdr = mesh.size, cache.header
    parts = pad_cache_for_mesh(cache, mesh)
    max_lanes = max_lanes or msm_ops.MSM_MAX_LANES
    c, c2 = window_sizes(cache, d, max_lanes, c, c2)

    h = r1cs_coset_step(mesh, cache, witness)
    mark("phase_a")
    wit = globalize(mesh, _pad_last(witness, d), -1)
    wit_c = globalize(mesh, _pad_last(witness[:, hdr.n_public + 1:], d), -1)
    ws_g1 = msm_g1_step(mesh, parts, wit, wit_c, h, c, max_lanes, cache.msm_pre)
    mark("phase_b")
    ws_b2 = msm_g2_step(mesh, parts, wit, c2, max_lanes, cache.msm_pre2)
    mark("phase_c")
    return h, ws_g1, ws_b2


def prove_multichip(mesh, wtns_path: str, cache, deterministic: bool = False, rng=None,
                    c: int | None = None, timer: pipeline.PhaseTimer | None = None):
    """The whole prove over the mesh: the sharded device phases, then
    the single-device prove's host combine and randomisation. Bit-exact
    with the single-device prove at any mesh size. Returns (proof_dict,
    public_signals) in every process."""
    timer = timer or trace.NULL
    hdr = cache.header
    wtns, witness = pipeline.read_witness(wtns_path, hdr, cache.keys_br_scaled.device)
    timer.mark("witness_ingest")
    c, c2 = window_sizes(cache, mesh.size, msm_ops.MSM_MAX_LANES, c)
    _h, ws_g1, ws_b2 = run_sharded_prove(mesh, cache, witness, c=c, c2=c2, timer=timer)

    g1 = msm_ops.host_points(ws_g1.cpu().numpy(), c, 4, g2=False)  # one download, four groups
    (pi_b,) = msm_ops.host_points(ws_b2.cpu().numpy(), c2, 1, g2=True)
    timer.mark("horner")
    r, s = pipeline.draw_rs(deterministic, rng)
    terms = pipeline.randomize_terms(hdr, r, s)
    pi_a, pi_c = pipeline.randomize_g1(terms, r, s, *g1)
    proof_points = (pi_a, pipeline.randomize_g2(terms, pi_b), pi_c)
    return pipeline.assemble_proof(hdr, wtns, proof_points, timer)
