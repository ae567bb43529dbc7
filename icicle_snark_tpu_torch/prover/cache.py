"""Device-resident proving-key cache.

The analog of the reference's ZKeyCache/CacheManager (src/cache.rs) and of
icicle_snark_tpu/prover/cache.py: parse the zkey once, upload the MSM bases
and the coefficient table, build the R1CS plan and the coset key powers.

  * Points and coefficients stay in Montgomery form (R = 2^256 is the
    snarkjs radix): the (n, 8) words upload with a transpose only.
  * The R1CS plan is CSR: records sorted by output slot (torch.sort),
    per-slot counts (bincount) and row offsets (cumsum). Kernel K2 reduces
    each row mod r term by term, so one level serves every fan-in; slots
    of more than `pipeline.R1CS_PIECE` terms get fold tables at first use
    (`pipeline.r1cs_fold_plan`, kept in `folds`).
  * The coset keys are kept only in bit-reversed order with 1/n folded in
    (`keys_br_scaled`), the multiplier of K5's last inverse pass.
  * The MSM plan ((c, f) for the grouped G1 MSM and for the G2 MSM) is
    baked in at cache build: with a precompute factor f > 1 the bases are
    the f interleaved shifted copies of ops/msm.py `precompute_bases`
    (kernel K7), shifted for exactly that window size. The default plan is
    `msm_ops.choose_c_pre` (factor 1: the zkey's points as they are).
  * The bases are resident once, as K4's lane-major records (`g1_records`,
    `b2_records`): the limb-major points they are built from are not kept.
    ops/msm.py routes every MSM over them and combines its results.
"""

from __future__ import annotations

from dataclasses import InitVar, dataclass, field

import torch

from ..curve import jcurve as jc
from ..fields import limbs as lb
from ..fields.limbs import FR_SPEC, words_to_limbs
from ..io.zkey import ZKeyFile, ZKeyHeader
from ..ops import msm as msm_ops
from ..ops.ntt import NTTDomain, powers_mont
from ..refmath.field import W
from ..runtime import require_device
from ..trace import NULL


@dataclass
class R1CSPlan:
    """CSR plan for out[m*n + c] += coef * witness[s] (A rows, then B rows)."""

    witness_idx: torch.Tensor  # (nnz,) int32, sorted by output slot
    coefs: torch.Tensor        # (8, nnz) int32 Montgomery limbs
    offsets: torch.Tensor      # (num_slots + 1,) int32 row offsets
    num_slots: int             # 2 * domain_size
    # K2's fold tables by piece size (prover/pipeline.py r1cs_fold_plan)
    folds: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class ZKeyCache:
    header: ZKeyHeader
    plan: R1CSPlan
    # the bases, only read to build the records below, not kept
    points_a: InitVar[tuple]   # (x, y): each (8, n_vars * msm_pre) Montgomery affine
    points_b1: InitVar[tuple]
    points_b2: InitVar[tuple]  # (x, y): each (2, 8, n_vars * msm_pre2)
    points_c: InitVar[tuple]
    points_h: InitVar[tuple]
    # (8, n) Montgomery coset key powers, NATURAL order: only read to build
    # keys_br_scaled, not kept
    keys: InitVar[torch.Tensor]
    domain: NTTDomain
    msm_c: int = 0     # G1 grouped window size (0: chosen here)
    msm_c2: int = 0    # G2 window size
    msm_pre: int = 1   # G1 precompute factor the points were built with
    msm_pre2: int = 1  # G2 precompute factor
    # K4's lane-major point records (ops/msm.py point_records), built once
    g1_records: torch.Tensor = field(init=False)  # A|B1|C|H concatenated
    b2_records: torch.Tensor = field(init=False)
    g1_sizes: list = field(init=False)    # scalar lanes of each G1 group
    # keys[:, bitrev] * n^-1 (Montgomery): K5's last inverse pass multiplies by it
    keys_br_scaled: torch.Tensor = field(init=False)
    # the sharded prove's per-shard state by mesh (parallel/prove_step.py
    # pad_cache_for_mesh), built at its first prove on that mesh
    mesh_parts: dict = field(init=False, default_factory=dict, repr=False, compare=False)
    # a pipeline.PhaseTimer that takes the phases key_table and records, or None
    timer: InitVar = None

    def __post_init__(self, points_a, points_b1, points_b2, points_c, points_h, keys, timer):
        dom = self.domain
        self.keys_br_scaled = lb.mont_mul(keys[:, dom.bitrev].contiguous(), dom.n_inv_mont, FR_SPEC)
        timer = timer or NULL
        timer.mark("key_table")
        groups = (points_a, points_b1, points_c, points_h)
        self.g1_records = msm_ops.point_records(
            tuple(torch.cat([g[i] for g in groups], dim=-1) for i in range(2)))
        self.b2_records = msm_ops.point_records(points_b2)
        timer.mark("records")
        self.g1_sizes = [g[0].shape[-1] // self.msm_pre for g in groups]
        self.msm_c = self.msm_c or msm_ops.choose_c(sum(self.g1_sizes), 4, self.msm_pre)
        self.msm_c2 = self.msm_c2 or msm_ops.choose_c(
            self.b2_records.shape[0] // self.msm_pre2, 1, self.msm_pre2)


def build_r1cs_plan(slots: torch.Tensor, witness_idx: torch.Tensor,
                    coefs: torch.Tensor, domain_size: int) -> R1CSPlan:
    """CSR plan from unsorted records: slots (nnz,) int64 in [0, 2n),
    witness_idx (nnz,), coefs (8, nnz) int32, all on the target device."""
    num_slots = 2 * domain_size
    if slots.numel() and (int(slots.min()) < 0 or int(slots.max()) >= num_slots):
        raise ValueError("coefficient record outside the 2 x domain slots")
    slot_sorted, order = torch.sort(slots, stable=True)
    counts = torch.bincount(slot_sorted, minlength=num_slots)
    offsets = torch.zeros(num_slots + 1, dtype=torch.int64, device=slots.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return R1CSPlan(
        witness_idx=witness_idx[order].to(torch.int32).contiguous(),
        coefs=coefs[:, order].contiguous(),
        offsets=offsets.to(torch.int32),
        num_slots=num_slots,
    )


def _g1(words, dev) -> tuple:
    """(n, 16) u32 affine words -> ((8, n), (8, n))."""
    return (words_to_limbs(words[:, :8], dev), words_to_limbs(words[:, 8:16], dev))


def _g2(words, dev) -> tuple:
    """(n, 32) u32 -> ((2, 8, n), (2, 8, n))."""
    x = torch.stack([words_to_limbs(words[:, 0:8], dev), words_to_limbs(words[:, 8:16], dev)])
    y = torch.stack([words_to_limbs(words[:, 16:24], dev), words_to_limbs(words[:, 24:32], dev)])
    return (x, y)


def default_msm_plan(hdr) -> tuple:
    """((c1, f1), (c2, f2)) of `msm_ops.choose_c_pre` for a key's lanes:
    the grouped G1 MSM over A, B1, C and H, and the G2 MSM over B2."""
    total_g1 = 3 * hdr.n_vars - (hdr.n_public + 1) + hdr.domain_size
    return (msm_ops.choose_c_pre(total_g1, groups=4),
            msm_ops.choose_c_pre(hdr.n_vars, groups=1, g2=True))


def load_zkey_cache(zkey_path: str, device="cuda", msm_plan=None, timer=None) -> ZKeyCache:
    """Parse the zkey and build the device cache. `msm_plan` is
    ((c1, f1), (c2, f2)), window size and precompute factor of the grouped
    G1 MSM and of the G2 MSM; None takes `default_msm_plan`. `timer`
    (a pipeline.PhaseTimer) takes the phases parse (the header and section 4
    decoded), upload (the point sections read from the memory-mapped file,
    transposed and copied to the device, with any precompute), plan_sort,
    key_table (the coset keys and the domain's twiddle tables) and records."""
    dev = require_device(device)
    zk = ZKeyFile(zkey_path)
    hdr = zk.header
    n = hdr.domain_size
    (c1, f1), (c2, f2) = msm_plan or default_msm_plan(hdr)

    mark = (timer or NULL).mark

    def pre1(points):
        return msm_ops.precompute_bases(points, jc.G1, c1, f1)

    m_arr, c_arr, s_arr, coef_words = zk.coefficients()
    mark("parse")
    slots = (torch.from_numpy(m_arr.astype("int64")) * n
             + torch.from_numpy(c_arr.astype("int64"))).to(dev)
    witness_idx = torch.from_numpy(s_arr.astype("int64")).to(dev)
    coefs = words_to_limbs(coef_words, dev)
    points = {k: pre1(_g1(getattr(zk, f"points_{k}")(), dev)) for k in ("a", "b1", "c", "h")}
    points_b2 = msm_ops.precompute_bases(_g2(zk.points_b2(), dev), jc.G2, c2, f2)
    mark("upload")
    plan = build_r1cs_plan(slots, witness_idx, coefs, n)
    mark("plan_sort")
    # coset generator g with g^n = -1 (reference cache.rs:168)
    keys = powers_mont(W[hdr.power + 1], hdr.power, dev)
    return ZKeyCache(
        header=hdr,
        plan=plan,
        points_a=points["a"],
        points_b1=points["b1"],
        points_b2=points_b2,
        points_c=points["c"],
        points_h=points["h"],
        keys=keys,
        domain=NTTDomain(hdr.power, dev),
        msm_c=c1, msm_c2=c2, msm_pre=f1, msm_pre2=f2,
        timer=timer,
    )


class CacheManager:
    """Keyed zkey cache surviving across prove calls (reference:
    CacheManager, src/cache.rs:110-262), for one device."""

    def __init__(self, device="cuda", msm_plan=None):
        self.device = require_device(device)
        self.msm_plan = msm_plan  # None: the default plan of load_zkey_cache
        self._caches: dict = {}

    def contains(self, zkey_path: str) -> bool:
        return zkey_path in self._caches

    def get(self, zkey_path: str, timer=None) -> ZKeyCache:
        """The cache of `zkey_path`, loaded at first use (`timer` takes that
        load's phases, as in load_zkey_cache)."""
        if zkey_path not in self._caches:
            self._caches[zkey_path] = load_zkey_cache(zkey_path, self.device, self.msm_plan, timer)
        return self._caches[zkey_path]
