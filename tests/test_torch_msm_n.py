"""K13's new design on the CPU (its plain versions and its programs), and
BN254's plain versions unchanged:

  * both programs of ops/point_programs.py, interpreted over Python
    integers (`run_program`), give the words of the plain point formulas
    (curve/jcurve.py padd, pdbl over the group's plain tables) for the six
    point types, P = Q and identities among the lanes;
  * K13's reduce (`msm_reduce_n_plain`: segments, then the tree) gives
    sum_b b * B_b of random projective buckets (identities among them) in
    affine form, with tree levels (c = 8) and without (c = 5, one segment
    a row);
  * the window sums through `msm_window_sums` with bit-valued scalars,
    BUCKET_PIECE 2 (every fold level) and c = 8 (three tree levels) equal
    the JAX package's eager `msm_device_grouped` window by window in affine
    form;
  * BN254's plain window sums (K4's plain versions) give the words they gave
    before K13 changed: digests of a seed-made case, taken with the earlier
    tree's package.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curves import device as jcdev
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.curves import host
from icicle_snark_tpu_torch.curves.params import get_curve
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.ops import point_programs as pprog
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import R_MOD, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

GROUPS = [("bls12_377", False), ("bls12_377", True), ("bls12_381", False),
          ("bls12_381", True), ("bw6_761", False), ("bw6_761", True)]
IDS = [f"{c}_{'g2' if g else 'g1'}" for c, g in GROUPS]


def _group(name, g2):
    p = get_curve(name)
    grp = cdev.g2_group(name) if g2 else cdev.g1_group(name)
    hc = host.g2_curve(p) if g2 else host.g1_curve(p)
    return p, grp, hc


def _projective(p, hc, g2, rng, count, identities=()):
    """`count` random multiples of the generator as projective points with a
    random z (the identity (0, 1, 0) at `identities`)."""
    gen = hc.from_affine(p.g2 if g2 else p.g1)
    fq2 = g2 and p.fp2_nonresidue is not None
    q = p.q
    out = []
    for i in range(count):
        if i in identities:
            out.append(((0, 0), (1, 0), (0, 0)) if fq2 else (0, 1, 0))
            continue
        x, y = hc.to_affine(hc.mul_scalar(gen, int(rng.integers(1, 1 << 40))))
        z = int.from_bytes(rng.bytes(100), "little") % (q - 1) + 1
        if fq2:
            nr = p.fp2_nonresidue
            def mul(u, v):
                return ((u[0] * v[0] + nr * u[1] * v[1]) % q, (u[0] * v[1] + u[1] * v[0]) % q)
            out.append((mul(x, (z, 0)), mul(y, (z, 0)), (z, 0)))
        else:
            out.append((x * z % q, y * z % q, z))
    return out


def _to_device(points, grp):
    """Host projective points -> (3, coords..., n) Montgomery limbs."""
    spec = grp.plain.spec
    q, r = spec.modulus, spec.r_mod

    def limbs(vals):
        return lb.ints_to_limbs([v * r % q for v in vals], "cpu", spec.words)

    coords = []
    for j in range(3):
        vals = [pt[j] for pt in points]
        if grp.g2 and len(grp.coords) == 2:
            coords.append(torch.stack([limbs([v[0] for v in vals]), limbs([v[1] for v in vals])]))
        else:
            coords.append(limbs(vals))
    return torch.stack(coords)


@pytest.mark.parametrize("group", range(len(GROUPS)), ids=IDS)
def test_programs_match_plain_formulas(group):
    name, g2 = GROUPS[group]
    p, grp, hc = _group(name, g2)
    gp = pprog.build_programs(grp)
    rng = np.random.default_rng(group)
    n = 6
    P = _projective(p, hc, g2, rng, n, identities=(2,))
    Q = _projective(p, hc, g2, rng, n, identities=(3,))
    P[1] = Q[1]  # doubling through the complete add
    tp, tq = _to_device(P, grp), _to_device(Q, grp)
    ops = grp.plain
    want = {pprog.ADD: jc.padd(ops, jc.point_unstack(tp), jc.point_unstack(tq)),
            pprog.DBL: jc.pdbl(ops, jc.point_unstack(tp))}
    w = gp.width

    def lane_words(t, i):
        """(3, coords..., n) -> the lane's Fq values, coordinate-major."""
        return lb.limbs_to_ints(t[..., i].reshape(-1, gp.words).T.contiguous())

    for i in range(n):
        pw, qw = lane_words(tp, i), lane_words(tq, i)
        for prog, slots in ((pprog.ADD, pw + qw), (pprog.DBL, list(pw))):
            got = pprog.run_program(gp, prog, slots, p.q)
            assert got[:3 * w] == lane_words(jc.point_stack(want[prog]), i), (prog, i)


@pytest.mark.parametrize("name, g2, c", [("bls12_381", False, 8), ("bls12_377", True, 8),
                                         ("bw6_761", True, 5)])
def test_tree_reduce_matches_host_sum(name, g2, c):
    p, grp, hc = _group(name, g2)
    half, windows = 1 << (c - 1), 2
    rng = np.random.default_rng(c)
    pts = _projective(p, hc, g2, rng, windows * half, identities=(0, 7, half - 1))
    ws = msm.msm_reduce_n_plain(grp.plain, _to_device(pts, grp), windows, 1, half)
    seg, n_seg = msm.reduce_shape_n(half)
    assert (n_seg > 1) == (c == 8)
    got = cdev.window_points_to_host(ws, grp.ops, 0)
    for w in range(windows):
        want = hc.zero_pt
        for b in range(half):
            want = hc.add(want, hc.mul_scalar(pts[w * half + b], b + 1))
        assert hc.to_affine(got[w]) == hc.to_affine(want)


def test_every_fold_level_and_tree_level_match_jax(monkeypatch):
    """Bit-valued scalars put every lane with a 1 into bucket 1 of window 0:
    with BUCKET_PIECE 2 the accumulate folds it over log2 levels; c = 8
    gives the reduce three tree levels above its segments."""
    name = "bls12_381"
    p, grp, hc = _group(name, False)
    n = 48
    pts, cur = [], hc.from_affine(p.g1)
    for _ in range(n):
        pts.append(hc.to_affine(cur))
        cur = hc.add(cur, hc.from_affine(p.g1))
    pts[7] = None
    rng = np.random.default_rng(3)
    scs = [int(b) for b in rng.integers(0, 2, size=n)]
    fr = cdev.curve_specs(name)[1]
    monkeypatch.setattr(msm, "BUCKET_PIECE", 2)
    sc = lb.ints_to_limbs(scs, "cpu", fr.words)
    rec = msm.point_records(cdev.affine_to_device(pts, grp.ops, "cpu"))
    order, negs, ends = msm.sort_windows(sc, [n], 8)
    assert len(msm.bucket_fold_plan(ends, order.shape[0], 1, 128, n)) >= 5
    mine = cdev.window_points_to_host(msm.msm_window_sums(sc, [n], rec, 8, group=grp), grp.ops)
    jops = jcdev.g1_ops(name)
    jsc = jnp.asarray(jlb.ints_to_limbs_np(scs, 2 * fr.words))
    jws = jmsm.msm_device_grouped([jsc], [jcdev.affine_to_device(pts, jops)], jops, c=8, k=8)
    theirs = jcdev.window_points_to_host(jws, jops)
    assert [hc.to_affine(a) for a in mine] == [hc.to_affine(b) for b in theirs]
    assert hc.to_affine(mine[0]) == hc.to_affine(hc.msm(scs, pts))


# sha256 of K4's plain window sums of `_bn254_case` at BUCKET_PIECE 2, then
# 16, taken with the package as it was before K13's redesign
BN254_DIGESTS = {
    False: "f9518cdf64453064135eb8dc420f4f287fcd8445d28520c93f01619d7ec0ac9e",
    True: "fe95c1377aada0e0d68bed2c449235ff55109913efc56cf9ba594d387a03bda6",
}


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_bn254_plain_window_sums_unchanged(g2, monkeypatch):
    rng = np.random.default_rng(9 + g2)
    sizes = (9, 7) if g2 else (12, 12, 10, 14)
    n = sum(sizes)
    ks = [int(k) for k in rng.integers(1, 1 << 20, size=n)]
    if g2:
        aff = [cv.g2_to_affine(cv.g2_mul(cv.G2_GEN, k)) for k in ks]
        x, y = (torch.stack([lb.ints_to_limbs([fq_to_mont(a[j][i]) for a in aff])
                             for i in range(2)]) for j in range(2))
    else:
        aff = [cv.g1_to_affine(cv.g1_mul(cv.G1_GEN, k)) for k in ks]
        x, y = (lb.ints_to_limbs([fq_to_mont(a[j]) for a in aff]) for j in range(2))
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    vals[:5] = [0, 1, 1, R_MOD - 1, 2]
    sc = lb.ints_to_limbs(vals)
    rec = msm.point_records((x, y))
    h = hashlib.sha256()
    for piece in (2, 16):
        monkeypatch.setattr(msm, "BUCKET_PIECE", piece)
        h.update(msm.msm_window_sums(sc, list(sizes), rec, 8).numpy().tobytes())
    assert h.hexdigest() == BN254_DIGESTS[g2]
