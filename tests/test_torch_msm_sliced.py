"""The port's out-of-core MSM (per-lane group ids, K4 on slices, K6
accumulation; plain versions on the CPU) against the JAX package's
`msm_windows_sliced` and `_acc_windows` and the refmath oracle, on the
inputs of tests/test_msm_units.py (group boundaries inside slices, a padded
tail): window sums equal as AFFINE points, final points equal, G1 and G2.
`window_sums`, the one entry that picks in core or sliced, is held to its
cap at both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import R_MOD, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

C = 8


def _g1_aff(n):
    rng = np.random.default_rng(3)
    return [cv.g1_to_affine(cv.g1_mul(cv.G1_GEN, int(k))) for k in rng.integers(1, 1 << 20, size=n)]


def _g2_aff(n):
    rng = np.random.default_rng(4)
    aff = [cv.g2_to_affine(cv.g2_mul(cv.G2_GEN, int(k))) for k in rng.integers(1, 1 << 20, size=n)]
    aff[1] = ((0, 0), (0, 0))
    return aff


def _port_g1(aff):
    return tuple(lb.ints_to_limbs([fq_to_mont(a[i]) for a in aff]) for i in range(2))


def _jax_g1(aff):
    return tuple(jnp.asarray(jlb.ints_to_limbs_np([fq_to_mont(a[i]) for a in aff])) for i in range(2))


def _port_g2(aff):
    return tuple(torch.stack([lb.ints_to_limbs([fq_to_mont(a[i][c]) for a in aff])
                              for c in range(2)]) for i in range(2))


def _jax_g2(aff):
    return tuple(jnp.asarray(np.stack(
        [jlb.ints_to_limbs_np([fq_to_mont(a[i][c]) for a in aff]) for c in range(2)], axis=1))
        for i in range(2))


def _oracle(vals, aff, g2=False):
    add, mul, frm, zero = ((cv.g2_add, cv.g2_mul, cv.g2_from_affine, cv.G2_ZERO) if g2 else
                           (cv.g1_add, cv.g1_mul, cv.g1_from_affine, cv.G1_ZERO))
    acc = zero
    for v, a in zip(vals, aff):
        acc = add(acc, mul(frm(a), v))
    return acc


def _affine_windows(ws, g, g2=False):
    if g2:
        return [cv.g2_to_affine(p) for p in msm.window_points_to_host_g2(ws, g)]
    return [cv.g1_to_affine(p) for p in msm.window_points_to_host_g1(ws, g)]


def test_sliced_grouped_g1_matches_direct_jax_and_oracle():
    """Groups of 40, 64 and 24 lanes in slices of 48: boundaries inside
    slices and a tail padded by 16 sentinel lanes."""
    aff = _g1_aff(64)
    rng = np.random.default_rng(23)
    sizes, vals, pts, jgroups = (40, 64, 24), [], [], []
    for n_g in sizes:
        v = [int(x) % R_MOD for x in rng.integers(0, 1 << 62, size=n_g, dtype=np.uint64)]
        vals.append(v)
        pts.append(aff[:n_g])
        jgroups.append((jnp.asarray(jlb.ints_to_limbs_np(v)), _jax_g1(aff[:n_g])))
    scalars = lb.ints_to_limbs([x for v in vals for x in v])
    points = msm.point_records(_port_g1([a for p in pts for a in p]))
    direct = msm.msm_window_sums(scalars, sizes, points, C).numpy()
    sliced = msm.msm_windows_sliced(scalars, sizes, points, C, max_lanes=48).numpy()
    jws = np.asarray(jmsm.msm_windows_sliced(jgroups, C, 8, False, max_lanes=48))
    for g in range(3):
        mine = _affine_windows(sliced, g)
        assert mine == _affine_windows(direct, g)
        assert mine == [cv.g1_to_affine(p) for p in jmsm.window_points_to_host_g1(jws, g)]
        got = msm.horner_combine(msm.window_points_to_host_g1(sliced, g), C)
        assert cv.g1_eq(got, _oracle(vals[g], pts[g]))


def test_sliced_g2_matches_direct_jax_and_oracle():
    """One G2 group of 20 lanes (one at infinity) in slices of 8: a tail
    padded by 4 lanes."""
    aff = _g2_aff(20)
    rng = np.random.default_rng(29)
    vals = [int(x) % R_MOD for x in rng.integers(0, 1 << 62, size=20, dtype=np.uint64)]
    scalars, points = lb.ints_to_limbs(vals), msm.point_records(_port_g2(aff))
    direct = msm.msm_window_sums(scalars, [20], points, C).numpy()
    sliced = msm.msm_windows_sliced(scalars, [20], points, C, max_lanes=8).numpy()
    jws = np.asarray(jmsm.msm_windows_sliced(
        [(jnp.asarray(jlb.ints_to_limbs_np(vals)), _jax_g2(aff))], C, 8, True, max_lanes=8))
    mine = _affine_windows(sliced, 0, g2=True)
    assert mine == _affine_windows(direct, 0, g2=True)
    assert mine == [cv.g2_to_affine(p) for p in jmsm.window_points_to_host_g2(jws, 0)]
    got = msm.horner_combine(msm.window_points_to_host_g2(sliced, 0), C, g2=True)
    assert cv.g2_eq(got, _oracle(vals, aff, g2=True))


@pytest.mark.parametrize("sizes,max_lanes", [
    ((16, 16), 16),   # every slice holds one group only; no padded tail
    ((5, 11), 32),    # one slice, padded by 16
    ((7, 9, 8), 6),   # four slices, the second group over three of them
], ids=["one-group-slices", "single-padded-slice", "group-over-three-slices"])
def test_sliced_edge_cases_equal_direct(sizes, max_lanes):
    aff = _g1_aff(sum(sizes))
    aff[2] = (0, 0)
    rng = np.random.default_rng(sum(sizes))
    vals = [int(x) % R_MOD for x in rng.integers(0, 1 << 62, size=sum(sizes), dtype=np.uint64)]
    vals[0], vals[1] = 0, R_MOD - 1
    scalars, points = lb.ints_to_limbs(vals), msm.point_records(_port_g1(aff))
    direct = msm.msm_window_sums(scalars, sizes, points, C).numpy()
    sliced = msm.msm_windows_sliced(scalars, sizes, points, C, max_lanes).numpy()
    lo = 0
    for g, n_g in enumerate(sizes):
        assert _affine_windows(sliced, g) == _affine_windows(direct, g)
        got = msm.horner_combine(msm.window_points_to_host_g1(sliced, g), C)
        assert cv.g1_eq(got, _oracle(vals[lo:lo + n_g], aff[lo:lo + n_g]))
        lo += n_g


# The routing table of `window_sums` under a cap of 16 point lanes (G2: 8):
# scalar lanes at exactly the cap and one lane past it, factors 1 and 2.
ROUTE_CAP = 16


@pytest.mark.parametrize("past", [0, 1], ids=["at_cap", "one_past"])
@pytest.mark.parametrize("pre", [1, 2], ids=["f1", "f2"])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_window_sums_routes_at_the_cap(g2, pre, past, monkeypatch):
    """`window_sums` runs in core at exactly the cap on point lanes and
    sliced one scalar lane past it, G1 at MSM_MAX_LANES and G2 at half of
    it, and returns word for word what the direct call of that route does."""
    monkeypatch.setattr(msm, "MSM_MAX_LANES", ROUTE_CAP)
    cap = ROUTE_CAP // 2 if g2 else ROUTE_CAP
    n = cap // pre + past
    aff = _g2_aff(n) if g2 else _g1_aff(n)
    rng = np.random.default_rng(41 + n)
    scalars = lb.ints_to_limbs(
        [int(x) % R_MOD for x in rng.integers(0, 1 << 62, size=n, dtype=np.uint64)])
    points = msm.precompute_bases(_port_g2(aff) if g2 else _port_g1(aff),
                                  jc.G2 if g2 else jc.G1, C, pre)
    records = msm.point_records(points)
    sizes = [n] if g2 else [n - n // 3, n // 3]
    routes = []

    def spy(name):
        real = getattr(msm, name)

        def call(*args, **kwargs):
            routes.append(name)
            return real(*args, **kwargs)
        return call

    for name in ("msm_window_sums", "msm_windows_sliced"):
        monkeypatch.setattr(msm, name, spy(name))
    got = msm.window_sums(scalars, sizes, records, C, pre)
    assert routes == ["msm_windows_sliced" if past else "msm_window_sums"]
    want = (msm.msm_windows_sliced(scalars, sizes, records, C, cap, pre) if past else
            msm.msm_window_sums(scalars, sizes, records, C, pre))
    assert torch.equal(got, want)


def test_sort_windows_takes_group_ids_and_a_sentinel():
    rng = np.random.default_rng(5)
    vals = [int(x) for x in rng.integers(0, 1 << 62, size=12, dtype=np.uint64)]
    scalars = lb.ints_to_limbs(vals)
    by_size = msm.sort_windows(scalars, [5, 7], C)
    gid = torch.tensor([0] * 5 + [1] * 7)
    by_gid = msm.sort_windows(scalars, (gid, 2), C)
    assert all(torch.equal(a, b) for a, b in zip(by_size, by_gid))
    # sentinel lanes (group id 2) sort last and fall in no bucket
    padded = torch.cat([scalars, lb.ints_to_limbs([123456789] * 4)], dim=-1)
    order, _negs, ends = msm.sort_windows(padded, (torch.cat([gid, torch.full((4,), 2)]), 2), C)
    assert torch.equal(ends, by_size[2])
    assert order[:, -4:].min() >= 12
    with pytest.raises(ValueError):
        msm.msm_windows_sliced(scalars, [5, 6], msm.point_records(_port_g1(_g1_aff(12))), C, 8)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_acc_windows_matches_jax_with_identities(g2):
    """K6's plain version against _acc_windows on (3, coords, G=2, W=4)
    stacks: random points, the identity on the left, on the right and on
    both sides, P + P and P + (-P)."""
    ops = jc.G2_PLAIN if g2 else jc.G1_PLAIN
    mul, gen, to_aff = ((cv.g2_mul, cv.G2_GEN, cv.g2_to_affine) if g2 else
                        (cv.g1_mul, cv.G1_GEN, cv.g1_to_affine))
    rng = np.random.default_rng(31 + g2)
    a_aff = [to_aff(mul(gen, int(k))) for k in rng.integers(1, 1 << 30, size=8)]
    b_aff = [to_aff(mul(gen, int(k))) for k in rng.integers(1, 1 << 30, size=8)]
    b_aff[3] = a_aff[3]                                        # P + P
    b_aff[4] = to_aff((cv.g2_neg if g2 else cv.g1_neg)(
        (cv.g2_from_affine if g2 else cv.g1_from_affine)(a_aff[4])))  # P + (-P)
    coords = _port_g2 if g2 else _port_g1

    def stack(aff, identity_lanes):
        x, y = coords(aff)
        one = jc.identity(ops, 8, "cpu")[1]
        p = jc.point_stack((x, y, one))
        ident = jc.point_stack(jc.identity(ops, 8, "cpu"))
        mask = torch.zeros(8, dtype=torch.bool)
        mask[identity_lanes] = True
        return torch.where(mask, ident, p).reshape(p.shape[:-1] + (2, 4)).contiguous()

    acc, new = stack(a_aff, [0, 2]), stack(b_aff, [1, 2])
    got = msm.acc_windows(acc, new)
    assert got.shape == acc.shape
    jacc, jnew = (jnp.asarray(np.moveaxis(lb.to_jax_limbs(np.moveaxis(t.numpy(), -3, 0)), 0, 1)
                              if not g2 else
                              np.moveaxis(lb.to_jax_limbs(np.moveaxis(t.numpy(), -3, 0)), (0, 1, 2), (1, 0, 2)))
                  for t in (acc, new))
    want = np.asarray(jmsm._acc_windows(g2, jacc, jnew))
    host = msm.window_points_to_host_g2 if g2 else msm.window_points_to_host_g1
    jhost = jmsm.window_points_to_host_g2 if g2 else jmsm.window_points_to_host_g1
    for g in range(2):
        assert [to_aff(p) for p in host(got.numpy(), g)] == [to_aff(p) for p in jhost(want, g)]
    flat = [to_aff(p) for g in range(2) for p in host(got.numpy(), g)]
    zero = ((0, 0), (0, 0)) if g2 else (0, 0)
    assert flat[0] == b_aff[0] and flat[1] == a_aff[1] and flat[2] == zero and flat[4] == zero
    with pytest.raises(ValueError):
        msm.acc_windows(acc, new[..., :3])


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_sliced_route_sums_its_slices_in_one_call(g2, monkeypatch):
    """The sliced route keeps every slice's window sums and adds them with
    one `sum_windows` call over all slices (one K6 launch on the card), in
    its tree order: equal word for word to `sum_windows_plain` over the
    slices' own window sums, and as affine points to the chain of JAX
    `_acc_windows` over them, the JAX package's sliced accumulation."""
    aff = _g2_aff(20) if g2 else _g1_aff(20)
    rng = np.random.default_rng(37 + g2)
    vals = [int(x) % R_MOD for x in rng.integers(0, 1 << 62, size=20, dtype=np.uint64)]
    scalars = lb.ints_to_limbs(vals)
    points = msm.point_records(_port_g2(aff) if g2 else _port_g1(aff))
    calls = []
    real = msm.sum_windows

    def spy(stacks):
        calls.append(stacks.clone())
        return real(stacks)

    monkeypatch.setattr(msm, "sum_windows", spy)
    sliced = msm.msm_windows_sliced(scalars, [20], points, C, max_lanes=6)
    assert len(calls) == 1 and calls[0].shape[0] == 4  # slices of 6, 6, 6 and 2 + 4 padding
    assert torch.equal(sliced, msm.sum_windows_plain(calls[0]))
    to_j = ((lambda t: np.moveaxis(lb.to_jax_limbs(np.moveaxis(t.numpy(), -3, 0)), (0, 1, 2),
                                   (1, 0, 2))) if g2 else
            (lambda t: np.moveaxis(lb.to_jax_limbs(np.moveaxis(t.numpy(), -3, 0)), 0, 1)))
    chain = jnp.asarray(to_j(calls[0][0]))
    for part in calls[0][1:]:
        chain = jmsm._acc_windows(g2, chain, jnp.asarray(to_j(part)))
    jhost = jmsm.window_points_to_host_g2 if g2 else jmsm.window_points_to_host_g1
    to_aff = cv.g2_to_affine if g2 else cv.g1_to_affine
    assert _affine_windows(sliced.numpy(), 0, g2) == [to_aff(p) for p in
                                                      jhost(np.asarray(chain), 0)]
