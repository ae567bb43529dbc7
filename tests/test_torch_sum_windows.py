"""K6's one-launch sum of window-sum stacks (`ops/msm.py` `sum_windows`,
plain version on the CPU) and its two callers, the mesh combine
(`parallel/msm_shard.py` `combine_windows`) and the sliced MSM: the tree
order against the JAX package's `_tree_reduce` (the mesh combine's order)
and a chain of its `_acc_windows` (the sliced accumulation's), in affine
form, on G1 (4, 16) and G2 (1, 16) stacks holding identity lanes, P + P and
P + (-P); word for word against `acc_windows` at S = 2 and against the
parent's pairwise combine at D = 2, 4, 8, whose order is the tree's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curve import jcurve as jjc
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.parallel import mesh as pmesh
from icicle_snark_tpu_torch.parallel import msm_shard
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import Q, fq_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

SHAPES = {False: (4, 16), True: (1, 16)}  # (G, W) of the prove's G1 and G2 window sums


def _pool(g2: bool) -> list:
    rng = np.random.default_rng(50 + g2)
    mul, gen, aff = ((cv.g2_mul, cv.G2_GEN, cv.g2_to_affine) if g2 else
                     (cv.g1_mul, cv.G1_GEN, cv.g1_to_affine))
    return [aff(mul(gen, int(k))) for k in rng.integers(1, 1 << 30, size=10)]


def _coord(vals: list, g2: bool) -> torch.Tensor:
    if g2:
        return torch.stack([lb.ints_to_limbs([fq_to_mont(v[c]) for v in vals]) for c in range(2)])
    return lb.ints_to_limbs([fq_to_mont(v) for v in vals])


def _stacks(g2: bool, s: int, seed: int) -> torch.Tensor:
    """(s, 3, [2,] 8, G, W) projective points (x l, y l, l) of the pool, l
    random; the identity in stack 0 at lane 0, in the last stack at lane 1,
    in every stack at lane 2; where s > 1, stack 1 holds P at lane 3 and -P
    at lane 4 where stack 0 holds P."""
    rng = np.random.default_rng(seed)
    pool = _pool(g2)
    g, w = SHAPES[g2]
    n = g * w

    def scale(a, lam):
        return ((a[0] * lam) % Q, (a[1] * lam) % Q) if g2 else a * lam % Q

    ident = (((0, 0), (1, 0), (0, 0)) if g2 else (0, 1, 0))
    pts = []
    for _ in range(s):
        row = []
        for _ in range(n):
            x, y = pool[int(rng.integers(len(pool)))]
            lam = int(rng.integers(1, 1 << 62))
            row.append((scale(x, lam), scale(y, lam), (lam, 0) if g2 else lam))
        pts.append(row)
    pts[0][0], pts[-1][1] = ident, ident
    for row in pts:
        row[2] = ident
    if s > 1:
        pts[1][3] = pts[0][3]
        x, y, z = pts[0][4]
        pts[1][4] = (x, ((-y[0]) % Q, (-y[1]) % Q) if g2 else (-y) % Q, z)
    out = torch.stack([torch.stack([_coord([p[c] for p in row], g2) for c in range(3)])
                       for row in pts])
    return out.reshape(out.shape[:-1] + (g, w)).contiguous()


def _jax(t: torch.Tensor, g2: bool) -> np.ndarray:
    """A port stack (3, [2,] 8, G, W) -> the JAX package's (3, 16, [2,] G, W)."""
    a = lb.to_jax_limbs(np.moveaxis(t.numpy(), -3, 0))
    return np.moveaxis(a, (0, 1, 2), (1, 0, 2)) if g2 else np.moveaxis(a, 0, 1)


def _affine(ws, g2: bool, host=msm) -> list:
    """Window sums (port or JAX layout) -> affine host points of every group."""
    to_host = host.window_points_to_host_g2 if g2 else host.window_points_to_host_g1
    to_aff = cv.g2_to_affine if g2 else cv.g1_to_affine
    return [to_aff(p) for g in range(SHAPES[g2][0]) for p in to_host(ws, g)]


@pytest.mark.parametrize("s", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_sum_windows_plain_equals_jax_tree_and_chain(g2, s):
    """`sum_windows` over s stacks equals, as affine points, the JAX
    `_tree_reduce` over the same points stacked on the last axis and the
    chain of JAX `_acc_windows`; the identity lanes, P + P and P + (-P)
    come out as the host sums say."""
    stacks = _stacks(g2, s, seed=20 * s + g2)
    got = msm.sum_windows(stacks)
    assert got.shape == stacks.shape[1:]
    assert torch.equal(got, msm.sum_windows_plain(stacks))
    ops = jjc.Fq2Ops if g2 else jjc.FqOps
    jst = [_jax(st, g2) for st in stacks.unbind(0)]
    tree = jjc.point_stack(jmsm._tree_reduce(
        jjc.point_unstack(jnp.asarray(np.stack(jst, axis=-1))), ops))
    chain = jnp.asarray(jst[0])
    for nxt in jst[1:]:
        chain = jmsm._acc_windows(g2, chain, jnp.asarray(nxt))
    mine = _affine(got.numpy(), g2)
    assert mine == _affine(np.asarray(tree), g2, jmsm)
    assert mine == _affine(np.asarray(chain), g2, jmsm)
    host = [_affine(st.numpy(), g2) for st in stacks.unbind(0)]
    add, zero = (cv.g2_add, ((0, 0), (0, 0))) if g2 else (cv.g1_add, (0, 0))
    frm, to_aff = (cv.g2_from_affine, cv.g2_to_affine) if g2 else (cv.g1_from_affine,
                                                                    cv.g1_to_affine)
    for lane in range(len(mine)):
        acc = None
        for h in host:
            p = frm(h[lane]) if h[lane] != zero else None
            acc = p if acc is None else (acc if p is None else add(acc, p))
        assert mine[lane] == (zero if acc is None else to_aff(acc)), lane
    assert mine[2] == zero
    if s == 2:
        assert mine[4] == zero
        assert torch.equal(got, msm.acc_windows(stacks[0], stacks[1]))


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_combine_windows_equals_pairwise(g2, d):
    """The mesh combine over D CPU shards is one `sum_windows` in shard
    order: at D = 2, 4, 8 the pairwise rounds it replaces added in the same
    tree, so the words agree, and so do the affine points."""
    stacks = _stacks(g2, d, seed=70 + d + g2)
    got = msm_shard.combine_windows(pmesh.make_mesh(["cpu"] * d), list(stacks.unbind(0)))
    pts = list(stacks.unbind(0))
    while len(pts) > 1:
        nxt = [msm.acc_windows(pts[i], pts[i + 1]) for i in range(0, len(pts) - 1, 2)]
        pts = nxt + pts[len(pts) - len(pts) % 2:]
    assert torch.equal(got, pts[0])
    assert _affine(got.numpy(), g2) == _affine(pts[0].numpy(), g2)


def test_sum_windows_checks_its_input():
    stacks = _stacks(False, 3, seed=3)
    assert torch.equal(msm.sum_windows(stacks[:1]), stacks[0])
    for bad in (stacks[0], stacks.to(torch.int64), stacks[:, :2], stacks[:0]):
        with pytest.raises(ValueError):
            msm.sum_windows(bad)
    with pytest.raises(ValueError):
        msm.acc_windows(stacks[0], stacks[1][..., :3])
    ident = jc.point_stack(jc.identity(jc.G1_PLAIN, 1, "cpu"))
    assert torch.equal(msm.sum_windows_plain(ident.expand(2, *ident.shape)[..., None]),
                       ident[..., None])
