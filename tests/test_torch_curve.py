"""The port's point formulas (plain torch over the K1 field ops) against
icicle_snark_tpu/curve/jcurve.py: G1 and G2, random points plus the
identity, P+P and P+(-P), compared as AFFINE points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curve import jcurve as jjc
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import fq_from_mont, fq_to_mont

N = 8
# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def _points(g2: bool, seed: int):
    """N random affine host points (numpy seed)."""
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << 60, size=N)]
    mul, gen = (cv.g2_mul, cv.G2_GEN) if g2 else (cv.g1_mul, cv.G1_GEN)
    to_aff = cv.g2_to_affine if g2 else cv.g1_to_affine
    aff = [to_aff(mul(gen, k)) for k in ks]
    return aff


def _enc(vals):
    return [fq_to_mont(v) for v in vals]


def _port_coord(aff, i, g2):
    if g2:
        return torch.stack([lb.ints_to_limbs(_enc(p[i][c] for p in aff)) for c in range(2)])
    return lb.ints_to_limbs(_enc(p[i] for p in aff))


def _jax_coord(aff, i, g2):
    if g2:
        return jnp.asarray(np.stack(
            [jlb.ints_to_limbs_np(_enc(p[i][c] for p in aff)) for c in range(2)], axis=1))
    return jnp.asarray(jlb.ints_to_limbs_np(_enc(p[i] for p in aff)))


def _one(n, g2, port):
    if port:
        return jc.identity(jc.G2 if g2 else jc.G1, n, "cpu")[1]
    return jjc.identity(jjc.Fq2Ops if g2 else jjc.FqOps, (n,))[1]


def _host_port(p, g2):
    """Port projective point tuple -> host affine points."""
    def ints(t):
        return [fq_from_mont(v) for v in lb.limbs_to_ints(t)]
    if g2:
        coords = [list(zip(ints(c[0]), ints(c[1]))) for c in p]
        return [cv.g2_to_affine(q) for q in zip(*coords)]
    return [cv.g1_to_affine(q) for q in zip(*(ints(c) for c in p))]


def _host_jax(p, g2):
    def ints(a):
        return [fq_from_mont(v) for v in jlb.limbs_to_ints_np(np.asarray(a))]
    if g2:
        coords = [list(zip(ints(c[:, 0]), ints(c[:, 1]))) for c in p]
        return [cv.g2_to_affine(q) for q in zip(*coords)]
    return [cv.g1_to_affine(q) for q in zip(*(ints(c) for c in p))]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_point_ops_match_jcurve_affine(g2):
    ops, jops = (jc.G2, jjc.Fq2Ops) if g2 else (jc.G1, jjc.FqOps)
    a_aff = _points(g2, 1)
    b_aff = _points(g2, 2)
    b_aff[1] = a_aff[1]  # P + P
    neg = cv.g2_neg if g2 else cv.g1_neg
    frm = cv.g2_from_affine if g2 else cv.g1_from_affine
    to_aff = cv.g2_to_affine if g2 else cv.g1_to_affine
    b_aff[3] = to_aff(neg(frm(a_aff[3])))  # P + (-P)
    zero = ((0, 0), (0, 0)) if g2 else (0, 0)
    b_aff[5] = zero  # affine (0, 0): the mixed add's identity

    p = (_port_coord(a_aff, 0, g2), _port_coord(a_aff, 1, g2), _one(N, g2, True))
    jp = (_jax_coord(a_aff, 0, g2), _jax_coord(a_aff, 1, g2), _one(N, g2, False))
    q_aff = (_port_coord(b_aff, 0, g2), _port_coord(b_aff, 1, g2))
    jq_aff = (_jax_coord(b_aff, 0, g2), _jax_coord(b_aff, 1, g2))
    # the identity as a projective left operand, lane 0
    ident = jc.identity(ops, N, "cpu")
    p = tuple(torch.where(torch.arange(N) == 0, i, c) for i, c in zip(ident, p))
    jident = jjc.identity(jops, (N,))
    mask = np.arange(N) == 0
    jp = tuple(jnp.where(mask, i, c) for i, c in zip(jident, jp))

    madd = _host_port(jc.pmadd(ops, p, q_aff), g2)
    jmadd = _host_jax(jax.jit(lambda a, b: jjc.pmadd(jops, a, b))(jp, jq_aff), g2)
    assert madd == jmadd
    q = (q_aff[0], q_aff[1], _one(N, g2, True))
    jq = (jq_aff[0], jq_aff[1], _one(N, g2, False))
    add = _host_port(jc.padd(ops, p, q), g2)
    # padd's (0, 0, 1) lane is not a curve point: compare the other lanes
    jadd = _host_jax(jax.jit(lambda a, b: jjc.padd(jops, a, b))(jp, jq), g2)
    assert [x for i, x in enumerate(add) if i != 5] == [x for i, x in enumerate(jadd) if i != 5]
    dbl = _host_port(jc.pdbl(ops, p), g2)
    jdbl = _host_jax(jax.jit(lambda a: jjc.pdbl(jops, a))(jp), g2)
    assert dbl == jdbl
    assert madd[1] == dbl[1] and madd[3] == zero
    neg_p = _host_port(jc.pneg(ops, p), g2)
    assert neg_p[2] == to_aff(neg(frm(a_aff[2])))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_points_equal_and_to_affine(g2):
    ops = jc.G2 if g2 else jc.G1
    aff = _points(g2, 3)
    p = (_port_coord(aff, 0, g2), _port_coord(aff, 1, g2), _one(N, g2, True))
    d = jc.pdbl(ops, p)
    two = jc.padd(ops, p, p)
    assert bool(jc.points_equal(ops, d, two).all())
    assert not bool(jc.points_equal(ops, d, p).any())
    ax, ay = jc.to_affine(ops, d)
    back = (ax, ay, _one(N, g2, True))
    assert bool(jc.points_equal(ops, back, d).all())
    plain = jc.G2_PLAIN if g2 else jc.G1_PLAIN
    assert all(torch.equal(a, b) for a, b in zip(jc.pdbl(plain, p), d))
