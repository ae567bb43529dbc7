"""The device setup's fixed-base MSM (setup/fast_setup.py fixed_base_msm,
K11's plain version on the CPU) against the JAX package's _fixed_base_msm
on the same numpy-seeded scalars (0, 1, r - 1 and 2^256 - 1 among them),
for G1 and G2: the points equal in affine form (and the projective words
too: both run the same complete formulas), and equal to k * G on the
host."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curve import jcurve as jjc
from icicle_snark_tpu.setup import fast_setup as jfs
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import R_MOD, fq_from_mont
from icicle_snark_tpu_torch.setup import fast_setup as fs
from icicle_snark_tpu_torch.setup.trusted_setup import _fixed_bases

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

N = 16


def _scalars() -> list:
    rng = np.random.default_rng(60)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(N)]
    vals[0], vals[1], vals[2], vals[3] = 0, 1, R_MOD - 1, (1 << 256) - 1
    return vals


def _host_affine(p, g2: bool) -> list:
    """Projective Montgomery limbs -> host affine points, lane by lane."""
    x, y, z = ([[fq_from_mont(v) for v in lb.limbs_to_ints(t[c])] for c in range(2)]
               if g2 else [fq_from_mont(v) for v in lb.limbs_to_ints(t)] for t in p)
    if g2:
        pts = [((x[0][i], x[1][i]), (y[0][i], y[1][i]), (z[0][i], z[1][i])) for i in range(N)]
        return [cv.g2_to_affine(q) for q in pts]
    return [cv.g1_to_affine(q) for q in zip(x, y, z)]


def _from_jax(arr) -> torch.Tensor:
    return torch.from_numpy(lb.from_jax_limbs(np.asarray(arr))).movedim(0, -2).contiguous()


@pytest.fixture(scope="module")
def bases():
    return _fixed_bases()


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_matches_jax(bases, g2):
    fb = bases[g2]
    vals = _scalars()
    sc = lb.ints_to_limbs(vals)
    table = fs._table_g2(fb, "cpu") if g2 else fs._table_g1(fb, "cpu")
    got = fs.fixed_base_msm(sc, table, jc.G2 if g2 else jc.G1)
    jtable = jfs._table_g2(fb) if g2 else jfs._table_g1(fb)
    jsc = jnp.asarray(lb.to_jax_limbs(sc))
    want = jfs._fixed_base_msm(jsc, jtable, jjc.Fq2Ops if g2 else jjc.FqOps)
    want = tuple(_from_jax(w) for w in want)
    aff = _host_affine(got, g2)
    assert aff == _host_affine(want, g2)
    assert aff == [cv.g2_to_affine(fb.mul(k)) if g2 else cv.g1_to_affine(fb.mul(k)) for k in vals]
    assert aff[0] == (((0, 0), (0, 0)) if g2 else (0, 0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_plain_ops_equal_k1_ops(bases, g2):
    """The plain scan with the plain ops (K11's plain version) and with the
    K1-backed ops (the route before K11; on the CPU both run plain) give the
    same words; the wrapper on a CPU tensor is the plain version."""
    fb = bases[g2]
    sc = lb.ints_to_limbs(_scalars()[:6])
    table = fs._table_g2(fb, "cpu") if g2 else fs._table_g1(fb, "cpu")
    plain = fs.fixed_base_msm_plain(sc, table, jc.G2_PLAIN if g2 else jc.G1_PLAIN)
    k1 = fs.fixed_base_msm_plain(sc, table, jc.G2 if g2 else jc.G1)
    wrapped = fs.fixed_base_msm(sc, table, jc.G2 if g2 else jc.G1)
    for a, b, c in zip(plain, k1, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_fixed_base_rejects_bad_input(bases):
    table = fs._table_g1(bases[0], "cpu")
    with pytest.raises(ValueError):
        fs.fixed_base_msm(lb.ints_to_limbs([1, 2]).to(torch.int64), table, jc.G1)
    with pytest.raises(ValueError):
        fs.fixed_base_msm(lb.ints_to_limbs([1, 2]), tuple(t[:, :256] for t in table), jc.G1)
