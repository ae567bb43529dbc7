"""The port's config-driven op surface against the JAX package's: `ntt()`
and `ntt_inplace` (ops/ntt.py) over every ordering x direction x coset at
log_n 1, 2, 4 and 6 and with columns_batch, `get_root_of_unity` and the
domain API; `msm_g1`, `msm_g1_many`, `msm_g2` (ops/msm.py) with a direct
window size, `MSMConfig(c=...)` and precompute factor 2. The kernels'
plain versions run here. Integers are compared exactly, curve points in
affine form.

Every ordering x direction x coset combination is held against a host DFT
on Python integers (the pattern of tests/test_api_surface.py) and the
round trip; the JAX package's eager `ntt()` costs seconds a call on the
CPU, so it is called for one or two combinations a size, together covering
every ordering, both directions and both coset cases, and for the batches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.config import MSMConfig as JMSMConfig
from icicle_snark_tpu.config import NTTConfig as JNTTConfig
from icicle_snark_tpu.config import Ordering as JOrdering
from icicle_snark_tpu.curve import jcurve as jjc
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu_torch.config import MSMConfig, NTTConfig, Ordering
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.errors import InvalidArgument
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.ops import ntt
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath.field import R_MOD, W, fq_to_mont, fr_from_mont, fr_to_mont

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

LOGS = (1, 2, 4, 6)
ROUNDTRIP = {Ordering.NN: Ordering.NN, Ordering.NR: Ordering.RN, Ordering.RN: Ordering.NR,
             Ordering.RR: Ordering.RR, Ordering.NM: Ordering.MN, Ordering.MN: Ordering.NM}
IN_REV = (Ordering.RN, Ordering.RR, Ordering.MN)
OUT_REV = (Ordering.NR, Ordering.RR, Ordering.NM)


def _vals(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]


def _mont(vals) -> torch.Tensor:
    return lb.ints_to_limbs([fr_to_mont(v) for v in vals])


def _ints(t: torch.Tensor) -> list:
    return [fr_from_mont(v) for v in lb.limbs_to_ints(t)]


def _jax(t: torch.Tensor):
    """Port (*lead, 8, n) -> JAX (16, *lead, n)."""
    return jnp.asarray(lb.to_jax_limbs(t.movedim(-2, 0).contiguous()))


def _from_jax(arr) -> torch.Tensor:
    return torch.from_numpy(lb.from_jax_limbs(np.asarray(arr))).movedim(0, -2)


def _bitrev(vals: list) -> list:
    rev = ntt.bitrev_permutation(len(vals).bit_length() - 1)
    return [vals[int(r)] for r in rev]


def _naive(vals: list, g: int, inverse: bool) -> list:
    """Natural order in and out: forward y_k = sum_i x_i (g w^k)^i; inverse
    x_i = n^-1 g^-i sum_k y_k w^-ik."""
    n = len(vals)
    w = W[n.bit_length() - 1]
    if not inverse:
        return [sum(v * pow(g * pow(w, k, R_MOD), i, R_MOD) for i, v in enumerate(vals)) % R_MOD
                for k in range(n)]
    wi, ni, gi = pow(w, -1, R_MOD), pow(n, -1, R_MOD), pow(g, -1, R_MOD)
    return [ni * pow(gi, i, R_MOD) * sum(y * pow(wi, i * k, R_MOD) for k, y in enumerate(vals))
            % R_MOD for i in range(n)]


def _expected(vals: list, o: Ordering, inverse: bool, g) -> list:
    """What ntt(x, inverse, NTTConfig(o, g)) gives for the input vals as
    stored: the R side of an ordering is bit-reversed."""
    x = _bitrev(vals) if o in IN_REV else vals
    y = _naive(x, g or 1, inverse)
    return _bitrev(y) if o in OUT_REV else y


@pytest.mark.parametrize("log_n", LOGS)
def test_ntt_every_ordering_direction_coset(log_n):
    """All 6 orderings x forward/inverse x no coset/a coset generator
    against the host DFT, and every forward/inverse pair round-trips."""
    n = 1 << log_n
    vals = _vals(n, log_n)
    g = _vals(1, 100 + log_n)[0] or 5
    x = _mont(vals)
    for coset in (None, g):
        for o in Ordering:
            for inverse in (False, True):
                got = ntt.ntt(x, inverse=inverse, cfg=NTTConfig(ordering=o, coset_gen=coset))
                assert _ints(got) == _expected(vals, o, inverse, coset), (o, inverse, coset)
            y = ntt.ntt(x, cfg=NTTConfig(ordering=o, coset_gen=coset))
            back = ntt.ntt(y, inverse=True, cfg=NTTConfig(ordering=ROUNDTRIP[o], coset_gen=coset))
            assert torch.equal(back, x), (o, coset)
    nn = ntt.ntt(x, cfg=NTTConfig(ordering=Ordering.NN))
    nr = ntt.ntt(x, cfg=NTTConfig(ordering=Ordering.NR))
    assert torch.equal(nr, nn[:, ntt.bitrev_permutation(log_n)])


# (ordering, inverse, coset) calls a size; together every ordering, both
# directions, with and without a coset (one call at 2^6, the dearest)
JAX_CASES = {
    1: [(Ordering.NN, False, False), (Ordering.MN, True, True)],
    2: [(Ordering.NR, False, True), (Ordering.RN, True, False)],
    4: [(Ordering.NM, False, True), (Ordering.RR, True, True)],
    6: [(Ordering.RR, False, False)],
}


@pytest.mark.parametrize("log_n", LOGS)
def test_ntt_matches_jax(log_n):
    n = 1 << log_n
    x = _mont(_vals(n, 10 + log_n))
    g = _vals(1, 200 + log_n)[0] or 7
    for o, inverse, coset in JAX_CASES[log_n]:
        gen = g if coset else None
        got = ntt.ntt(x, inverse=inverse, cfg=NTTConfig(ordering=o, coset_gen=gen))
        want = jntt.ntt(_jax(x), inverse=inverse,
                        cfg=JNTTConfig(ordering=JOrdering[o.name], coset_gen=gen))
        assert torch.equal(got, _from_jax(want)), (o, inverse, coset)


def test_ntt_batches_match_jax():
    """A row batch (3, 8, n) with a coset, forward; a column batch (n, 8, 2)
    with columns_batch, inverse; each against the JAX package, and the
    column batch against the row batch transposed."""
    n, g = 16, 11
    rows = torch.stack([_mont(_vals(n, 30 + b)) for b in range(3)])
    got = ntt.ntt(rows, cfg=NTTConfig(coset_gen=g))
    want = jntt.ntt(_jax(rows), cfg=JNTTConfig(coset_gen=g))
    assert torch.equal(got, _from_jax(want))
    for b in range(3):
        assert torch.equal(got[b], ntt.ntt(rows[b], cfg=NTTConfig(coset_gen=g)))
    cols = rows[:2].permute(2, 1, 0).contiguous()  # (n, 8, 2): the batch last
    got_c = ntt.ntt(cols, inverse=True, cfg=NTTConfig(columns_batch=True))
    jcols = jnp.moveaxis(_jax(rows[:2]), 1, -1)  # JAX (16, n, 2)
    want_c = jntt.ntt(jcols, inverse=True, cfg=JNTTConfig(columns_batch=True))
    assert torch.equal(got_c, _from_jax(want_c))
    assert torch.equal(got_c.permute(2, 1, 0), ntt.ntt(rows[:2], inverse=True))


def test_ntt_inplace_and_domain_api():
    x = _mont(_vals(8, 40))
    want = ntt.ntt(x, cfg=NTTConfig(ordering=Ordering.NR, coset_gen=3))
    y = x.clone()
    out = ntt.ntt_inplace(y, cfg=NTTConfig(ordering=Ordering.NR, coset_gen=3))
    assert out is y and torch.equal(y, want)
    assert ntt.get_root_of_unity(8) == W[8] == jntt.get_root_of_unity(8)
    assert pow(W[8], 1 << 8, R_MOD) == 1 and pow(W[8], 1 << 7, R_MOD) != 1
    with pytest.raises(ValueError):
        ntt.get_root_of_unity(len(W))
    dom = ntt.initialize_domain(3, "cpu")
    assert dom is ntt.initialize_domain(3, "cpu") and dom.n == 8
    ntt.release_domain(3, "cpu")
    assert ntt.initialize_domain(3, "cpu") is not dom
    with pytest.raises(ValueError):
        ntt.ntt(x[:, :6].contiguous())


# ---------------------------------------------------------------- msm

N_MSM = 8  # the shape of tests/test_api_surface.py's MSMConfig test


def _chain(g2: bool) -> list:
    """Affine 2^i G, i < 8 (the JAX test's points), the identity at lane 2."""
    acc, pts = (cv.G2_GEN if g2 else cv.G1_GEN), []
    for _ in range(N_MSM):
        pts.append(cv.g2_to_affine(acc) if g2 else cv.g1_to_affine(acc))
        acc = cv.g2_dbl(acc) if g2 else cv.g1_dbl(acc)
    pts[2] = ((0, 0), (0, 0)) if g2 else (0, 0)
    return pts


def _port_points(pts, g2: bool):
    if g2:
        return tuple(torch.stack([lb.ints_to_limbs([fq_to_mont(p[i][c]) for p in pts])
                                  for c in range(2)]) for i in range(2))
    return tuple(lb.ints_to_limbs([fq_to_mont(p[i]) for p in pts]) for i in range(2))


def _scalars() -> list:
    """Full-width scalars below 2^254 with 0, 1, r - 1 and 2^254 - 1."""
    rng = np.random.default_rng(50)
    vals = [int.from_bytes(rng.bytes(32), "little") >> 2 for _ in range(N_MSM)]
    vals[0], vals[1], vals[3], vals[4] = 0, 1, R_MOD - 1, (1 << 254) - 1
    return vals


def _oracle(vals, pts, g2: bool):
    add, mul = (cv.g2_add, cv.g2_mul) if g2 else (cv.g1_add, cv.g1_mul)
    frm = cv.g2_from_affine if g2 else cv.g1_from_affine
    acc = cv.G2_ZERO if g2 else cv.G1_ZERO
    for v, p in zip(vals, pts):
        acc = add(acc, mul(frm(p), v))
    return acc


def _aff(p, g2: bool):
    return cv.g2_to_affine(p) if g2 else cv.g1_to_affine(p)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_config_matches_jax(g2):
    """msm_g1 / msm_g2 with c = 8, k = 8; with MSMConfig(c=8); with the
    default window; with MSMConfig(c=8, precompute_factor=2) on the port's
    precompute_bases: each equals the JAX package's msm with c = 8 (and,
    for G1, its precomputed-bases MSM) and the host oracle, as affine
    points."""
    pts = _chain(g2)
    vals = _scalars()
    sc = lb.ints_to_limbs(vals)
    p = _port_points(pts, g2)
    fn, jfn = (msm.msm_g2, jmsm.msm_g2) if g2 else (msm.msm_g1, jmsm.msm_g1)
    ops, jops = (jc.G2, jjc.Fq2Ops) if g2 else (jc.G1, jjc.FqOps)
    jsc, jp = _jax(sc), tuple(_jax(t) for t in p)
    want = _aff(_oracle(vals, pts, g2), g2)
    assert _aff(jfn(jsc, jp, c=8, k=8), g2) == want
    assert _aff(fn(sc, p, c=8, k=8), g2) == want
    assert _aff(fn(sc, p, k=8, cfg=MSMConfig(c=8)), g2) == want
    assert _aff(fn(sc, p), g2) == want
    pre = msm.precompute_bases(p, ops, 8, 2)
    assert pre[0].shape[-1] == 2 * N_MSM
    assert _aff(fn(sc, pre, k=8, cfg=MSMConfig(c=8, precompute_factor=2)), g2) == want
    if not g2:
        jpre = jmsm.precompute_bases(jp, jops, c=8, factor=2)
        assert torch.equal(pre[0], _from_jax(jpre[0])) and torch.equal(pre[1], _from_jax(jpre[1]))
        got = jmsm.msm_g1(jsc, jpre, k=8, cfg=JMSMConfig(c=8, precompute_factor=2))
        assert _aff(got, g2) == want


def test_msm_g1_many_and_sliced():
    """Two G1 groups through one pipeline equal their single MSMs and the
    oracle; with MSM_MAX_LANES patched down the sliced route (K6's plain
    version) gives the same points, also with precomputed bases."""
    pts, vals = _chain(False), _scalars()
    sc, p = lb.ints_to_limbs(vals), _port_points(pts, False)
    groups = [(sc[:, :5], tuple(t[:, :5] for t in p)), (sc[:, 5:], tuple(t[:, 5:] for t in p))]
    wants = [cv.g1_to_affine(_oracle(vals[:5], pts[:5], False)),
             cv.g1_to_affine(_oracle(vals[5:], pts[5:], False))]
    assert [cv.g1_to_affine(q) for q in msm.msm_g1_many(groups, c=8)] == wants
    old = msm.MSM_MAX_LANES
    try:
        msm.MSM_MAX_LANES = 4
        assert [cv.g1_to_affine(q) for q in msm.msm_g1_many(groups, c=8)] == wants
        pre = msm.precompute_bases(p, jc.G1, 8, 2)
        got = msm.msm_g1(sc, pre, cfg=MSMConfig(c=8, precompute_factor=2))
        assert cv.g1_to_affine(got) == cv.g1_to_affine(_oracle(vals, pts, False))
    finally:
        msm.MSM_MAX_LANES = old


def test_msm_rejects_bad_input():
    pts, vals = _chain(False), _scalars()
    p = _port_points(pts, False)
    with pytest.raises(InvalidArgument):
        msm.msm_g1(lb.ints_to_limbs([1 << 254] + vals[1:]), p)
    with pytest.raises(InvalidArgument):
        msm.msm_g1(lb.ints_to_limbs(vals), p, cfg=MSMConfig(c=8, precompute_factor=2))
    assert msm._cfg_params(None, 9, 32) == (9, 32, 1)
    assert msm._cfg_params(MSMConfig(c=10, chunk=16, precompute_factor=4), None, 32) == (10, 16, 4)
    assert msm._cfg_params(MSMConfig(), 12, 8) == (12, 8, 1)
