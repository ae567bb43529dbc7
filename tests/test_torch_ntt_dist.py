"""The port's four-step NTT over a mesh of CPU shards (parallel/ntt_dist.py,
plain versions) against the JAX package's on its virtual CPU mesh: K15's
twiddle pass against Python integers, in both orientations of the factors;
the mesh's all_to_all against jax.lax.all_to_all(tiled=True); the
natural-order transform against JAX make_dist_ntt at D = 2, 4 and 8 in
both directions; and the intermediate [k1_loc][k2] order of
ntt_four_step_partial against the JAX function's. Field values are compared as integers, word for word."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu.parallel import mesh as jmesh
from icicle_snark_tpu.parallel import ntt_dist as jnd
from icicle_snark_tpu.refmath.field import R_MOD, W, fr_to_mont
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.parallel import mesh as pmesh
from icicle_snark_tpu_torch.parallel import ntt_dist

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

LOG_N = 7  # n1 = 8, n2 = 16 over 8 shards, as tests/test_ntt_dist.py
B = 2


def _mont_values(rng, count: int) -> list:
    vals = [int(v) % R_MOD for v in rng.integers(0, 2**62, size=count)]
    vals[:3] = [0, 1, R_MOD - 1]
    return [fr_to_mont(v) for v in vals]


@pytest.fixture(scope="module")
def data():
    """(16, B, n) JAX limbs and the same values as the port's (B, 8, n)."""
    rng = np.random.default_rng(42)
    rows = [_mont_values(rng, 1 << LOG_N) for _ in range(B)]
    x = np.stack([jlb.ints_to_limbs_np(r) for r in rows], axis=1)
    port = torch.from_numpy(lb.from_jax_limbs(x)).permute(1, 0, 2).contiguous()
    return jnp.asarray(x), port


def _port_of_jax(arr) -> torch.Tensor:
    """JAX (16, ...) limbs -> the port's (8, ...) words."""
    return torch.from_numpy(lb.from_jax_limbs(np.asarray(arr)))


def _cpu_mesh(d: int):
    return pmesh.make_mesh(["cpu"] * d)


@pytest.mark.parametrize("log_n,d,shard,swapped", [(6, 2, 1, False), (7, 4, 3, True),
                                                   (7, 8, 5, True)])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_twiddle_plain_against_ints(inverse, log_n, d, shard, swapped):
    """K15's twiddle pass on one shard: every element times w^(k1 i2)
    (w^-1 for the inverse), i2 the global column, in the exchange layout
    (D, B, n1/D, 8, n2/D); `swapped` exchanges the factors, as the coset
    evaluation's forward pass does."""
    log_n1, log_n2 = ntt_dist.split_logs(log_n, d)
    if swapped:
        log_n1, log_n2 = log_n2, log_n1
    n1, n2_loc = 1 << log_n1, (1 << log_n2) // d
    rng = np.random.default_rng(3)
    vals = _mont_values(rng, B * n2_loc * n1)
    x = lb.ints_to_limbs(vals).reshape(8, B, n2_loc, n1).permute(1, 2, 0, 3).contiguous()
    tables = ntt_dist.twiddle_tables(log_n, "cpu", inverse)
    out = ntt_dist.four_step_twiddle(x, tables, shard, d)
    assert out.shape == (d, B, n1 // d, 8, n2_loc)
    w = pow(W[log_n], -1, R_MOD) if inverse else W[log_n]
    got = lb.limbs_to_ints(out.permute(3, 0, 1, 2, 4).reshape(8, -1))
    want = [0] * len(got)  # out order: dst, b, k1_loc, i2_loc
    for b in range(B):
        for i2l in range(n2_loc):
            for k1 in range(n1):
                v = vals[(b * n2_loc + i2l) * n1 + k1]
                dst, k1l = divmod(k1, n1 // d)
                e = k1 * (shard * n2_loc + i2l)
                at = ((dst * B + b) * (n1 // d) + k1l) * n2_loc + i2l
                want[at] = v * pow(w, e, R_MOD) % R_MOD
    assert got == want


@pytest.mark.parametrize("split_axis,concat_axis", [(2, 1), (1, 2), (0, 0)])
def test_all_to_all_block_order_matches_jax(split_axis, concat_axis):
    d = 4
    x = np.arange(16 * 8 * 16, dtype=np.int32).reshape(16, 8, 16)  # every axis splits into 4
    jm = jmesh.make_mesh(jax.devices()[:d])
    f = jax.jit(jax.shard_map(
        lambda xl: jax.lax.all_to_all(xl, jmesh.AXIS, split_axis, concat_axis, tiled=True),
        mesh=jm, in_specs=P(jmesh.AXIS), out_specs=P(jmesh.AXIS), check_vma=False))
    want = np.asarray(f(jnp.asarray(x)))
    m = _cpu_mesh(d)
    got = m.all_to_all(pmesh.globalize(m, torch.from_numpy(x), 0), split_axis, concat_axis)
    assert np.array_equal(torch.cat(got, 0).numpy(), want)
    gathered = m.all_gather(pmesh.globalize(m, torch.from_numpy(x), 0))
    assert np.array_equal(torch.cat(gathered, 0).numpy(), x)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_dist_ntt_matches_jax_make_dist_ntt(data, d, inverse):
    jx, px = data
    want = _port_of_jax(jnd.make_dist_ntt(jmesh.make_mesh(jax.devices()[:d]), LOG_N, B,
                                          inverse=inverse)(jx)).permute(1, 0, 2)
    m = _cpu_mesh(d)
    fn = ntt_dist.make_dist_ntt(m, LOG_N, B, inverse=inverse)
    got = torch.cat(fn(pmesh.globalize(m, px, -1)), -1)
    assert torch.equal(got, want)
    # and the single-device transform of the JAX package
    single = _port_of_jax(jntt.ntt_natural(jx, jntt.get_domain(LOG_N), inverse=inverse))
    assert torch.equal(got, single.permute(1, 0, 2))


@pytest.mark.parametrize("inverse", [False, True])
def test_partial_intermediate_order_matches_jax(data, inverse):
    """ntt_four_step_partial's [k1_loc][k2] blocks, concatenated on k1,
    equal the JAX function's under shard_map at D = 2."""
    jx, px = data
    d = 2
    log_n1, log_n2 = jnd.split_logs(LOG_N, d)
    n1, n2 = 1 << log_n1, 1 << log_n2
    dom1, dom2, dom = (jntt.get_domain(k) for k in (log_n1, log_n2, LOG_N))
    tw = (lambda dm: dm.tw_inv) if inverse else (lambda dm: dm.tw_fwd)
    jm = jmesh.make_mesh(jax.devices()[:d])
    f = jax.jit(jax.shard_map(
        lambda xl: jnd.ntt_four_step_partial(xl, tw(dom1), tw(dom2), tw(dom), dom1.n_inv_mont,
                                             dom2.n_inv_mont, log_n1, log_n2, inverse),
        mesh=jm, in_specs=P(None, None, None, jmesh.AXIS),
        out_specs=P(None, None, jmesh.AXIS, None), check_vma=False))
    want = _port_of_jax(f(jx.reshape(16, B, n1, n2))).permute(1, 2, 0, 3)  # (B, n1, 8, n2)
    m = _cpu_mesh(d)
    x4 = px.reshape(B, 8, n1, n2)
    cols = [c.permute(0, 3, 1, 2).contiguous() for c in pmesh.globalize(m, x4, 3)]
    got = torch.cat(ntt_dist.ntt_four_step_partial(m, cols, log_n1, log_n2, inverse), 1)
    assert torch.equal(got, want)


def test_split_logs_and_can_distribute_match_jax():
    for log_n in range(1, 23):
        for d in (1, 2, 4, 8, 16):
            if ntt_dist.split_logs(log_n, d)[0] < 0:
                assert not ntt_dist.can_distribute(log_n, d)
                continue
            assert ntt_dist.split_logs(log_n, d) == jnd.split_logs(log_n, d)
            assert ntt_dist.can_distribute(log_n, d) == jnd.can_distribute(log_n, d)
