"""The port's prove path on the CPU (plain versions) against the JAX
package on identical state: h scalars equal to pipeline.construct_r1cs and
the refmath oracle (also from a forced two-level JAX plan), and a
deterministic proof byte-identical to pipeline.prove(deterministic=True),
with either side forced through each of its large-circuit routes (JAX:
matmul NTT, staged h, sliced MSM; the port: multi-stage NTT, sliced MSM,
precomputed bases)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.io.wtns import write_wtns
from icicle_snark_tpu.io.zkey import ZKeyFile
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu.prover import cache as jcache
from icicle_snark_tpu.prover import pipeline as jpipeline
from icicle_snark_tpu.refmath import groth16 as joracle
from icicle_snark_tpu.refmath.field import R_MOD
from icicle_snark_tpu.setup.r1cs import complex_circuit, complex_circuit_witness
from icicle_snark_tpu.setup.trusted_setup import groth16_setup
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm as msm_ops
from icicle_snark_tpu_torch.ops import ntt as ntt_ops
from icicle_snark_tpu_torch.prover import convert, pipeline
from icicle_snark_tpu_torch.prover.cache import load_zkey_cache
from icicle_snark_tpu_torch.refmath import groth16 as oracle

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_prove")
    r1cs = complex_circuit(40, 50)  # domain 64, the JAX prove tests' shape
    zkey_path = str(tmp / "circuit_final.zkey")
    vk = groth16_setup(r1cs, zkey_path, str(tmp / "verification_key.json"))
    wtns_path = str(tmp / "witness.wtns")
    witness = complex_circuit_witness(r1cs, a=7)
    write_wtns(wtns_path, witness)
    return zkey_path, wtns_path, vk, witness


def _port_cache_from_jax(jc):
    plan = jc.plan
    return convert.cache_from_jax_arrays(
        jc.header,
        coefs=np.asarray(plan.coefs), witness_idx=np.asarray(plan.witness_idx),
        segments=np.asarray(plan.segments),
        level2=None if plan.level2 is None else (np.asarray(plan.level2[0]), plan.level2[1]),
        points_a=tuple(np.asarray(c) for c in jc.points_a),
        points_b1=tuple(np.asarray(c) for c in jc.points_b1),
        points_b2=tuple(np.asarray(c) for c in jc.points_b2),
        points_c=tuple(np.asarray(c) for c in jc.points_c),
        points_h=tuple(np.asarray(c) for c in jc.points_h),
        keys=np.asarray(jc.keys), msm_c=jc.msm_c, msm_pre=jc.msm_pre,
        msm_c2=jc.msm_c2, msm_pre2=jc.msm_pre2, device="cpu",
    )


def _h_both(jc, witness):
    jw = jnp.asarray(jlb.ints_to_limbs_np([w % R_MOD for w in witness]))
    want = jlb.limbs_to_ints_np(np.asarray(jpipeline.construct_r1cs(jw, jc)))
    got = lb.limbs_to_ints(pipeline.construct_r1cs(lb.ints_to_limbs(witness), _port_cache_from_jax(jc)))
    return got, want


def test_h_scalars_match_jax_and_oracle(fixture):
    zkey_path, _wtns, _vk, witness = fixture
    got, want = _h_both(jcache.load_zkey_cache(zkey_path), witness)
    assert got == want
    assert got == joracle.compute_h_scalars(ZKeyFile(zkey_path), witness)
    own = pipeline.construct_r1cs(lb.ints_to_limbs(witness), load_zkey_cache(zkey_path, "cpu"))
    assert lb.limbs_to_ints(own) == want


def test_h_scalars_from_two_level_jax_plan(fixture, monkeypatch):
    """A JAX plan forced two-level (every slot chunked) converts to the
    port's single CSR level with the same h scalars."""
    zkey_path, _wtns, _vk, witness = fixture
    monkeypatch.setenv("ISTPU_SEG_CHUNK", "1")
    jc = jcache.load_zkey_cache(zkey_path)
    assert jc.plan.level2 is not None
    got, want = _h_both(jc, witness)
    assert got == want


def test_convert_carries_precompute(fixture):
    """A JAX cache built with precomputed bases (G1 factor 2, G2 factor 4,
    the copies from the JAX package's host oracle) converts, limbs
    repacked only, and proves the proof of the plain cache. Without the
    window size the copies were shifted for it is refused."""
    zkey_path, wtns_path, _vk, _witness = fixture
    jc = jcache.load_zkey_cache(zkey_path)
    assert (jc.msm_pre, jc.msm_pre2) == (1, 1)
    want = pipeline.prove(wtns_path, _port_cache_from_jax(jc), deterministic=True)
    c = 8
    for name in ("points_a", "points_b1", "points_c", "points_h"):
        pts = tuple(np.asarray(a) for a in getattr(jc, name))
        setattr(jc, name, jmsm.precompute_bases_host(pts, c, 2))
    jc.points_b2 = jmsm.precompute_bases_host(
        tuple(np.asarray(a) for a in jc.points_b2), c, 4, g2=True)
    jc.msm_pre, jc.msm_pre2 = 2, 4
    jc.msm_c = jc.msm_c2 = 0
    with pytest.raises(ValueError):
        _port_cache_from_jax(jc)
    jc.msm_c = jc.msm_c2 = c
    cache = _port_cache_from_jax(jc)
    assert (cache.msm_c, cache.msm_pre, cache.msm_c2, cache.msm_pre2) == (c, 2, c, 4)
    assert cache.b2_records.shape[0] == 4 * jc.header.n_vars
    assert cache.g1_sizes[0] == jc.header.n_vars
    assert pipeline.prove(wtns_path, cache, deterministic=True) == want


def test_prove_bitexact_vs_jax_and_verifies(fixture):
    zkey_path, wtns_path, vk, _witness = fixture
    cache = load_zkey_cache(zkey_path, device="cpu")
    proof, public = pipeline.prove(wtns_path, cache, deterministic=True)
    jproof, jpublic = jpipeline.prove(wtns_path, jcache.load_zkey_cache(zkey_path),
                                      deterministic=True)
    assert (proof, public) == (jproof, jpublic)
    assert (proof, public) == oracle.prove(zkey_path, wtns_path, deterministic=True)
    assert oracle.verify(proof, public, vk)
    rproof, rpublic = pipeline.prove(wtns_path, cache)
    assert rproof != proof
    assert oracle.verify(rproof, rpublic, vk)


@pytest.fixture(scope="module")
def jax_proof(fixture):
    zkey_path, wtns_path, _vk, _witness = fixture
    return jpipeline.prove(wtns_path, jcache.load_zkey_cache(zkey_path), deterministic=True)


@pytest.mark.parametrize("route", ["mxu_ntt", "staged", "sliced_msm"])
def test_prove_bitexact_vs_jax_large_circuit_routes(fixture, jax_proof, route, monkeypatch):
    """The JAX side forced through each route it takes for large circuits
    (the matmul NTT, the h values staged one polynomial at a time, the
    out-of-core MSM) gives the proof the port gives: the port has one flow
    for all of them."""
    zkey_path, wtns_path, _vk, _witness = fixture
    jc = jcache.load_zkey_cache(zkey_path)
    if route == "mxu_ntt":
        monkeypatch.setenv("ISTPU_MXU_NTT_MIN_LOG", "2")
    elif route == "staged":
        monkeypatch.setattr(jpipeline, "SPLIT_NTT_POWER", 4)
    else:
        monkeypatch.setattr(jmsm, "MSM_MAX_LANES", 64)
    forced = jpipeline.prove(wtns_path, jc, deterministic=True)
    assert forced == jax_proof
    cache = load_zkey_cache(zkey_path, device="cpu")
    assert pipeline.prove(wtns_path, cache, deterministic=True) == forced


@pytest.mark.parametrize("route", ["block_ntt", "sliced_msm", "precompute"])
def test_port_large_circuit_routes_give_the_same_proof(fixture, jax_proof, route, monkeypatch):
    """The port forced through K5's path (tiles of 2^3), the sliced MSM
    (slices of 64 G1 and 32 G2 lanes) and precomputed bases (factor 2)
    proves byte for byte what the JAX package proves."""
    zkey_path, wtns_path, vk, _witness = fixture
    plan = None
    if route == "block_ntt":
        monkeypatch.setattr(ntt_ops, "NTT_BLOCK_MIN_LOG", 2)
        monkeypatch.setattr(ntt_ops, "NTT_TILE_LOG", 3)
    elif route == "sliced_msm":
        monkeypatch.setattr(msm_ops, "MSM_MAX_LANES", 64)
    else:
        plan = ((8, 2), (8, 2))
    cache = load_zkey_cache(zkey_path, device="cpu", msm_plan=plan)
    if plan is not None:
        assert (cache.msm_pre, cache.msm_pre2) == (2, 2)
        assert cache.g1_sizes[0] == cache.header.n_vars
        assert cache.g1_records.shape[0] == 2 * sum(cache.g1_sizes)
    proof, public = pipeline.prove(wtns_path, cache, deterministic=True)
    assert (proof, public) == jax_proof
    assert oracle.verify(proof, public, vk)


class _Seeded:
    """A seeded source with the `randbelow` that both provers draw r and s by."""

    def __init__(self, seed):
        import random

        self._rng = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._rng.randrange(n)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_seeded_prove_bitexact_vs_jax(fixture, seed):
    """A randomised proof with r and s from one seeded source is the JAX
    package's, byte for byte: the port draws r, then s, before its MSMs and
    splits the randomisation around them; the JAX package draws them after
    and randomises in one step. r and s differ, so swapping them, or s A'
    and r B1', changes the proof."""
    zkey_path, wtns_path, vk, _witness = fixture
    src = _Seeded(seed)
    assert src.randbelow(R_MOD) != src.randbelow(R_MOD)
    cache = load_zkey_cache(zkey_path, device="cpu")
    proof, public = pipeline.prove(wtns_path, cache, rng=_Seeded(seed))
    want = jpipeline.prove(wtns_path, jcache.load_zkey_cache(zkey_path), rng=_Seeded(seed))
    assert (proof, public) == want
    assert proof != pipeline.prove(wtns_path, cache, deterministic=True)[0]
    assert oracle.verify(proof, public, vk)
