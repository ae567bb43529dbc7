"""The port's prove path on the CPU (plain versions) against the JAX
package on identical state: h scalars equal to pipeline.construct_r1cs and
the refmath oracle (also from a forced two-level JAX plan), and a
deterministic proof byte-identical to pipeline.prove(deterministic=True)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.io.wtns import write_wtns
from icicle_snark_tpu.io.zkey import ZKeyFile
from icicle_snark_tpu.prover import cache as jcache
from icicle_snark_tpu.prover import pipeline as jpipeline
from icicle_snark_tpu.refmath import groth16 as joracle
from icicle_snark_tpu.refmath.field import R_MOD
from icicle_snark_tpu.setup.r1cs import complex_circuit, complex_circuit_witness
from icicle_snark_tpu.setup.trusted_setup import groth16_setup
from icicle_snark_tpu_torch.fields import limbs as lb
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
        keys=np.asarray(jc.keys), msm_pre=jc.msm_pre, msm_pre2=jc.msm_pre2,
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


def test_convert_refuses_precompute(fixture):
    zkey_path, *_ = fixture
    jc = jcache.load_zkey_cache(zkey_path)
    jc.msm_pre = 2
    with pytest.raises(ValueError):
        _port_cache_from_jax(jc)


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
