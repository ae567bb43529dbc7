"""A small circuit on the family's gadgets through the port's prove on the
CPU (plain versions): `poseidon_bits_circuit` (a Poseidon hash of two
private inputs, each bound to 254 bits by a row whose packing sum sits in
A, so K2 folds its slots; two public signals). Its deterministic proof
equals the JAX package's pipeline.prove(deterministic=True) byte for
byte, public.json too, and the oracle's; both kinds of proof verify. Also
the weight-carrying entry point's default device."""

import numpy as np
import pytest
import torch

from icicle_snark_tpu.prover import cache as jcache
from icicle_snark_tpu.prover import pipeline as jpipeline
from icicle_snark_tpu_torch.io.wtns import write_wtns
from icicle_snark_tpu_torch.prover import convert, pipeline
from icicle_snark_tpu_torch.prover.cache import load_zkey_cache
from icicle_snark_tpu_torch.refmath import groth16 as oracle
from icicle_snark_tpu_torch.refmath.field import R_MOD
from icicle_snark_tpu_torch.setup.r1cs import poseidon_bits_circuit
from icicle_snark_tpu_torch.setup.poseidon import poseidon_hash
from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

# the inputs chip_smoke.py's phase 9 proves (POSEIDON_BITS_INPUTS)
X, Y = 3 ** 150 % (1 << 250), 7 ** 88 % (1 << 247)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_circuits_prove")
    r1cs, witness = poseidon_bits_circuit(X, Y)
    zkey = str(tmp / "circuit_final.zkey")
    vk = groth16_setup(r1cs, zkey, str(tmp / "verification_key.json"))
    wtns = str(tmp / "witness.wtns")
    write_wtns(wtns, witness)
    return r1cs, witness, zkey, wtns, vk


def test_circuit_shape(fixture):
    r1cs, witness, *_ = fixture
    assert r1cs.check_witness(witness)
    assert r1cs.n_public == 2
    assert witness[1:3] == [poseidon_hash([X, Y]), (X + Y) % R_MOD]
    widest = max(len(a) for a, _, _ in r1cs.constraints)
    assert widest == 254


def test_fold_plan_taken(fixture):
    """The A slots of 254 terms fold twice at pieces of 32 (8 pieces, then
    one), and the plan's long slots hold every slot above 32 terms."""
    _r1cs, _w, zkey, _wtns, _vk = fixture
    plan = load_zkey_cache(zkey, "cpu").plan
    long_slots, levels = pipeline.r1cs_fold_plan(plan, pipeline.R1CS_PIECE)
    counts = (plan.offsets[1:] - plan.offsets[:-1]).long()
    assert len(levels) == 2
    assert torch.equal(long_slots.long(), torch.nonzero(counts > pipeline.R1CS_PIECE).flatten())
    n = plan.num_slots // 2
    assert int(counts[:n].max()) == 254 and int(counts[n:].max()) <= 2 * pipeline.R1CS_PIECE


def test_prove_bitexact_vs_jax_and_verifies(fixture):
    _r1cs, _w, zkey, wtns, vk = fixture
    cache = load_zkey_cache(zkey, device="cpu")
    proof, public = pipeline.prove(wtns, cache, deterministic=True)
    assert (proof, public) == jpipeline.prove(wtns, jcache.load_zkey_cache(zkey),
                                              deterministic=True)
    assert (proof, public) == oracle.prove(zkey, wtns, deterministic=True)
    assert public == [str(poseidon_hash([X, Y])), str((X + Y) % R_MOD)]
    assert oracle.verify(proof, public, vk)
    rproof, rpublic = pipeline.prove(wtns, cache)
    assert rproof != proof and oracle.verify(rproof, rpublic, vk)
    assert not oracle.verify(proof, [str((X + Y + 1) % R_MOD)] + public[1:], vk)


def test_convert_defaults_to_the_card():
    """cache_from_jax_arrays runs on the card unless asked for the CPU:
    without one, the call without a device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    empty = np.zeros((16, 0), dtype=np.uint16)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.cache_from_jax_arrays(
            None, coefs=empty, witness_idx=np.zeros(0), segments=np.zeros(0), level2=None,
            points_a=(empty, empty), points_b1=(empty, empty), points_b2=(empty, empty),
            points_c=(empty, empty), points_h=(empty, empty), keys=empty)
