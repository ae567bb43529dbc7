"""The port's copies of the AadhaarVerifier and keyless (JWT RS256 + OIDC
claims + Poseidon commitment) builders against the JAX package's, at the
reduced sizes the JAX tests build (max_data_length 320, max_jwt_len 512):
the same R1CS and witness, the expected public outputs, and a tampered
nullifier or identity commitment rejected."""

import pytest
import torch

from icicle_snark_tpu.setup import aadhaar_circuit as jaadhaar
from icicle_snark_tpu.setup import keyless_circuit as jkeyless
from icicle_snark_tpu_torch.refmath.field import R_MOD
from icicle_snark_tpu_torch.setup import aadhaar_circuit, keyless_circuit

from test_torch_circuits_hash import assert_same_circuit

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def aadhaar():
    kwargs, expected = aadhaar_circuit.aadhaar_test_vector(max_data_length=320)
    jkwargs, jexpected = jaadhaar.aadhaar_test_vector(max_data_length=320)
    assert (kwargs, expected) == (jkwargs, jexpected)
    return (aadhaar_circuit.aadhaar_verifier_circuit(**kwargs),
            jaadhaar.aadhaar_verifier_circuit(**jkwargs), expected)


@pytest.fixture(scope="module")
def keyless():
    kwargs, idc = keyless_circuit.keyless_test_vector(max_jwt_len=512)
    jkwargs, jidc = jkeyless.keyless_test_vector(max_jwt_len=512)
    assert (kwargs, idc) == (jkwargs, jidc)
    return keyless_circuit.keyless_circuit(**kwargs), jkeyless.keyless_circuit(**jkwargs), idc


@pytest.mark.parametrize("name", ["anon_aadhaar_320", "keyless_512"])
def test_builder_matches_jax(name, request):
    port, jax, expected = request.getfixturevalue(name.rsplit("_", 1)[0].removeprefix("anon_"))
    assert_same_circuit(port, jax)
    r1cs, wit = port
    if name.startswith("anon"):
        assert r1cs.n_public == 9
        names = ["pubkeyHash", "nullifier", "timestamp", "ageAbove18", "gender", "state",
                 "pinCode"]
        assert [wit[1 + i] for i in range(7)] == [expected[k] % R_MOD for k in names]
    else:
        assert r1cs.n_public == 5
        assert wit[1] == expected % R_MOD


@pytest.mark.parametrize("name,signal", [("aadhaar", 2), ("keyless", 1)],
                         ids=["tampered_nullifier", "tampered_idc"])
def test_tampered_output_rejected(name, signal, request):
    (r1cs, wit), _, _ = request.getfixturevalue(name)
    bad = list(wit)
    bad[signal] = (bad[signal] + 1) % R_MOD
    assert not r1cs.check_witness(bad)
