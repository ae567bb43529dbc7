"""The port's copy of the RSA builders (RSAVerify65537(64, 32) and the
anon_aadhaar SignatureVerifier core, SHA-256 in circuit feeding it)
against the JAX package's at full size: the same R1CS and witness; a bad
signature refused by both."""

import pytest
import torch

from icicle_snark_tpu.setup import rsa_circuit as jrsa
from icicle_snark_tpu_torch.setup import rsa_circuit

from test_torch_circuits_hash import assert_same_circuit

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["rsa", "rsa_sha256"])
def test_builder_matches_jax(name):
    if name == "rsa":
        vector = rsa_circuit.rsa_test_vector()
        assert vector == jrsa.rsa_test_vector()
        port = rsa_circuit.rsa_verify_circuit(*vector)
        assert_same_circuit(port, jrsa.rsa_verify_circuit(*vector))
        assert port[0].n_public == 32
    else:
        vector = rsa_circuit.rsa_sha256_test_vector()
        assert vector == jrsa.rsa_sha256_test_vector()
        port = rsa_circuit.rsa_sha256_verify_circuit(*vector)
        assert_same_circuit(port, jrsa.rsa_sha256_verify_circuit(*vector))
        assert port[0].n_public == 32


@pytest.mark.parametrize("name", ["rsa", "rsa_sha256"])
def test_bad_signature_refused(name):
    if name == "rsa":
        sig, n, h = rsa_circuit.rsa_test_vector()
        for build in (rsa_circuit.rsa_verify_circuit, jrsa.rsa_verify_circuit):
            with pytest.raises(AssertionError):
                build(sig + 1, n, h)
    else:
        msg, sig, n = rsa_circuit.rsa_sha256_test_vector()
        for build in (rsa_circuit.rsa_sha256_verify_circuit, jrsa.rsa_sha256_verify_circuit):
            with pytest.raises(AssertionError):
                build(msg, sig + 1, n)
