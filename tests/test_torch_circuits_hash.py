"""The port's copies of the SHA-256, Keccak-256 and Poseidon builders
(icicle_snark_tpu_torch/setup/) against the JAX package's: at the full
sizes the JAX tests build, the same R1CS (n_vars, n_public, every
constraint) and the same witness; Poseidon's circomlib known answers and
its gadget against the host hash."""

import hashlib

import pytest
import torch

from icicle_snark_tpu.setup import keccak_circuit as jkeccak
from icicle_snark_tpu.setup import poseidon as jposeidon
from icicle_snark_tpu.setup import sha256_circuit as jsha
from icicle_snark_tpu_torch.refmath.field import R_MOD
from icicle_snark_tpu_torch.setup import keccak_circuit, poseidon, sha256_circuit
from icicle_snark_tpu_torch.setup.sha256_circuit import Builder

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def _msb_bits(msg: bytes) -> list:
    return [(msg[i // 8] >> (7 - i % 8)) & 1 for i in range(8 * len(msg))]


def _lsb_bits(msg: bytes) -> list:
    return [(msg[i // 8] >> (i % 8)) & 1 for i in range(8 * len(msg))]


def assert_same_circuit(port, jax):
    (r, w), (jr, jw) = port, jax
    assert (r.n_vars, r.n_public, r.n_constraints) == (jr.n_vars, jr.n_public, jr.n_constraints)
    assert r.constraints == jr.constraints
    assert w == jw
    assert r.check_witness(w)


@pytest.mark.parametrize("name", ["sha256_512", "keccak256"])
def test_builder_matches_jax(name):
    if name == "sha256_512":
        msg = bytes(range(64))
        port = sha256_circuit.sha256_512_circuit(_msb_bits(msg))
        assert_same_circuit(port, jsha.sha256_512_circuit(_msb_bits(msg)))
        assert sha256_circuit.digest_from_witness(port[1]) == hashlib.sha256(msg).digest()
        assert port[0].n_public == 256
    else:
        msg = bytes(range(32))
        port = keccak_circuit.keccak256_circuit(_lsb_bits(msg))
        assert_same_circuit(port, jkeccak.keccak256_circuit(_lsb_bits(msg)))
        assert keccak_circuit.digest_from_witness(port[1]) == jkeccak.digest_from_witness(port[1])
        assert port[0].n_public == 256


# circomlib's published digests (go-iden3-crypto / circomlibjs test vectors)
CIRCOMLIB_KATS = [
    ([1], 18586133768512220936620570745912940619677854269274689475585506675881198879027),
    ([1, 2], 7853200120776062878684798364095072458815029376092732009249414926327459813530),
]


@pytest.mark.parametrize("inputs,digest", CIRCOMLIB_KATS)
def test_poseidon_circomlib_kats(inputs, digest):
    assert poseidon.poseidon_hash(inputs) == digest == jposeidon.poseidon_hash(inputs)


def test_poseidon_params_match_jax():
    for t in (2, 3, 5, 17):
        assert poseidon.poseidon_params(t) == jposeidon.poseidon_params(t)


@pytest.mark.parametrize("inputs", [[5, 6], list(range(1, 17)), [7], [0, 0, 0]])
def test_poseidon_gadget_matches_host_and_jax(inputs):
    out = []
    for mod, bld in ((poseidon, Builder(0)), (jposeidon, jsha.Builder(0))):
        sigs = [bld.alloc(v) for v in inputs]
        lc, v = mod.poseidon_gadget(bld, [({s: 1}, bld.values[s]) for s in sigs])
        out.append((lc, v, bld.constraints, bld.values))
    assert out[0] == out[1]
    lc, v, constraints, values = out[0]
    assert v == poseidon.poseidon_hash(inputs)

    def ev(combo):
        return sum(c * values[s] for s, c in combo.items()) % R_MOD

    assert all(ev(a) * ev(b) % R_MOD == ev(c) for a, b, c in constraints)
