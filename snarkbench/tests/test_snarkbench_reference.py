"""The frozen builders, the wtns writer and the plain reference, held
against the port on the CPU at small sizes."""

import json
import os

import pytest
import torch

from snarkbench.circuits import anon_aadhaar, complex as complex_inputs
from snarkbench.circuits.r1cs import complex_circuit, poseidon_bits_circuit
from snarkbench.circuits.sha256_circuit import sha256_512_circuit
from snarkbench.reference import groth16 as ref
from snarkbench.reference import zkey as refzkey
from snarkbench.wtns import write_wtns

torch.set_num_threads(1)
SEED = b"snarkbench test ceremony"


@pytest.fixture(scope="module")
def poseidon_fixture(tmp_path_factory):
    """poseidon_bits_circuit's zkey and vk by the port's setup on the CPU,
    its witness by the benchmark's writer, and one randomized proof by
    the port on the CPU."""
    from icicle_snark_tpu_torch.prover import api
    from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device

    d = tmp_path_factory.mktemp("poseidon")
    r1cs, witness = poseidon_bits_circuit(12345, 67890)
    paths = {k: str(d / f) for k, f in (("zkey", "c.zkey"), ("vk", "vk.json"), ("wtns", "w.wtns"),
                                         ("proof", "proof.json"), ("public", "public.json"))}
    groth16_setup_device(r1cs, paths["zkey"], paths["vk"], seed=SEED, device="cpu")
    write_wtns(paths["wtns"], witness)
    api.groth16_prove(paths["wtns"], paths["zkey"], paths["proof"], paths["public"],
                      api.CacheManager("cpu"))
    return r1cs, witness, paths


@pytest.mark.parametrize("build, constraints, signals", [
    (lambda: complex_circuit(20, 20), 21, 23),
    (lambda: complex_circuit(100, 150), 151, 103),
    (lambda: poseidon_bits_circuit(3, 4)[0], 755, None),
    (lambda: sha256_512_circuit([i % 2 for i in range(512)])[0], 51963, 51596),
])
def test_frozen_builders_keep_their_constraint_counts(build, constraints, signals):
    r1cs = build()
    assert r1cs.n_constraints == constraints
    if signals is not None:
        assert r1cs.n_vars == signals


def test_complex_inputs_follow_the_seed():
    params = {"num_variables": 30, "num_constraints": 30, "witnesses_per_seed": 2}
    r1cs = complex_inputs.setup_circuit(params)
    none, ws = complex_inputs.run_inputs(params, 2**40 + 5)
    assert none is None and len(ws) == 2 and ws[0] != ws[1]
    assert all(r1cs.check_witness(w) for w in ws)
    assert complex_inputs.run_inputs(params, 2**40 + 5)[1] == ws
    assert complex_inputs.run_inputs(params, 2**40 + 6)[1] != ws


def test_aadhaar_payloads_keep_their_sizes_across_seeds():
    params = {"max_data_length": 1536, "photo_bytes": 768}
    a = anon_aadhaar.seeded_payload(params, 1)
    b = anon_aadhaar.seeded_payload(params, 2**40 + 3)
    assert len(a["qr_data_padded"]) == len(b["qr_data_padded"]) == 1536
    for k in ("padded_len", "non_padded_len", "delimiter_indices", "modulus"):
        assert a[k] == b[k]
    assert a["qr_data_padded"] != b["qr_data_padded"] and a["signature"] != b["signature"]
    assert anon_aadhaar.seeded_payload(params, 1) == a


def test_wtns_writer_matches_the_port(tmp_path):
    from icicle_snark_tpu_torch.io.wtns import WtnsFile, write_wtns as port_write

    w = [1, 5, 2**253 + 7, 0, 12345678901234567890]
    write_wtns(str(tmp_path / "a.wtns"), w)
    port_write(str(tmp_path / "b.wtns"), w)
    assert (tmp_path / "a.wtns").read_bytes() == (tmp_path / "b.wtns").read_bytes()
    assert WtnsFile(str(tmp_path / "a.wtns")).witness_ints() == w


def test_reference_key_equals_the_setup_key(poseidon_fixture):
    r1cs, _, paths = poseidon_fixture
    with open(paths["vk"]) as fh:
        assert ref.verification_key(r1cs, SEED) == json.load(fh)


def test_circuit_digest_matches_the_zkey(poseidon_fixture):
    r1cs, _, paths = poseidon_fixture
    assert refzkey.circuit_digest(r1cs) == refzkey.zkey_circuit_digest(paths["zkey"])
    assert refzkey.header(paths["zkey"])["n_vars"] == r1cs.n_vars
    other = poseidon_bits_circuit(1, 2)[0]
    other.constraints[5] = ({1: 2}, {0: 1}, {})
    assert refzkey.circuit_digest(other) != refzkey.zkey_circuit_digest(paths["zkey"])


def test_reference_accepts_the_port_proof_and_rejects_a_changed_public(poseidon_fixture):
    r1cs, witness, paths = poseidon_fixture
    vk = ref.verification_key(r1cs, SEED)
    with open(paths["proof"]) as fh:
        points = ref.parse_proof(json.load(fh))
    with open(paths["public"]) as fh:
        public = [int(v) for v in json.load(fh)]
    assert public == witness[1:r1cs.n_public + 1]
    assert ref.pairing_check(points, public, vk)
    assert not ref.pairing_check(points, [public[0] + 1] + public[1:], vk)


def test_batch_check_holds_every_answer(poseidon_fixture, tmp_path):
    import random

    from icicle_snark_tpu_torch.prover import api

    r1cs, witness, paths = poseidon_fixture
    vk = ref.verification_key(r1cs, SEED)
    public = witness[1:r1cs.n_public + 1]
    answers = []
    for k in range(3):
        proof = str(tmp_path / f"proof_{k}.json")
        api.groth16_prove(paths["wtns"], paths["zkey"], proof, str(tmp_path / "public.json"),
                          api.CacheManager("cpu"))
        with open(proof) as fh:
            answers.append((ref.parse_proof(json.load(fh)), public))
    rng = random.Random(5)
    assert ref.batch_check(answers, vk, rng)
    # each point on its curve, one answer's C taken from another answer
    (a, b, _), (_, _, c) = answers[0][0], answers[1][0]
    swapped = [((a, b, c), public)] + answers[1:]
    assert all(ref.pairing_check(p, pub, vk) for p, pub in answers)
    assert not ref.pairing_check(*swapped[0], vk)
    assert not ref.batch_check(swapped, vk, rng)
    assert not ref.batch_check(answers[:2] + [(answers[2][0], [public[0] + 1] + public[1:])],
                               vk, rng)


def test_parse_rejects_malformed_points(poseidon_fixture):
    _, _, paths = poseidon_fixture
    with open(paths["proof"]) as fh:
        proof = json.load(fh)
    ref.parse_proof(proof)
    for bad in (dict(proof, pi_a=[str(int(proof["pi_a"][0]) + 1)] + proof["pi_a"][1:]),
                dict(proof, pi_c=["0", "0", "1"]), dict(proof, protocol="plonk"),
                dict(proof, pi_a=[str(2**256)] + proof["pi_a"][1:])):
        with pytest.raises(ValueError):
            ref.parse_proof(bad)
    assert os.path.exists(paths["zkey"])
