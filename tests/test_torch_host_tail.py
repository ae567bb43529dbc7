"""The prove's host tail run under the MSMs (prover/pipeline.py
commit_and_randomize) on the CPU: r and s drawn before the MSMs from the same
`rng` in the same order, so a seeded prove writes byte for byte the proof of
the order that randomised after both MSMs (a copy of that formula is kept
here) and the JAX package's seeded proof; the split randomisation
(randomize_terms, randomize_g1, randomize_g2) against refmath's scalar
products on points of known discrete logarithm, with r or s zero and
identity MSM results; and an all-zero group through the early download of
G1's window sums (ops/msm.py HostCopy). HostCopy's pinned copy and event
are checked on the card (the chip-marked test)."""

import json
import random
from types import SimpleNamespace

import pytest
import torch

from icicle_snark_tpu_torch import trace
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.io.wtns import write_wtns
from icicle_snark_tpu_torch.ops import msm as msm_ops
from icicle_snark_tpu_torch.prover import api, pipeline
from icicle_snark_tpu_torch.prover.cache import load_zkey_cache
from icicle_snark_tpu_torch.refmath import curve as cv
from icicle_snark_tpu_torch.refmath import groth16 as oracle
from icicle_snark_tpu_torch.refmath.field import R_MOD
from icicle_snark_tpu_torch.refmath.groth16 import serialize_proof
from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness
from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def randomize_after_msms(hdr, commitments, r, s):
    """The old order: the randomisation in one step once both MSMs have
    finished, r and s given (proof_helper.rs:274-295)."""
    pi_a, pi_b1, pi_b, pi_c, pi_h = commitments
    alpha1 = cv.g1_from_affine(hdr.vk_alpha_1)
    beta1 = cv.g1_from_affine(hdr.vk_beta_1)
    delta1 = cv.g1_from_affine(hdr.vk_delta_1)
    beta2 = cv.g2_from_affine(hdr.vk_beta_2)
    delta2 = cv.g2_from_affine(hdr.vk_delta_2)
    pi_a = cv.g1_add(pi_a, cv.g1_add(alpha1, cv.g1_mul(delta1, r)))
    pi_b = cv.g2_add(pi_b, cv.g2_add(beta2, cv.g2_mul(delta2, s)))
    pi_b1 = cv.g1_add(pi_b1, cv.g1_add(beta1, cv.g1_mul(delta1, s)))
    pi_c = cv.g1_add(pi_c, pi_h)
    pi_c = cv.g1_add(pi_c, cv.g1_mul(pi_a, s))
    pi_c = cv.g1_add(pi_c, cv.g1_mul(pi_b1, r))
    pi_c = cv.g1_add(pi_c, cv.g1_neg(cv.g1_mul(delta1, r * s % R_MOD)))
    return pi_a, pi_b, pi_c


class Seeded:
    """A seeded source with the `randbelow` that the prove draws r and s by."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._rng.randrange(n)


def draw_after_msms(rng):
    return rng.randbelow(R_MOD), rng.randbelow(R_MOD)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The complex circuit (domain 64), its zkey, a witness and a CPU cache."""
    tmp = tmp_path_factory.mktemp("torch_host_tail")
    r1cs = complex_circuit(40, 50)
    zkey, vk, wtns = (str(tmp / f) for f in ("circuit_final.zkey", "vk.json", "witness.wtns"))
    groth16_setup(r1cs, zkey, vk)
    write_wtns(wtns, complex_circuit_witness(r1cs, a=7))
    return tmp, zkey, vk, wtns, load_zkey_cache(zkey, device="cpu")


def _files(proof, public) -> tuple:
    """proof.json and public.json as api.groth16_prove writes them."""
    return json.dumps(proof, indent=1), json.dumps(public, indent=1)


@pytest.fixture(scope="module")
def raw_commitments(fixture):
    """The five MSM results of the fixture's witness, caught on their way
    into the randomisation of a deterministic prove."""
    *_, wtns, cache = fixture
    seen = {}
    g1, g2 = pipeline.randomize_g1, pipeline.randomize_g2

    def catch_g1(terms, r, s, *points):
        seen["g1"] = points
        return g1(terms, r, s, *points)

    def catch_g2(terms, pi_b):
        seen["g2"] = pi_b
        return g2(terms, pi_b)

    mp = pytest.MonkeyPatch()
    mp.setattr(pipeline, "randomize_g1", catch_g1)
    mp.setattr(pipeline, "randomize_g2", catch_g2)
    try:
        pipeline.prove(wtns, cache, deterministic=True)
    finally:
        mp.undo()
    pi_a, pi_b1, pi_c, pi_h = seen["g1"]
    return pi_a, pi_b1, seen["g2"], pi_c, pi_h


@pytest.mark.parametrize("seed", SEEDS)
def test_a_seeded_prove_writes_the_files_of_the_old_order(fixture, raw_commitments, seed):
    """r and s drawn before the MSMs give the files that drawing them after
    both MSMs gave, byte for byte, the port oracle's seeded proof and the
    JAX package's (its refmath oracle draws r, then s, from the same
    source after its MSMs)."""
    from icicle_snark_tpu.refmath import groth16 as joracle

    _tmp, zkey, vk, wtns, cache = fixture
    proof, public = pipeline.prove(wtns, cache, rng=Seeded(seed))
    r, s = draw_after_msms(Seeded(seed))
    assert r != s
    want = serialize_proof(*randomize_after_msms(cache.header, raw_commitments, r, s))
    assert _files(proof, public)[0] == _files(want, public)[0]
    assert (proof, public) == oracle.prove(zkey, wtns, deterministic=False,
                                           rng=Seeded(seed))
    jproof, jpublic = joracle.prove(zkey, wtns, deterministic=False, rng=Seeded(seed))
    assert _files(proof, public) == _files(jproof, jpublic)
    assert oracle.verify(proof, public, json.load(open(vk)))


def test_seeded_files_through_the_api_are_the_old_orders(fixture, raw_commitments,
                                                            monkeypatch):
    """api.groth16_prove, with `secrets` seeded, writes the old order's
    proof.json and public.json byte for byte; two draws give two proofs."""
    tmp, zkey, vk, wtns, cache = fixture
    import secrets

    cm = api.CacheManager("cpu")
    _proof, pub = pipeline.prove(wtns, cache, deterministic=True)
    written = []
    for seed in (3, 4):
        monkeypatch.setattr(secrets, "randbelow", Seeded(seed).randbelow)
        proof, public = str(tmp / f"proof_{seed}.json"), str(tmp / f"public_{seed}.json")
        api.groth16_prove(wtns, zkey, proof, public, cm)
        written.append((open(proof).read(), open(public).read()))
        r, s = draw_after_msms(Seeded(seed))
        want = serialize_proof(*randomize_after_msms(cache.header, raw_commitments, r, s))
        assert written[-1] == _files(want, pub)
        assert api.groth16_verify(proof, public, vk)
    assert written[0][0] != written[1][0]


def test_the_deterministic_proof_is_the_oracles(fixture, raw_commitments):
    _tmp, zkey, vk, wtns, cache = fixture
    proof, public = pipeline.prove(wtns, cache, deterministic=True)
    assert (proof, public) == oracle.prove(zkey, wtns, deterministic=True)
    assert proof == serialize_proof(*randomize_after_msms(cache.header, raw_commitments, 1, 1))
    assert oracle.verify(proof, public, json.load(open(vk)))


def test_draw_rs_takes_r_then_s_from_one_source():
    rng = Seeded(5)
    assert pipeline.draw_rs(False, Seeded(5)) == (rng.randbelow(R_MOD), rng.randbelow(R_MOD))
    assert pipeline.draw_rs(True, Seeded(5)) == (1, 1)
    r, s = pipeline.draw_rs(False, None)  # secrets
    assert 0 <= r < R_MOD and 0 <= s < R_MOD


# ---------------------------------------------------------------- the split formula

def _g1(k):
    return cv.g1_mul(cv.G1_GEN, k % R_MOD)


def _g2(k):
    return cv.g2_mul(cv.G2_GEN, k % R_MOD)


def _key(rng):
    """A verification key of known logarithms (alpha, beta, delta)."""
    alpha, beta, delta = (rng.randrange(1, R_MOD) for _ in range(3))
    hdr = SimpleNamespace(vk_alpha_1=cv.g1_to_affine(_g1(alpha)),
                          vk_beta_1=cv.g1_to_affine(_g1(beta)),
                          vk_delta_1=cv.g1_to_affine(_g1(delta)),
                          vk_beta_2=cv.g2_to_affine(_g2(beta)),
                          vk_delta_2=cv.g2_to_affine(_g2(delta)))
    return hdr, alpha, beta, delta


CASES = {
    "random": lambda rng: (rng.randrange(R_MOD), rng.randrange(R_MOD), None),
    "r_zero": lambda rng: (0, rng.randrange(R_MOD), None),
    "s_zero": lambda rng: (rng.randrange(R_MOD), 0, None),
    "r_and_s_zero": lambda rng: (0, 0, None),
    "identity_msms": lambda rng: (rng.randrange(R_MOD), rng.randrange(R_MOD), "all"),
    "identity_h": lambda rng: (rng.randrange(R_MOD), rng.randrange(R_MOD), "h"),
    "deterministic": lambda rng: (1, 1, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_split_randomisation_is_the_scalar_formula(case):
    """A = (a + alpha + r delta) G1, B = (b + beta + s delta) G2 and
    C = (c + h + s A + r B1 - rs delta) G1 for MSM results of known
    logarithms a, b1, b, c, h (zero for an identity result): the three
    parts of the new order equal refmath's g1_mul / g2_mul of those
    scalars, and the old order."""
    rng = random.Random(f"host_tail/{case}")
    hdr, alpha, beta, delta = _key(rng)
    r, s, zero = CASES[case](rng)
    a, b1, b, c, h = (rng.randrange(1, R_MOD) for _ in range(5))
    if zero == "all":
        a = b1 = b = c = h = 0
    elif zero == "h":
        h = 0
    commitments = (_g1(a), _g1(b1), _g2(b), _g1(c), _g1(h))
    if zero:
        assert commitments[4] == cv.G1_ZERO

    terms = pipeline.randomize_terms(hdr, r, s)
    assert cv.g1_eq(terms.a, _g1(alpha + r * delta))
    assert cv.g1_eq(terms.b1, _g1(beta + s * delta))
    assert cv.g2_eq(terms.b2, _g2(beta + s * delta))
    assert cv.g1_eq(terms.rs, _g1(-r * s * delta))
    pi_a, pi_c = pipeline.randomize_g1(terms, r, s, *commitments[:2], *commitments[3:])
    pi_b = pipeline.randomize_g2(terms, commitments[2])

    big_a = a + alpha + r * delta
    big_b1 = b1 + beta + s * delta
    assert cv.g1_eq(pi_a, _g1(big_a))
    assert cv.g2_eq(pi_b, _g2(b + beta + s * delta))
    assert cv.g1_eq(pi_c, _g1(c + h + s * big_a + r * big_b1 - r * s * delta))

    old = randomize_after_msms(hdr, commitments, r, s)
    assert (pi_a, pi_b, pi_c) == old  # the same operations in the same order
    assert serialize_proof(pi_a, pi_b, pi_c) == serialize_proof(*old)


# ---------------------------------------------------------------- G1's early download

def _g1_window_sums(cache, witness, h):
    npub = cache.header.n_public
    scalars = torch.cat([witness, witness, witness[:, npub + 1:], h], dim=-1)
    return msm_ops.msm_window_sums(scalars, cache.g1_sizes, cache.g1_records, cache.msm_c,
                                   cache.msm_pre)


def test_an_all_zero_group_downloads_and_combines_to_the_identity(fixture, raw_commitments):
    """A group of all-zero scalars has identity window sums: through the
    early download and the combine it gives the identity, the other groups
    their MSM results, and the randomisation the old order's points."""
    *_, wtns, cache = fixture
    _wtns, witness = pipeline.read_witness(wtns, cache.header, "cpu")
    zero_h = torch.zeros((lb.NLIMB, cache.g1_sizes[3]), dtype=torch.int32)
    got = msm_ops.HostCopy(_g1_window_sums(cache, witness, zero_h)).wait()
    windows = msm_ops.window_points_to_host_g1(got, 3)
    assert all(p[2] == 0 for p in windows)
    pi_h = msm_ops.horner_combine(windows, cache.msm_c)
    assert pi_h == cv.G1_ZERO
    g1 = msm_ops.host_points(got, cache.msm_c, 4, g2=False)
    pi_a, pi_b1, pi_b, pi_c, _pi_h = raw_commitments
    assert g1 == [pi_a, pi_b1, pi_c, pi_h]
    r, s = draw_after_msms(Seeded(11))
    terms = pipeline.randomize_terms(cache.header, r, s)
    split_a, split_c = pipeline.randomize_g1(terms, r, s, *g1)
    assert (split_a, pipeline.randomize_g2(terms, pi_b), split_c) == \
        randomize_after_msms(cache.header, (pi_a, pi_b1, pi_b, pi_c, pi_h), r, s)


@pytest.mark.chip
def test_the_early_download_on_the_card(fixture):
    """On the card: HostCopy lands `.cpu()`'s bytes, its wait is not a call
    that torch's sync debug mode flags, and a seeded prove writes the CPU's
    proof."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import warnings

    _tmp, zkey, _vk, wtns, cache = fixture
    x = torch.arange(3 * 8 * 4 * 16, dtype=torch.int32, device="cuda").reshape(3, 8, 4, 16)
    copy = msm_ops.HostCopy(x * 3)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            host = copy.wait()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in got if str(w.message).startswith(trace.SYNC_WARNING)]
    assert (host == (x * 3).cpu().numpy()).all()
    card = load_zkey_cache(zkey, device="cuda")
    assert pipeline.prove(wtns, card, rng=Seeded(9)) == pipeline.prove(wtns, cache, rng=Seeded(9))
