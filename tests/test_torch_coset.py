"""The port's fused coset evaluation on the CPU: K2 rows, then K5's passes
with the coset keys fused into the last inverse pass and h into the last
forward pass (plain versions), against the JAX package's
pipeline.construct_r1cs and the refmath oracle's compute_h_scalars, exact
integer equality, with a forced small tile so that the first, middle and
both fused last passes run; the same from a forced two-level JAX plan
through convert.py; and a word-by-word integer model of the PTX field
arithmetic of csrc/field_ptx.cuh (carry chains and lazy bounds)."""

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.io.wtns import write_wtns
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu.prover import cache as jcache
from icicle_snark_tpu.prover import pipeline as jpipeline
from icicle_snark_tpu.refmath import groth16 as joracle
from icicle_snark_tpu.refmath.field import MONT_R_FR, R_MOD, W
from icicle_snark_tpu.setup.r1cs import (complex_circuit, complex_circuit_witness, fanin_circuit,
                                        fanin_witness)
from icicle_snark_tpu.setup.trusted_setup import groth16_setup
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import ntt
from icicle_snark_tpu_torch.prover import convert, pipeline
from icicle_snark_tpu_torch.prover.cache import build_r1cs_plan, load_zkey_cache

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

MASK = (1 << 32) - 1
R = 1 << 256


def _coefficients(r1cs, n):
    """The zkey's coefficient records (A and B rows, then the public
    binding rows), as ZKeyFile.coefficients() returns them."""
    recs = []
    for row, (a_lc, b_lc, _c) in enumerate(r1cs.constraints):
        recs += [(0, row, s, v) for s, v in a_lc.items()]
        recs += [(1, row, s, v) for s, v in b_lc.items()]
    recs += [(0, len(r1cs.constraints) + s, s, 1) for s in range(r1cs.n_public + 1)]
    m, c, s, v = (np.array(col, dtype=object) for col in zip(*recs))
    words = lb.ints_to_words([int(x) % R_MOD * MONT_R_FR % R_MOD for x in v])
    return m.astype(np.uint32), c.astype(np.uint32), s.astype(np.uint32), words


def _h_port(m, c, s, words, n, log_n, witness):
    """h through the port's own flow (CPU: plain versions), and through
    the chip script's reference (r1cs_rows_plain, coset_h_plain)."""
    slots = torch.from_numpy(m.astype(np.int64) * n + c.astype(np.int64))
    plan = build_r1cs_plan(slots, torch.from_numpy(s.astype(np.int64)),
                           lb.words_to_limbs(words), n)
    dom = ntt.NTTDomain(log_n, "cpu")
    keys = ntt.powers_mont(W[log_n + 1], log_n, "cpu")
    keys_br_scaled = lb.mont_mul(keys[:, dom.bitrev].contiguous(), dom.n_inv_mont, lb.FR_SPEC)
    w = lb.ints_to_limbs(witness)
    got = ntt.coset_h(pipeline.r1cs_rows(w, plan), dom, keys_br_scaled)
    ref = ntt.coset_h_plain(pipeline.r1cs_rows_plain(w, plan), dom, keys_br_scaled)
    assert torch.equal(got, ref)
    return lb.limbs_to_ints(got)


def _h_jax(m, c, s, words, n, log_n, witness):
    hdr = SimpleNamespace(domain_size=n, power=log_n)
    jc = jcache.ZKeyCache(
        header=hdr, plan=jcache.build_r1cs_plan(m, c, s, words, n), points_a=None,
        points_b1=None, points_b2=None, points_c=None, points_h=None,
        keys=jntt.powers_mont(W[log_n + 1], log_n))
    jw = jnp.asarray(jlb.ints_to_limbs_np([x % R_MOD for x in witness]))
    return jlb.limbs_to_ints_np(np.asarray(jpipeline.construct_r1cs(jw, jc)))


@pytest.mark.parametrize("tile_log", [2, 3])
@pytest.mark.parametrize("log_n", [6, 7, 8, 9, 10])
def test_fused_coset_matches_jax_and_oracle(log_n, tile_log, monkeypatch):
    cons = {6: 50, 7: 100, 8: 200, 9: 400, 10: 900}[log_n]
    r1cs = complex_circuit(cons // 2, cons)
    witness = complex_circuit_witness(r1cs, a=3 + log_n)
    n = 1 << log_n
    assert len(r1cs.constraints) + r1cs.n_public + 1 <= n < 2 * (len(r1cs.constraints) + 2)
    m, c, s, words = _coefficients(r1cs, n)
    monkeypatch.setattr(ntt, "NTT_TILE_LOG", tile_log)
    passes = ntt.block_passes(log_n)
    assert len(passes) >= 3 and log_n >= ntt.NTT_BLOCK_MIN_LOG  # first, middle, last
    got = _h_port(m, c, s, words, n, log_n, witness)
    zkey = SimpleNamespace(header=SimpleNamespace(domain_size=n, power=log_n),
                           coefficients=lambda: (m, c, s, words))
    assert got == joracle.compute_h_scalars(zkey, witness)
    assert got == _h_jax(m, c, s, words, n, log_n, witness)


def test_fused_coset_with_folded_row(monkeypatch):
    """A circom-like linear-combination row of 300 terms, summed by K2 in
    pieces of 4 over five fold levels, gives the oracle's h."""
    r1cs = fanin_circuit(300)
    witness = fanin_witness(r1cs)
    n, log_n = 8, 3
    m, c, s, words = _coefficients(r1cs, n)
    monkeypatch.setattr(pipeline, "R1CS_PIECE", 4)
    monkeypatch.setattr(ntt, "NTT_TILE_LOG", 1)
    assert len(ntt.block_passes(log_n)) == 3
    got = _h_port(m, c, s, words, n, log_n, witness)
    zkey = SimpleNamespace(header=SimpleNamespace(domain_size=n, power=log_n),
                           coefficients=lambda: (m, c, s, words))
    assert got == joracle.compute_h_scalars(zkey, witness)


@pytest.fixture(scope="module")
def small_zkey(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_coset")
    r1cs = complex_circuit(40, 50)
    zkey_path = str(tmp / "circuit_final.zkey")
    groth16_setup(r1cs, zkey_path)
    witness = complex_circuit_witness(r1cs, a=7)
    write_wtns(str(tmp / "witness.wtns"), witness)
    return zkey_path, witness


def test_two_level_jax_plan_through_convert(small_zkey, monkeypatch):
    """A JAX cache with a forced two-level plan converts to a port cache
    whose derived tables (the bit-reversed scaled keys) equal those of the
    port's own cache, and whose fused coset evaluation (tile 2^2) gives
    the JAX package's h."""
    zkey_path, witness = small_zkey
    monkeypatch.setenv("ISTPU_SEG_CHUNK", "1")
    jc = jcache.load_zkey_cache(zkey_path)
    assert jc.plan.level2 is not None
    plan = jc.plan
    cache = convert.cache_from_jax_arrays(
        jc.header, coefs=np.asarray(plan.coefs), witness_idx=np.asarray(plan.witness_idx),
        segments=np.asarray(plan.segments),
        level2=(np.asarray(plan.level2[0]), plan.level2[1]),
        points_a=tuple(np.asarray(a) for a in jc.points_a),
        points_b1=tuple(np.asarray(a) for a in jc.points_b1),
        points_b2=tuple(np.asarray(a) for a in jc.points_b2),
        points_c=tuple(np.asarray(a) for a in jc.points_c),
        points_h=tuple(np.asarray(a) for a in jc.points_h),
        keys=np.asarray(jc.keys), msm_c=jc.msm_c, msm_c2=jc.msm_c2, device="cpu")
    own = load_zkey_cache(zkey_path, "cpu")
    assert torch.equal(cache.keys_br_scaled, own.keys_br_scaled)
    n_inv = pow(cache.header.domain_size, -1, R_MOD)
    g = W[cache.domain.log_n + 1]  # the coset generator, g^n = -1
    assert lb.limbs_to_ints(cache.keys_br_scaled) == [
        pow(g, int(i), R_MOD) * lb.FR_SPEC.r_mod * n_inv % R_MOD for i in cache.domain.bitrev]
    monkeypatch.setattr(ntt, "NTT_TILE_LOG", 2)
    got = lb.limbs_to_ints(pipeline.construct_r1cs(lb.ints_to_limbs(witness), cache))
    jw = jnp.asarray(jlb.ints_to_limbs_np([w % R_MOD for w in witness]))
    assert got == jlb.limbs_to_ints_np(np.asarray(jpipeline.construct_r1cs(jw, jc)))


# ---------------------------------------------------------------- field_ptx.cuh

P_WORDS = [(R_MOD >> (32 * i)) & MASK for i in range(8)]
P2_WORDS = [((2 * R_MOD) >> (32 * i)) & MASK for i in range(8)]
N0 = (-pow(R_MOD, -1, 1 << 32)) % (1 << 32)


def _words(v):
    return [(v >> (32 * i)) & MASK for i in range(8)]


def _value(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def _mac_lo(t, a, b):
    """mad.lo.cc / madc.lo.cc x 8 into t[0..7], addc into t[8]."""
    cf = 0
    for j in range(8):
        s = t[j] + ((a[j] * b) & MASK) + cf
        t[j], cf = s & MASK, s >> 32
    s = t[8] + cf
    assert s <= MASK, "carry lost out of t[8]"
    t[8] = s


def _mac_hi(t, a, b):
    """mad.hi.cc / madc.hi.cc x 7 into t[1..7], madc.hi into t[8]."""
    cf = 0
    for j in range(8):
        s = t[j + 1] + ((a[j] * b) >> 32) + cf
        t[j + 1], cf = s & MASK, s >> 32
    assert cf == 0, "carry lost out of t[8]"


def fr_mul_model(a, b):
    aw, bw, t = _words(a), _words(b), [0] * 9
    for i in range(8):
        _mac_lo(t, aw, bw[i])
        _mac_hi(t, aw, bw[i])
        m = (t[0] * N0) & MASK
        _mac_lo(t, P_WORDS, m)
        assert t[0] == 0
        _mac_hi(t, P_WORDS, m)
        t = t[1:] + [0]
    return _value(t[:8])


def _sub_chain(a, b):
    """sub.cc / subc.cc x 8, then subc of a zero register: (words, mask)."""
    out, bf = [], 0
    for x, y in zip(_words(a), b):
        d = x - y - bf
        out.append(d & MASK)
        bf = 1 if d < 0 else 0
    return _value(out), MASK if bf else 0


def sub_if_ge_model(s, q_words):
    d, borrow = _sub_chain(s, q_words)
    return s if borrow else d


def fr_add2_model(a, b):
    s = a + b
    assert s < R, "carry lost out of the top word"
    return sub_if_ge_model(s, P2_WORDS)


def fr_sub2_model(a, b):
    d, borrow = _sub_chain(a, _words(b))
    # on a borrow, + 2r with the carry out of the top word dropped
    return (d + _value(P2_WORDS)) % R if borrow else d


def fr_canon_model(a):
    return sub_if_ge_model(a, P_WORDS)


def test_ptx_field_model_on_edges_and_random():
    r, rinv = R_MOD, pow(R, -1, R_MOD)
    prng = random.Random(4)
    edges = [0, 1, r - 1, r, 2 * r - 1]
    lazy = edges + [prng.randrange(2 * r) for _ in range(300)]
    for a in lazy:
        for b in edges + [prng.randrange(2 * r) for _ in range(4)]:
            got = fr_mul_model(a, b)
            assert got % r == a * b * rinv % r and got < 2 * r
            s = fr_add2_model(a, b)
            assert s % r == (a + b) % r and s < 2 * r
            d = fr_sub2_model(a, b)
            assert d % r == (a - b) % r and d < 2 * r
        assert fr_canon_model(a) == a % r
    # the header's wider claims: any a < 4r, b < R keeps the round sums in
    # nine words; the output is below 2r whenever a b < R r
    for _ in range(300):
        a, b = prng.randrange(4 * r), prng.randrange(R)
        got = fr_mul_model(a, b)
        assert got % r == a * b * rinv % r
        if a * b < R * r:
            assert got < 2 * r
    assert fr_mul_model(4 * r - 1, R - 1) % r == (4 * r - 1) * (R - 1) * rinv % r
    # a REDC (times standard 1) of a lazy sum is at most r, so K2 canonicalizes it
    assert all(fr_mul_model(a, 1) <= r for a in lazy)
