"""K2, the R1CS rows (plain version on the CPU), against Python integers:
slots of fan-in 0, 1, L and L + 1 and one slot holding every term, with
the piece size L patched to 4 so the long slots are summed over several
fold levels; the fold tables' cover of each long slot; and the rows on
the JAX package's evaluation of a complex circuit's plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.prover import cache as jcache
from icicle_snark_tpu.prover import pipeline as jpipeline
from icicle_snark_tpu.refmath.field import MONT_R_FR, R_MOD
from icicle_snark_tpu.setup.r1cs import complex_circuit, complex_circuit_witness
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.prover import pipeline
from icicle_snark_tpu_torch.prover.cache import build_r1cs_plan

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

RINV = pow(1 << 256, -1, R_MOD)
PIECE = 4


def _rand_words(rng, count, below):
    w = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64).astype(np.uint32)
    w[:, 7] = rng.integers(0, below >> 224, size=count).astype(np.uint32)
    return w


def _case(seed, fanins, n, n_vars=37):
    """A plan whose slots get the given fan-ins (slot -> terms, the rest
    empty), random coefficients below r, and a random witness with 0, 1
    and r - 1 among its values; returns (plan, witness tensor, expected
    (3, n) integers)."""
    rng = np.random.default_rng(seed)
    slots = np.concatenate([np.full(k, s, dtype=np.int64) for s, k in fanins.items()])
    rng.shuffle(slots)
    nnz = slots.size
    widx = rng.integers(0, n_vars, size=nnz)
    coefs = _rand_words(rng, nnz, R_MOD)
    coefs[:2] = lb.ints_to_words([0, R_MOD - 1])
    wwords = _rand_words(rng, n_vars, R_MOD)
    wwords[:3] = lb.ints_to_words([0, 1, R_MOD - 1])
    cvals = [int.from_bytes(c.astype("<u4").tobytes(), "little") for c in coefs]
    wvals = [int.from_bytes(w.astype("<u4").tobytes(), "little") for w in wwords]
    sums = [0] * (2 * n)
    for s, i, c in zip(slots, widx, cvals):
        sums[s] = (sums[s] + c * wvals[i] * RINV) % R_MOD
    ab = [v * RINV % R_MOD for v in sums]
    want = [ab[:n], ab[n:], [a * b * RINV % R_MOD for a, b in zip(ab[:n], ab[n:])]]
    plan = build_r1cs_plan(torch.from_numpy(slots), torch.from_numpy(widx),
                           lb.words_to_limbs(coefs), n)
    return plan, lb.words_to_limbs(wwords), want


def _ints(batch):
    return [lb.limbs_to_ints(batch[i]) for i in range(3)]


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_at_fanin_edges(seed, monkeypatch):
    """Slots of fan-in 0, 1, L, L + 1, 2L + 1 and L^2 + 1 in A and B."""
    monkeypatch.setattr(pipeline, "R1CS_PIECE", PIECE)
    n = 16
    fanins = {0: 1, 1: PIECE, 2: PIECE + 1, 3: 2 * PIECE + 1, 5: PIECE * PIECE + 1,
              n + 0: PIECE + 1, n + 1: 1, n + 4: PIECE, n + 9: 3 * PIECE * PIECE}
    plan, w, want = _case(seed, fanins, n)
    long_slots, levels = pipeline.r1cs_fold_plan(plan, PIECE)
    assert long_slots.tolist() == sorted(s for s, k in fanins.items() if k > PIECE)
    assert len(levels) == 3  # 48 terms: 12 pieces, then 3, then 1
    got = pipeline.r1cs_rows(w, plan)
    assert got.shape == (3, 8, n) and got.dtype == torch.int32
    assert _ints(got) == want
    # the fold tables were built once for this piece size
    assert pipeline.r1cs_fold_plan(plan, PIECE) is plan.folds[PIECE]


def test_one_slot_holds_every_term(monkeypatch):
    monkeypatch.setattr(pipeline, "R1CS_PIECE", PIECE)
    n = 8
    plan, w, want = _case(2, {n + 3: 300}, n)
    long_slots, levels = pipeline.r1cs_fold_plan(plan, PIECE)
    assert long_slots.tolist() == [n + 3]
    assert [lo.numel() for lo, _ in levels] == [75, 19, 5, 2, 1]
    assert _ints(pipeline.r1cs_rows(w, plan)) == want


@pytest.mark.parametrize("piece", [2, 3, 7])
def test_fold_tables_cover_each_long_slot_once(piece):
    """Level 0 cuts each long slot's CSR range into consecutive pieces of
    at most `piece` terms; every later level cuts the previous level's
    partials of each slot the same way, down to one per slot."""
    n = 16
    fanins = {0: 5, 3: 22, 7: 1, n + 2: 9, n + 15: 64}
    plan, _w, _want = _case(3, fanins, n)
    long_slots, levels = pipeline.r1cs_fold_plan(plan, piece)
    offsets = plan.offsets.tolist()
    spans = [(offsets[s], offsets[s + 1]) for s in long_slots.tolist()]
    for lo, hi in levels:
        lo, hi = lo.tolist(), hi.tolist()
        assert all(0 < b - a <= piece for a, b in zip(lo, hi))
        parts, at, nxt = [], 0, []
        for a, b in spans:
            mine = [(x, y) for x, y in zip(lo, hi) if a <= x < b]
            assert mine[0][0] == a and mine[-1][1] == b
            assert all(y == x2 for (_, y), (x2, _) in zip(mine, mine[1:]))
            nxt.append((at, at + len(mine)))
            at += len(mine)
            parts += mine
        assert len(parts) == len(lo)
        spans = nxt
    assert all(b - a == 1 for a, b in spans)
    with pytest.raises(ValueError):
        pipeline.r1cs_fold_plan(plan, 1)  # pieces of one term never fold


def test_rows_match_jax_evaluation():
    """The A and B evaluations of a complex circuit's plan, and C = A B R^-1,
    equal the JAX package's segment reduction and product."""
    r1cs = complex_circuit(40, 50)
    n = 64
    recs = []
    for row, (a_lc, b_lc, _c) in enumerate(r1cs.constraints):
        recs += [(0, row, s, v) for s, v in a_lc.items()] + [(1, row, s, v) for s, v in b_lc.items()]
    recs += [(0, len(r1cs.constraints) + s, s, 1) for s in range(r1cs.n_public + 1)]
    m, c, s, v = (np.array(col, dtype=np.int64) for col in zip(*recs))
    words = lb.ints_to_words([int(x) * MONT_R_FR % R_MOD for x in v])
    witness = complex_circuit_witness(r1cs, a=5)
    jplan = jcache.build_r1cs_plan(m.astype(np.uint32), c.astype(np.uint32),
                                   s.astype(np.uint32), words, n)
    jw = jnp.asarray(jlb.ints_to_limbs_np([x % R_MOD for x in witness]))
    ja, jb = jpipeline._r1cs_eval_jit(jw, jplan.coefs, jplan.witness_idx, jplan.segments,
                                      num_segments=jplan.num_segments, seg2=None, nseg2=0,
                                      log_n=6)
    plan = build_r1cs_plan(torch.from_numpy(m * n + c), torch.from_numpy(s),
                           lb.words_to_limbs(words), n)
    got = _ints(pipeline.r1cs_rows(lb.ints_to_limbs(witness), plan))
    a, b = jlb.limbs_to_ints_np(np.asarray(ja)), jlb.limbs_to_ints_np(np.asarray(jb))
    assert got[0] == a and got[1] == b
    assert got[2] == [x * y * RINV % R_MOD for x, y in zip(a, b)]
