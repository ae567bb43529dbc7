"""A word-by-word model, on Python integers, of csrc/fq_lazy.cuh: the lazy
Fq arithmetic of K11's G1 window loop (every value in [0, 2q), canonical
only at the store). Each step repeats the header's 32-bit words and carries
and asserts that nothing it drops is nonzero (the product's ninth word, the
sum's carry, the 9x reduction's ninth word). Checked: every step's bound and
residue on random operands and on operands at 2q - 1; the 9x reduction for
every x next to each quotient step and next to 0 and 2q; the canonical
store; and the whole mixed add, run on the model from lazy coordinates,
against the same formula in canonical arithmetic (jcurve.pmadd on the
plain ops)."""

import random

import numpy as np
import torch

from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.refmath.field import Q

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

MASK = (1 << 32) - 1
R = 1 << 256
Q_WORDS = [(Q >> (32 * i)) & MASK for i in range(8)]
Q2_WORDS = [((2 * Q) >> (32 * i)) & MASK for i in range(8)]
N0 = (-pow(Q, -1, 1 << 32)) % (1 << 32)
RINV = pow(R, -1, Q)


def _words(v):
    return [(v >> (32 * i)) & MASK for i in range(8)]


def _value(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def lz_mul(a, b):
    """fq_lz_mul: field.cuh's CIOS in 64-bit C words, no final subtraction;
    the header keeps t[0..7]."""
    aw, bw, t = _words(a), _words(b), [0] * 10
    for i in range(8):
        c = 0
        for j in range(8):
            s = aw[j] * bw[i] + t[j] + c
            t[j], c = s & MASK, s >> 32
        s = t[8] + c
        t[8], t[9] = s & MASK, s >> 32
        m = (t[0] * N0) & MASK
        s = m * Q_WORDS[0] + t[0]
        assert s & MASK == 0
        c = s >> 32
        for j in range(1, 8):
            s = m * Q_WORDS[j] + t[j] + c
            t[j - 1], c = s & MASK, s >> 32
        s = t[8] + c
        t[7] = s & MASK
        t[8] = t[9] + (s >> 32)
        assert t[8] <= MASK
    assert t[8] == 0, "the product's ninth word is dropped"
    return _value(t[:8])


def _sub2p_if_ge(s):
    d, borrow = 0, 0
    for j, (x, y) in enumerate(zip(_words(s), Q2_WORDS)):
        v = x - y - borrow
        d |= (v & MASK) << (32 * j)
        borrow = 1 if v < 0 else 0
    return s if borrow else d


def lz_add(a, b):
    s = a + b
    assert s < R, "the sum's carry is dropped"
    return _sub2p_if_ge(s)


def lz_sub(a, b):
    d = (a - b) % R
    return (d + 2 * Q) % R if a < b else d  # the carry out cancels the borrow


def lz_mul9(x):
    t = 9 * x
    t_hi = t >> 224  # words 8 and 7
    assert t >> 256 <= 3 and t_hi < 1 << 64
    k = t_hi // (Q_WORDS[7] + 1)
    r = t - k * Q
    assert 0 <= r < R, "t - k q keeps its ninth word 0"
    return r


def lz_canon(a):
    return a - Q if a >= Q else a


def _check(value, want_residue):
    assert 0 <= value < 2 * Q
    assert value % Q == want_residue % Q
    return value


def test_lazy_steps_on_edges_and_random():
    prng = random.Random(20)
    edges = [0, 1, Q - 1, Q, Q + 1, 2 * Q - 2, 2 * Q - 1]
    lazy = edges + [prng.randrange(2 * Q) for _ in range(400)]
    for a in lazy:
        for b in edges + [prng.randrange(2 * Q) for _ in range(4)]:
            _check(lz_mul(a, b), a * b * RINV)
            _check(lz_add(a, b), a + b)
            _check(lz_sub(a, b), a - b)
        _check(lz_mul9(a), 9 * a)
        assert lz_canon(a) == a % Q
    # the largest operands of a product
    _check(lz_mul(2 * Q - 1, 2 * Q - 1), (2 * Q - 1) ** 2 * RINV)


def test_mul9_reduction_at_every_step():
    """Every x < 2q within 300 of a point where the quotient k changes
    (9x = m (q_7 + 1) 2^224), of a multiple of q / 9, of 0 and of 2q."""
    step = (Q_WORDS[7] + 1) << 224
    centres = {0, 2 * Q}
    centres |= {-(-m * step // 9) for m in range(1, 18)}
    centres |= {m * Q // 9 for m in range(1, 18)}
    seen = 0
    for c in centres:
        for x in range(max(0, c - 300), min(2 * Q, c + 300)):
            _check(lz_mul9(x), 9 * x)
            seen += 1
    assert seen > 20000


def _madd_model(p, qx, qy):
    """lz_madd (RCB15 algorithm 8) on the model, p's coordinates lazy."""
    px, py, pz = p
    t0 = lz_mul(px, qx)
    t1 = lz_mul(py, qy)
    ta = lz_mul(lz_add(px, py), lz_add(qx, qy))
    mxz = lz_mul(qx, pz)
    myz = lz_mul(qy, pz)
    u = lz_mul9(pz)
    t3 = lz_sub(ta, lz_add(t0, t1))
    t4 = lz_add(mxz, px)
    t5 = lz_add(myz, py)
    z3 = lz_add(t1, u)
    x3m = lz_sub(t1, u)
    t0 = lz_add(lz_add(t0, t0), t0)
    y3m = lz_mul9(t4)
    out = (lz_sub(lz_mul(t3, x3m), lz_mul(t5, y3m)),
           lz_add(lz_mul(x3m, z3), lz_mul(t0, y3m)),
           lz_add(lz_mul(t5, z3), lz_mul(t3, t0)))
    for v in out:
        assert 0 <= v < 2 * Q
    return out


def test_lazy_mixed_add_equals_canonical_formula():
    """32 lanes: a chain of 8 mixed adds from the identity on the model, with
    its lazy words fed on as they are, made canonical at the end, equals the
    same chain of jcurve.pmadd on the plain (canonical) ops word for word.
    The affine points are arbitrary field elements: the formula's words do
    not depend on them being on the curve."""
    rng = np.random.default_rng(21)
    lanes, steps = 32, 8
    adds = [[(int(rng.integers(0, Q >> 200)) << 200 | int(rng.integers(1, 1 << 62)),
              int(rng.integers(0, Q >> 200)) << 200 | int(rng.integers(1, 1 << 62)))
             for _ in range(lanes)] for _ in range(steps)]
    ops = jc.G1_PLAIN
    acc = jc.identity(ops, lanes, "cpu")
    model = [(0, R % Q, 0)] * lanes  # the identity (0, one, 0), one = R mod q
    for step in adds:
        qx = lb.ints_to_limbs([a for a, _ in step])
        qy = lb.ints_to_limbs([b for _, b in step])
        acc = jc.pmadd(ops, acc, (qx, qy))
        model = [_madd_model(p, a, b) for p, (a, b) in zip(model, step)]
    want = [lb.limbs_to_ints(t) for t in acc]
    got = [[lz_canon(p[c]) for p in model] for c in range(3)]
    assert got == want
