"""A word-by-word model, on Python integers, of csrc/fq_lazy.cuh and
csrc/fq2_lazy.cuh: the lazy Fq and Fq2 arithmetic of K11's G1 window loop
and of K4's BN254 loops (every value in [0, 2q), canonical only at the
store). Each Fq step repeats the header's 32-bit words and carries and
asserts that nothing it drops is nonzero (the product's ninth word, the
sum's carry, the 9x reduction's ninth word). Checked: every step's bound
and residue on random operands and on operands at 2q - 1, in Fq and in
Fq2; the 9x reduction for every x next to each quotient step and next to 0
and 2q; the canonical store; and the mixed add (G1, G2) and the complete
add (G1, G2), run on the model from lazy coordinates, against the same
formulas in canonical arithmetic (jcurve.pmadd and jcurve.padd on the
plain ops)."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.refmath.curve import B_G2
from icicle_snark_tpu_torch.refmath.field import Q, fq_to_mont

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


# the lazy layer's operations at E1 (fq_lazy.cuh lz_mul, lz_add, ...)
LAZY_FQ = SimpleNamespace(mul=lz_mul, add=lz_add, sub=lz_sub, mul_b3=lz_mul9, canon=lz_canon,
                          bounded=lambda v: 0 <= v < 2 * Q)


def _madd_model(p, qx, qy, f=LAZY_FQ):
    """lz_madd (RCB15 algorithm 8) on the model, p's coordinates lazy."""
    px, py, pz = p
    t0 = f.mul(px, qx)
    t1 = f.mul(py, qy)
    ta = f.mul(f.add(px, py), f.add(qx, qy))
    mxz = f.mul(qx, pz)
    myz = f.mul(qy, pz)
    u = f.mul_b3(pz)
    t3 = f.sub(ta, f.add(t0, t1))
    t4 = f.add(mxz, px)
    t5 = f.add(myz, py)
    z3 = f.add(t1, u)
    x3m = f.sub(t1, u)
    t0 = f.add(f.add(t0, t0), t0)
    y3m = f.mul_b3(t4)
    out = (f.sub(f.mul(t3, x3m), f.mul(t5, y3m)),
           f.add(f.mul(x3m, z3), f.mul(t0, y3m)),
           f.add(f.mul(t5, z3), f.mul(t3, t0)))
    assert all(f.bounded(v) for v in out)
    return out


def _padd_model(p, q, f=LAZY_FQ):
    """lz_padd (RCB15 algorithm 7) on the model, every coordinate lazy."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = f.mul(x1, x2)
    t1 = f.mul(y1, y2)
    t2 = f.mul(z1, z2)
    ta = f.mul(f.add(x1, y1), f.add(x2, y2))
    tb = f.mul(f.add(y1, z1), f.add(y2, z2))
    tc = f.mul(f.add(x1, z1), f.add(x2, z2))
    t3 = f.sub(ta, f.add(t0, t1))
    t4 = f.sub(tb, f.add(t1, t2))
    t5 = f.sub(tc, f.add(t0, t2))
    u = f.mul_b3(t2)
    y3m = f.mul_b3(t5)
    z3 = f.add(t1, u)
    x3m = f.sub(t1, u)
    t0 = f.add(f.add(t0, t0), t0)
    out = (f.sub(f.mul(t3, x3m), f.mul(t4, y3m)),
           f.add(f.mul(x3m, z3), f.mul(t0, y3m)),
           f.add(f.mul(t4, z3), f.mul(t3, t0)))
    assert all(f.bounded(v) for v in out)
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


# ---------------------------------------------------------------- Fq2 (fq2_lazy.cuh)

# b3 = 3 b_G2 in Montgomery form (curve.cuh e_mul_b3, fq2_lazy.cuh fq2_b3)
B3 = (fq_to_mont(3 * B_G2[0] % Q), fq_to_mont(3 * B_G2[1] % Q))


def fq2_mul(a, b):
    """fq2_lz_mul: Karatsuba on the lazy Fq steps, each checking its bound."""
    t0, t1 = lz_mul(a[0], b[0]), lz_mul(a[1], b[1])
    t2 = lz_mul(lz_add(a[0], a[1]), lz_add(b[0], b[1]))
    return lz_sub(t0, t1), lz_sub(t2, lz_add(t0, t1))


def fq2_mul_b3(x):
    return fq2_mul(B3, x)


# the lazy layer's operations at E2 (fq2_lazy.cuh), on (c0, c1) pairs
LAZY_FQ2 = SimpleNamespace(
    mul=fq2_mul, mul_b3=fq2_mul_b3,
    add=lambda a, b: (lz_add(a[0], b[0]), lz_add(a[1], b[1])),
    sub=lambda a, b: (lz_sub(a[0], b[0]), lz_sub(a[1], b[1])),
    canon=lambda a: (lz_canon(a[0]), lz_canon(a[1])),
    bounded=lambda v: all(0 <= c < 2 * Q for c in v))


def _fq2_residue(a, b):
    """(a0 + a1 u)(b0 + b1 u) R^-1 mod q, u^2 = -1."""
    return ((a[0] * b[0] - a[1] * b[1]) * RINV % Q, (a[0] * b[1] + a[1] * b[0]) * RINV % Q)


def _check2(value, want):
    assert LAZY_FQ2.bounded(value)
    assert (value[0] % Q, value[1] % Q) == (want[0] % Q, want[1] % Q)


def test_fq2_lazy_steps_on_edges_and_random():
    """The Fq2 product, sum, difference and b3 product: components below
    2q with the canonical residues, on operands at 0, q - 1, q, 2q - 1 and
    random ones (every Fq step inside checks its own bound)."""
    prng = random.Random(30)
    edges = [0, 1, Q - 1, Q, 2 * Q - 2, 2 * Q - 1]
    vals = [(a, b) for a in edges for b in edges]
    vals += [(prng.randrange(2 * Q), prng.randrange(2 * Q)) for _ in range(150)]
    assert B3[0] < Q and B3[1] < Q
    for a in vals:
        for b in vals[:12] + [prng.choice(vals) for _ in range(6)]:
            _check2(fq2_mul(a, b), _fq2_residue(a, b))
            _check2(LAZY_FQ2.add(a, b), (a[0] + b[0], a[1] + b[1]))
            _check2(LAZY_FQ2.sub(a, b), (a[0] - b[0], a[1] - b[1]))
        _check2(fq2_mul_b3(a), _fq2_residue(B3, a))
        assert LAZY_FQ2.canon(a) == (a[0] % Q, a[1] % Q)


def _lazy_rep(v, rng):
    """v < q as the lazy layer may hold it: v or v + q."""
    return v + Q if rng.random() < 0.5 else v


def _g2_limbs(pairs):
    return torch.stack([lb.ints_to_limbs([p[0] for p in pairs]),
                        lb.ints_to_limbs([p[1] for p in pairs])])


def _coord_ints(t, g2):
    if g2:
        return list(zip(lb.limbs_to_ints(t[0]), lb.limbs_to_ints(t[1])))
    return lb.limbs_to_ints(t)


def _random_elems(rng, g2, n):
    one = lambda: rng.randrange(Q)  # noqa: E731
    return [(one(), one()) if g2 else one() for _ in range(n)]


def _as_limbs(vals, g2):
    return _g2_limbs(vals) if g2 else lb.ints_to_limbs(vals)


def _lazy_elem(v, rng, g2):
    return (_lazy_rep(v[0], rng), _lazy_rep(v[1], rng)) if g2 else _lazy_rep(v, rng)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_lazy_complete_add_equals_canonical_formula(g2):
    """16 lanes: a chain of 6 complete adds (RCB15 algorithm 7) on the
    model, from lazy coordinates (each canonical input given as v or
    v + q) and with the lazy words fed on, made canonical at the end,
    equals the same chain of jcurve.padd on the plain ops word for word.
    Lane 0 adds the identity (0, one, 0) every step, lane 1 adds its own
    running sum's canonical words (a doubling through the add)."""
    rng = random.Random(31 + g2)
    ops, f = (jc.G2_PLAIN, LAZY_FQ2) if g2 else (jc.G1_PLAIN, LAZY_FQ)
    lanes, steps = 16, 6
    one = (R % Q, 0) if g2 else R % Q
    zero = (0, 0) if g2 else 0
    acc_vals = [_random_elems(rng, g2, lanes) for _ in range(3)]
    acc = tuple(_as_limbs(c, g2) for c in acc_vals)
    model = [tuple(_lazy_elem(acc_vals[c][i], rng, g2) for c in range(3)) for i in range(lanes)]
    for _ in range(steps):
        add = [_random_elems(rng, g2, lanes) for _ in range(3)]
        for c, v in enumerate((zero, one, zero)):
            add[c][0] = v
        now = [_coord_ints(t, g2) for t in acc]
        for c in range(3):
            add[c][1] = now[c][1]
        acc = jc.padd(ops, acc, tuple(_as_limbs(c, g2) for c in add))
        model = [_padd_model(p, tuple(_lazy_elem(add[c][i], rng, g2) for c in range(3)), f)
                 for i, p in enumerate(model)]
    want = [_coord_ints(t, g2) for t in acc]
    got = [[f.canon(p[c]) for p in model] for c in range(3)]
    assert got == want


def test_lazy_g2_mixed_add_equals_canonical_formula():
    """The G2 mixed add (RCB15 algorithm 8) over the lazy Fq2 layer: a chain
    of 6 on 16 lanes from the identity, the affine operands canonical as K4
    loads them in half the lanes and lazy (v or v + q) in the others, equals
    jcurve.pmadd on the plain ops word for word once made canonical."""
    rng = random.Random(33)
    lanes, steps = 16, 6
    acc = jc.identity(jc.G2_PLAIN, lanes, "cpu")
    model = [((0, 0), (R % Q, 0), (0, 0))] * lanes
    for _ in range(steps):
        qx, qy = _random_elems(rng, True, lanes), _random_elems(rng, True, lanes)
        acc = jc.pmadd(jc.G2_PLAIN, acc, (_g2_limbs(qx), _g2_limbs(qy)))
        model = [_madd_model(p, *((a, b) if i % 2 else (_lazy_elem(a, rng, True),
                                                         _lazy_elem(b, rng, True))), f=LAZY_FQ2)
                 for i, (p, a, b) in enumerate(zip(model, qx, qy))]
    want = [_coord_ints(t, True) for t in acc]
    got = [[LAZY_FQ2.canon(p[c]) for p in model] for c in range(3)]
    assert got == want
