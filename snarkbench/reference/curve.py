"""Frozen copy of `icicle_snark_tpu_torch/refmath/curve.py`, the benchmark's plain reference: it imports nothing of the port.

BN254 G1/G2 point arithmetic over Python ints (host-side oracle).

Uses homogeneous projective coordinates with the complete addition
formulas for a=0 short-Weierstrass curves (Renes-Costello-Batina 2015,
algorithms 7-9) — the same formula family the reference's device code
uses (reference icicle/include/icicle/curves/projective.h:54-120).
Completeness means no branches, which also keeps this host oracle
bit-identical in control flow to the branch-free device kernels.

G1:  y^2 = x^3 + 3        over Fq
G2:  y^2 = x^3 + 3/(9+u)  over Fq2 (D-type sextic twist)

Points are (X, Y, Z) tuples; field elements are ints (G1) or Fq2 pairs
(G2). Identity is (0, 1, 0).
"""

from __future__ import annotations

from .field import Q
from . import tower as t2

# Curve constants
B_G1 = 3
# b2 = 3 / (9 + u)
B_G2 = t2.fq2_mul((3, 0), t2.fq2_inv(t2.XI))

G1_GEN = (1, 2, 1)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
    t2.FQ2_ONE,
)


class _FqOps:
    """Field-op vtable so one complete-formula implementation serves G1 and G2."""

    def __init__(self, add, sub, mul, neg, zero, one, b3):
        self.add, self.sub, self.mul, self.neg = add, sub, mul, neg
        self.zero, self.one, self.b3 = zero, one, b3


_G1OPS = _FqOps(
    add=lambda a, b: (a + b) % Q,
    sub=lambda a, b: (a - b) % Q,
    mul=lambda a, b: a * b % Q,
    neg=lambda a: -a % Q,
    zero=0,
    one=1,
    b3=(3 * B_G1) % Q,
)

_G2OPS = _FqOps(
    add=t2.fq2_add,
    sub=t2.fq2_sub,
    mul=t2.fq2_mul,
    neg=t2.fq2_neg,
    zero=t2.FQ2_ZERO,
    one=t2.FQ2_ONE,
    b3=t2.fq2_scalar(B_G2, 3),
)


def _padd(f: _FqOps, p, q):
    """Complete projective addition, a=0 (RCB15 algorithm 7)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    add, sub, mul = f.add, f.sub, f.mul
    b3 = f.b3

    t0 = mul(x1, x2)
    t1 = mul(y1, y2)
    t2 = mul(z1, z2)
    t3 = mul(add(x1, y1), add(x2, y2))
    t3 = sub(t3, add(t0, t1))
    t4 = mul(add(y1, z1), add(y2, z2))
    t4 = sub(t4, add(t1, t2))
    t5 = mul(add(x1, z1), add(x2, z2))
    t5 = sub(t5, add(t0, t2))
    x3 = mul(b3, t2)
    z3 = add(t1, x3)
    x3 = sub(t1, x3)
    y3 = mul(b3, t5)
    t0 = add(add(t0, t0), t0)
    t2 = mul(t4, y3)
    t1 = mul(t0, y3)
    y3 = mul(x3, z3)
    y3 = add(y3, t1)
    x3 = sub(mul(t3, x3), t2)
    z3 = add(mul(t4, z3), mul(t3, t0))
    return (x3, y3, z3)


def _pdbl(f: _FqOps, p):
    """Complete projective doubling, a=0 (RCB15 algorithm 9)."""
    x1, y1, z1 = p
    add, sub, mul = f.add, f.sub, f.mul
    b3 = f.b3

    t0 = mul(y1, y1)
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)  # 8*y^2
    t1 = mul(y1, z1)
    t2 = mul(z1, z1)
    t2 = mul(b3, t2)
    x3 = mul(t2, z3)
    y3 = add(t0, t2)
    z3 = mul(t1, z3)
    t1 = add(t2, t2)
    t2 = add(t1, t2)
    t0 = sub(t0, t2)
    y3 = mul(t0, y3)
    y3 = add(x3, y3)
    t1 = mul(x1, y1)
    x3 = mul(t0, t1)
    x3 = add(x3, x3)
    return (x3, y3, z3)


def _pneg(f: _FqOps, p):
    return (p[0], f.neg(p[1]), p[2])


def _pmul(f: _FqOps, p, k: int):
    k %= _FR_ORDER
    result = (f.zero, f.one, f.zero)
    base = p
    while k > 0:
        if k & 1:
            result = _padd(f, result, base)
        base = _pdbl(f, base)
        k >>= 1
    return result


_FR_ORDER = 21888242871839275222246405745257275088548364400416034343698204186575808495617


# --------------------------------------------------------------- G1 API
G1_ZERO = (0, 1, 0)


def g1_add(p, q):
    return _padd(_G1OPS, p, q)


def g1_dbl(p):
    return _pdbl(_G1OPS, p)


def g1_neg(p):
    return _pneg(_G1OPS, p)


def g1_mul(p, k: int):
    return _pmul(_G1OPS, p, k)


def g1_to_affine(p):
    x, y, z = p
    if z == 0:
        return (0, 0)  # snarkjs convention for the identity
    zinv = pow(z, -1, Q)
    return (x * zinv % Q, y * zinv % Q)


def g1_from_affine(a):
    if a == (0, 0):
        return G1_ZERO
    return (a[0], a[1], 1)


def g1_is_on_curve(p) -> bool:
    x, y = g1_to_affine(p)
    if (x, y) == (0, 0):
        return True
    return (y * y - x * x * x - B_G1) % Q == 0


def g1_eq(p, q) -> bool:
    # cross-multiplied projective equality
    px, py, pz = p
    qx, qy, qz = q
    if pz == 0 or qz == 0:
        return pz == qz
    return (px * qz - qx * pz) % Q == 0 and (py * qz - qy * pz) % Q == 0


# --------------------------------------------------------------- G2 API
G2_ZERO = (t2.FQ2_ZERO, t2.FQ2_ONE, t2.FQ2_ZERO)


def g2_add(p, q):
    return _padd(_G2OPS, p, q)


def g2_dbl(p):
    return _pdbl(_G2OPS, p)


def g2_neg(p):
    return _pneg(_G2OPS, p)


def g2_mul(p, k: int):
    return _pmul(_G2OPS, p, k)


def g2_to_affine(p):
    x, y, z = p
    if z == t2.FQ2_ZERO:
        return (t2.FQ2_ZERO, t2.FQ2_ZERO)
    zinv = t2.fq2_inv(z)
    return (t2.fq2_mul(x, zinv), t2.fq2_mul(y, zinv))


def g2_from_affine(a):
    if a == (t2.FQ2_ZERO, t2.FQ2_ZERO):
        return G2_ZERO
    return (a[0], a[1], t2.FQ2_ONE)


def g2_is_on_curve(p) -> bool:
    x, y = g2_to_affine(p)
    if (x, y) == (t2.FQ2_ZERO, t2.FQ2_ZERO):
        return True
    lhs = t2.fq2_sqr(y)
    rhs = t2.fq2_add(t2.fq2_mul(t2.fq2_sqr(x), x), B_G2)
    return lhs == rhs


def g2_eq(p, q) -> bool:
    px, py, pz = p
    qx, qy, qz = q
    if pz == t2.FQ2_ZERO or qz == t2.FQ2_ZERO:
        return pz == qz
    return t2.fq2_mul(px, qz) == t2.fq2_mul(qx, pz) and t2.fq2_mul(py, qz) == t2.fq2_mul(qy, pz)
