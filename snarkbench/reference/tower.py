"""Frozen copy of `icicle_snark_tpu_torch/refmath/tower.py`, the benchmark's plain reference: it imports nothing of the port.

BN254 extension-field tower Fq2 / Fq6 / Fq12 over Python ints.

Tower shape mirrors the reference's pairing target field
(reference icicle/include/icicle/fields/{complex,cubic,quartic}_extension.h,
 reference icicle/include/icicle/pairing/params/bn254.h):

    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w] / (w^2 - v)

Elements are immutable tuples of ints; all ops are exact host math.
"""

from __future__ import annotations

from .field import Q

# ---------------------------------------------------------------- Fq2
# Element: (c0, c1) meaning c0 + c1*u with u^2 = -1.

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (9, 1)  # the sextic-twist non-residue 9 + u


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return (-a[0] % Q, -a[1] % Q)


def fq2_mul(a, b):
    # Karatsuba: (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def fq2_sqr(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % Q, t1 % Q)


def fq2_scalar(a, k: int):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_conj(a):
    return (a[0], -a[1] % Q)


def fq2_inv(a):
    # 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, -1, Q)
    return (a[0] * ninv % Q, -a[1] * ninv % Q)


def fq2_pow(a, e: int):
    result = FQ2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


def fq2_mul_by_xi(a):
    # a * (9 + u)
    return ((9 * a[0] - a[1]) % Q, (a[0] + 9 * a[1]) % Q)


# ---------------------------------------------------------------- Fq6
# Element: (c0, c1, c2) of Fq2, meaning c0 + c1 v + c2 v^2, v^3 = xi.

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # (c0 + c1 v + c2 v^2) * v = xi*c2 + c0 v + c1 v^2
    return (fq2_mul_by_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    t0 = fq2_sub(fq2_sqr(a0), fq2_mul_by_xi(fq2_mul(a1, a2)))
    t1 = fq2_sub(fq2_mul_by_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    t2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    det = fq2_add(fq2_mul(a0, t0), fq2_mul_by_xi(fq2_add(fq2_mul(a2, t1), fq2_mul(a1, t2))))
    dinv = fq2_inv(det)
    return (fq2_mul(t0, dinv), fq2_mul(t1, dinv), fq2_mul(t2, dinv))


# ---------------------------------------------------------------- Fq12
# Element: (c0, c1) of Fq6, meaning c0 + c1 w, w^2 = v.

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    # conjugate over Fq6: the p^6-Frobenius
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    a0, a1 = a
    det = fq6_sub(fq6_sqr(a0), fq6_mul_by_v(fq6_sqr(a1)))
    dinv = fq6_inv(det)
    return (fq6_mul(a0, dinv), fq6_neg(fq6_mul(a1, dinv)))


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


# Frobenius coefficients: gamma[k] = xi^(k*(q-1)/6) in Fq2, k = 1..5.
_FROB_GAMMA1 = [None] + [fq2_pow(XI, k * (Q - 1) // 6) for k in range(1, 6)]


def fq2_frob(a, power: int):
    # (p^power)-Frobenius on Fq2: conjugation iff power is odd.
    return fq2_conj(a) if power & 1 else a


def _gamma(k: int, power: int):
    # xi^(k*(q^power - 1)/6) for power in {1,2,3}; computed from gamma1.
    if power == 1:
        return _FROB_GAMMA1[k]
    if power == 2:
        g = _FROB_GAMMA1[k]
        return fq2_mul(g, fq2_conj(g))  # norm: gamma1 * gamma1^p
    if power == 3:
        # gamma1^(q^2 + q + 1) = gamma1 * conj(gamma1) * gamma1 = gamma2 * gamma1
        return fq2_mul(_gamma(k, 2), _FROB_GAMMA1[k])
    raise ValueError(power)


# Precompute frobenius tables for powers 1..3.
_FROB = {power: [None] + [_gamma(k, power) for k in range(1, 6)] for power in (1, 2, 3)}


def fq12_frob(a, power: int = 1):
    """(q^power)-Frobenius endomorphism on Fq12 (power in 1..3)."""
    coef = _FROB[power]
    (a0, a1, a2), (b0, b1, b2) = a
    a0 = fq2_frob(a0, power)
    a1 = fq2_mul(fq2_frob(a1, power), coef[2])
    a2 = fq2_mul(fq2_frob(a2, power), coef[4])
    b0 = fq2_mul(fq2_frob(b0, power), coef[1])
    b1 = fq2_mul(fq2_frob(b1, power), coef[3])
    b2 = fq2_mul(fq2_frob(b2, power), coef[5])
    return ((a0, a1, a2), (b0, b1, b2))
