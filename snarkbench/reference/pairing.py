"""Frozen copy of `icicle_snark_tpu_torch/refmath/pairing.py`, the benchmark's plain reference: it imports nothing of the port.

BN254 optimal-ate pairing over Python ints (host-side).

The reference computes its pairing host-side on the CPU in the frontend
library (reference icicle/src/pairing.cpp:168-182,
pairing/models/bn.h:12-137); verification is O(1) and latency-bound, so
host Python is the right tool here too.

Optimal ate for BN curves: f = Miller(6x+2, Q, P) with two extra line
evaluations at pi(Q) and -pi^2(Q), then the final exponentiation
(q^12-1)/r split into the easy part and the Devegili et al. hard-part
addition chain.
"""

from __future__ import annotations

from .field import Q, BN_X
from . import tower as tw
from . import curve as cv

# 6x + 2 for the BN parameter x, in NAF form for a shorter Miller loop.
ATE_LOOP_COUNT = 6 * BN_X + 2


def _naf(k: int):
    out = []
    while k > 0:
        if k & 1:
            d = 2 - (k % 4)
            out.append(d)
            k -= d
        else:
            out.append(0)
        k >>= 1
    return out


ATE_NAF = _naf(ATE_LOOP_COUNT)

# Frobenius twist constants for untwisting pi(Q):
#   pi(x, y) = (conj(x) * xi^((q-1)/3), conj(y) * xi^((q-1)/2))
_TW_X = tw.fq2_pow(tw.XI, (Q - 1) // 3)
_TW_Y = tw.fq2_pow(tw.XI, (Q - 1) // 2)


def _g2_frob(q_aff):
    x, y = q_aff
    return (tw.fq2_mul(tw.fq2_conj(x), _TW_X), tw.fq2_mul(tw.fq2_conj(y), _TW_Y))


def _sparse_line(a, b, c):
    """Build the Fq12 line element c0=(a,0,0), c1=(b,c,0).

    With the D-twist embedding, the line through T,Q evaluated at P
    lands in the sparse subspace a + b*w + c*v*w of Fq12.
    """
    return ((a, tw.FQ2_ZERO, tw.FQ2_ZERO), (b, c, tw.FQ2_ZERO))


def _dbl_step(t, p_aff):
    """Double T and evaluate the tangent line at P (projective, BN std)."""
    x, y, z = t
    px, py = p_aff

    a = tw.fq2_scalar(tw.fq2_mul(x, y), pow(2, -1, Q))  # X*Y/2
    b = tw.fq2_sqr(y)
    c = tw.fq2_sqr(z)
    e = tw.fq2_scalar(cv.B_G2, 3)
    e = tw.fq2_mul(e, c)
    f = tw.fq2_scalar(e, 3)
    g = tw.fq2_scalar(tw.fq2_add(b, f), pow(2, -1, Q))
    h = tw.fq2_sub(tw.fq2_sqr(tw.fq2_add(y, z)), tw.fq2_add(b, c))
    i = tw.fq2_sub(e, b)
    j = tw.fq2_sqr(x)
    e2 = tw.fq2_sqr(e)

    x3 = tw.fq2_mul(a, tw.fq2_sub(b, f))
    y3 = tw.fq2_sub(tw.fq2_sqr(g), tw.fq2_scalar(e2, 3))
    z3 = tw.fq2_mul(b, h)

    # line: l = -h*y_P + 3*x^2 * x_P * w + i * v*w  (D-twist sparse form)
    l_a = tw.fq2_scalar(h, (-py) % Q)
    l_b = tw.fq2_scalar(tw.fq2_scalar(j, 3), px)
    l_c = i
    return (x3, y3, z3), _sparse_line(l_a, l_b, l_c)


def _add_step(t, q_aff, p_aff):
    """Add affine Q into projective T; evaluate the line at P."""
    x1, y1, z1 = t
    x2, y2 = q_aff
    px, py = p_aff

    theta = tw.fq2_sub(y1, tw.fq2_mul(y2, z1))
    lam = tw.fq2_sub(x1, tw.fq2_mul(x2, z1))
    c = tw.fq2_sqr(theta)
    d = tw.fq2_sqr(lam)
    e = tw.fq2_mul(lam, d)
    f = tw.fq2_mul(z1, c)
    g = tw.fq2_mul(x1, d)
    h = tw.fq2_add(e, tw.fq2_sub(f, tw.fq2_scalar(g, 2)))

    x3 = tw.fq2_mul(lam, h)
    y3 = tw.fq2_sub(tw.fq2_mul(theta, tw.fq2_sub(g, h)), tw.fq2_mul(e, y1))
    z3 = tw.fq2_mul(z1, e)

    jj = tw.fq2_sub(tw.fq2_mul(theta, x2), tw.fq2_mul(lam, y2))

    # line: l = lam*y_P - theta*x_P * w + j * v*w
    l_a = tw.fq2_scalar(lam, py)
    l_b = tw.fq2_scalar(theta, (-px) % Q)
    l_c = jj
    return (x3, y3, z3), _sparse_line(l_a, l_b, l_c)


def miller_loop(p_aff, q_aff):
    """Miller loop of the optimal-ate pairing. p in G1 affine, q in G2 affine."""
    if p_aff == (0, 0) or q_aff == (tw.FQ2_ZERO, tw.FQ2_ZERO):
        return tw.FQ12_ONE

    t = (q_aff[0], q_aff[1], tw.FQ2_ONE)
    q_neg = (q_aff[0], tw.fq2_neg(q_aff[1]))
    f = tw.FQ12_ONE

    for bit in reversed(ATE_NAF[:-1]):
        f = tw.fq12_sqr(f)
        t, line = _dbl_step(t, p_aff)
        f = tw.fq12_mul(f, line)
        if bit == 1:
            t, line = _add_step(t, q_aff, p_aff)
            f = tw.fq12_mul(f, line)
        elif bit == -1:
            t, line = _add_step(t, q_neg, p_aff)
            f = tw.fq12_mul(f, line)

    # Frobenius correction steps: add pi(Q) and subtract pi^2(Q).
    q1 = _g2_frob(q_aff)
    q2 = _g2_frob(q1)
    q2 = (q2[0], tw.fq2_neg(q2[1]))

    t, line = _add_step(t, q1, p_aff)
    f = tw.fq12_mul(f, line)
    t, line = _add_step(t, q2, p_aff)
    f = tw.fq12_mul(f, line)
    return f


def final_exponentiation(f):
    """f^((q^12 - 1) / r): easy part + Devegili et al. hard part."""
    # Easy part: f^(q^6 - 1) then ^(q^2 + 1).
    m = tw.fq12_mul(tw.fq12_conj(f), tw.fq12_inv(f))
    m = tw.fq12_mul(tw.fq12_frob(m, 2), m)

    # After the easy part m is in the cyclotomic subgroup: inverse == conj.
    def cinv(a):
        return tw.fq12_conj(a)

    x = BN_X
    fx = tw.fq12_pow(m, x)
    fx2 = tw.fq12_pow(fx, x)
    fx3 = tw.fq12_pow(fx2, x)

    fp = tw.fq12_frob(m, 1)
    fp2 = tw.fq12_frob(m, 2)
    fp3 = tw.fq12_frob(m, 3)
    fxp = tw.fq12_frob(fx, 1)
    fx2p = tw.fq12_frob(fx2, 1)
    fx3p = tw.fq12_frob(fx3, 1)
    fx2p2 = tw.fq12_frob(fx2, 2)

    y0 = tw.fq12_mul(tw.fq12_mul(fp, fp2), fp3)
    y1 = cinv(m)
    y2 = fx2p2
    y3 = cinv(fxp)
    y4 = cinv(tw.fq12_mul(fx, fx2p))
    y5 = cinv(fx2)
    y6 = cinv(tw.fq12_mul(fx3, fx3p))

    t0 = tw.fq12_mul(tw.fq12_mul(tw.fq12_sqr(y6), y4), y5)
    t1 = tw.fq12_mul(tw.fq12_mul(y3, y5), t0)
    t0 = tw.fq12_mul(t0, y2)
    t1 = tw.fq12_sqr(tw.fq12_mul(tw.fq12_sqr(t1), t0))
    t0 = tw.fq12_mul(t1, y1)
    t1 = tw.fq12_mul(t1, y0)
    t0 = tw.fq12_sqr(t0)
    return tw.fq12_mul(t1, t0)


def pairing(p_aff, q_aff):
    """Full pairing e(P, Q) with P in G1, Q in G2 (both affine)."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


def multi_pairing_is_one(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 with a single shared final exponentiation
    (mirrors the reference's 4-pairing product check,
    reference src/proof_helper.rs:345-369)."""
    f = tw.FQ12_ONE
    for p_aff, q_aff in pairs:
        f = tw.fq12_mul(f, miller_loop(p_aff, q_aff))
    return final_exponentiation(f) == tw.FQ12_ONE
