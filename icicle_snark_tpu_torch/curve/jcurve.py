"""Batched BN254 G1/G2 point arithmetic in plain torch over the K1 field
ops, and the wrappers of the two per-lane point kernels of K7.

Complete a=0 short-Weierstrass formulas (Renes-Costello-Batina 2015,
algorithms 7/8/9), the same as icicle_snark_tpu/curve/jcurve.py and as the
per-thread versions in csrc/curve.cuh that the MSM kernel (K4) runs. Here
every field operation is one K1 launch over a whole batch of points (for
CUDA tensors), with independent products batched into one launch
(`mul_many`). The plain versions of K4 and of the setup's fixed-base
scan (K11) run them with `plain=True` ops. `pdbl_k` (k
doublings) and `to_affine` launch `csrc/precompute.cu` for CUDA tensors
and run `pdbl_k_plain` / `to_affine_plain` for CPU tensors.

Point representations (Montgomery-form limbs, see fields/limbs.py):
  G1: (x, y, z), each (8, n)
  G2: (x, y, z), each (2, 8, n)  [Fq2 component axis first, u^2 = -1]
Affine (0, 0) is the identity for the mixed add (zkeys hold such points).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fields import limbs as lb
from ..fields.limbs import FQ_SPEC, NLIMB, OP_ADD, OP_MUL, OP_NEG, OP_SUB
from ..refmath.curve import B_G1, B_G2
from ..refmath.field import Q, fq_to_mont


class FqOps:
    """Base-field ops on (8, n) limb tensors. `spec` and `coords` (the
    coordinate shape before the lane axis) are what curves/device.py's
    tables for the other curves change."""

    g2 = False
    spec = FQ_SPEC
    coords = (NLIMB,)

    def __init__(self, plain: bool = False):
        self.plain = plain
        self._fn = lb.field_op_plain if plain else lb.field_op

    def _op(self, op, a, b=None):
        return self._fn(op, a, b, self.spec)

    def add(self, a, b):
        return self._op(OP_ADD, a, b)

    def sub(self, a, b):
        return self._op(OP_SUB, a, b)

    def mul(self, a, b):
        return self._op(OP_MUL, a, b)

    def neg(self, a):
        return self._op(OP_NEG, a)

    def mul_many(self, pairs):
        """k independent products as ONE launch over k times the lanes."""
        n = pairs[0][0].shape[-1]
        a = torch.cat([x for x, _ in pairs], dim=-1)
        b = torch.cat([y.expand(x.shape) for x, y in pairs], dim=-1)
        p = self.mul(a, b)
        return [p[..., i * n:(i + 1) * n] for i in range(len(pairs))]

    def mul_b3(self, x):
        """9*x = 8x + x (b3 = 3b = 9 for G1)."""
        x2 = self.add(x, x)
        x4 = self.add(x2, x2)
        x8 = self.add(x4, x4)
        return self.add(x8, x)

    def is_zero_lanes(self, a):
        return lb.is_zero(a)

    def const(self, v: int, n: int, device):
        """Montgomery-form constant in every lane."""
        return lb.const(fq_to_mont(v % Q), device, n)

    def inv(self, a):
        """a^-1 per lane by Fermat, square-and-multiply (0 maps to 0)."""
        acc = lb.one_mont(self.spec, a.device).expand(a.shape).contiguous()
        for bit in bin(self.spec.modulus - 2)[2:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc


class Fq2Ops(FqOps):
    """Quadratic-extension ops on (2, 8, n) tensors (u^2 = -1). add, sub
    and neg are one K1 launch over both components (batch 2)."""

    g2 = True
    coords = (2, NLIMB)

    def mul_many(self, pairs):
        """k independent Fq2 products by Karatsuba as ONE Fq product launch
        over 3k times the lanes."""
        n = pairs[0][0].shape[-1]
        k = len(pairs)
        pairs = [(x, y.expand(x.shape)) for x, y in pairs]
        a0 = torch.cat([x[0] for x, _ in pairs], dim=-1)
        a1 = torch.cat([x[1] for x, _ in pairs], dim=-1)
        b0 = torch.cat([y[0] for _, y in pairs], dim=-1)
        b1 = torch.cat([y[1] for _, y in pairs], dim=-1)
        sa = self.add(a0, a1)
        sb = self.add(b0, b1)
        p = self.mul(torch.cat([a0, a1, sa], dim=-1), torch.cat([b0, b1, sb], dim=-1))
        kn = k * n
        t0, t1, t2 = p[..., :kn], p[..., kn:2 * kn], p[..., 2 * kn:]
        c0 = self.sub(t0, t1)
        c1 = self.sub(t2, self.add(t0, t1))
        out = torch.stack([c0, c1], dim=0)
        return [out[..., i * n:(i + 1) * n] for i in range(k)]

    def mul_b3(self, x):
        b3 = self.const((3 * B_G2[0], 3 * B_G2[1]), 1, x.device)
        return self.mul_many([(b3.expand(x.shape), x)])[0]

    def is_zero_lanes(self, a):
        return lb.is_zero(a[0]) & lb.is_zero(a[1])

    def const(self, v2, n: int, device):
        return torch.stack([lb.const(fq_to_mont(v2[0] % Q), device, n),
                            lb.const(fq_to_mont(v2[1] % Q), device, n)])

    def inv(self, a):
        """(x + yu)^-1 = (x - yu) / (x^2 + y^2)."""
        fq = FqOps(self.plain)
        x, y = a[0], a[1]
        xx, yy = fq.mul_many([(x, x), (y, y)])
        ninv = fq.inv(fq.add(xx, yy))
        c0, c1 = fq.mul_many([(x, ninv), (fq.neg(y), ninv)])
        return torch.stack([c0, c1])


G1 = FqOps()
G2 = Fq2Ops()
G1_PLAIN = FqOps(plain=True)
G2_PLAIN = Fq2Ops(plain=True)
assert B_G1 == 3  # mul_b3's addition chain is 9 = 3 * b


def identity(ops, n: int, device):
    """Projective identity (0 : 1 : 0) in n lanes."""
    if ops.g2:
        zero, one = ops.const((0, 0), n, device), ops.const((1, 0), n, device)
    else:
        zero, one = ops.const(0, n, device), ops.const(1, n, device)
    return (zero, one, zero.clone())


def padd(ops, p, q):
    """Complete projective addition (RCB15 alg 7, a=0)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    add, sub = ops.add, ops.sub
    t0, t1, t2, ta, tb, tc = ops.mul_many([
        (x1, x2), (y1, y2), (z1, z2),
        (add(x1, y1), add(x2, y2)),
        (add(y1, z1), add(y2, z2)),
        (add(x1, z1), add(x2, z2)),
    ])
    t3 = sub(ta, add(t0, t1))
    t4 = sub(tb, add(t1, t2))
    t5 = sub(tc, add(t0, t2))
    u, y3m = ops.mul_b3(t2), ops.mul_b3(t5)
    z3 = add(t1, u)
    x3m = sub(t1, u)
    t0 = add(add(t0, t0), t0)
    m1, m2, m3, m4, m5, m6 = ops.mul_many([
        (t4, y3m), (t0, y3m), (x3m, z3), (t3, x3m), (t4, z3), (t3, t0),
    ])
    return (sub(m4, m1), add(m3, m2), add(m5, m6))


def pmadd(ops, p, q_aff):
    """Mixed addition: projective p + affine q (RCB15 alg 8, a=0); q = (0,0)
    is the identity."""
    x1, y1, z1 = p
    x2, y2 = q_aff
    add, sub = ops.add, ops.sub
    t0, t1, ta, m_xz, m_yz = ops.mul_many([
        (x1, x2), (y1, y2),
        (add(x1, y1), add(x2, y2)),
        (x2, z1), (y2, z1),
    ])
    u = ops.mul_b3(z1)
    t3 = sub(ta, add(t0, t1))
    t4 = add(m_xz, x1)
    t5 = add(m_yz, y1)
    z3 = add(t1, u)
    x3m = sub(t1, u)
    t0 = add(add(t0, t0), t0)
    y3m = ops.mul_b3(t4)
    m1, m2, m3, m4, m5, m6 = ops.mul_many([
        (t5, y3m), (t0, y3m), (x3m, z3), (t3, x3m), (t5, z3), (t3, t0),
    ])
    out = (sub(m4, m1), add(m3, m2), add(m5, m6))
    q_inf = ops.is_zero_lanes(x2) & ops.is_zero_lanes(y2)
    return tuple(torch.where(q_inf, a, b) for a, b in zip(p, out))


def pdbl(ops, p):
    """Complete projective doubling (RCB15 alg 9, a=0)."""
    x1, y1, z1 = p
    add, sub = ops.add, ops.sub
    t0, t1, t2, txy = ops.mul_many([(y1, y1), (y1, z1), (z1, z1), (x1, y1)])
    z3a = add(t0, t0)
    z3a = add(z3a, z3a)
    z3a = add(z3a, z3a)  # 8*y^2
    t2b = ops.mul_b3(t2)
    y3s = add(t0, t2b)
    t0b = sub(t0, add(add(t2b, t2b), t2b))
    mx, mz, my, mxf = ops.mul_many([(t2b, z3a), (t1, z3a), (t0b, y3s), (t0b, txy)])
    return (add(mxf, mxf), add(mx, my), mz)


def pneg(ops, p):
    return (p[0], ops.neg(p[1]), p[2])


def pselect(mask, p, q):
    """Per-lane point select: mask True -> p, False -> q."""
    return tuple(torch.where(mask, a, b) for a, b in zip(p, q))


def point_stack(p):
    """Point tuple -> (3, coords..., n) tensor."""
    return torch.stack(p, dim=0)


def point_unstack(arr):
    return (arr[0], arr[1], arr[2])


def points_equal(ops, p, q):
    """Per-lane equality of projective points as AFFINE points (X1 Z2 ==
    X2 Z1 and Y1 Z2 == Y2 Z1, identities equal only to identities)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    a, b, c, d = ops.mul_many([(x1, z2), (x2, z1), (y1, z2), (y2, z1)])
    same = (a == b).flatten(0, -2).all(0) & (c == d).flatten(0, -2).all(0)
    return same & (ops.is_zero_lanes(z1) == ops.is_zero_lanes(z2))


def _check_point(ops, p, what: str):
    for a in p:
        if (a.dtype != torch.int32 or tuple(a.shape[:-1]) != ops.coords
                or a.shape != p[0].shape or a.device != p[0].device):
            raise ValueError(f"{what}: want int32 {ops.coords + ('n',)} coordinates, "
                             f"got {tuple(a.shape)}")


def pdbl_k_plain(ops, p, k: int):
    """Plain version of K7 point_dbl_k: k complete doublings."""
    for _ in range(k):
        p = pdbl(ops, p)
    return p


def pdbl_k(ops, p, k: int):
    """2^k * p per lane (k complete doublings; the identity stays)."""
    _check_point(ops, p, "pdbl_k")
    dev = p[0].device
    if dev.type == "cpu":
        return pdbl_k_plain(ops, p, k)
    if dev.type != "cuda":
        raise RuntimeError(f"pdbl_k: unsupported device {dev}")
    src = point_stack(p).contiguous()
    out = torch.empty_like(src)
    kernels.POINT_DBL_K.launch(int(ops.g2), out.data_ptr(), src.data_ptr(), src.shape[-1], k)
    return point_unstack(out)


def to_affine_plain(ops, p):
    """Plain version of K7 point_to_affine."""
    x, y, z = p
    inf = ops.is_zero_lanes(z)
    zi = ops.inv(z)
    ax, ay = ops.mul_many([(x, zi), (y, zi)])
    zero = torch.zeros_like(ax)
    return torch.where(inf, zero, ax), torch.where(inf, zero, ay)


def to_affine(ops, p):
    """Projective -> affine (x, y) Montgomery limbs; infinity -> (0, 0)."""
    _check_point(ops, p, "to_affine")
    dev = p[0].device
    if dev.type == "cpu":
        return to_affine_plain(ops, p)
    if dev.type != "cuda":
        raise RuntimeError(f"to_affine: unsupported device {dev}")
    src = point_stack(p).contiguous()
    ax, ay = torch.empty_like(src[0]), torch.empty_like(src[0])
    kernels.POINT_TO_AFFINE.launch(
        int(ops.g2), ax.data_ptr(), ay.data_ptr(), src.data_ptr(), src.shape[-1])
    return ax, ay
