"""Generic host-side (pure Python int) curve oracle. A copy of
icicle_snark_tpu/curves/host.py, which the port does not import.

The multi-curve counterpart of refmath/curve.py: slow, obviously
correct projective arithmetic over any CurveParams, for G1 (Fp) and G2
(Fp2 twist or Fp twist). Used as the differential-test oracle for the
port's curve kernels (curves/device.py) — the same role the reference's
CPU backend plays for its CUDA backend (SURVEY.md section 4).
"""

from __future__ import annotations

from .params import CurveParams


class FpOps:
    """Field ops over python ints mod q."""

    def __init__(self, q: int):
        self.q = q
        self.zero = 0
        self.one = 1

    def add(self, a, b):
        return (a + b) % self.q

    def sub(self, a, b):
        return (a - b) % self.q

    def mul(self, a, b):
        return a * b % self.q

    def eqz(self, a):
        return a == 0


class Fp2Ops:
    """Fp2 = Fp[u]/(u^2 - nonresidue), elements as (re, im) tuples."""

    def __init__(self, q: int, nonresidue: int):
        self.q = q
        self.nr = nonresidue % q
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.q, (a[1] + b[1]) % self.q)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.q, (a[1] - b[1]) % self.q)

    def mul(self, a, b):
        return (
            (a[0] * b[0] + self.nr * a[1] * b[1]) % self.q,
            (a[0] * b[1] + a[1] * b[0]) % self.q,
        )

    def eqz(self, a):
        return a == (0, 0)


class HostCurve:
    """Projective short-Weierstrass group (y^2 = x^3 + b, a = 0) over a
    host field-ops object; complete RCB15 formulas so identity/doubling
    need no branches — the same formula family the device uses."""

    def __init__(self, fops, b):
        self.f = fops
        self.b = b if not isinstance(b, list) else tuple(b)
        # b3 = 3b
        self.b3 = fops.add(fops.add(self.b, self.b), self.b)
        self.zero_pt = (fops.zero, fops.one, fops.zero)

    def from_affine(self, a):
        if a is None or (self.f.eqz(a[0]) and self.f.eqz(a[1])):
            return self.zero_pt
        return (a[0], a[1], self.f.one)

    def to_affine(self, p):
        x, y, z = p
        if self.f.eqz(z):
            return None
        zinv = self._inv(z)
        return (self.f.mul(x, zinv), self.f.mul(y, zinv))

    def _inv(self, a):
        f = self.f
        q = f.q
        if isinstance(a, tuple):  # Fp2: (re - im u)/(re^2 - nr im^2)
            d = (a[0] * a[0] - f.nr * a[1] * a[1]) % q
            dinv = pow(d, -1, q)
            return (a[0] * dinv % q, (-a[1]) * dinv % q)
        return pow(a, -1, q)

    def add(self, p, q):
        f = self.f
        x1, y1, z1 = p
        x2, y2, z2 = q
        t0 = f.mul(x1, x2)
        t1 = f.mul(y1, y2)
        t2 = f.mul(z1, z2)
        t3 = f.sub(f.mul(f.add(x1, y1), f.add(x2, y2)), f.add(t0, t1))
        t4 = f.sub(f.mul(f.add(y1, z1), f.add(y2, z2)), f.add(t1, t2))
        t5 = f.sub(f.mul(f.add(x1, z1), f.add(x2, z2)), f.add(t0, t2))
        u = f.mul(self.b3, t2)
        z3 = f.add(t1, u)
        x3m = f.sub(t1, u)
        y3m = f.mul(self.b3, t5)
        t0_3 = f.add(f.add(t0, t0), t0)
        x3 = f.sub(f.mul(t3, x3m), f.mul(t4, y3m))
        y3 = f.add(f.mul(x3m, z3), f.mul(t0_3, y3m))
        z3 = f.add(f.mul(t4, z3), f.mul(t3, t0_3))
        return (x3, y3, z3)

    def dbl(self, p):
        return self.add(p, p)

    def mul_scalar(self, p, k: int):
        acc = self.zero_pt
        if k <= 0:
            return acc
        for bit in bin(k)[2:]:
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.add(acc, p)
        return acc

    def eq(self, p, q):
        """Projective equality (cross-multiplied)."""
        f = self.f
        x1, y1, z1 = p
        x2, y2, z2 = q
        if f.eqz(z1) or f.eqz(z2):
            return f.eqz(z1) and f.eqz(z2)
        return (
            f.eqz(f.sub(f.mul(x1, z2), f.mul(x2, z1)))
            and f.eqz(f.sub(f.mul(y1, z2), f.mul(y2, z1)))
        )

    def msm(self, scalars, points_affine):
        acc = self.zero_pt
        for s, a in zip(scalars, points_affine):
            acc = self.add(acc, self.mul_scalar(self.from_affine(a), s))
        return acc


def g1_curve(params: CurveParams) -> HostCurve:
    return HostCurve(FpOps(params.q), params.g1_b)


def g2_curve(params: CurveParams) -> HostCurve:
    if params.fp2_nonresidue is None:
        return HostCurve(FpOps(params.q), params.g2_b)
    return HostCurve(Fp2Ops(params.q, params.fp2_nonresidue), params.g2_b)
