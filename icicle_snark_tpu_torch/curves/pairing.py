"""Generic BLS12 pairing (host oracle): bls12-377 / bls12-381. A copy of
icicle_snark_tpu/curves/pairing.py, which the port does not import.

Parity with the reference's vendored BLS12 pairing model
(icicle/include/icicle/pairing/models/bls12.h, shipped for the
bls12-377/381 wrapper crates' pairing API) re-designed for a
host oracle: a single sextic extension Fp12 = Fp2[w]/(w^6 - xi)
replaces the 2-3-2 tower, the ate Miller loop runs on the UNTWISTED
curve E(Fp12) with affine lines (ext-Euclid inversion), and the final
exponentiation is a direct (q^12-1)/r power — O(1) host work, correct
by construction, no per-curve Frobenius coefficient tables.

The BLS parameter z is self-validated against the curve family
identities r = z^4 - z^2 + 1 and q = ((z-1)^2 (z^4-z^2+1))/3 + z.
BN254 stays on the hand-optimized refmath/pairing.py path (the only
pairing the reference's prover itself calls).
"""

from __future__ import annotations

from .params import get_curve

# BLS parameter z and the Fp6/Fp12 nonresidue xi (an Fp2 element), per
# curve. Standard public constants, asserted against q/r below.
_BLS = {
    "bls12_381": {"z": -0xD201000000010000, "xi": (1, 1)},
    "bls12_377": {"z": 0x8508C00000000001, "xi": (0, 1)},
}


class _Fp2:
    def __init__(self, q: int, nonresidue: int):
        self.q = q
        self.nr = nonresidue % q

    def add(self, a, b):
        return ((a[0] + b[0]) % self.q, (a[1] + b[1]) % self.q)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.q, (a[1] - b[1]) % self.q)

    def mul(self, a, b):
        q, nr = self.q, self.nr
        re = (a[0] * b[0] + nr * a[1] * b[1]) % q
        im = (a[0] * b[1] + a[1] * b[0]) % q
        return (re, im)

    def smul(self, a, k: int):
        return (a[0] * k % self.q, a[1] * k % self.q)

    def inv(self, a):
        q = self.q
        norm = (a[0] * a[0] - self.nr * a[1] * a[1]) % q
        ninv = pow(norm, -1, q)
        return (a[0] * ninv % q, (-a[1]) * ninv % q)

    zero = (0, 0)
    one = (1, 0)

    def eqz(self, a):
        return a[0] % self.q == 0 and a[1] % self.q == 0


class _Fp12:
    """Fp2[w]/(w^6 - xi): elements are 6-tuples of Fp2 coefficients."""

    def __init__(self, fp2: _Fp2, xi):
        self.f = fp2
        self.xi = xi
        self.zero = (fp2.zero,) * 6
        self.one = (fp2.one,) + (fp2.zero,) * 5

    def add(self, a, b):
        return tuple(self.f.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.f.sub(x, y) for x, y in zip(a, b))

    def mul(self, a, b):
        f, xi = self.f, self.xi
        acc = [f.zero] * 11
        for i, ai in enumerate(a):
            if f.eqz(ai):
                continue
            for j, bj in enumerate(b):
                acc[i + j] = f.add(acc[i + j], f.mul(ai, bj))
        out = list(acc[:6])
        for k in range(6, 11):  # w^k = xi * w^(k-6)
            out[k - 6] = f.add(out[k - 6], f.mul(xi, acc[k]))
        return tuple(out)

    def embed2(self, a):  # Fp2 scalar -> Fp12
        return (a,) + (self.f.zero,) * 5

    def eqz(self, a):
        return all(self.f.eqz(x) for x in a)

    def eq(self, a, b):
        return self.eqz(self.sub(a, b))

    def inv(self, a):
        """Extended Euclid over Fp2[x] for gcd(a(x), x^6 - xi)."""
        f = self.f

        def deg(p):
            for i in range(len(p) - 1, -1, -1):
                if not f.eqz(p[i]):
                    return i
            return -1

        def pmul(p, q):
            out = [f.zero] * (len(p) + len(q) - 1)
            for i, pi in enumerate(p):
                if f.eqz(pi):
                    continue
                for j, qj in enumerate(q):
                    out[i + j] = f.add(out[i + j], f.mul(pi, qj))
            return out

        def psub(p, q):
            n = max(len(p), len(q))
            p = list(p) + [f.zero] * (n - len(p))
            q = list(q) + [f.zero] * (n - len(q))
            return [f.sub(x, y) for x, y in zip(p, q)]

        # r0 = x^6 - xi, r1 = a
        r0 = [f.sub(f.zero, self.xi)] + [f.zero] * 5 + [f.one]
        r1 = list(a)
        s0, s1 = [f.zero], [f.one]  # s_i tracks coeff of a
        while deg(r1) > 0:
            d0, d1 = deg(r0), deg(r1)
            if d0 < d1:
                r0, r1, s0, s1 = r1, r0, s1, s0
                continue
            lead = f.mul(r0[d0], f.inv(r1[d1]))
            shift = d0 - d1
            qpoly = [f.zero] * shift + [lead]
            r0 = psub(r0, pmul(qpoly, r1))
            s0 = psub(s0, pmul(qpoly, s1))
        assert deg(r1) == 0, "element not invertible"
        c = f.inv(r1[0])
        out = [f.mul(c, x) for x in s1] + [f.zero] * 6
        # reduce mod x^6 - xi
        for k in range(10, 5, -1):
            if k < len(out) and not f.eqz(out[k]):
                out[k - 6] = f.add(out[k - 6], f.mul(self.xi, out[k]))
                out[k] = f.zero
        return tuple(out[:6])

    def pow(self, a, e: int):
        if e < 0:
            return self.pow(self.inv(a), -e)
        out, base = self.one, a
        while e:
            if e & 1:
                out = self.mul(out, base)
            base = self.mul(base, base)
            e >>= 1
        return out


class Bls12Pairing:
    def __init__(self, name: str):
        p = get_curve(name)
        cfg = _BLS[name]
        z = cfg["z"]
        # family identities validate z (and the params file)
        assert p.r == z**4 - z**2 + 1, "BLS z mismatch (r)"
        assert p.q == ((z - 1) ** 2 * (z**4 - z**2 + 1)) // 3 + z, "BLS z mismatch (q)"
        self.params = p
        self.z = z
        # params store the SIGNED nonresidue (params._mk applies
        # fp2_nonres_neg): -1 for bls12_381, -5 for bls12_377
        self.fp2 = _Fp2(p.q, p.fp2_nonresidue)
        self.fp12 = _Fp12(self.fp2, cfg["xi"])
        self._qt = self._untwist_exponents()

    # ---- curve maps
    def _g1_embed(self, a):
        """G1 affine (x, y) over Fp -> E(Fp12)."""
        e = self.fp12
        return (e.embed2((a[0], 0)), e.embed2((a[1], 0)))

    def _untwist_exponents(self):
        """Find the w-power untwist (x, y) -> (x*w^i, y*w^j) that lands
        E'(Fp2) on E(Fp12): try the two standard choices (M/D twist)
        and keep the one satisfying y^2 = x^3 + b. Self-validating —
        no per-curve twist-type table."""
        e, f = self.fp12, self.fp2
        p = self.params
        b12 = e.embed2((p.g1_b, 0))
        gx, gy = p.g2
        for ix, iy in ((2, 3), (-2, -3)):
            X = self._mul_wpow(e.embed2(gx), ix)
            Y = self._mul_wpow(e.embed2(gy), iy)
            lhs = e.mul(Y, Y)
            rhs = e.add(e.mul(X, e.mul(X, X)), b12)
            if e.eq(lhs, rhs):
                return (ix, iy)
        raise AssertionError("no untwist found")

    def _mul_wpow(self, a, k: int):
        """a * w^k in Fp12 (k may be negative)."""
        e = self.fp12
        w = (self.fp2.zero, self.fp2.one) + (self.fp2.zero,) * 4
        if k >= 0:
            return e.mul(a, e.pow(w, k))
        return e.mul(a, e.inv(e.pow(w, -k)))

    def _g2_embed(self, a):
        ix, iy = self._qt
        e = self.fp12
        return (
            self._mul_wpow(e.embed2(a[0]), ix),
            self._mul_wpow(e.embed2(a[1]), iy),
        )

    # ---- Miller loop on E(Fp12), affine lines
    def _line(self, T, Q2, P):
        """Evaluate the line through T and Q2 (or tangent if equal) at
        P; returns (f_contrib, T')."""
        e = self.fp12
        x1, y1 = T
        x2, y2 = Q2
        if e.eq(x1, x2) and e.eq(y1, y2):
            # tangent: m = 3x^2 / 2y
            num = e.mul(e.mul(x1, x1), e.embed2((3, 0)))
            den = e.mul(y1, e.embed2((2, 0)))
        elif e.eq(x1, x2):
            # vertical line x - x1
            return e.sub(P[0], x1), None
        else:
            num = e.sub(y2, y1)
            den = e.sub(x2, x1)
        m = e.mul(num, e.inv(den))
        x3 = e.sub(e.sub(e.mul(m, m), x1), x2)
        y3 = e.sub(e.mul(m, e.sub(x1, x3)), y1)
        # l(P) = yP - y1 - m (xP - x1)
        l = e.sub(e.sub(P[1], y1), e.mul(m, e.sub(P[0], x1)))
        return l, (x3, y3)

    def miller_loop(self, P, Q):
        """f_{|z|, Q}(P) with Q in E(Fp12), P in E(Fp12) (from G1)."""
        e = self.fp12
        n = abs(self.z)
        f = e.one
        T = Q
        for bit in bin(n)[3:]:
            l, T2 = self._line(T, T, P)
            f = e.mul(e.mul(f, f), l)
            if T2 is None:
                T = None
                break
            T = T2
            if bit == "1":
                l, T2 = self._line(T, Q, P)
                f = e.mul(f, l)
                T = T2
        return f

    def pairing(self, p1, q2) -> tuple:
        """e(P, Q): P G1 affine over Fp, Q G2 affine over Fp2 (None =
        identity -> returns one). Output: Fp12 element (6 Fp2 coeffs)."""
        e = self.fp12
        if p1 is None or q2 is None:
            return e.one
        P = self._g1_embed(p1)
        Q = self._g2_embed(q2)
        f = self.miller_loop(P, Q)
        if self.z < 0:
            f = e.inv(f)
        # final exponentiation, direct
        exp = (self.params.q ** 12 - 1) // self.params.r
        return e.pow(f, exp)


_CACHE: dict = {}


def get_pairing(name: str) -> Bls12Pairing:
    if name not in _CACHE:
        _CACHE[name] = Bls12Pairing(name)
    return _CACHE[name]


def pairing(name: str, p1, q2):
    return get_pairing(name).pairing(p1, q2)
