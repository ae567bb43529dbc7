"""The other curves on the card: bls12-377, bls12-381 and bw6-761.

The port of icicle_snark_tpu/curves/device.py: field-op tables over the
port's limb layer at the curve's word count (fields/limbs.py `FieldSpec`),
in curve/jcurve.py's interface, so that the same point formulas
(jcurve.padd / pmadd / pdbl) and the same MSM pipeline (ops/msm.py) run
over them, as the reference instantiates its templates per curve.

  * `LimbFieldOps` (Fq) and `LimbFq2Ops` (Fq2, u^2 = the curve's
    non-residue) launch K12 (csrc/field_vec_n.cu) for CUDA tensors; with
    plain=True they run the plain versions, and they are the plain
    versions of K13's point formulas;
  * `g1_group` / `g2_group` name a curve's point type for ops/msm.py:
    its window sums run K13 (csrc/msm_<curve>.cu: K4's accumulate and
    segments templates at the curve's types, csrc/curve_n.cuh, and the
    tree of csrc/msm_kernels_n.cuh);
  * `msm` takes host scalars and affine points, runs the window sums on
    the device and Horner on the host over curves/host.py.

Layouts: an Fq coordinate is (words, n) int32 and an Fq2 coordinate
(2, words, n), component axis first as BN254's G2; the JAX package's are
(nlimb, n) and (nlimb, 2, n) (fields/limbs.py `from_jax_limbs`). Words:
12 for the bls12 Fq, 24 for the bw6-761 Fq; the Fr are 8 (bls12) and 12
(bw6-761) words, so a bw6-761 scalar has 384 bits and 48 windows at c = 8.

"bn254" maps onto the BN254 tables and kernels (curve/jcurve.py, K4).
"""

from __future__ import annotations

import torch

from ..curve import jcurve as jc
from ..fields import limbs as lb
from ..fields.limbs import FieldSpec
from ..ops import msm as msm_ops
from ..runtime import default_device
from . import host
from .params import get_curve

# K13's curve selector (csrc/msm_n.cu)
CURVE_INDEX = {"bls12_377": 0, "bls12_381": 1, "bw6_761": 2}
# K12's field selector (csrc/field_vec_n.cu), (curve, "r" or "q") in its
# order; K14 (csrc/ntt_n.cu) takes the first three, the scalar fields. The
# bw6-761 Fr is bls12-377's Fq, so it takes selector 1.
KERNEL_FIELDS = (("bls12_377", "r"), ("bls12_377", "q"), ("bls12_381", "r"),
                 ("bls12_381", "q"), ("bw6_761", "q"))


def _small_signed(v: int, q: int, limit: int = 32):
    """v mod q as a small signed int if it is one, else None."""
    if v <= limit:
        return v
    if q - v <= limit:
        return -(q - v)
    return None


class LimbFieldOps(jc.FqOps):
    """Fq ops on (words, n) limb tensors for any spec (K12 launches, or the
    plain versions with plain=True). b3 = 3b multiplies by an addition chain
    when it is small (`_mul_b3_small`), else by a product."""

    def __init__(self, spec: FieldSpec, b3_int: int, plain: bool = False):
        super().__init__(plain)
        self.spec = spec
        self.coords = (spec.words,)
        self._b3_int = b3_int % spec.modulus
        self._b3_small = _small_signed(self._b3_int, spec.modulus)

    def const(self, v: int, n: int, device):
        """Montgomery-form constant in every lane."""
        q = self.spec.modulus
        return lb.const(v % q * self.spec.r_mod % q, device, n, self.spec.words)

    def b3(self, n: int, device):
        return self.const(self._b3_int, n, device)

    def mul_b3(self, x):
        if self._b3_small is None:
            return self.mul(x, self.b3(1, x.device))
        return self._mul_b3_small(x)

    def _small_chain(self, x, k: int):
        """k * x for a small signed k: double-and-add on sums, negated for
        k < 0 (as the JAX package's _mul_b3_small and _mul_nr)."""
        acc, cur, kk = None, x, abs(k)
        while kk:
            if kk & 1:
                acc = cur if acc is None else self.add(acc, cur)
            kk >>= 1
            if kk:
                cur = self.add(cur, cur)
        return self.neg(acc) if k < 0 else acc

    def _mul_b3_small(self, x):
        return self._small_chain(x, self._b3_small)


class LimbFq2Ops(LimbFieldOps):
    """Fq2 = Fq[u] / (u^2 - nonresidue) ops on (2, words, n) tensors: add,
    sub and neg are one K12 launch over both components; k products are one
    Karatsuba product launch over 3k times the lanes (`mul_many`)."""

    g2 = True

    def __init__(self, spec: FieldSpec, nonresidue: int, b3_fq2: tuple, plain: bool = False):
        super().__init__(spec, 0, plain)
        self.coords = (2, spec.words)
        q = spec.modulus
        self._nr = nonresidue % q
        self._nr_small = _small_signed(self._nr, q)
        self._b3_val = tuple(v % q for v in b3_fq2)

    def _fq(self, op, a, b=None):
        return self._fn(op, a, b, self.spec)

    def _mul_nr(self, t):
        """nonresidue * t (a small signed chain, else a product)."""
        if self._nr_small is not None:
            return self._small_chain(t, self._nr_small)
        q = self.spec.modulus
        nr = lb.const(self._nr * self.spec.r_mod % q, t.device, 1, self.spec.words)
        return self._fq(lb.OP_MUL, t, nr)

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """Karatsuba over the pair list: (a0 + a1 u)(b0 + b1 u) =
        (T0 + nr T1) + (T2 - T0 - T1) u with T2 = (a0 + a1)(b0 + b1)."""
        n = pairs[0][0].shape[-1]
        k = len(pairs)
        pairs = [(x, y.expand(x.shape)) for x, y in pairs]
        a0 = torch.cat([x[0] for x, _ in pairs], dim=-1)
        a1 = torch.cat([x[1] for x, _ in pairs], dim=-1)
        b0 = torch.cat([y[0] for _, y in pairs], dim=-1)
        b1 = torch.cat([y[1] for _, y in pairs], dim=-1)
        sa = self._fq(lb.OP_ADD, a0, a1)
        sb = self._fq(lb.OP_ADD, b0, b1)
        p = self._fq(lb.OP_MUL, torch.cat([a0, a1, sa], dim=-1), torch.cat([b0, b1, sb], dim=-1))
        kn = k * n
        t0, t1, t2 = p[..., :kn], p[..., kn:2 * kn], p[..., 2 * kn:]
        c0 = self._fq(lb.OP_ADD, t0, self._mul_nr(t1))
        c1 = self._fq(lb.OP_SUB, t2, self._fq(lb.OP_ADD, t0, t1))
        out = torch.stack([c0, c1], dim=0)
        return [out[..., i * n:(i + 1) * n] for i in range(k)]

    def mul_b3(self, x):
        b3 = self.b3(1, x.device)
        return self.mul_many([(b3.expand(x.shape), x)])[0]

    def is_zero_lanes(self, a):
        return lb.is_zero(a[0]) & lb.is_zero(a[1])

    def const(self, v2, n: int, device):
        return torch.stack([LimbFieldOps.const(self, v2[0], n, device),
                            LimbFieldOps.const(self, v2[1], n, device)])

    def b3(self, n: int, device):
        return self.const(self._b3_val, n, device)

    def inv(self, a):
        raise NotImplementedError("LimbFq2Ops.inv: no path of the port inverts in Fq2")


# ---------------------------------------------------------------- factories

_CACHE: dict = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _field_id(modulus: int) -> int:
    """The kernels' selector of a field (KERNEL_FIELDS), -1 for none."""
    mods = [getattr(get_curve(c), f) for c, f in KERNEL_FIELDS]
    return mods.index(modulus) if modulus in mods else -1


def curve_specs(name: str) -> tuple:
    """(fq_spec, fr_spec) of a registered curve (BN254's own for "bn254"),
    with the kernels' field selectors and the Fr's root tower."""
    if name == "bn254":
        return lb.FQ_SPEC, lb.FR_SPEC
    p = get_curve(name)
    return _cached(("specs", name), lambda: (
        FieldSpec(modulus=p.q, name=f"{name}_fq", field_id=_field_id(p.q)),
        FieldSpec(modulus=p.r, name=f"{name}_fr", field_id=_field_id(p.r),
                  root_tower=tuple(p.root_tower()))))


def g1_ops(name: str, plain: bool = False):
    """The G1 coordinate table: Fq with b3 = 3 b_G1."""
    if name == "bn254":
        return jc.G1_PLAIN if plain else jc.G1
    p = get_curve(name)
    return _cached(("g1", name, plain),
                   lambda: LimbFieldOps(curve_specs(name)[0], 3 * p.g1_b, plain))


def g2_ops(name: str, plain: bool = False):
    """The G2 coordinate table: Fq2 with b3 = 3 b_G2, or Fq for bw6-761's
    M-twist."""
    if name == "bn254":
        return jc.G2_PLAIN if plain else jc.G2
    p = get_curve(name)
    fq = curve_specs(name)[0]
    if p.fp2_nonresidue is None:
        return _cached(("g2", name, plain), lambda: LimbFieldOps(fq, 3 * p.g2_b, plain))
    b3 = tuple(3 * v % p.q for v in p.g2_b)
    return _cached(("g2", name, plain), lambda: LimbFq2Ops(fq, p.fp2_nonresidue, b3, plain))


def g1_group(name: str) -> msm_ops.PointGroup:
    """The curve's G1 point type for ops/msm.py (K13; K4 for "bn254")."""
    if name == "bn254":
        return msm_ops.BN254_G1
    return _cached(("group1", name), lambda: msm_ops.PointGroup(
        f"{name}_g1", g1_ops(name), g1_ops(name, plain=True), False, CURVE_INDEX[name]))


def g2_group(name: str) -> msm_ops.PointGroup:
    """The curve's G2 point type for ops/msm.py (K13; K4 for "bn254")."""
    if name == "bn254":
        return msm_ops.BN254_G2
    return _cached(("group2", name), lambda: msm_ops.PointGroup(
        f"{name}_g2", g2_ops(name), g2_ops(name, plain=True), True, CURVE_INDEX[name]))


# ---------------------------------------------------------------- conversions

def affine_to_device(points, ops, device=None) -> tuple:
    """List of host affine points (None = infinity) -> Montgomery limb
    coordinates (x, y), each ops.coords + (n,), on `device` (the runtime's
    default when None). Infinity is (0, 0), as in zkeys."""
    dev = default_device() if device is None else torch.device(device)
    spec = ops.spec
    q, r, words = spec.modulus, spec.r_mod, spec.words

    def limbs(vals):
        return lb.ints_to_limbs([v * r % q for v in vals], dev, words)

    zero = (0, 0) if ops.g2 else 0
    xs = [zero if a is None else a[0] for a in points]
    ys = [zero if a is None else a[1] for a in points]
    if ops.g2:
        return tuple(torch.stack([limbs([v[0] for v in vs]), limbs([v[1] for v in vs])])
                     for vs in (xs, ys))
    return limbs(xs), limbs(ys)


def _coord_ints(arr, spec) -> list:
    """(words, k) Montgomery limbs -> k standard-form ints."""
    return [v * spec.rinv % spec.modulus for v in lb.limbs_to_ints(arr)]


def window_points_to_host(wsums, ops, g: int = 0) -> list:
    """Window sums (3, coords..., G, W) -> W host projective points (ints)."""
    ws = wsums.detach().cpu()
    coords = []
    for i in range(3):
        a = ws[i]
        if ops.g2:
            c0, c1 = _coord_ints(a[0][:, g, :], ops.spec), _coord_ints(a[1][:, g, :], ops.spec)
            coords.append(list(zip(c0, c1)))
        else:
            coords.append(_coord_ints(a[:, g, :], ops.spec))
    return list(zip(*coords))


def msm(name: str, scalars: list, points_affine: list, g2: bool = False,
        c: int = 8, k: int = 8, jit: bool = True, device=None):
    """Generic-curve MSM: host scalars (ints, reduced mod r) and affine
    points (None = infinity) -> one host projective point (curves/host.py's
    representation). The window sums run on `device` (the runtime's default
    when None: the card) through the same pipeline as the BN254 MSM, on
    K13; Horner over the windows runs on the host. `k` (the JAX package's
    scan chunk) and `jit` are accepted and ignored: the port has neither."""
    del k, jit
    p = get_curve(name)
    grp = g2_group(name) if g2 else g1_group(name)
    fr = curve_specs(name)[1]
    dev = default_device() if device is None else torch.device(device)
    sc = lb.ints_to_limbs([s % p.r for s in scalars], dev, fr.words)
    records = msm_ops.point_records(affine_to_device(points_affine, grp.ops, dev))
    ws = msm_ops.msm_window_sums(sc, [len(scalars)], records, c, group=grp)
    hcurve = host.g2_curve(p) if g2 else host.g1_curve(p)
    acc = hcurve.zero_pt
    for wp in reversed(window_points_to_host(ws, grp.ops, 0)):
        for _ in range(c):
            acc = hcurve.dbl(acc)
        acc = hcurve.add(acc, wp)  # complete formulas: z = 0 is the identity
    return acc
