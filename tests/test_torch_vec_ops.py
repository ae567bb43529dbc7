"""The port's vec-ops (ops/vec_ops.py: K1's ops, the K9 powers, the K10
reductions, here their plain versions on the CPU) and the new field-layer
functions (mont_pow_const, mont_inv, batch_inv, mont_reduce) against the
JAX package's on the same numpy-seeded inputs, 0, 1 and p-1 among them:
every integer equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.config import VecOpsConfig as JVecOpsConfig
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import vec_ops as jvo
from icicle_snark_tpu_torch.config import VecOpsConfig
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import vec_ops as vo

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

SPECS = {"fr": (lb.FR_SPEC, jlb.FR_SPEC), "fq": (lb.FQ_SPEC, jlb.FQ_SPEC)}
N = 48


def _rand(seed: int, p: int, shape) -> torch.Tensor:
    """Canonical values < p as a port tensor (*lead, 8, n); 0, 1 and p-1 in
    the first lanes (as many as there are)."""
    *lead, n = shape
    count = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64).astype(np.uint32)
    w[:, 7] = rng.integers(0, p >> 224, size=count).astype(np.uint32)
    for i, v in enumerate((0, 1, p - 1)[:count]):
        w[i] = lb.ints_to_words([v])[0]
    return lb.words_to_limbs(w).reshape(8, *lead, n).movedim(0, -2).contiguous()


def _jax(t: torch.Tensor):
    """Port (*lead, 8, n) -> JAX (16, *lead, n)."""
    return jnp.asarray(lb.to_jax_limbs(t.movedim(-2, 0).contiguous()))


def _from_jax(arr, limb_axis_to: int = -2) -> torch.Tensor:
    """JAX (16, ...) -> port layout, the limb axis moved to `limb_axis_to`."""
    return torch.from_numpy(lb.from_jax_limbs(np.asarray(arr))).movedim(0, limb_axis_to)


ELEMENTWISE = {
    "add": (lambda a, b, s: vo.add(a, b, s), lambda a, b, s: jvo.add(a, b, s)),
    "sub": (lambda a, b, s: vo.sub(a, b, s), lambda a, b, s: jvo.sub(a, b, s)),
    "mul": (lambda a, b, s: vo.mul(a, b, s), lambda a, b, s: jvo.mul(a, b, s)),
    "neg": (lambda a, b, s: vo.neg(a, s), lambda a, b, s: jvo.neg(a, s)),
    "inv": (lambda a, b, s: vo.inv(a, s), lambda a, b, s: jvo.inv(a, s)),
    "div": (lambda a, b, s: vo.div(a, b, s), lambda a, b, s: jvo.div(a, b, s)),
    "accumulate": (lambda a, b, s: vo.accumulate(a.clone(), b, s),
                   lambda a, b, s: jvo.accumulate(a, b, s)),
    "to_mont": (lambda a, b, s: vo.to_mont(a, s), lambda a, b, s: jvo.to_mont(a, s)),
    "from_mont": (lambda a, b, s: vo.from_mont(a, s), lambda a, b, s: jvo.from_mont(a, s)),
}


@pytest.mark.parametrize("field", SPECS)
@pytest.mark.parametrize("op", ELEMENTWISE)
def test_elementwise_matches_jax(op, field):
    """b holds 0 where a holds 0, 1, p-1 (lanes 3-5), so div(x, 0) and
    inv(0) are covered as well as 0 * (p-1) and (p-1) + 1."""
    spec, jspec = SPECS[field]
    a = _rand(1, spec.modulus, (N,))
    b = _rand(2, spec.modulus, (N,))
    b[:, 3:6] = a[:, :3]
    b[:, 6:9] = 0
    ours, theirs = ELEMENTWISE[op]
    got = ours(a, b, spec)
    want = _from_jax(theirs(_jax(a), _jax(b), jspec))
    assert torch.equal(got, want)
    if op in ("inv", "div"):
        assert bool(lb.is_zero(got[:, :1]).all())  # inv(0) = 0, 0 / x = 0


@pytest.mark.parametrize("op", ["scalar_add", "scalar_sub", "scalar_mul"])
def test_scalar_ops_match_jax(op):
    """The scalar as (8,) and as (8, 1), over a batch of rows (K1's
    constant broadcast) and over one vector; the JAX scalar is (16,), over
    one (16, n) vector a call."""
    spec, jspec = SPECS["fr"]
    v = _rand(3, spec.modulus, (2, 20))
    for lane in (0, 2, 7):  # 0, p - 1, random
        s = v[0, :, lane].clone()
        js = jnp.asarray(lb.to_jax_limbs(s.reshape(8, 1)).reshape(16))
        want = torch.stack([_from_jax(getattr(jvo, op)(js, _jax(row), jspec)) for row in v])
        assert torch.equal(getattr(vo, op)(s, v, spec), want)
        assert torch.equal(getattr(vo, op)(s.reshape(8, 1), v[1], spec), want[1])


@pytest.mark.parametrize("field,shape", [
    ("fr", (1,)), ("fr", (37,)), ("fr", (64,)), ("fr", (2, 3, 17)),
    ("fq", (37,)), ("fq", (2, 3, 17)),
], ids=["fr-n1", "fr-odd", "fr-even", "fr-batch2d", "fq-odd", "fq-batch2d"])
@pytest.mark.parametrize("op", ["sum_reduce", "product_reduce"])
def test_reductions_match_jax(op, field, shape):
    spec, jspec = SPECS[field]
    v = _rand(4, spec.modulus, shape)
    got = getattr(vo, op)(v, spec)
    want = _from_jax(getattr(jvo, op)(_jax(v), jspec), limb_axis_to=-1)
    assert got.shape == v.shape[:-2] + (8,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["sum_reduce", "product_reduce"])
def test_reductions_of_p_minus_1(op):
    """Every value p - 1 (the largest carries, an odd count): the output is
    canonical and equals the integer result."""
    spec = lb.FR_SPEC
    p, n = spec.modulus, 63
    v = lb.const(p - 1, "cpu", n)
    got = lb.limbs_to_ints(getattr(vo, op)(v, spec).reshape(8, 1))[0]
    if op == "sum_reduce":
        want = n * (p - 1) % p
    else:  # Montgomery: prod (x R) R^-(n-1) = (x R)^n R^-(n-1)
        want = pow(p - 1, n, p) * pow(spec.rinv, n - 1, p) % p
    assert got == want


def test_mixed_mul_fq2_matches_jax():
    """Fq2 values (2, 8, n) scaled by Fq values (8, n)."""
    spec, jspec = SPECS["fq"]
    ext = _rand(5, spec.modulus, (2, 24))
    base = _rand(6, spec.modulus, (24,))
    got = vo.mixed_mul(ext, base, spec)
    jext = jnp.stack([_jax(ext[0]), _jax(ext[1])])  # JAX: (k, 16, n)
    want = np.asarray(jvo.mixed_mul(jext, _jax(base), jspec))
    assert torch.equal(got, torch.stack([_from_jax(want[0]), _from_jax(want[1])]))


@pytest.mark.parametrize("op", ["add_cfg", "sub_cfg", "mul_cfg"])
def test_cfg_ops_match_jax(op):
    spec, jspec = SPECS["fr"]
    a, b = _rand(7, spec.modulus, (32,)), _rand(8, spec.modulus, (32,))
    got = getattr(vo, op)(a, b, VecOpsConfig(batch_size=4), spec)
    want = _from_jax(getattr(jvo, op)(_jax(a), _jax(b), JVecOpsConfig(batch_size=4), jspec))
    assert torch.equal(got, want)
    assert torch.equal(got, getattr(vo, op[:3])(a, b, spec))
    with pytest.raises(ValueError):
        getattr(vo, op)(a, b, VecOpsConfig(batch_size=5), spec)
    with pytest.raises(ValueError):
        getattr(jvo, op)(_jax(a), _jax(b), JVecOpsConfig(batch_size=5), jspec)


@pytest.mark.parametrize("field", SPECS)
def test_pow_inv_reduce_match_jax(field):
    """fields/limbs.py mont_pow_const (K9's plain version) at exponents 0,
    1, 2, 5, a 256-bit one and p - 2; mont_inv; batch_inv on nonzero values
    (the JAX batch trick needs them); mont_reduce."""
    spec, jspec = SPECS[field]
    a = _rand(9, spec.modulus, (N,))
    ja = _jax(a)
    big = int.from_bytes(np.random.default_rng(10).bytes(32), "little")
    for e in (0, 1, 2, 5, big, spec.modulus - 2):
        assert torch.equal(lb.mont_pow_const(a, e, spec),
                           _from_jax(jlb.mont_pow_const(ja, e, jspec))), e
    assert torch.equal(lb.mont_inv(a, spec), _from_jax(jlb.mont_inv(ja, jspec)))
    nz = a[:, 1:].contiguous()
    assert torch.equal(lb.batch_inv(nz, spec), _from_jax(jlb.batch_inv(_jax(nz), jspec)))
    assert torch.equal(lb.mont_reduce(a, spec), _from_jax(jlb.mont_reduce(ja, jspec)))


def test_field_reduce_tree_order_is_free():
    """K10 folds in another order than the JAX pairing: any order of the
    modular sum, or of Montgomery products, gives the same canonical words.
    Here a sequential left fold against the plain tree."""
    spec = lb.FR_SPEC
    v = _rand(11, spec.modulus, (3, 29))
    for op, code in ((0, lb.OP_ADD), (1, lb.OP_MUL)):
        acc = v[..., :1]
        for i in range(1, v.shape[-1]):
            acc = lb.field_op_plain(code, acc.contiguous(), v[..., i:i + 1].contiguous(), spec)
        assert torch.equal(vo.field_reduce_plain(op, v, spec), acc)


def test_bad_arguments_raise():
    a = _rand(12, lb.FR_SPEC.modulus, (8,))
    with pytest.raises(ValueError):
        vo.field_reduce(0, a[:, :0], lb.FR_SPEC)
    with pytest.raises(ValueError):
        vo.scalar_add(a[:, :2], a)
    with pytest.raises(ValueError):
        lb.mont_pow_const(a, -1, lb.FR_SPEC)
