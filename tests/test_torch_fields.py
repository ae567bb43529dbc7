"""The port's field layer (K1 plain versions on the CPU) against the JAX
package's limb arithmetic: exact integer equality, Fr and Fq, on seeded
random vectors plus 0, 1 and p-1."""

import jax
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu_torch.curve import jcurve as jc
from icicle_snark_tpu_torch.fields import limbs as lb

N = 64
# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def _vals(rng, modulus, n=N):
    """Canonical values < modulus (numpy seed) with 0, 1, p-1 up front."""
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    words[:, 7] = rng.integers(0, modulus >> 224, size=n).astype(np.uint32)
    ints = [int.from_bytes(w.astype("<u4").tobytes(), "little") for w in words]
    ints[:3] = [0, 1, modulus - 1]
    return ints


SPECS = [(lb.FR_SPEC, jlb.FR_SPEC), (lb.FQ_SPEC, jlb.FQ_SPEC)]


@pytest.mark.parametrize("specs", SPECS, ids=["fr", "fq"])
@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_binop_matches_jax(specs, op):
    spec, jspec = specs
    rng = np.random.default_rng(11)
    a, b = _vals(rng, spec.modulus), _vals(rng, spec.modulus)[::-1]
    got = lb.limbs_to_ints(getattr(lb, op)(lb.ints_to_limbs(a), lb.ints_to_limbs(b), spec))
    jfn = jax.jit(lambda x, y: getattr(jlb, op)(x, y, jspec))
    want = jlb.limbs_to_ints_np(jfn(jlb.ints_to_limbs_np(a), jlb.ints_to_limbs_np(b)))
    assert got == want


@pytest.mark.parametrize("specs", SPECS, ids=["fr", "fq"])
def test_neg_and_to_mont_match_jax(specs):
    spec, jspec = specs
    a = _vals(np.random.default_rng(12), spec.modulus)
    ja = jlb.ints_to_limbs_np(a)
    assert lb.limbs_to_ints(lb.neg_mod(lb.ints_to_limbs(a), spec)) == jlb.limbs_to_ints_np(
        jax.jit(lambda x: jlb.neg_mod(x, jspec))(ja))
    assert lb.limbs_to_ints(lb.to_mont(lb.ints_to_limbs(a), spec)) == jlb.limbs_to_ints_np(
        jax.jit(lambda x: jlb.to_mont(x, jspec))(ja))


def test_broadcast_forms():
    """b as a table shared by a batch, and as a constant (the pipeline's
    key-power and R^2 products)."""
    spec = lb.FR_SPEC
    rng = np.random.default_rng(13)
    a = torch.stack([lb.ints_to_limbs(_vals(rng, spec.modulus)) for _ in range(3)])
    table = lb.ints_to_limbs(_vals(rng, spec.modulus))
    full = lb.mont_mul(a, table.expand(3, 8, N).contiguous(), spec)
    assert torch.equal(lb.mont_mul(a, table, spec), full)
    c = lb.const(spec.r2, "cpu")
    assert torch.equal(lb.mont_mul(a, c, spec),
                       lb.mont_mul(a, c.expand(3, 8, N).contiguous(), spec))
    with pytest.raises(ValueError):
        lb.mont_mul(a, table[:, :5], spec)


def test_conversions_roundtrip():
    spec = lb.FQ_SPEC
    vals = _vals(np.random.default_rng(14), spec.modulus)
    t = lb.ints_to_limbs(vals)
    assert t.dtype == torch.int32 and t.shape == (8, N)
    assert lb.limbs_to_ints(t) == vals
    j = jlb.ints_to_limbs_np(vals)
    assert np.array_equal(lb.to_jax_limbs(t), j)
    assert np.array_equal(lb.from_jax_limbs(j), t.numpy())
    assert np.array_equal(lb.limbs_to_words(t), lb.ints_to_words(vals))


def test_inverse():
    """Fq inversion (Fermat over K1 products), as the setup's affine
    conversion uses it."""
    spec = lb.FQ_SPEC
    vals = _vals(np.random.default_rng(15), spec.modulus, 8)[1:]
    inv = jc.G1.inv(lb.ints_to_limbs(vals))
    one = lb.mont_mul(inv, lb.ints_to_limbs(vals), spec)
    assert lb.limbs_to_ints(one) == [spec.r_mod] * len(vals)
    assert lb.limbs_to_ints(jc.G1.inv(lb.ints_to_limbs([0]))) == [0]
