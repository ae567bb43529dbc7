"""The port's inv, div, sum_reduce, product_reduce, mont_pow_const and
batch_inv over the six fields of the other curves (bls12-377, bls12-381 and
bw6-761, Fq and Fr each; bw6-761's Fr is bls12-377's Fq) on the CPU, where
they run the plain versions of K16 (csrc/field_pow_n.cu) and K17
(csrc/field_reduce_n.cu), against the JAX package's on the same
numpy-seeded inputs: 5 to 7 lanes, one of them zero, odd lengths for the
reductions' padded tails. Canonical values are equal as integers. The JAX
product_reduce fails above 8 words (it reshapes its one to (NLIMB, 1)); the
port's raises there too. The kernels' exponent reduction is held against
Python integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curves import device as jcdev
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import vec_ops as jvo
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.errors import InvalidArgument
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import vec_ops as vo

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CURVES = ("bls12_377", "bls12_381", "bw6_761")
# field name -> (curve, index in curve_specs: 0 Fq, 1 Fr)
FIELDS = {f"{c}_{f}": (c, i) for c in CURVES for i, f in enumerate(("fq", "fr"))}
WIDE = [name for name, (c, i) in FIELDS.items() if cdev.curve_specs(c)[i].words > 8]
ZERO_LANE = 2
# an exponent above 2^256: 301 bits
BIG_EXPONENT = (1 << 300) + 0x9E3779B97F4A7C15


def _specs(name: str):
    c, i = FIELDS[name]
    return cdev.curve_specs(c)[i], jcdev.curve_specs(c)[i]


def _vals(seed: int, p: int, n: int, zero: bool = True) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes((p.bit_length() + 7) // 8 + 8), "little") % p
            for _ in range(n)]
    vals = [v or 1 for v in vals]
    if zero:
        vals[ZERO_LANE] = 0
    return vals


def _port(vals, spec) -> torch.Tensor:
    return lb.ints_to_limbs(vals, words=spec.words)


def _jax(t: torch.Tensor):
    return jnp.asarray(lb.to_jax_limbs(t))


def _ints(x) -> list:
    """A port tensor or a JAX array -> canonical ints along the last axis."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(lb.from_jax_limbs(np.asarray(x)))
    return lb.limbs_to_ints(x.reshape(x.shape[0], -1))


def _inv(spec, jspec, a, b):
    return vo.inv(a, spec), jvo.inv(_jax(a), jspec)


def _div(spec, jspec, a, b):
    return vo.div(a, b, spec), jvo.div(_jax(a), _jax(b), jspec)


def _sum(spec, jspec, a, b):
    a5 = a[:, :5].contiguous()
    got, want = vo.sum_reduce(a5, spec), jvo.sum_reduce(_jax(a5), jspec)
    return got[:, None], want[:, None]


def _pow(spec, jspec, a, b):
    return (lb.mont_pow_const(a, BIG_EXPONENT, spec),
            jlb.mont_pow_const(_jax(a), BIG_EXPONENT, jspec))


def _batch_inv(spec, jspec, a, b):
    # the JAX batch trick needs nonzero inputs: its lanes without the zero
    nz = torch.cat([a[:, :ZERO_LANE], a[:, ZERO_LANE + 1:]], dim=-1)
    got = lb.batch_inv(a, spec)
    assert lb.limbs_to_ints(got[:, ZERO_LANE:ZERO_LANE + 1]) == [0]
    return torch.cat([got[:, :ZERO_LANE], got[:, ZERO_LANE + 1:]], dim=-1), \
        jlb.batch_inv(_jax(nz), jspec)


OPS = {"inv": _inv, "div": _div, "sum_reduce": _sum, "mont_pow_const": _pow,
       "batch_inv": _batch_inv}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS)
def test_op_matches_jax(field, op):
    """7 lanes with a zero in lane 2 (b has its own zero, so div covers x / 0
    and 0 / x); sum_reduce over the first 5 (5 -> 6 -> 3 -> 4 -> 2 -> 1:
    two padded tails); mont_pow_const at an exponent of 301 bits; batch_inv
    maps the zero to 0 and is held against JAX on the other lanes."""
    spec, jspec = _specs(field)
    p = spec.modulus
    a = _port(_vals(1, p, 7), spec)
    b = _port(_vals(2, p, 7)[::-1], spec)
    got, want = OPS[op](spec, jspec, a, b)
    assert _ints(got) == _ints(want)
    assert all(v < p for v in _ints(got))
    if op in ("inv", "div", "mont_pow_const"):
        assert _ints(got)[ZERO_LANE] == 0


@pytest.mark.parametrize("field", ["bls12_377_fr", "bls12_381_fr"])
def test_product_reduce_matches_jax(field):
    """The two 8-word Fr: 5 nonzero lanes (two padded tails), and a row
    holding a zero."""
    spec, jspec = _specs(field)
    a = _port(_vals(3, spec.modulus, 5, zero=False), spec)
    got, want = vo.product_reduce(a, spec), jvo.product_reduce(_jax(a), jspec)
    assert _ints(got[:, None]) == _ints(want[:, None])
    assert _ints(got[:, None])[0] != 0
    z = _port(_vals(4, spec.modulus, 5), spec)
    assert _ints(vo.product_reduce(z, spec)[:, None]) == [0]


@pytest.mark.parametrize("field", WIDE)
def test_product_reduce_raises_as_jax_does(field):
    """Above 8 words the JAX product_reduce fails (its one reshaped to
    (NLIMB, 1)); the port's raises InvalidArgument there."""
    spec, jspec = _specs(field)
    a = _port(_vals(5, spec.modulus, 3, zero=False), spec)
    with pytest.raises(ValueError):
        jvo.product_reduce(_jax(a), jspec)
    with pytest.raises(InvalidArgument):
        vo.product_reduce(a, spec)
    assert _ints(vo.sum_reduce(a, spec)[:, None]) == [sum(_ints(a)) % spec.modulus]


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_381_fr", "bw6_761_fq"])
def test_kernel_exponent_gives_the_same_powers(field):
    """The exponent the CUDA path hands K9 or K16: unchanged where it fits
    the kernel's words, else reduced into [1, p - 1] with the same power of
    every element, 0 included (Python integers)."""
    spec = lb.FR_SPEC if field == "bn254_fr" else _specs(field)[0]
    p, cap = spec.modulus, lb.POW_EXPONENT_BITS[spec.bn254]
    xs = [0, 1, p - 1] + _vals(6, p, 4, zero=False)
    for e in (0, 1, p - 2, (1 << cap) - 1, 1 << cap, (p - 1) << cap, 7 << (2 * cap)):
        k = lb.kernel_exponent(e, spec)
        assert k.bit_length() <= cap
        assert k == e or 1 <= k <= p - 1
        assert [pow(x, k, p) for x in xs] == [pow(x, e, p) for x in xs], e
