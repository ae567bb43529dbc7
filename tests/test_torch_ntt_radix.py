"""K3's register passes (ops/ntt.py `ntt_radix`, `ntt_radix_n`; their plain
versions on the CPU): the transforms below NTT_BLOCK_MIN_LOG against the
JAX package's `ntt_dit`, `intt_dif` and `ntt_natural` (jitted on JAX CPU)
over BN254 Fr and the bls12-377, bls12-381 and bw6-761 Fr at 2^1 - 2^9,
batch 2; every `radix_passes` split at R = 1 - 4 against the plain stages,
both directions, with a (words, 1) and a (words, n) scale; the wrappers'
input checks; and the route's launches, counted by a spy. Seeded numpy
inputs; tolerance: equal integers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curves import device as jcdev
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu_torch import kernels
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.curves import params
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import ntt

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

FIELDS = ("bn254", "bls12_377", "bls12_381", "bw6_761")


def _spec(name):
    return lb.FR_SPEC if name == "bn254" else cdev.curve_specs(name)[1]


def _field(rng, spec, shape) -> torch.Tensor:
    """(..., words, n) canonical values with 0, 1 and p - 1 up front."""
    *lead, n = shape
    count = int(np.prod(lead, dtype=np.int64)) * n
    nbytes = (spec.modulus.bit_length() + 7) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % spec.modulus for _ in range(count)]
    vals[:3] = [0, 1, spec.modulus - 1][:count]
    t = lb.ints_to_limbs(vals, "cpu", spec.words)
    return t.reshape(spec.words, *lead, n).movedim(0, -2).contiguous()


def _to_jax(x: torch.Tensor):
    """The port's (B, words, n) -> JAX (nlimb, B, n)."""
    return jnp.asarray(lb.to_jax_limbs(x.movedim(0, 1).contiguous()))


def _from_jax(a) -> torch.Tensor:
    return torch.from_numpy(lb.from_jax_limbs(np.asarray(a))).movedim(1, 0).contiguous()


def _stage_pair(x, dom, scale):
    """The plain stage-by-stage route: the inverse (`scale` (words, 1) in
    its last stage, or a (words, n) product after it) and the forward
    transform of x."""
    spec, log_n = dom.spec, dom.log_n
    lanes = scale.shape[-1] == 1
    inv = x
    for s in range(log_n, 0, -1):
        inv = ntt.ntt_stage_n_plain(inv, dom.stw_inv, 1 << s, True, spec,
                                    scale if lanes and s == 1 else None)
    if not lanes:
        inv = lb.field_op_plain(lb.OP_MUL, inv, scale, spec)
    fwd = x
    for s in range(1, log_n + 1):
        fwd = ntt.ntt_stage_n_plain(fwd, dom.stw_fwd, 1 << s, False, spec)
    return inv, fwd


@pytest.fixture
def radix_route(monkeypatch):
    """Every domain below NTT_BLOCK_MIN_LOG: the register passes."""
    monkeypatch.setattr(ntt, "NTT_BLOCK_MIN_LOG", 99)


def _spied(monkeypatch):
    """Count the register pass, one-stage and tile pass wrapper calls of
    both families (the CPU runs their plain versions)."""
    calls = {}
    for name in ("ntt_radix", "ntt_radix_n", "ntt_stage", "ntt_stage_n", "ntt_block",
                 "ntt_block_n"):
        calls[name] = 0

        def call(*a, _name=name, _fn=getattr(ntt, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ntt, name, call)
    return calls


# BN254 Fr at every size, each curve's Fr at three
JAX_CASES = ([("bn254", log_n) for log_n in range(1, 10)]
             + [("bls12_377", 1), ("bls12_377", 4), ("bls12_377", 7),
                ("bls12_381", 2), ("bls12_381", 5), ("bls12_381", 8),
                ("bw6_761", 3), ("bw6_761", 6), ("bw6_761", 9)])


@pytest.mark.parametrize("name,log_n", JAX_CASES)
def test_radix_route_equals_jax(name, log_n, radix_route):
    """ntt_dit, intt_dif and ntt_natural (both directions) on the register
    passes equal the JAX package's functions on the same (2, words,
    2^log_n) batch, word for word."""
    spec = _spec(name)
    if name == "bn254":
        jspec, tower, jdom = None, None, jntt.NTTDomain(log_n)
    else:
        jspec = jcdev.curve_specs(name)[1]
        tower = params.get_curve(name).root_tower()
        jdom = jntt.NTTDomain(log_n, jspec, tower)
    dom = ntt.NTTDomain(log_n, "cpu", spec)
    x = _field(np.random.default_rng(500 + 10 * FIELDS.index(name) + log_n), spec, (2, dom.n))
    run = jax.jit(lambda v: (jntt.ntt_dit(v, jdom.tw_fwd, jspec),
                             jntt.intt_dif(v, jdom.tw_inv, jdom.n_inv_mont, jspec),
                             jntt.ntt_natural(v, jdom), jntt.ntt_natural(v, jdom, True)))
    want = [_from_jax(a) for a in run(_to_jax(x))]
    got = [ntt.ntt_dit(x, dom), ntt.intt_dif(x, dom), ntt.ntt_natural(x, dom),
           ntt.ntt_natural(x, dom, inverse=True)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("name", FIELDS)
def test_every_split_equals_the_stages(name, r, monkeypatch, radix_route):
    """At R = r stages a pass (at most 3 at 12 words) the transforms of
    2^1 - 2^9, log n a multiple of R or not, equal the plain stages word for
    word: the forward, the inverse with the 1/n (fused into the low = 0
    pass) and with a (words, n) table (a product after the passes)."""
    spec = _spec(name)
    if r > ntt.RADIX_MAX[spec.words]:
        r = ntt.RADIX_MAX[spec.words]
    monkeypatch.setitem(ntt.NTT_RADIX_LOG, spec.words, r)
    for log_n in range(1, 10):
        dom = ntt.get_domain(log_n, "cpu", spec)
        rng = np.random.default_rng(600 + 10 * r + log_n)
        x = _field(rng, spec, (1, dom.n))
        table = _field(rng, spec, (dom.n,))
        passes = ntt.radix_passes(log_n, r)
        assert all(k == r for _, k in passes[:-1]) and 1 <= passes[-1][1] <= r
        for scale in (dom.n_inv_mont, table):
            inv_want, fwd_want = _stage_pair(x, dom, scale)
            y = x.clone()
            ntt._inverse_(y, dom, scale)
            assert torch.equal(y, inv_want), (log_n, tuple(scale.shape))
        y = x.clone()
        ntt._forward_(y, dom)
        assert torch.equal(y, fwd_want), log_n


@pytest.mark.parametrize("name", FIELDS)
def test_pass_plain_is_its_stages(name):
    """A register pass's plain version is its r plain stages in the pass's
    order, the scale on the last, at every (low, r) of 2^6, r up to the
    field's most; `ntt_radix_plain` is `ntt_radix_n_plain` at BN254 Fr."""
    spec = _spec(name)
    dom = ntt.get_domain(6, "cpu", spec)
    rng = np.random.default_rng(700 + FIELDS.index(name))
    x = _field(rng, spec, (2, dom.n))
    for r in range(1, ntt.RADIX_MAX[spec.words] + 1):
        for low in range(0, 7 - r):
            for inverse, scale in ((False, None), (True, None), (True, dom.n_inv_mont)):
                stw = dom.stw_inv if inverse else dom.stw_fwd
                got = ntt.ntt_radix_n_plain(x, stw, low, r, inverse, spec, scale)
                want = x
                stages = range(low + r, low, -1) if inverse else range(low + 1, low + r + 1)
                for s in stages:
                    last = s == (low + 1 if inverse else low + r)
                    want = ntt.ntt_stage_n_plain(want, stw, 1 << s, inverse, spec,
                                                 scale if last else None)
                assert torch.equal(got, want), (r, low, inverse)
                if spec.bn254:
                    assert torch.equal(ntt.ntt_radix_plain(x, stw, low, r, inverse, scale), got)


@pytest.mark.parametrize("log_n", [1, 2, 5, 6, 17, 21, 22])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_radix_passes_cover_every_stage_once(log_n, r):
    """Passes of r stages from low = 0 up, the rest in one shorter pass:
    ceil(log n / r) passes, each stage once."""
    passes = ntt.radix_passes(log_n, r)
    assert [s for low, k in passes for s in range(low + 1, low + k + 1)] == \
        list(range(1, log_n + 1))
    assert len(passes) == -(-log_n // r)
    assert [low for low, _ in passes] == list(range(0, log_n, r))


@pytest.mark.parametrize("name", FIELDS)
def test_route_launches_radix_only(name, monkeypatch, radix_route):
    """Below NTT_BLOCK_MIN_LOG a transform pair is 2 ceil(log n / R) register
    pass calls of its family, none of the one-stage or tile wrappers; the
    op-surface `ntt()` takes the same route."""
    spec = _spec(name)
    radix = "ntt_radix" if spec.bn254 else "ntt_radix_n"
    r = ntt.NTT_RADIX_LOG[spec.words]
    calls = _spied(monkeypatch)
    for log_n in (2, 5, 7):
        dom = ntt.get_domain(log_n, "cpu", spec)
        x = _field(np.random.default_rng(800 + log_n), spec, (1, dom.n))
        calls.update(dict.fromkeys(calls, 0))
        back = ntt.ntt_dit(ntt.intt_dif(x, dom), dom)
        assert torch.equal(back, x)
        want = dict.fromkeys(calls, 0)
        want[radix] = 2 * -(-log_n // r)
        assert calls == want, log_n
    calls.update(dict.fromkeys(calls, 0))
    x = _field(np.random.default_rng(810), spec, (4,))
    assert torch.equal(ntt.ntt(ntt.ntt(x, spec=spec), inverse=True, spec=spec), x)
    assert calls[radix] == 2 and sum(calls.values()) == 2


def test_default_route_below_block_min_log():
    """At the default NTT_BLOCK_MIN_LOG (3) only 2^1 and 2^2 take the
    register passes, at most two a transform at every width's R."""
    assert ntt.NTT_BLOCK_MIN_LOG == 3
    for words, r in ntt.NTT_RADIX_LOG.items():
        assert 1 <= r <= ntt.RADIX_MAX[words]
        assert [len(ntt.radix_passes(log_n, r)) for log_n in (1, 2)] == [1, 1 if r >= 2 else 2]


def test_wrapper_checks():
    """Shapes, the pass, the table and the scale are checked before any
    launch; a device that is neither the CPU nor CUDA raises; both kernels
    are registered for the chip script's rows and counts."""
    fr = cdev.curve_specs("bw6_761")[1]
    dom = ntt.get_domain(4, "cpu")
    dom_n = ntt.get_domain(4, "cpu", fr)
    x = _field(np.random.default_rng(900), lb.FR_SPEC, (1, 16))
    xn = _field(np.random.default_rng(901), fr, (1, 16))
    bad = [
        lambda: ntt.ntt_radix(x[:, :4].contiguous(), dom.stw_fwd, 0, 2, False),  # words
        lambda: ntt.ntt_radix(x[:, :, :12].contiguous(), dom.stw_fwd, 0, 2, False),  # n
        lambda: ntt.ntt_radix(x.to(torch.int64), dom.stw_fwd, 0, 2, False),  # dtype
        lambda: ntt.ntt_radix(x, dom.stw_fwd, 0, 0, False),  # r = 0
        lambda: ntt.ntt_radix(x, dom.stw_fwd, 0, 5, False),  # r past 4
        lambda: ntt.ntt_radix(x, dom.stw_fwd, 2, 3, False),  # low + r > log n
        lambda: ntt.ntt_radix(x, dom.stw_fwd, -1, 2, False),  # low < 0
        lambda: ntt.ntt_radix(x, dom.stw_fwd[:, :8], 0, 2, False),  # table
        lambda: ntt.ntt_radix(x, dom.stw_fwd, 0, 2, True, dom.tw_inv),  # (8, n) scale
        lambda: ntt.ntt_radix(x, dom.stw_fwd, 0, 2, False, dom.n_inv_mont),  # forward scale
        lambda: ntt.ntt_radix_n(xn, dom_n.stw_fwd, 0, 4, False, fr),  # r past 3 at 12 words
        lambda: ntt.ntt_radix_n(xn, dom.stw_fwd, 0, 2, False, fr),  # an 8-word table
        lambda: ntt.ntt_radix_n(x, dom_n.stw_fwd, 0, 2, False, fr),  # an 8-word x
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} did not raise")
    meta = torch.empty((1, 8, 16), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        ntt.ntt_radix(meta, dom.stw_fwd, 0, 2, False)
    assert {"ntt_radix", "ntt_radix_n", "ntt_stage", "ntt_stage_n"} <= set(kernels.counts())
    assert kernels.NTT_RADIX.entry == "snark_ntt_radix"
    assert kernels.NTT_RADIX_N.entry == "snark_ntt_radix_n"
    with pytest.raises(ntt.InvalidArgument):
        ntt._k14_field(lb.FR_SPEC, "ntt_radix_n")
