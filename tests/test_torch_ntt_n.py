"""K14's passes over the other curves' Fr (ops/ntt.py `ntt_block_n`, its
plain version on the CPU), against the JAX package: `ntt_dit` and
`intt_dif` over bls12-377 Fr, bls12-381 Fr and the bw6-761 Fr at 2^6 - 2^8,
batch 2, on forced small tiles (several passes a transform), held against
icicle_snark_tpu.ops.ntt.ntt_dit / intt_dif on JAX CPU, with the 1/n and
with a (words, n) scale; every `block_passes` split against the plain
stages; and the lazy-value bound of csrc/field_n.cuh's LAZY flag on Python
integers: a word model of the lazy product, sum and difference at the
fields' word counts, and bls12-381 Fr failing 4r < 2^256. Seeded numpy
inputs; tolerance: equal integers."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curves import device as jcdev
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu_torch import kernels
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.curves import params
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import ntt

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CURVES = ("bls12_377", "bls12_381", "bw6_761")
CSRC = Path(__file__).resolve().parents[1] / "icicle_snark_tpu_torch" / "csrc"
MASK = (1 << 32) - 1


def _field(rng, spec, shape) -> torch.Tensor:
    """(..., words, n) canonical values with 0, 1 and p - 1 up front."""
    *lead, n = shape
    count = int(np.prod(lead, dtype=np.int64)) * n
    nbytes = (spec.modulus.bit_length() + 7) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % spec.modulus for _ in range(count)]
    vals[:3] = [0, 1, spec.modulus - 1]
    t = lb.ints_to_limbs(vals, "cpu", spec.words)
    return t.reshape(spec.words, *lead, n).movedim(0, -2).contiguous()


def _to_jax(x: torch.Tensor):
    """The port's (B, words, n) -> JAX (nlimb, B, n)."""
    return jnp.asarray(lb.to_jax_limbs(x.movedim(0, 1).contiguous()))


def _from_jax(a) -> torch.Tensor:
    return torch.from_numpy(lb.from_jax_limbs(np.asarray(a))).movedim(1, 0).contiguous()


@pytest.fixture
def small_tile(monkeypatch):
    """Tiles of 2^3 elements at every width: a transform of 2^6 - 2^8 takes
    three or four passes, the strided ones of two columns."""
    monkeypatch.setattr(ntt, "NTT_N_TILE_LOG", 3)
    monkeypatch.setattr(ntt, "NTT_BLOCK_MIN_LOG", 3)


def _spied(monkeypatch):
    """Count the tile pass, register pass and one-stage wrapper calls (the
    CPU runs their plain versions)."""
    calls = {"block": 0, "stage": 0, "radix": 0}
    wrapped = {"block": ntt.ntt_block_n, "stage": ntt.ntt_stage_n, "radix": ntt.ntt_radix_n}

    def spy(key):
        def call(*a, **kw):
            calls[key] += 1
            return wrapped[key](*a, **kw)
        return call

    for key, name in (("block", "ntt_block_n"), ("stage", "ntt_stage_n"),
                      ("radix", "ntt_radix_n")):
        monkeypatch.setattr(ntt, name, spy(key))
    return calls


# one size a field, 2^6 - 2^8 over the three
JAX_CASES = [("bls12_377", 8), ("bls12_381", 7), ("bw6_761", 6)]


@pytest.mark.parametrize("name,log_n", JAX_CASES)
def test_pass_route_equals_jax(name, log_n, small_tile, monkeypatch):
    """ntt_dit and intt_dif through K14's passes equal the JAX package's on
    the same (2, words, 2^log_n) batch; the inverse with a (words, n) scale
    equals the JAX intt_dif without 1/n times the table. The JAX functions
    run under jax.jit (the same graph as eagerly, compiled once)."""
    fr = cdev.curve_specs(name)[1]
    jfr = jcdev.curve_specs(name)[1]
    tower = params.get_curve(name).root_tower()
    rng = np.random.default_rng(300 + log_n)
    dom = ntt.NTTDomain(log_n, "cpu", fr)
    jdom = jntt.NTTDomain(log_n, jfr, tower)
    x = _field(rng, fr, (2, dom.n))
    table = _field(rng, fr, (dom.n,))
    calls = _spied(monkeypatch)
    passes = len(ntt.ntt_n_passes(log_n))
    assert passes >= 3
    jx = _to_jax(x)
    dit = jax.jit(lambda v, tw: jntt.ntt_dit(v, tw, jfr))
    dif = jax.jit(lambda v, tw, s: jntt.intt_dif(v, tw, s, jfr))
    assert torch.equal(ntt.ntt_dit(x, dom), _from_jax(dit(jx, jdom.tw_fwd)))
    assert torch.equal(ntt.intt_dif(x, dom), _from_jax(dif(jx, jdom.tw_inv, jdom.n_inv_mont)))
    y = x.clone()
    ntt._inverse_(y, dom, table)
    one = jnp.asarray(lb.to_jax_limbs(lb.one_mont(fr, "cpu")))[:, :, None]
    want = jlb.mont_mul(dif(jx, jdom.tw_inv, one),
                        jnp.asarray(lb.to_jax_limbs(table))[:, None, :], jfr)
    assert torch.equal(y, _from_jax(want))
    assert calls == {"block": 3 * passes, "stage": 0, "radix": 0}


@pytest.mark.parametrize("name", CURVES)
def test_below_block_min_log_runs_stages(name, monkeypatch):
    """Below NTT_BLOCK_MIN_LOG the transform is the register passes
    (`ntt_radix_n`, NTT_RADIX_LOG stages a launch, here 3; no one-stage
    launch), and
    both routes give the same words (patching the constant past the domain
    forces the register passes, as the chip script does)."""
    fr = cdev.curve_specs(name)[1]
    dom = ntt.NTTDomain(5, "cpu", fr)
    x = _field(np.random.default_rng(320), fr, (2, dom.n))
    passes_f, passes_i = ntt.ntt_dit(x, dom), ntt.intt_dif(x, dom)
    calls = _spied(monkeypatch)
    monkeypatch.setattr(ntt, "NTT_BLOCK_MIN_LOG", 99)
    monkeypatch.setitem(ntt.NTT_RADIX_LOG, fr.words, 3)
    assert torch.equal(ntt.ntt_dit(x, dom), passes_f)
    assert torch.equal(ntt.intt_dif(x, dom), passes_i)
    assert calls == {"block": 0, "stage": 0, "radix": 4}  # passes (0, 3), (3, 2) each way


@pytest.mark.parametrize("tile_log", [1, 2, 3, 4, 10])
@pytest.mark.parametrize("name", CURVES)
def test_block_plain_equals_stages_for_every_split(name, tile_log):
    """ntt_block_n_plain over the passes of `block_passes` at 2^3 - 2^9 (at
    the fields' fewest columns) equals the plain stages one by one, forward
    and inverse, the inverse's low = 0 pass scaled by 1/n."""
    fr = cdev.curve_specs(name)[1]
    for log_n in range(3, 10):
        dom = ntt.get_domain(log_n, "cpu", fr)
        x = _field(np.random.default_rng(340 + log_n), fr, (1, dom.n))
        passes = ntt.block_passes(log_n, tile_log, ntt.NTT_N_TILE_MIN_COLS_LOG)
        assert [s for low, k, _ in passes for s in range(low, low + k)] == list(range(log_n))
        f_pass, f_stage = x, x
        for low, k, _ in passes:
            f_pass = ntt.ntt_block_n_plain(f_pass, dom.stw_fwd, low, k, False, fr)
        for s in range(1, log_n + 1):
            f_stage = ntt.ntt_stage_n_plain(f_stage, dom.stw_fwd, 1 << s, False, fr)
        assert torch.equal(f_pass, f_stage)
        i_pass, i_stage = x, x
        for low, k, _ in reversed(passes):
            i_pass = ntt.ntt_block_n_plain(i_pass, dom.stw_inv, low, k, True, fr,
                                           dom.n_inv_mont if low == 0 else None)
        for s in range(log_n, 0, -1):
            i_stage = ntt.ntt_stage_n_plain(i_stage, dom.stw_inv, 1 << s, True, fr,
                                            dom.n_inv_mont if s == 1 else None)
        assert torch.equal(i_pass, i_stage)


@pytest.mark.parametrize("words", [8, 12])
def test_transform_at_2_22_is_three_passes(words):
    """At the default tiles a transform of 2^22 is three passes, their
    strided tiles at least 2^NTT_N_TILE_MIN_COLS_LOG columns wide, and each
    tile with its twiddles fits a block's 227 KB of shared memory."""
    spec = cdev.curve_specs("bw6_761" if words == 12 else "bls12_377")[1]
    assert spec.words == words
    passes = ntt.ntt_n_passes(22)
    assert len(passes) == 3
    assert all(t >= ntt.NTT_N_TILE_MIN_COLS_LOG for _, _, t in passes[1:])
    assert all(8 * words << (k + t) <= 227 * 1024 for _, k, t in passes)


def test_wrapper_checks():
    """Shapes, the scale's pass and the field are checked before any launch;
    the kernel is registered for the chip script's rows and counts."""
    fr = cdev.curve_specs("bls12_377")[1]
    dom = ntt.get_domain(4, "cpu", fr)
    x = _field(np.random.default_rng(360), fr, (1, 16))
    with pytest.raises(ValueError):
        ntt.ntt_block_n(x, dom.stw_fwd, 2, 3, 0, False, fr)  # low + k > log_n
    with pytest.raises(ValueError):
        ntt.ntt_block_n(x, dom.stw_fwd, 2, 2, 3, False, fr)  # tcols_log > low
    with pytest.raises(ValueError):
        ntt.ntt_block_n(x, dom.stw_fwd, 0, 4, 0, False, fr, dom.n_inv_mont)  # forward scale
    with pytest.raises(ValueError):
        ntt.ntt_block_n(x[:, :4].contiguous(), dom.stw_fwd, 0, 4, 0, False, fr)
    assert "ntt_block_n" in kernels.counts()
    with pytest.raises(ntt.InvalidArgument):
        ntt._k14_field(lb.FR_SPEC, "ntt_block_n")


# ---------------------------------------------------------------- the lazy flag

def _header_lazy() -> dict:
    """csrc/field_n.cuh's LAZY flag by traits struct."""
    text = (CSRC / "field_n.cuh").read_text()
    return {m.group(1): m.group(2) == "true" for m in re.finditer(
        r"^struct (\w+) \{\n(?:  .*\n)*?  static constexpr bool LAZY = (true|false);", text,
        re.M)}


def _specs() -> dict:
    """The five fields of csrc/field_n.cuh by its struct names."""
    structs = ("Bls377Fr", "Bls377Fq", "Bls381Fr", "Bls381Fq", "Bw6Fq")
    return {s: cdev.curve_specs(c)[0 if f == "q" else 1]
            for s, (c, f) in zip(structs, cdev.KERNEL_FIELDS)}


def test_lazy_flag_is_the_bound():
    """LAZY is set exactly where 4p < 2^(32 N), and `block_n_lazy` agrees;
    bls12-381 Fr (r > 2^254.8) alone fails it and stays canonical."""
    flags, specs = _header_lazy(), _specs()
    assert set(flags) == set(specs)
    for name, spec in specs.items():
        assert flags[name] == (4 * spec.modulus < 1 << (32 * spec.words)), name
        assert ntt.block_n_lazy(spec) == flags[name]
    r381 = specs["Bls381Fr"].modulus
    assert 4 * r381 >= 1 << 256 and 2 * r381 < 1 << 256
    assert not flags["Bls381Fr"] and sum(flags.values()) == 4


def _words(v: int, n: int) -> list:
    return [(v >> (32 * i)) & MASK for i in range(n)]


def lz_mul(a: int, b: int, p: int, n: int) -> int:
    """nb_mul's lazy product: field_n.cuh's CIOS rounds (nmont_rounds) word
    by word, no final subtraction; asserts the carry word t[N] ends 0."""
    aw, bw, pw, t = _words(a, n), _words(b, n), _words(p, n), [0] * (n + 2)
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    for i in range(n):
        c = 0
        for j in range(n):
            s = aw[j] * bw[i] + t[j] + c
            t[j], c = s & MASK, s >> 32
        s = t[n] + c
        t[n], t[n + 1] = s & MASK, s >> 32
        m = (t[0] * n0) & MASK
        s = m * pw[0] + t[0]
        assert s & MASK == 0
        c = s >> 32
        for j in range(1, n):
            s = m * pw[j] + t[j] + c
            t[j - 1], c = s & MASK, s >> 32
        s = t[n] + c
        t[n - 1] = s & MASK
        t[n] = t[n + 1] + (s >> 32)
    assert t[n] == 0
    return sum(w << (32 * i) for i, w in enumerate(t[:n]))


def lz_add(a: int, b: int, p: int, n: int) -> int:
    s = a + b
    assert s < 1 << (32 * n)  # no carry out of the N words
    return s - 2 * p if s >= 2 * p else s


def lz_sub(a: int, b: int, p: int, n: int) -> int:
    d = a - b
    return d + 2 * p if d < 0 else d


@pytest.mark.parametrize("struct", ["Bls377Fr", "Bls377Fq"])
def test_lazy_steps_hold_their_bound(struct):
    """For the two lazy Fr (K14's fields 0 and 1), each lazy step on
    operands in [0, 2p), 2p - 1 among them, stays below 2p and has the
    canonical step's residue; a butterfly chain of them stays there."""
    spec = _specs()[struct]
    p, n = spec.modulus, spec.words
    rinv = pow(1 << (32 * n), -1, p)
    rng = np.random.default_rng(380)
    edges = [0, 1, p - 1, p, p + 1, 2 * p - 2, 2 * p - 1]
    vals = edges + [int.from_bytes(rng.bytes(4 * n), "little") % (2 * p) for _ in range(30)]
    for a in vals:
        for b in edges + vals[-5:]:
            m, s, d = lz_mul(a, b, p, n), lz_add(a, b, p, n), lz_sub(a, b, p, n)
            assert m < 2 * p and m % p == a * b * rinv % p
            assert s < 2 * p and s % p == (a + b) % p
            assert d < 2 * p and d % p == (a - b) % p
    u, v = 2 * p - 1, 2 * p - 2
    for w in vals[:10]:
        w %= p  # twiddles are canonical
        vw = lz_mul(v, w, p, n)
        u, v = lz_add(u, vw, p, n), lz_sub(u, vw, p, n)
        assert u < 2 * p and v < 2 * p


def test_bls12_381_fr_lazy_sum_would_overflow():
    """Why bls12-381 Fr takes the canonical path: two values just below 2r
    sum past 2^256, so the lazy sum's N words cannot hold it."""
    r = _specs()["Bls381Fr"].modulus
    with pytest.raises(AssertionError):
        lz_add(2 * r - 1, 2 * r - 1, r, 8)
