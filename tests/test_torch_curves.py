"""The other curves (bls12-377, bls12-381, bw6-761) in the port, on the CPU,
against the JAX package: the parameter copies, K12's plain versions at 8,
12 and 24 words (the five new moduli), the Fq2 product with each bls12
non-residue, the limb conversions at every width, the kernels' constants
(csrc/field_n.cuh, csrc/curve_n.cuh), the NTT over each Fr (K14's plain
stages) and the host pairing copy (inv, div and the reductions over these
fields: tests/test_torch_vec_ops_curves.py). Inputs are seeded numpy
values; field values compare as canonical integers."""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curves import device as jcdev
from icicle_snark_tpu.curves import pairing as jpairing
from icicle_snark_tpu.curves import params as jparams
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu_torch.config import NTTConfig
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.curves import host, pairing, params
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import ntt, vec_ops

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CURVES = ("bls12_377", "bls12_381", "bw6_761")
CSRC = Path(__file__).resolve().parents[1] / "icicle_snark_tpu_torch" / "csrc"
N = 32


def _fields():
    """The five new fields as (port spec, JAX spec), in the order of K12's
    selector (curves/device.py KERNEL_FIELDS)."""
    out = []
    for c, f in cdev.KERNEL_FIELDS:
        spec = cdev.curve_specs(c)[0 if f == "q" else 1]
        out.append((spec, jlb.FieldSpec(modulus=spec.modulus, name=spec.name)))
    return out


FIELDS = _fields()
FIELD_IDS = [s.name for s, _ in FIELDS]


def _vals(rng, p: int, n: int = N) -> list:
    """Canonical values < p with 0, 1 and p - 1 up front."""
    nbytes = (p.bit_length() + 7) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


@pytest.mark.parametrize("name", params.CURVE_NAMES)
def test_params_equal_jax(name):
    mine, theirs = params.get_curve(name), jparams.get_curve(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.root_tower() == theirs.root_tower()


@pytest.mark.parametrize("field", range(len(FIELDS)), ids=FIELD_IDS)
def test_spec_radix_equals_jax(field):
    spec, jspec = FIELDS[field]
    assert spec.field_id == field and not spec.bn254
    assert 2 * spec.words == jspec.nlimb and 32 * spec.words == jspec.radix_bits
    assert (spec.r_mod, spec.rinv) == (jspec.r_mod, jspec.rinv)
    assert 2 * spec.modulus < 1 << (32 * spec.words)


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod", "neg_mod"])
@pytest.mark.parametrize("field", range(len(FIELDS)), ids=FIELD_IDS)
def test_field_op_plain_matches_jax(field, op):
    spec, jspec = FIELDS[field]
    rng = np.random.default_rng(100 + field)
    a, b = _vals(rng, spec.modulus), _vals(rng, spec.modulus)[::-1]
    ta = lb.ints_to_limbs(a, words=spec.words)
    tb = lb.ints_to_limbs(b, words=spec.words)
    ja = jnp.asarray(jlb.ints_to_limbs_np(a, jspec.nlimb))
    jb = jnp.asarray(jlb.ints_to_limbs_np(b, jspec.nlimb))
    if op == "neg_mod":
        got, want = lb.neg_mod(ta, spec), jlb.neg_mod(ja, jspec)
    else:
        got, want = getattr(lb, op)(ta, tb, spec), getattr(jlb, op)(ja, jb, jspec)
    assert lb.limbs_to_ints(got) == jlb.limbs_to_ints_np(np.asarray(want))
    # the kernels' layout is the JAX one regrouped
    assert np.array_equal(lb.from_jax_limbs(np.asarray(want)), got.numpy())


@pytest.mark.parametrize("name", ["bls12_377", "bls12_381"])
def test_fq2_mul_many_matches_jax(name):
    fq = cdev.curve_specs(name)[0]
    ops, jops = cdev.g2_ops(name, plain=True), jcdev.g2_ops(name)
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(2):
        x, y = (np.stack([lb.ints_to_limbs(_vals(rng, fq.modulus, 8), words=12).numpy()
                          for _ in range(2)]) for _ in range(2))
        pairs.append((x, y))
    got = ops.mul_many([(torch.from_numpy(x), torch.from_numpy(y)) for x, y in pairs])
    want = jops.mul_many([(jnp.asarray(lb.to_jax_limbs(x, fq2=True)),
                           jnp.asarray(lb.to_jax_limbs(y, fq2=True))) for x, y in pairs])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), lb.from_jax_limbs(np.asarray(w), fq2=True))
    # b3 through the same product equals the JAX table's constant times x
    x = torch.from_numpy(pairs[0][0])
    b3 = jops.b3((1,))
    want_b3 = jops.mul(jnp.broadcast_to(b3, (jops.spec.nlimb, 2, 8)),
                       jnp.asarray(lb.to_jax_limbs(pairs[0][0], fq2=True)))
    assert np.array_equal(ops.mul_b3(x).numpy(), lb.from_jax_limbs(np.asarray(want_b3), fq2=True))


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_mul_b3_matches_host(name, g2):
    """The b3 multiplication of every group's table (chains, products)
    against 3 b on the host, in Montgomery form."""
    p = params.get_curve(name)
    ops = cdev.g2_ops(name, plain=True) if g2 else cdev.g1_ops(name, plain=True)
    hc = host.g2_curve(p) if g2 else host.g1_curve(p)
    rng = np.random.default_rng(3)
    vals = _vals(rng, p.q, 8)
    q, r, rinv, w = p.q, ops.spec.r_mod, ops.spec.rinv, ops.spec.words
    if ops.g2:
        xs = list(zip(vals, vals[::-1]))
        x = torch.stack([lb.ints_to_limbs([v[i] * r % q for v in xs], words=w) for i in range(2)])
        got = ops.mul_b3(x)
        comps = [[v * rinv % q for v in lb.limbs_to_ints(got[i])] for i in range(2)]
        assert list(zip(*comps)) == [hc.f.mul(hc.b3, v) for v in xs]
    else:
        got = ops.mul_b3(lb.ints_to_limbs([v * r % q for v in vals], words=w))
        assert [v * rinv % q for v in lb.limbs_to_ints(got)] == [hc.b3 * v % q for v in vals]


@pytest.mark.parametrize("words", [12, 24])
def test_jax_limb_round_trips(words):
    rng = np.random.default_rng(words)
    t = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(words, 5), dtype=np.int64)
                         .astype(np.int32))
    j = lb.to_jax_limbs(t)
    assert j.shape == (2 * words, 5) and int(j.max()) < 1 << 16
    assert np.array_equal(lb.from_jax_limbs(j), t.numpy())
    vals = [int(v) for v in lb.limbs_to_ints(t)]
    assert jlb.limbs_to_ints_np(j) == vals
    assert lb.limbs_to_ints(lb.ints_to_limbs(vals, words=words)) == vals


def test_jax_fq2_layout_round_trip():
    """The port's (2, words, n) Fq2 against the JAX (nlimb, 2, n) of
    curves/device.py affine_to_device, on points of bls12-381 G2."""
    p = params.get_curve("bls12_381")
    hc = host.g2_curve(p)
    pts = [hc.to_affine(hc.mul_scalar(hc.from_affine(p.g2), k)) for k in (2, 3, 5)] + [None]
    jx, jy = jcdev.affine_to_device(pts, jcdev.g2_ops("bls12_381"))
    x, y = cdev.affine_to_device(pts, cdev.g2_ops("bls12_381"), "cpu")
    assert x.shape == (2, 12, 4)
    for mine, theirs in ((x, jx), (y, jy)):
        assert np.array_equal(lb.from_jax_limbs(np.asarray(theirs), fq2=True), mine.numpy())
        assert np.array_equal(lb.to_jax_limbs(mine, fq2=True), np.asarray(theirs))


def _header_words(text: str, struct: str, fn: str) -> int:
    """The integer a traits struct's p(i) / one(i) switch spells."""
    body = text.split(f"struct {struct} {{")[1].split("};")[0]
    sw = body.split(f"u32 {fn}(int i)")[1].split("}\n  }")[0]
    words = [int(h, 16) for h in re.findall(r"return 0x([0-9a-f]+)u;", sw)]
    return sum(w << (32 * k) for k, w in enumerate(words)), len(words)


@pytest.mark.parametrize("field", range(len(FIELDS)), ids=FIELD_IDS)
def test_kernel_field_constants(field):
    """csrc/field_n.cuh's traits, in K12's field order, against the specs."""
    spec = FIELDS[field][0]
    text = (CSRC / "field_n.cuh").read_text()
    struct = re.findall(r"^struct (\w+) \{\n  static constexpr int N", text, re.M)[field]
    p, n = _header_words(text, struct, "p")
    one, _ = _header_words(text, struct, "one")
    n0 = int(re.search(r"N0 = 0x([0-9a-f]+)u", text.split(f"struct {struct} {{")[1]).group(1), 16)
    assert (p, n, one, n0) == (spec.modulus, spec.words, spec.r_mod, spec.n0inv)
    assert f"static constexpr int N = {spec.words};" in text.split(f"struct {struct} {{")[1]


def test_kernel_bls12_377_b3_constant():
    """curve_n.cuh's Montgomery 3 * b2.c1 of bls12-377's G2 (b2.c0 = 0)."""
    p = params.get_curve("bls12_377")
    spec = cdev.curve_specs("bls12_377")[0]
    text = (CSRC / "curve_n.cuh").read_text()
    words = re.search(r"const u32 C\[12\] = \{([^}]*)\}", text).group(1)
    c = sum(int(h, 16) << (32 * k) for k, h in enumerate(re.findall(r"0x([0-9a-f]+)u", words)))
    assert p.g2_b[0] == 0 and c == 3 * p.g2_b[1] * spec.r_mod % p.q


def _fr_limbs(fr, vals):
    return lb.ints_to_limbs([v * fr.r_mod % fr.modulus for v in vals], words=fr.words)


def _fr_ints(fr, t):
    return [v * fr.rinv % fr.modulus for v in lb.limbs_to_ints(t)]


def test_ntt_bls12_377_matches_jax():
    """NTTDomain(spec, root_tower) + ntt_natural against the JAX package's,
    as tests/test_curves.py test_ntt_roundtrip_and_dft drives it."""
    p = params.get_curve("bls12_377")
    fr = cdev.curve_specs("bls12_377")[1]
    jfr = jcdev.curve_specs("bls12_377")[1]
    dom = ntt.NTTDomain(4, "cpu", fr, p.root_tower())
    jdom = jntt.get_domain(4, jfr, p.root_tower())
    vals = _vals(np.random.default_rng(5), fr.modulus, 16)
    x = _fr_limbs(fr, vals)
    jx = jnp.asarray(lb.to_jax_limbs(x))[:, None, :]
    for inverse in (False, True):
        got = ntt.ntt_natural(x[None], dom, inverse=inverse)[0]
        want = jntt.ntt_natural(jx, jdom, inverse=inverse)[:, 0, :]
        assert np.array_equal(lb.from_jax_limbs(np.asarray(want)), got.numpy())


@pytest.mark.parametrize("name", CURVES)
def test_ntt_matches_host_dft(name):
    fr = cdev.curve_specs(name)[1]
    dom = ntt.get_domain(4, "cpu", fr)
    assert dom.w == params.get_curve(name).root_tower()[4]
    vals = _vals(np.random.default_rng(6), fr.modulus, 16)
    y = ntt.ntt_natural(_fr_limbs(fr, vals)[None], dom)[0]
    want = [sum(vals[j] * pow(dom.w, i * j, fr.modulus) for j in range(16)) % fr.modulus
            for i in range(16)]
    assert _fr_ints(fr, y) == want
    z = ntt.ntt_natural(y[None], dom, inverse=True)[0]
    assert _fr_ints(fr, z) == vals


@pytest.mark.parametrize("name", CURVES)
def test_ntt_api_with_coset(name):
    """ntt(spec=fr) with a coset evaluates on g<w> (the powers g^i times the
    input, then the transform), and the inverse coset NTT undoes it."""
    fr = cdev.curve_specs(name)[1]
    g = 7
    vals = _vals(np.random.default_rng(8), fr.modulus, 8)
    x = _fr_limbs(fr, vals)
    cfg = NTTConfig(coset_gen=g)
    y = ntt.ntt(x, cfg=cfg, spec=fr)
    w = ntt.get_root_of_unity(3, params.get_curve(name).root_tower())
    want = [sum(vals[j] * pow(g * pow(w, i, fr.modulus), j, fr.modulus) for j in range(8))
            % fr.modulus for i in range(8)]
    assert _fr_ints(fr, y) == want
    assert torch.equal(ntt.ntt(y, inverse=True, cfg=cfg, spec=fr), x)


@pytest.mark.parametrize("name", CURVES)
def test_ntt_stage_n_plain_matches_stage_plain(name):
    """K14's plain stage (stage-major twiddles) equals the K3-style plain
    stage over the power table, stage by stage, both directions."""
    fr = cdev.curve_specs(name)[1]
    dom = ntt.get_domain(5, "cpu", fr)
    x = _fr_limbs(fr, _vals(np.random.default_rng(9), fr.modulus, 32))[None]
    for s in range(1, 6):
        m = 1 << s
        for inverse, stw, tw in ((False, dom.stw_fwd, dom.tw_fwd), (True, dom.stw_inv, dom.tw_inv)):
            a = ntt.ntt_stage_n_plain(x, stw, m, inverse, fr)
            b = ntt._butterflies_plain(x, tw[:, : (m // 2) * (32 // m): 32 // m], m, inverse,
                                       None, fr)
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["bls12_381", "bls12_377"])
def test_pairing_copy_matches_jax(name):
    """The port's host pairing against the JAX copy on one pair, and its
    bilinearity, as tests/test_bls12_pairing.py."""
    p = params.get_curve(name)
    g1c, g2c = host.g1_curve(p), host.g2_curve(p)
    aP = g1c.to_affine(g1c.mul_scalar(g1c.from_affine(p.g1), 5))
    bQ = g2c.to_affine(g2c.mul_scalar(g2c.from_affine(p.g2), 7))
    pr = pairing.get_pairing(name)
    e = pr.pairing(aP, bQ)
    assert pr.fp12.eq(e, jpairing.get_pairing(name).pairing(aP, bQ))
    assert pr.fp12.eq(e, pr.fp12.pow(pr.pairing(p.g1, p.g2), 35))


def test_vec_ops_on_other_fields():
    """The elementwise vec-ops take any spec: a bw6-761 Fq vector."""
    fq = cdev.curve_specs("bw6_761")[0]
    vals = _vals(np.random.default_rng(12), fq.modulus, 6)
    x = lb.ints_to_limbs([v * fq.r_mod % fq.modulus for v in vals], words=24)
    s = lb.ints_to_limbs([5 * fq.r_mod % fq.modulus], words=24)[:, 0]

    def ints(t):
        return [v * fq.rinv % fq.modulus for v in lb.limbs_to_ints(t)]

    assert ints(vec_ops.mul(x, x, fq)) == [v * v % fq.modulus for v in vals]
    assert ints(vec_ops.scalar_sub(s, x, fq)) == [(5 - v) % fq.modulus for v in vals]
    assert ints(vec_ops.from_mont(vec_ops.to_mont(x, fq), fq)) == ints(x)
