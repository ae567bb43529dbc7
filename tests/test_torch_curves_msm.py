"""The other curves' MSM in the port (K13's plain versions on the CPU):
`curves/device.py` `msm` against the host oracle (curves/host.py) at
tests/test_curves.py's inputs for all three curves (and BN254) and both
groups, the signed window digits of every scalar field at c = 8, 13 and
16, and the window sums against the JAX package's eager
`msm_device_grouped` (bls12-381 G1 here; the other groups in
tests/test_torch_curves_msm_jax*.py, split so that each file stays short).
Points compare in affine form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.curves import device as jcdev
from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.curves import host
from icicle_snark_tpu_torch.curves.params import get_curve
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CURVES = ("bls12_377", "bls12_381", "bw6_761")


def chain_inputs(name: str, g2: bool):
    """tests/test_curves.py's inputs: G, 2G, ... with random scalars; G1: 8
    points with an infinity (lane 3) and a zero scalar (lane 5); G2: 6."""
    p = get_curve(name)
    hc = host.g2_curve(p) if g2 else host.g1_curve(p)
    gen = hc.from_affine(p.g2 if g2 else p.g1)
    rng = np.random.default_rng(3 if g2 else 2)
    pts, scs, cur = [], [], gen
    for _ in range(6 if g2 else 8):
        pts.append(hc.to_affine(cur))
        scs.append(int(rng.integers(0, 1 << (30 if g2 else 40))))
        cur = hc.add(cur, gen)
    if not g2:
        pts[3] = None
        scs[5] = 0
    return hc, pts, scs


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("name", CURVES + ("bn254",))
def test_msm_matches_host_oracle(name, g2):
    """`msm` over the curve's K13 groups; "bn254" maps onto K4's."""
    hc, pts, scs = chain_inputs(name, g2)
    got = cdev.msm(name, scs, pts, g2=g2, c=8, k=8, device="cpu")
    assert hc.to_affine(got) == hc.to_affine(hc.msm(scs, pts))


@pytest.mark.parametrize("c", [8, 13, 16])
@pytest.mark.parametrize("name", CURVES)
def test_signed_digits_keep_the_top_carry(name, c):
    """No carry leaves the top window for scalars below r: the signed digits
    of r - 1, of r - 1 with every window at its largest, and of random
    scalars sum back to the scalar, each |digit| <= 2^(c-1); and the top
    window, plus the carry it can receive, stays below 2^(c-1)."""
    p = get_curve(name)
    fr = cdev.curve_specs(name)[1]
    bits = 32 * fr.words
    windows = -(-bits // c)
    assert (((p.r - 1) >> (c * (windows - 1))) + 1) <= 1 << (c - 1)
    rng = np.random.default_rng(c)
    nbytes = (p.r.bit_length() + 7) // 8
    top = c * (windows - 1)
    big = ((1 << top) - 1) | (((p.r - 1) >> top) << top)
    scalars = [p.r - 1, min(big, p.r - 1), 0, 1] + [
        int.from_bytes(rng.bytes(nbytes), "little") % p.r for _ in range(12)]
    digits, neg = msm.window_digits_signed(lb.ints_to_limbs(scalars, words=fr.words), c)
    assert digits.shape == (windows, len(scalars))
    assert int(digits.max()) <= 1 << (c - 1)
    signed = torch.where(neg, -digits, digits)
    back = [sum(int(signed[w, i]) << (c * w) for w in range(windows)) for i in range(len(scalars))]
    assert back == scalars


def window_sums_match_jax(name: str, g2: bool):
    """The port's window sums (c = 8, K13's plain versions) against the JAX
    package's eager `msm_device_grouped` over the curve's tables, window by
    window in affine form; then both Horner sums against the host oracle."""
    hc, pts, scs = chain_inputs(name, g2)
    p = get_curve(name)
    fr = cdev.curve_specs(name)[1]
    grp = cdev.g2_group(name) if g2 else cdev.g1_group(name)
    sc = lb.ints_to_limbs([s % p.r for s in scs], words=fr.words)
    rec = msm.point_records(cdev.affine_to_device(pts, grp.ops, "cpu"))
    mine = cdev.window_points_to_host(msm.msm_window_sums(sc, [len(scs)], rec, 8, group=grp),
                                      grp.ops)
    jops = jcdev.g2_ops(name) if g2 else jcdev.g1_ops(name)
    jsc = jnp.asarray(jlb.ints_to_limbs_np([s % p.r for s in scs], 2 * fr.words))
    jws = jmsm.msm_device_grouped([jsc], [jcdev.affine_to_device(pts, jops)], jops, c=8, k=8)
    theirs = jcdev.window_points_to_host(jws, jops)
    assert len(mine) == len(theirs) == -(-32 * fr.words // 8)
    assert [hc.to_affine(a) for a in mine] == [hc.to_affine(b) for b in theirs]
    acc = hc.zero_pt
    for wp in reversed(mine):
        for _ in range(8):
            acc = hc.dbl(acc)
        acc = hc.add(acc, wp)
    assert hc.to_affine(acc) == hc.to_affine(hc.msm(scs, pts))


def test_window_sums_match_jax_bls12_381_g1():
    window_sums_match_jax("bls12_381", False)
