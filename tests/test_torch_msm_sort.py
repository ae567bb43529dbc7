"""K19, the MSM's bucket sort (`ops/msm.py` `sort_windows`, `window_pairs`,
`sort_pairs`): on the CPU its plain path gives (order, negs, ends) equal to
the formulation it replaced (int64 keys group * (H + 1) + |digit|,
torch.sort of each window), over BN254's G1 and G2 groups, window sizes,
a precompute factor, the sliced route's group ids with sentinel lanes,
the other curves' 8- and 12-word scalars and a bit-valued witness; the
per-window path, forced by a small `max_bits`, gives the same; the
counters of `msm.sort`. On the card (marked `chip`): K19's two launches
against that formulation and against their plain versions at
complex-1600k's G1 width (6 897 159 lanes, c = 16) and a G2 width."""

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch import trace
from icicle_snark_tpu_torch.curves import device as cdev
from icicle_snark_tpu_torch.curves.params import get_curve
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm
from icicle_snark_tpu_torch.refmath.field import R_MOD as FR

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def replaced_sort_windows(scalars, groups_of, c: int, precompute: int = 1):
    """The formulation sort_windows replaced, as it stood: int64 keys, one
    stable torch.sort a window, int64 order cast to int32, the signs
    gathered, the bucket ends by searchsorted of each sorted row."""
    half = 1 << (c - 1)
    dev = scalars.device
    if isinstance(groups_of, tuple):
        gid, groups = groups_of
        gid = gid.to(device=dev, dtype=torch.int64)
    else:
        groups = len(groups_of)
        gid = torch.repeat_interleave(
            torch.arange(groups, device=dev), torch.tensor(list(groups_of), device=dev))
    digits, neg = msm.window_digits_signed(scalars, c)
    if precompute > 1:
        digits = msm.merge_digit_windows(digits, precompute, 0)
        neg = msm.merge_digit_windows(neg, precompute, False)
        gid = torch.repeat_interleave(gid, precompute)
    keys = gid * (half + 1) + digits
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    negs = torch.gather(neg, 1, order)
    probes = torch.arange(groups * (half + 1), device=dev).expand(keys.shape[0], -1)
    ends = torch.searchsorted(sorted_keys, probes.contiguous(), right=True)
    return order.to(torch.int32), negs, ends.to(torch.int32)


def uniform(rng, n: int, modulus: int = FR, words: int = 8) -> torch.Tensor:
    nbytes = (modulus.bit_length() + 7) // 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % modulus for _ in range(n)]
    vals[:3] = [0, 1, modulus - 1]
    return lb.ints_to_limbs(vals, words=words)


def bits(rng, n: int) -> torch.Tensor:
    """A bit-valued witness, as anon_aadhaar's: most scalars 0 or 1, a few
    full-width, so one bucket of window 0 holds most lanes."""
    vals = [int(b) for b in rng.integers(0, 2, size=n)]
    for i in rng.choice(n, size=max(n // 16, 1), replace=False):
        vals[int(i)] = int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 1 << 62))
    return lb.ints_to_limbs(vals)


def other_curve(name: str):
    def make(rng, n):
        fr = cdev.curve_specs(name)[1]
        return uniform(rng, n, get_curve(name).r, fr.words)
    return make


def sentinel(scalars, sizes):
    """The sliced route's form of `sizes`: per-lane ids, then four lanes of
    the sentinel group len(sizes) with zero scalars, as its padded slice."""
    gid = torch.repeat_interleave(torch.arange(len(sizes)), torch.tensor(sizes))
    pad = torch.zeros((scalars.shape[0], 4), dtype=torch.int32)
    return (torch.cat([scalars, pad], dim=-1),
            (torch.cat([gid, torch.full((4,), len(sizes))]), len(sizes)))


def forced_per_window(scalars, groups_of, c: int, pre: int):
    """`sort_windows` on its per-window path (`_sorted_pairs` at max_bits 4)."""
    if isinstance(groups_of, tuple):
        gid, groups = groups_of[0].to(device=scalars.device, dtype=torch.int32), groups_of[1]
    else:
        gid, groups = msm.group_ids(groups_of, scalars.device), len(groups_of)
    vals, ends = msm._sorted_pairs(scalars, gid, groups, c, pre, 4)
    negs = vals < 0
    return vals & 0x7FFFFFFF, negs, ends


# (id, scalars, group sizes, c, precompute factor, sliced form)
CASES = [
    ("g1_four_groups_c16", lambda r, n: uniform(r, n), [40, 31, 25, 64], 16, 1, False),
    ("g2_one_group_c16", lambda r, n: uniform(r, n), [96], 16, 1, False),
    ("g1_c8", lambda r, n: uniform(r, n), [50, 30, 20], 8, 1, False),
    ("g1_c13", lambda r, n: uniform(r, n), [70, 58], 13, 1, False),
    ("g2_c13", lambda r, n: uniform(r, n), [77], 13, 1, False),
    ("precompute_2_c13", lambda r, n: uniform(r, n), [33, 27], 13, 2, False),
    ("precompute_2_c16_one_group", lambda r, n: uniform(r, n), [45], 16, 2, False),
    ("sliced_sentinel_c13", lambda r, n: uniform(r, n), [30, 26, 20], 13, 1, True),
    ("sliced_sentinel_precompute_2", lambda r, n: uniform(r, n), [18, 22], 16, 2, True),
    ("bls12_381_8_words_c13", other_curve("bls12_381"), [40, 24], 13, 1, False),
    ("bls12_377_8_words_c16", other_curve("bls12_377"), [64], 16, 1, False),
    ("bw6_761_12_words_c13", other_curve("bw6_761"), [36, 28], 13, 1, False),
    ("bw6_761_12_words_c8", other_curve("bw6_761"), [50], 8, 1, False),
    ("bit_valued_c16", bits, [120, 80, 60, 40], 16, 1, False),
    ("bit_valued_g2_c13", bits, [150], 13, 1, False),
]


@pytest.mark.parametrize("make, sizes, c, pre, sliced",
                         [case[1:] for case in CASES], ids=[case[0] for case in CASES])
def test_sort_windows_equals_the_replaced_formulation(make, sizes, c, pre, sliced):
    rng = np.random.default_rng(sum(sizes) * 131 + c * 7 + pre)
    scalars = make(rng, sum(sizes))
    groups_of = list(sizes)
    if sliced:
        scalars, groups_of = sentinel(scalars, sizes)
    got = msm.sort_windows(scalars, groups_of, c, pre)
    want = replaced_sort_windows(scalars, groups_of, c, pre)
    for g, w, name in zip(got, want, ("order", "negs", "ends")):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    # the per-window path: each window's pairs sorted alone
    forced = forced_per_window(scalars, groups_of, c, pre)
    assert all(torch.equal(g, f) for g, f in zip(got, forced))


def test_window_pairs_hold_the_key_and_the_signed_lane():
    """K19's pairs, word for word: key = j * KR + group * (H + 1) + |digit|,
    value = lane | neg << 31, in merge_digit_windows' layout."""
    rng = np.random.default_rng(11)
    c, pre, sizes = 13, 2, [9, 7]
    half = 1 << (c - 1)
    kr = (len(sizes) + 1) * (half + 1)
    scalars = uniform(rng, sum(sizes))
    gid = msm.group_ids(sizes, "cpu")
    keys, vals = msm.window_pairs(scalars, gid * (half + 1), c, pre, kr)
    digits, neg = msm.window_digits_signed(scalars, c)
    digits = msm.merge_digit_windows(digits, pre, 0)
    neg = msm.merge_digit_windows(neg, pre, False)
    wp, total = digits.shape
    assert keys.shape == vals.shape == (wp, total) and keys.dtype == vals.dtype == torch.int32
    lane_gid = gid.to(torch.int64).repeat_interleave(pre)
    want = torch.arange(wp)[:, None] * kr + lane_gid * (half + 1) + digits
    assert torch.equal(keys.to(torch.int64), want)
    assert torch.equal(vals & 0x7FFFFFFF, torch.arange(total, dtype=torch.int32).expand(wp, -1))
    assert torch.equal(vals < 0, neg)


def test_group_ids_are_fills_of_the_sizes():
    assert msm.group_ids([2, 0, 3], "cpu").tolist() == [0, 0, 2, 2, 2]
    assert msm.group_ids([], "cpu").shape == (0,)


def test_sort_pairs_checks_its_input():
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        msm.sort_pairs(k.to(torch.int64), k, 8)
    with pytest.raises(ValueError):
        msm.sort_pairs(k, k[:3], 8)
    with pytest.raises(ValueError):
        msm.sort_pairs(k, k, 32)


def test_the_sort_counts_its_pairs_and_bits():
    """`msm.sort` counts the pairs sorted (`sort_items`) and the key bits
    walked (`sort_bits`): one sort of W * total pairs over the bits of
    W * KR, or W sorts over the bits of KR on the per-window path: 22 bits
    at c = 16 with four groups, as complex-1600k's G1."""
    rng = np.random.default_rng(13)
    scalars, sizes, c = uniform(rng, 60), [20, 15, 15, 10], 16
    windows, kr = 16, 5 * ((1 << 15) + 1)
    t = trace.PhaseTimer("cpu")
    with trace.activate(t):
        with trace.span("msm.sort"):
            msm.sort_windows(scalars, sizes, c)
        with trace.span("msm.sort"):
            forced_per_window(scalars, sizes, c, 1)
    flat, per_window = [r.counts for r in t.records if r.name == "msm.sort"]
    assert flat == {"sort_items": windows * 60, "sort_bits": (windows * kr - 1).bit_length()}
    assert flat["sort_bits"] == 22
    assert per_window == {"sort_items": windows * 60,
                          "sort_bits": windows * (kr - 1).bit_length()}


# ---------------------------------------------------------------- on the card

def _card_scalars(n: int, seed: int, dev) -> torch.Tensor:
    """(8, n) uniform words below 2^254 on the card (the digits need only that)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(0, 1 << 32, (8, n), generator=g, device=dev, dtype=torch.int64)
    w[7] &= (1 << 30) - 1
    return w.to(torch.int32)


@pytest.mark.chip
@pytest.mark.parametrize("sizes, c", [
    ([1600003, 1600003, 1600001, 2097152], 16),  # complex-1600k's G1 width
    ([1600003], 16),  # its G2 width
    ([936533], 13),  # anon_aadhaar-1536's G2 width at c = 13
], ids=["complex_g1", "complex_g2", "anon_g2_c13"])
def test_k19_equals_the_replaced_sort_on_the_card(sizes, c):
    """K19's (order, negs, ends) equal the replaced formulation's on the
    card, and its pairs equal their plain version's, at full widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from icicle_snark_tpu_torch import kernels

    dev = torch.device("cuda")
    scalars = _card_scalars(sum(sizes), sum(sizes) + c, dev)
    before = (kernels.MSM_SORT_KEYS.launches, kernels.MSM_SORT.launches)
    got = msm.sort_windows(scalars, sizes, c)
    assert (kernels.MSM_SORT_KEYS.launches, kernels.MSM_SORT.launches) == \
        (before[0] + 1, before[1] + 1)
    want = replaced_sort_windows(scalars, sizes, c)
    for g, w, name in zip(got, want, ("order", "negs", "ends")):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    del want
    half = 1 << (c - 1)
    kr = (len(sizes) + 1) * (half + 1)
    base = msm.group_ids(sizes, dev) * (half + 1)
    keys, vals = msm.window_pairs(scalars, base, c, 1, kr)
    pkeys, pvals = msm.window_pairs_plain(scalars, base, c, 1, kr)
    assert torch.equal(keys, pkeys) and torch.equal(vals, pvals)


@pytest.mark.chip
def test_k19_takes_precompute_sentinels_and_12_words_on_the_card():
    """The merged layout, the sliced route's sentinel lanes and a 12-word
    scalar field through K19, and the per-window path, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    sizes = [3000, 2000]
    scalars, groups_of = sentinel(uniform(rng, sum(sizes)), sizes)
    scalars = scalars.to(dev)
    groups_of = (groups_of[0].to(dev), groups_of[1])
    for pre, sort in ((1, msm.sort_windows), (2, msm.sort_windows), (2, forced_per_window)):
        got = sort(scalars, groups_of, 13, pre)
        want = replaced_sort_windows(scalars, groups_of, 13, pre)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (pre, sort.__name__)
    bw6 = other_curve("bw6_761")(rng, 4096).to(dev)
    got = msm.sort_windows(bw6, [4096], 13)
    assert all(torch.equal(g, w) for g, w in zip(got, replaced_sort_windows(bw6, [4096], 13)))
