"""The port's multi-stage NTT (K5) on the CPU against the JAX package's
large-domain transform: `mxu_ntt.ntt_mxu` (the matmul NTT) and
`ntt_ops.ntt_natural`, forward and inverse, exact integer equality; K5's
plain path against K3's plain stages for every forced tile size; and an
integer model of the kernel's tile index arithmetic (swizzled shared
memory, pairs of stages in registers, the tile's stage-major twiddles
staged in shared memory) against the plain radix-2 network."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.ops import mxu_ntt
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import ntt
from icicle_snark_tpu_torch.refmath.field import R_MOD, W

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def _batch(rng, batch, log_n):
    """(B, 8, n) port tensor and the JAX (16, B, n) array of the same
    canonical values (numpy seed), with 0, 1 and r - 1 among them."""
    n = 1 << log_n
    words = rng.integers(0, 1 << 32, size=(batch * n, 8), dtype=np.uint64).astype(np.uint32)
    words[:, 7] = rng.integers(0, R_MOD >> 224, size=batch * n).astype(np.uint32)
    words[:3] = lb.ints_to_words([0, 1, R_MOD - 1])
    flat = lb.words_to_limbs(words)
    t = flat.reshape(8, batch, n).transpose(0, 1).contiguous()
    return t, lb.to_jax_limbs(flat).reshape(16, batch, n)


def _port_to_jax(t):
    return lb.to_jax_limbs(t.transpose(0, 1).contiguous())


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", [8, 9])
def test_natural_transform_matches_mxu_ntt_and_radix2(log_n, inverse, monkeypatch):
    rng = np.random.default_rng(10 * log_n + inverse)
    x, jx = _batch(rng, 2, log_n)
    dom = ntt.NTTDomain(log_n, "cpu")
    with monkeypatch.context() as forced:
        forced.setattr(ntt, "NTT_BLOCK_MIN_LOG", 1)
        forced.setattr(ntt, "NTT_TILE_LOG", 3)
        got = _port_to_jax(ntt.ntt_natural(x, dom, inverse))
    want = np.asarray(mxu_ntt.ntt_mxu(jnp.asarray(jx), log_n, inverse=inverse))
    assert np.array_equal(got, want)
    radix2 = np.asarray(jntt.ntt_natural(jnp.asarray(jx), jntt.get_domain(log_n), inverse=inverse))
    assert np.array_equal(got, radix2)
    # the route the domain size picks gives the same words
    assert np.array_equal(got, _port_to_jax(ntt.ntt_natural(x, dom, inverse)))


@pytest.mark.parametrize("tile_log", [2, 3])
@pytest.mark.parametrize("log_n", [6, 7, 8, 9, 10])
def test_block_path_equals_stage_path(log_n, tile_log, monkeypatch):
    """K5's plain path with a forced tile equals K3's plain stages word for
    word, and the pair inverts."""
    rng = np.random.default_rng(100 * log_n + tile_log)
    x, _ = _batch(rng, 1 if log_n > 8 else 3, log_n)
    dom = ntt.NTTDomain(log_n, "cpu")
    monkeypatch.setattr(ntt, "NTT_BLOCK_MIN_LOG", 99)
    stage_inv = ntt.intt_dif(x, dom)
    stage_fwd = ntt.ntt_dit(stage_inv, dom)
    assert torch.equal(stage_fwd, x)
    # the domain size alone selects K5 from the threshold up
    monkeypatch.setattr(ntt, "NTT_BLOCK_MIN_LOG", log_n)
    monkeypatch.setattr(ntt, "NTT_TILE_LOG", tile_log)
    block_inv = ntt.intt_dif(x, dom)
    assert torch.equal(block_inv, stage_inv)
    assert torch.equal(ntt.ntt_dit(block_inv, dom), stage_fwd)


@pytest.mark.parametrize("log_n", [1, 5, 10, 11, 17, 21, 22])
def test_block_passes_cover_every_stage_once(log_n):
    passes = ntt.block_passes(log_n)
    covered = [s for low, k, _ in passes for s in range(low + 1, low + k + 1)]
    assert covered == list(range(1, log_n + 1))
    for low, k, tcols in passes:
        assert k + tcols == min(ntt.NTT_TILE_LOG, log_n) and 0 <= tcols <= low
        assert low == 0 or tcols >= ntt.NTT_TILE_MIN_COLS_LOG
    assert len(passes) <= 1 + -(-max(log_n - ntt.NTT_TILE_LOG, 0) // 5)


def _stage_ints(x, tw, n, m, inverse, scale):
    h, y = m // 2, list(x)
    for i0 in (blk * m + j for blk in range(n // m) for j in range(h)):
        u, v, w = x[i0], x[i0 + h], tw[(i0 % m) * (n // m)]
        if inverse:
            a, d = (u + v) % R_MOD, (u - v) * w % R_MOD
            if scale is not None:
                a, d = a * scale % R_MOD, d * scale % R_MOD
        else:
            a, d = (u + v * w) % R_MOD, (u - v * w) % R_MOD
        y[i0], y[i0 + h] = a, d
    return y


def _swz(e):
    """csrc/ntt_block.cu swz(): the shared-memory word of tile element e."""
    return e ^ (31 * ((e >> 5) & 1)) ^ (26 * ((e >> 6) & 1)) ^ (20 * ((e >> 7) & 1))


def _group_items(tile_log, tcols_log, j0, g):
    """Each item of a group's loop (b = 0, 1, ...): its column, the row
    bits below the group, and its 2^g tile elements."""
    cols = 1 << tcols_log
    for b in range((1 << tile_log) >> g):
        c, rb = b & (cols - 1), b >> tcols_log
        below = rb & ((1 << j0) - 1)
        r0 = ((rb >> j0) << (j0 + g)) | below
        yield c, below, [((r0 | (q << j0)) << tcols_log) | c for q in range(1 << g)]


def _twiddle_lane(e, low, tcols_log, t):
    """csrc/ntt_block.cu load_twiddles(): the stage-major lane that the
    tile's twiddle entry e holds (e = ((2^jb - 1 + jj) << tc) | c)."""
    row = (e >> tcols_log) + 1
    jb = row.bit_length() - 1
    return ((1 << (low + jb)) - 1) + ((row - (1 << jb)) << low) + ((t << tcols_log)
                                                                  | (e & ((1 << tcols_log) - 1)))


def _block_pass_ints(x, stw, n, low, k, tcols_log, inverse, scale):
    """csrc/ntt_block.cu, one block after another, on Python integers: the
    tile gather into the swizzled shared array, the tile's twiddles copied
    into their shared table, the pairs of row bits (top down for the DIF,
    an odd k ending in a single bit), each item's elements and their
    butterflies with the twiddle read from the table, and the outputs
    times `scale` (the low = 0 inverse pass)."""
    cols, tile_log = 1 << tcols_log, k + tcols_log
    tiles = (1 << low) >> tcols_log
    x = list(x)
    for blk in range(n >> tile_log):
        q, t = divmod(blk, tiles)
        base = (q << (low + k)) | (t << tcols_log)
        where = [base | ((e >> tcols_log) << low) | (e & (cols - 1)) for e in range(1 << tile_log)]
        sm = [0] * (1 << tile_log)
        for e, i in enumerate(where):
            sm[_swz(e)] = x[i]
        st = [stw[_twiddle_lane(e, low, tcols_log, t)] for e in range(((1 << k) - 1) << tcols_log)]
        groups = (k + 1) // 2
        for gi in (range(groups - 1, -1, -1) if inverse else range(groups)):
            j0 = 2 * gi
            g = min(2, k - j0)
            for c, below, es in _group_items(tile_log, tcols_log, j0, g):
                v = [sm[_swz(e)] for e in es]
                for sg in (range(g - 1, -1, -1) if inverse else range(g)):
                    jb = j0 + sg
                    for lowv in range(1 << sg):
                        jj = below | (lowv << j0)
                        w = st[(((1 << jb) - 1 + jj) << tcols_log) | c]
                        for hv in range(1 << (g - 1 - sg)):
                            q0 = lowv | (hv << (sg + 1))
                            q1 = q0 | (1 << sg)
                            u, vv = v[q0], v[q1]
                            if inverse:
                                v[q0], v[q1] = (u + vv) % R_MOD, (u - vv) * w % R_MOD
                            else:
                                v[q0], v[q1] = (u + vv * w) % R_MOD, (u - vv * w) % R_MOD
                for e, val in zip(es, v):
                    sm[_swz(e)] = val
        for e, i in enumerate(where):
            x[i] = sm[_swz(e)] if scale is None else sm[_swz(e)] * scale % R_MOD
    return x


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n,tile_log", [(6, 2), (6, 3), (7, 4), (8, 4)])
def test_kernel_index_model_matches_radix2_network(log_n, tile_log, inverse):
    n = 1 << log_n
    root = pow(W[log_n], -1, R_MOD) if inverse else W[log_n]
    tw = [pow(root, i, R_MOD) for i in range(n)]
    scale = pow(n, -1, R_MOD) if inverse else None
    prng = random.Random(log_n)
    x = [prng.randrange(R_MOD) for _ in range(n)]
    want = list(x)
    for s in (range(log_n, 0, -1) if inverse else range(1, log_n + 1)):
        want = _stage_ints(want, tw, n, 1 << s, inverse, scale if s == 1 else None)
    passes = ntt.block_passes(log_n, tile_log)
    # the port's stage-major table, as integers
    table = ntt.stage_major(lb.ints_to_limbs([v * lb.FR_SPEC.r_mod % R_MOD for v in tw]))
    stw = [v * lb.FR_SPEC.rinv % R_MOD for v in lb.limbs_to_ints(table)]
    got = list(x)
    for low, k, tcols in (reversed(passes) if inverse else passes):
        got = _block_pass_ints(got, stw, n, low, k, tcols, inverse, scale if low == 0 else None)
    assert got == want


@pytest.mark.parametrize("tile_log", [10, 11, 12])
def test_kernel_swizzle_spreads_lanes_over_banks(tile_log):
    """In every pair of stages of the pass with low = 0 (T = 1), the 32
    lanes of a warp read 32 different banks for each of their elements,
    and swz() is a permutation of the tile."""
    assert sorted(map(_swz, range(1 << tile_log))) == list(range(1 << tile_log))
    for j0 in range(0, tile_log, 2):
        g = min(2, tile_log - j0)
        items = list(_group_items(tile_log, 0, j0, g))
        for warp in range(0, len(items), 32):
            for q in range(1 << g):
                banks = {_swz(es[q]) % 32 for _c, _b, es in items[warp:warp + 32]}
                assert len(banks) == 32


@pytest.mark.parametrize("log_n,tile_log", [(21, 10), (21, 11), (22, 10)])
def test_kernel_twiddle_table_is_the_tiles_stage_lanes(log_n, tile_log):
    """For every pass of the full-size domains and a few of its tiles, the
    tile's shared twiddle table holds, entry for entry, the stage-major lane
    each butterfly of the plain network reads, and fits beside the tile in
    the shared memory a block may take (227 KB; H holds two tiles)."""
    for low, k, tcols in ntt.block_passes(log_n, tile_log):
        entries = ((1 << k) - 1) << tcols
        assert entries < 1 << (k + tcols) and (96 << (k + tcols)) <= 227 * 1024
        tiles = (1 << low) >> tcols
        for t in {0, tiles // 2, tiles - 1}:
            lanes = {}
            for jb in range(k):
                for jj in range(1 << jb):
                    for c in range(1 << tcols):
                        # the plain stage of span 2^(low+jb+1) at position (jj << low) | col
                        lanes[(((1 << jb) - 1 + jj) << tcols) | c] = (
                            (1 << (low + jb)) - 1 + ((jj << low) | (t << tcols) | c))
            assert sorted(lanes) == list(range(entries))
            assert all(_twiddle_lane(e, low, tcols, t) == lane for e, lane in lanes.items())


def test_block_rejects_bad_passes():
    dom = ntt.NTTDomain(4, "cpu")
    x = torch.zeros((1, 8, 16), dtype=torch.int32)
    for low, k, tcols in ((0, 5, 0), (2, 1, 3), (0, 0, 0)):
        with pytest.raises(ValueError):
            ntt.ntt_block(x, dom.tw_fwd, low, k, tcols, False)
    with pytest.raises(ValueError):
        ntt.ntt_block(x.to(torch.int64), dom.tw_fwd, 0, 4, 0, False)
    with pytest.raises(ValueError):
        ntt.block_passes(8, tile_log=0)
    keys, h = dom.tw_fwd, torch.zeros((8, 16), dtype=torch.int32)
    for bad in (dict(inverse=False, scale=keys), dict(inverse=True, scale=keys, low=2),
                dict(inverse=True, scale=keys[:, :3]), dict(inverse=True, h_out=h, scale=keys[:, :1]),
                dict(inverse=False, h_out=h), dict(inverse=False, h_out=h[:, :8], scale=keys[:, :1])):
        low = bad.pop("low", 0)
        with pytest.raises(ValueError):
            ntt.ntt_block(x, dom.stw_fwd, low, 4 - low, 0, **bad)
    with pytest.raises(ValueError):  # h needs the batch of three polynomials
        ntt.ntt_block(x[:2].contiguous(), dom.stw_fwd, 0, 4, 0, False, keys[:, :1], h_out=h)
