"""Batched radix-2 NTT over BN254 Fr (kernels K3 and K5) and over the scalar
fields of bls12-377, bls12-381 and bw6-761 (kernel K14: its register
passes, K3's template over N words, and its tile passes).

The prove pipeline never needs natural->natural transforms: `intt_dif`
takes natural-order values to BIT-REVERSED coefficients (Gentleman-Sande,
scaled by 1/n), the coset key powers are taken in bit-reversed order, and
`ntt_dit` takes bit-reversed input to natural-order values (Cooley-Tukey),
as in icicle_snark_tpu/ops/ntt.py. `ntt_natural` wraps them in a
bit-reversal gather.

Two kernels run the same butterfly network. K3 (`csrc/ntt.cu`, the body
in `csrc/ntt_radix.cuh`) runs a pass of up to NTT_RADIX_LOG consecutive
stages a launch in registers (`ntt_radix`; `ntt_stage`, one stage over the
natural power table, is its one-stage entry). K5 (`csrc/ntt_block.cu`)
runs several consecutive stages per launch (a pass) through shared memory
and registers; it is the large-domain transform, the port's counterpart of
icicle_snark_tpu/ops/mxu_ntt.py, and is taken from `NTT_BLOCK_MIN_LOG` up.
Every stage's outputs are canonical in the plain versions and every pass's
in K3 and K5, so all give the same words. `_inverse_` and `_forward_` hold
the route and the pass order of both directions. `coset_h` is the prove's
whole coset evaluation on K5 alone: the last inverse pass multiplies by
the coset keys (1/n folded in) and the last forward pass writes
h = (A B - C) R^2. For CPU tensors each wrapper runs its plain version
(`ntt_stage_plain`, `ntt_radix_plain`, `ntt_block_plain`,
`ntt_block_scale_plain`, `ntt_block_h_plain`).

The op surface (`ntt`, `ntt_inplace`, `initialize_domain`,
`get_root_of_unity`, as in icicle_snark_tpu/ops/ntt.py) runs every
ordering and an arbitrary coset on `ntt_natural`, K1 products against
`powers_mont` tables and bit-reversal gathers.

The other curves' Fr (`NTTDomain(log_n, device, spec, root_tower)`, as
the JAX NTTDomain(log_n, spec, root_tower)) run the same pair of networks
on K14, with K12 for their products and power tables; K5 and K3 stay
BN254's. From NTT_BLOCK_MIN_LOG up a transform is K14's passes
(`csrc/ntt_block_n.cu`, K5's passes at N words, the 1/n or the (words, n)
scale fused into the low = 0 inverse pass, tiles of NTT_N_TILE_LOG);
below it, K3's register passes over N words (`ntt_radix_n`, `csrc/ntt_n.cu`
on the same template), which also stay as the passes' check, with
`ntt_stage_n` their one-stage entry. The plain versions are
`ntt_block_n_plain`, `ntt_radix_n_plain` and `ntt_stage_n_plain`.

Data layout: (B, words, n) int32, Montgomery form (fields/limbs.py): 8
words for BN254 Fr and the bls12 Fr, 12 for the bw6-761 Fr.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import NTTConfig, Ordering
from ..errors import InvalidArgument
from ..fields import limbs as lb
from ..fields.limbs import FR_SPEC, NLIMB, OP_ADD, OP_MUL, OP_SUB
from ..refmath.field import W
from ..runtime import default_device


def bitrev_permutation(log_n: int) -> np.ndarray:
    """Index array: out[i] = bit-reverse of i."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def powers_mont(base_int: int, log_n: int, device, spec=FR_SPEC) -> torch.Tensor:
    """(words, 2^log_n) Montgomery-form powers base^0..base^(n-1), by
    doubling: powers [2^k, 2^(k+1)) are powers [0, 2^k) times base^(2^k),
    one K1 (K12) product per step with the constant broadcast over the
    lanes."""
    p = spec.modulus
    table = lb.one_mont(spec, device)
    step = base_int % p
    for _ in range(log_n):
        factor = lb.const(step * spec.r_mod % p, device, words=spec.words)
        table = torch.cat([table, lb.mont_mul(table, factor, spec)], dim=-1)
        step = step * step % p
    return table


def stage_major(tw: torch.Tensor) -> torch.Tensor:
    """(words, n) powers w^0 .. w^(n-1) -> the stage-major (words, n) table: the
    stage of span m = 2^s has its half-span of twiddles w^(j n / m),
    j < m/2, in lanes [m/2 - 1, m - 1); the last lane is unused (zero)."""
    n = tw.shape[-1]
    parts = [tw[:, : n // 2: n // m] for m in (1 << s for s in range(1, n.bit_length()))]
    return torch.cat(parts + [torch.zeros_like(tw[:, :1])], dim=-1).contiguous()


def default_tower(spec) -> list:
    """The root tower of a scalar field (W[i] a primitive 2^i-th root of
    unity): the spec's own (curves/device.py `curve_specs` gives each Fr
    its curve's), else BN254's refmath tower for BN254's Fr."""
    if spec.root_tower:
        return list(spec.root_tower)
    if spec.modulus == FR_SPEC.modulus:
        return W
    raise ValueError(f"ntt: no root tower known for {spec.name}; pass root_tower")


class NTTDomain:
    """Twiddle tables of one transform size and field on one device (the
    analog of the reference's NTT domain). `spec` (default BN254 Fr) and
    `root_tower` (default `default_tower(spec)`) as the JAX NTTDomain's."""

    def __init__(self, log_n: int, device, spec=None, root_tower=None):
        spec = spec or FR_SPEC
        tower = root_tower or default_tower(spec)
        if log_n >= len(tower):
            raise ValueError(f"{spec.name} supports NTTs up to 2^{len(tower) - 1}")
        p = spec.modulus
        self.spec = spec
        self.log_n = log_n
        self.n = 1 << log_n
        self.w = tower[log_n]
        self.tw_fwd = powers_mont(self.w, log_n, device, spec)
        self.tw_inv = powers_mont(pow(self.w, -1, p), log_n, device, spec)
        # the same twiddles stage by stage, for K3, K5 and K14
        self.stw_fwd = stage_major(self.tw_fwd)
        self.stw_inv = stage_major(self.tw_inv)
        self.n_inv_mont = lb.const(pow(self.n, -1, p) * spec.r_mod % p, device,
                                   words=spec.words)
        self.r2 = lb.const(spec.r2, device, words=spec.words)  # h's R^2 (fused into K5)
        self.bitrev = torch.from_numpy(bitrev_permutation(log_n)).to(device)


# ---------------------------------------------------------------- K3

def ntt_stage_plain(x: torch.Tensor, tw: torch.Tensor, m: int, inverse: bool,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K3: one butterfly stage of span m over
    (B, 8, n); returns the new tensor."""
    n = x.shape[-1]
    return _butterflies_plain(x, tw[:, : (m // 2) * (n // m): n // m], m, inverse, scale)


def _butterflies_plain(x: torch.Tensor, w: torch.Tensor, m: int, inverse: bool,
                       scale: torch.Tensor | None, spec=FR_SPEC) -> torch.Tensor:
    """One stage of span m over (B, words, n) with its (words, m/2) twiddles
    given."""
    b, words, n = x.shape
    h = m // 2
    xr = x.reshape(b, words, n // m, 2, h).permute(0, 2, 3, 1, 4)  # (B, n/m, 2, words, h)
    u, v = xr[:, :, 0], xr[:, :, 1]

    def op(code, a, c):
        return lb.field_op_plain(code, a, c, spec)

    if inverse:
        lo = op(OP_ADD, u, v)
        hi = op(OP_MUL, op(OP_SUB, u, v), w)
        if scale is not None:
            lo, hi = op(OP_MUL, lo, scale), op(OP_MUL, hi, scale)
    else:
        vw = op(OP_MUL, v, w)
        lo, hi = op(OP_ADD, u, vw), op(OP_SUB, u, vw)
    out = torch.stack([lo, hi], dim=2)  # (B, n/m, 2, words, h)
    return out.permute(0, 3, 1, 2, 4).reshape(b, words, n)


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, m: int, inverse: bool,
              scale: torch.Tensor | None = None) -> None:
    """One butterfly stage of span m, IN PLACE on x (B, 8, n) int32:
    DIF (u+v, (u-v)w) when inverse, else DIT (u+vw, u-vw); `scale` (8, 1)
    multiplies both outputs (the 1/n of the last inverse stage)."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != NLIMB or not x.is_contiguous():
        raise ValueError(f"ntt_stage: want contiguous int32 (B, 8, n), got {tuple(x.shape)}")
    b, _, n = x.shape
    if tw.shape != (NLIMB, n) or m < 2 or n % m:
        raise ValueError(f"ntt_stage: bad twiddles {tuple(tw.shape)} or span {m} for n={n}")
    if x.device.type == "cpu":
        x.copy_(ntt_stage_plain(x, tw, m, inverse, scale))
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt_stage: unsupported device {x.device}")
    tw = tw.contiguous()
    scale = None if scale is None else scale.contiguous()
    kernels.NTT.launch(
        x.data_ptr(), tw.data_ptr(), None if scale is None else scale.data_ptr(),
        b, n, m, int(inverse),
    )


# Stages a launch of the register passes below NTT_BLOCK_MIN_LOG, by the
# field's words (K3 and ntt_radix_n: at most 4 at 8 words, 3 at 12). On an
# H100 the BN254 pair at (3, 8, 2^21) took 6.74-6.75 / 5.20-5.25 / 4.98-5.02
# / 6.10-6.15 ms at R = 1 / 2 / 3 / 4 (K5: 5.15), the bls12 Fr pairs at 2^22
# 3.59-3.63 at R = 2 and 3.59-3.71 at R = 3, the bw6-761 Fr pair 7.86-7.88 /
# 7.03-7.07 / 7.75-7.78 at R = 1 / 2 / 3 (chip_smoke.py `radix_sweep`,
# PERF.md): R = 3 at 8 words, where BN254 gains 4-5 % and the bls12 Fr lose
# 0-3 %. Patch it to time the others.
NTT_RADIX_LOG = {8: 3, 12: 2}
RADIX_MAX = {8: 4, 12: 3}


def radix_passes(log_n: int, r: int) -> list:
    """The register passes of one transform of 2^log_n at r stages a pass,
    as (low, k) in ascending order of stages: passes of r stages from
    low = 0 up, then one shorter pass for the rest."""
    if r < 1:
        raise ValueError(f"radix_passes: bad radix 2^{r}")
    return [(low, min(r, log_n - low)) for low in range(0, log_n, r)]


def _check_radix(who: str, x, stw, low: int, r: int, inverse: bool, scale, words: int):
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != words or not x.is_contiguous():
        raise ValueError(f"{who}: want contiguous int32 (B, {words}, n), got {tuple(x.shape)}")
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if (stw.shape != (words, n) or n != 1 << log_n or not 1 <= r <= RADIX_MAX[words] or low < 0
            or low + r > log_n):
        raise ValueError(f"{who}: bad twiddles {tuple(stw.shape)} or pass ({low}, {r}) for n={n}")
    if scale is not None and (not inverse or scale.shape != (words, 1)):
        raise ValueError(f"{who}: scale is one ({words}, 1) value for an inverse pass")


def ntt_radix_plain(x: torch.Tensor, stw: torch.Tensor, low: int, r: int, inverse: bool,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of a K3 pass over (B, 8, n) with the
    stage-major table: `ntt_radix_n_plain` at BN254 Fr."""
    return ntt_radix_n_plain(x, stw, low, r, inverse, FR_SPEC, scale)


def ntt_radix(x: torch.Tensor, stw: torch.Tensor, low: int, r: int, inverse: bool,
              scale: torch.Tensor | None = None) -> None:
    """r butterfly stages (spans 2^(low+1) .. 2^(low+r)) IN PLACE on x
    (B, 8, n) int32 in one K3 launch, 1 <= r <= 4: descending DIF stages
    when inverse, else ascending DIT stages, with the STAGE-MAJOR table
    (`NTTDomain.stw_*`); `scale` (8, 1) multiplies every output of an
    inverse pass (the 1/n of the low = 0 pass)."""
    _check_radix("ntt_radix", x, stw, low, r, inverse, scale, NLIMB)
    if x.device.type == "cpu":
        x.copy_(ntt_radix_plain(x, stw, low, r, inverse, scale))
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt_radix: unsupported device {x.device}")
    stw = stw.contiguous()
    scale = None if scale is None else scale.contiguous()
    kernels.NTT_RADIX.launch(
        x.data_ptr(), stw.data_ptr(), None if scale is None else scale.data_ptr(),
        x.shape[0], x.shape[-1], low, r, int(inverse),
    )


# ---------------------------------------------------------------- K14

def ntt_stage_n_plain(x: torch.Tensor, stw: torch.Tensor, m: int, inverse: bool, spec,
                      scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K14: one butterfly stage of span m over
    (B, words, n) with the stage-major table `stw` (the stage's twiddles at
    lanes m/2 - 1 .. m - 2); returns the new tensor."""
    h = m // 2
    return _butterflies_plain(x, stw[:, h - 1: 2 * h - 1], m, inverse, scale, spec)


def _k14_field(spec, who: str):
    if spec.bn254 or spec.field_id < 0:
        raise InvalidArgument(f"{who}: K14 covers the bls12 and bw6-761 Fr, not {spec.name}")


def ntt_stage_n(x: torch.Tensor, stw: torch.Tensor, m: int, inverse: bool, spec,
                scale: torch.Tensor | None = None) -> None:
    """One butterfly stage of span m over a non-BN254 Fr, IN PLACE on x
    (B, words, n) int32, as `ntt_stage` with the stage-major table of
    `NTTDomain.stw_*` and `scale` (words, 1). One K14 launch for CUDA
    tensors."""
    w = spec.words
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != w or not x.is_contiguous():
        raise ValueError(f"ntt_stage_n: want contiguous int32 (B, {w}, n), got {tuple(x.shape)}")
    b, _, n = x.shape
    if stw.shape != (w, n) or m < 2 or n % m or (scale is not None and scale.shape != (w, 1)):
        raise ValueError(f"ntt_stage_n: bad twiddles {tuple(stw.shape)}, scale or span {m} "
                         f"for n={n}")
    if x.device.type == "cpu":
        x.copy_(ntt_stage_n_plain(x, stw, m, inverse, spec, scale))
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt_stage_n: unsupported device {x.device}")
    _k14_field(spec, "ntt_stage_n")
    stw = stw.contiguous()
    scale = None if scale is None else scale.contiguous()
    kernels.NTT_N.launch(
        spec.field_id, x.data_ptr(), stw.data_ptr(), None if scale is None else scale.data_ptr(),
        b, n, m, int(inverse),
    )


def ntt_radix_n_plain(x: torch.Tensor, stw: torch.Tensor, low: int, r: int, inverse: bool,
                      spec, scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of a register pass (K3, and K14's below
    NTT_BLOCK_MIN_LOG): r calls of `ntt_stage_n_plain` over (B, words, n)
    in the pass's order (descending when inverse), `scale` (words, 1) given
    to the last."""
    stages = list(range(low + r, low, -1) if inverse else range(low + 1, low + r + 1))
    for s in stages:
        x = ntt_stage_n_plain(x, stw, 1 << s, inverse, spec, scale if s == stages[-1] else None)
    return x


def ntt_radix_n(x: torch.Tensor, stw: torch.Tensor, low: int, r: int, inverse: bool, spec,
                scale: torch.Tensor | None = None) -> None:
    """`ntt_radix` over a non-BN254 Fr, IN PLACE on x (B, words, n) int32,
    1 <= r <= 4 at 8 words, 3 at 12, with the stage-major table of
    `NTTDomain.stw_*` and `scale` (words, 1). One launch for CUDA
    tensors."""
    _check_radix("ntt_radix_n", x, stw, low, r, inverse, scale, spec.words)
    if x.device.type == "cpu":
        x.copy_(ntt_radix_n_plain(x, stw, low, r, inverse, spec, scale))
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt_radix_n: unsupported device {x.device}")
    _k14_field(spec, "ntt_radix_n")
    stw = stw.contiguous()
    scale = None if scale is None else scale.contiguous()
    kernels.NTT_RADIX_N.launch(
        spec.field_id, x.data_ptr(), stw.data_ptr(), None if scale is None else scale.data_ptr(),
        x.shape[0], x.shape[-1], low, r, int(inverse),
    )


# ---------------------------------------------------------------- K5

# Elements of one shared-memory tile (2^10 x 32 bytes = 32 KB, as much again
# for its twiddles; K5 takes tiles up to 2^11), and the fewest columns a tile of a strided pass keeps side by side, so that each
# limb row is read 32 consecutive words at a time.
NTT_TILE_LOG = 10
NTT_TILE_MIN_COLS_LOG = 5
# Domains of at least 2^NTT_BLOCK_MIN_LOG go through K5, smaller ones
# through K3's register passes. On an H100, at batch 3, K5 was ahead of
# them at every size timed from 2^3 to 2^17 (fewer launches), level at 2^1
# and 2^2 and 3 % behind at 2^21 (chip_smoke.py `ntt_threshold_sweep`,
# PERF.md). So no circuit's prove runs K3 by default; it stays as the check
# of K5. Raise the constant past the domain to force K3.
NTT_BLOCK_MIN_LOG = 3


def block_passes(log_n: int, tile_log: int | None = None, min_cols_log: int | None = None):
    """The passes of one transform as (low, k, tcols_log), in ascending
    order of stages: pass (low, k, t) covers the spans 2^(low+1) ..
    2^(low+k) on tiles of 2^k rows by 2^t columns. The first pass takes
    the lowest min(tile_log, log_n) stages on contiguous tiles; the others
    keep at least 2^min_cols_log columns (NTT_TILE_MIN_COLS_LOG by default;
    half the tile's bits for a small forced tile) and split the remaining
    stages evenly."""
    tile_log = NTT_TILE_LOG if tile_log is None else tile_log
    if tile_log < 1:
        raise ValueError(f"block_passes: bad tile size 2^{tile_log}")
    min_cols_log = min(NTT_TILE_MIN_COLS_LOG if min_cols_log is None else min_cols_log,
                       tile_log // 2)
    first = min(tile_log, log_n)
    passes = [(0, first, 0)]
    rest = log_n - first
    if rest:
        k_max = tile_log - min_cols_log
        count = -(-rest // k_max)
        low = first
        for i in range(count):
            k = rest // count + (1 if i < rest % count else 0)
            passes.append((low, k, tile_log - k))
            low += k
    return passes


def ntt_block_plain(x: torch.Tensor, stw: torch.Tensor, low: int, k: int,
                    inverse: bool) -> torch.Tensor:
    """The plain PyTorch version of a bare K5 pass: the stages of spans
    2^(low+1) .. 2^(low+k), one plain stage each, in the kernel's order,
    with the kernel's stage-major twiddle table `stw`."""
    return ntt_block_n_plain(x, stw, low, k, inverse, FR_SPEC)


def ntt_block_scale_plain(x: torch.Tensor, stw: torch.Tensor, k: int,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K5's last inverse pass (low = 0) with its outputs
    multiplied by `scale`: (8, 1) a constant, (8, n) one factor per lane
    (the coset keys in bit-reversed order with 1/n folded in)."""
    y = ntt_block_plain(x, stw, 0, k, True)
    return lb.field_op_plain(OP_MUL, y, scale, FR_SPEC)


def ntt_block_h_plain(x: torch.Tensor, stw: torch.Tensor, low: int, k: int,
                      r2: torch.Tensor) -> torch.Tensor:
    """Plain version of K5's last forward pass over the batch (A, B, C):
    h = (A B - C) * r2, (8, n)."""
    y = ntt_block_plain(x, stw, low, k, False)

    def op(code, a, b):
        return lb.field_op_plain(code, a, b, FR_SPEC)

    return op(OP_MUL, op(OP_SUB, op(OP_MUL, y[0], y[1]), y[2]), r2)


def ntt_block(x: torch.Tensor, tw: torch.Tensor, low: int, k: int, tcols_log: int,
              inverse: bool, scale: torch.Tensor | None = None,
              h_out: torch.Tensor | None = None) -> None:
    """k butterfly stages (spans 2^(low+1) .. 2^(low+k)) IN PLACE on x
    (B, 8, n) int32, tiles of 2^k rows by 2^tcols_log columns; descending
    DIF stages when inverse, else ascending DIT stages. `tw` is the
    STAGE-MAJOR twiddle table (`stage_major`, NTTDomain.stw_*).

    `scale`, the pass's multiplier: for the low = 0 inverse pass, (8, 1) or
    (8, n), each output times it (lane i times scale[:, i] for a table).
    With `h_out` (a forward pass over B = 3), the pass writes
    h = (x0 x1 - x2) * scale, scale (8, 1), into h_out (8, n) and leaves x
    as it was."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != NLIMB or not x.is_contiguous():
        raise ValueError(f"ntt_block: want contiguous int32 (B, 8, n), got {tuple(x.shape)}")
    b, _, n = x.shape
    log_n = n.bit_length() - 1
    if (tw.shape != (NLIMB, n) or n != 1 << log_n or k < 1 or low < 0 or low + k > log_n
            or not 0 <= tcols_log <= low):
        raise ValueError(
            f"ntt_block: bad twiddles {tuple(tw.shape)} or pass ({low}, {k}, {tcols_log}) for n={n}")
    if h_out is not None:
        if (inverse or b != 3 or scale is None or scale.shape != (NLIMB, 1)
                or h_out.shape != (NLIMB, n) or h_out.dtype != torch.int32
                or not h_out.is_contiguous() or h_out.device != x.device):
            raise ValueError("ntt_block: h_out is (8, n) int32 for a forward pass over "
                             "(3, 8, n), with an (8, 1) scale")
    elif scale is not None and (not inverse or low != 0
                                or scale.shape not in ((NLIMB, 1), (NLIMB, n))):
        raise ValueError("ntt_block: scale is for the low = 0 inverse pass, (8, 1) or (8, n)")
    if x.device.type == "cpu":
        if h_out is not None:
            h_out.copy_(ntt_block_h_plain(x, tw, low, k, scale))
        elif scale is not None:
            x.copy_(ntt_block_scale_plain(x, tw, k, scale))
        else:
            x.copy_(ntt_block_plain(x, tw, low, k, inverse))
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt_block: unsupported device {x.device}")
    tw = tw.contiguous()
    scale = None if scale is None else scale.contiguous()
    kernels.NTT_BLOCK.launch(
        x.data_ptr(), tw.data_ptr(), None if scale is None else scale.data_ptr(),
        0 if scale is None else scale.shape[-1], None if h_out is None else h_out.data_ptr(),
        b, n, log_n, low, k, tcols_log, int(inverse),
    )


# ---------------------------------------------------------------- K14's passes

# The tile of K14's passes: 2^NTT_N_TILE_LOG elements, 8 * words bytes each
# with its twiddles (64 KB at 8 words, 96 KB at 12: two blocks an SM at
# both), and the fewest columns of a strided pass (2^4: 16 neighbouring
# words of each word row, two full 32-byte sectors), so that a transform at
# 2^22 is three passes. On an H100 the pair at 2^22 took 3.74 / 3.86 / 7.63
# ms (bls12-377 / bls12-381 / bw6-761 Fr) so; 3.83 / 3.95 / 7.84 with 2^5
# columns (four passes); 4.49 / 4.64 / 9.55 at tiles of 2^11, one block an
# SM at both widths (chip_smoke.py check_ntt_n, PERF.md PR 11 run D).
NTT_N_TILE_LOG = 10
NTT_N_TILE_MIN_COLS_LOG = 4


def ntt_n_passes(log_n: int):
    """The passes of one K14 transform of 2^log_n over `spec` (8 or 12
    words: the same tile), as `block_passes` gives them."""
    return block_passes(log_n, NTT_N_TILE_LOG, NTT_N_TILE_MIN_COLS_LOG)


def block_n_lazy(spec) -> bool:
    """Whether K14's passes keep values in [0, 2p) between operations
    (csrc/field_n.cuh LAZY): 4p < 2^(32 words), so that a lazy sum of two
    such values stays in the field's words. False for bls12-381 Fr (r
    2^254.86 in 256 bits), which stays canonical after every operation."""
    return 4 * spec.modulus < 1 << (32 * spec.words)


def ntt_block_n_plain(x: torch.Tensor, stw: torch.Tensor, low: int, k: int, inverse: bool,
                      spec, scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of a K14 pass (and of a bare K5 pass at
    BN254 Fr): the stages of spans 2^(low+1) .. 2^(low+k) over (B, words,
    n), one `ntt_stage_n_plain` each, in the kernel's order, with the
    stage-major table `stw`; then each output times `scale` ((words, 1) or
    (words, n)) when one is given."""
    stages = range(low + k, low, -1) if inverse else range(low + 1, low + k + 1)
    for s in stages:
        x = ntt_stage_n_plain(x, stw, 1 << s, inverse, spec)
    return x if scale is None else lb.field_op_plain(OP_MUL, x, scale, spec)


def ntt_block_n(x: torch.Tensor, stw: torch.Tensor, low: int, k: int, tcols_log: int,
                inverse: bool, spec, scale: torch.Tensor | None = None) -> None:
    """k butterfly stages (spans 2^(low+1) .. 2^(low+k)) over a non-BN254 Fr
    IN PLACE on x (B, words, n) int32, tiles of 2^k rows by 2^tcols_log
    columns, with the stage-major table of `NTTDomain.stw_*`; descending
    DIF stages when inverse, else ascending DIT stages. `scale`, for the
    low = 0 inverse pass: (words, 1) or (words, n), each output times it.
    One K14 pass launch for CUDA tensors."""
    w = spec.words
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != w or not x.is_contiguous():
        raise ValueError(f"ntt_block_n: want contiguous int32 (B, {w}, n), got {tuple(x.shape)}")
    b, _, n = x.shape
    log_n = n.bit_length() - 1
    if (stw.shape != (w, n) or n != 1 << log_n or k < 1 or low < 0 or low + k > log_n
            or not 0 <= tcols_log <= low):
        raise ValueError(f"ntt_block_n: bad twiddles {tuple(stw.shape)} or pass ({low}, {k}, "
                         f"{tcols_log}) for n={n}")
    if scale is not None and (not inverse or low != 0 or scale.shape not in ((w, 1), (w, n))):
        raise ValueError(f"ntt_block_n: scale is for the low = 0 inverse pass, ({w}, 1) or "
                         f"({w}, n)")
    if x.device.type == "cpu":
        x.copy_(ntt_block_n_plain(x, stw, low, k, inverse, spec, scale))
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt_block_n: unsupported device {x.device}")
    _k14_field(spec, "ntt_block_n")
    stw = stw.contiguous()
    scale = None if scale is None else scale.contiguous()
    kernels.NTT_BLOCK_N.launch(
        spec.field_id, x.data_ptr(), stw.data_ptr(), None if scale is None else scale.data_ptr(),
        0 if scale is None else scale.shape[-1], b, n, log_n, low, k, tcols_log, int(inverse),
    )


# ---------------------------------------------------------------- transforms

def _radix_pass(y: torch.Tensor, dom: NTTDomain, low: int, r: int, inverse: bool,
                scale: torch.Tensor | None = None) -> None:
    """One register pass of the domain's network: K3 (BN254) or its N-word
    instance (the other Fr)."""
    stw = dom.stw_inv if inverse else dom.stw_fwd
    if dom.spec.bn254:
        ntt_radix(y, stw, low, r, inverse, scale)
    else:
        ntt_radix_n(y, stw, low, r, inverse, dom.spec, scale)


def _inverse_(y: torch.Tensor, dom: NTTDomain, scale: torch.Tensor) -> None:
    """The inverse network IN PLACE on y (B, words, n), natural in,
    bit-reversed out, each output times `scale`, (words, 1) or (words, n).
    From NTT_BLOCK_MIN_LOG up: K5's passes (BN254) or K14's (the other Fr),
    the scale fused into the low = 0 pass. Below it, K3's register passes
    of NTT_RADIX_LOG stages (`radix_passes`, top down): a (words, 1) scale
    fused into the low = 0 pass, a (words, n) one a K1 (K12) product after
    it."""
    spec = dom.spec
    lanes = scale.shape[-1] == 1
    if dom.log_n >= NTT_BLOCK_MIN_LOG:
        if spec.bn254:
            for low, k, tcols in reversed(block_passes(dom.log_n)):
                ntt_block(y, dom.stw_inv, low, k, tcols, True, scale if low == 0 else None)
        else:
            for low, k, tcols in reversed(ntt_n_passes(dom.log_n)):
                ntt_block_n(y, dom.stw_inv, low, k, tcols, True, spec, scale if low == 0 else None)
        return
    for low, r in reversed(radix_passes(dom.log_n, NTT_RADIX_LOG[spec.words])):
        _radix_pass(y, dom, low, r, True, scale if lanes and low == 0 else None)
    if not lanes:
        y.copy_(lb.mont_mul(y, scale, spec))


def _forward_(y: torch.Tensor, dom: NTTDomain, h_out: torch.Tensor | None = None) -> None:
    """The forward network IN PLACE on y (B, words, n), bit-reversed in,
    natural out. With `h_out` (BN254, B = 3: A, B, C) it writes
    h = (A B - C) R^2 there instead, fused into K5's last pass (below
    NTT_BLOCK_MIN_LOG: three K1 launches after K3's passes), and y is
    scratch. The other Fr: K14's passes from NTT_BLOCK_MIN_LOG up, else the
    register passes; no h."""
    if not dom.spec.bn254 and h_out is not None:
        raise ValueError("_forward_: h is the BN254 prove's")
    if dom.log_n >= NTT_BLOCK_MIN_LOG:
        if not dom.spec.bn254:
            for low, k, tcols in ntt_n_passes(dom.log_n):
                ntt_block_n(y, dom.stw_fwd, low, k, tcols, False, dom.spec)
            return
        passes = block_passes(dom.log_n)
        for i, (low, k, tcols) in enumerate(passes):
            last = h_out is not None and i == len(passes) - 1
            ntt_block(y, dom.stw_fwd, low, k, tcols, False, dom.r2 if last else None,
                      h_out if last else None)
        return
    for low, r in radix_passes(dom.log_n, NTT_RADIX_LOG[dom.spec.words]):
        _radix_pass(y, dom, low, r, False)
    if h_out is not None:
        h_raw = lb.sub_mod(lb.mont_mul(y[0], y[1], FR_SPEC), y[2], FR_SPEC)
        h_out.copy_(lb.mont_mul(h_raw, dom.r2, FR_SPEC))


def intt_dif(x: torch.Tensor, dom: NTTDomain) -> torch.Tensor:
    """Inverse NTT of (B, words, n), natural input -> BIT-REVERSED output,
    times 1/n. From NTT_BLOCK_MIN_LOG up K5 (BN254) or K14's passes, else
    K3's register passes (`ntt_radix`, `ntt_radix_n`)."""
    y = x.clone().contiguous()
    _inverse_(y, dom, dom.n_inv_mont)
    return y


def ntt_dit(x: torch.Tensor, dom: NTTDomain) -> torch.Tensor:
    """Forward NTT of (B, words, n), BIT-REVERSED input -> natural output."""
    y = x.clone().contiguous()
    _forward_(y, dom)
    return y


def ntt_natural(x: torch.Tensor, dom: NTTDomain, inverse: bool = False) -> torch.Tensor:
    """Natural-order in and out (icicle_snark_tpu/ops/ntt.py ntt_natural):
    the reorder-free pair with a bit-reversal gather on the reversed side."""
    if inverse:
        return intt_dif(x, dom)[..., dom.bitrev]
    return ntt_dit(x[..., dom.bitrev], dom)


# ---------------------------------------------------------------- coset evaluation

def coset_h(x: torch.Tensor, dom: NTTDomain, keys_br_scaled: torch.Tensor) -> torch.Tensor:
    """The prove's coset evaluation of the batch x = (A, B, C), (3, 8, n):
    h = (A' B' - C') R^2 with P' = NTT(keys * INTT(P)) on the coset, as
    (8, n). Runs IN PLACE on x (x is scratch afterwards). `keys_br_scaled`
    (8, n) is the coset key powers in bit-reversed order times 1/n
    (ZKeyCache.keys_br_scaled). From NTT_BLOCK_MIN_LOG up: K5 passes only,
    the keys fused into the last inverse pass and h into the last forward
    pass; below it K3's register passes and K1 products."""
    h = torch.empty_like(x[0])
    _inverse_(x, dom, keys_br_scaled)
    _forward_(x, dom, h)
    return h


def coset_h_plain(x: torch.Tensor, dom: NTTDomain, keys_br_scaled: torch.Tensor) -> torch.Tensor:
    """Plain version of `coset_h`'s K5 path, pass by pass (x untouched)."""
    passes = block_passes(dom.log_n)
    for low, k, _ in reversed(passes):
        x = (ntt_block_scale_plain(x, dom.stw_inv, k, keys_br_scaled) if low == 0
             else ntt_block_plain(x, dom.stw_inv, low, k, True))
    for low, k, _ in passes[:-1]:
        x = ntt_block_plain(x, dom.stw_fwd, low, k, False)
    low, k, _ = passes[-1]
    return ntt_block_h_plain(x, dom.stw_fwd, low, k, dom.r2)


# ---------------------------------------------------------------- the op surface

_DOMAINS: dict = {}


def get_root_of_unity(log_n: int, root_tower=None) -> int:
    """Primitive 2^log_n-th root of unity as an integer (ICICLE's
    get_root_of_unity)."""
    tower = root_tower or W
    if log_n >= len(tower) or tower[log_n] == 0:
        raise ValueError(f"no 2^{log_n} root of unity for this field")
    return tower[log_n]


def get_domain(log_n: int, device, spec=None, root_tower=None) -> NTTDomain:
    """The NTTDomain of 2^log_n over `spec` (default BN254 Fr) on `device`,
    built once and kept by (log_n, spec name, device), as the JAX
    get_domain by (log_n, spec name)."""
    spec = spec or FR_SPEC
    key = (log_n, spec.name, str(torch.device(device)))
    if key not in _DOMAINS:
        _DOMAINS[key] = NTTDomain(log_n, torch.device(device), spec, root_tower)
    return _DOMAINS[key]


def initialize_domain(log_n: int, device=None, spec=None, root_tower=None) -> NTTDomain:
    """Build (or find) the domain of 2^log_n over `spec` on `device`, by
    default the runtime's default device (ICICLE's initialize_domain)."""
    return get_domain(log_n, default_device() if device is None else device, spec, root_tower)


def release_domain(log_n: int | None = None, device=None):
    """Drop the kept domains (of one size and device, or all of them)."""
    for key in list(_DOMAINS):
        if (log_n is None or key[0] == log_n) and (
                device is None or key[2] == str(torch.device(device))):
            del _DOMAINS[key]


def ntt(x: torch.Tensor, inverse: bool = False, cfg=None, spec=None) -> torch.Tensor:
    """Config-driven transform, ICICLE's `ntt()` entry point with its
    orderings, arbitrary coset generators and columns_batch
    (icicle_snark_tpu/ops/ntt.py ntt).

    x: (words, n) one vector, (B, words, n) a row batch, or, with
    cfg.columns_batch, (n, words, B) a column batch; Montgomery-form values
    of `spec` (default BN254 Fr; the other curves' Fr on K14) on any
    device.

    Semantics (ICICLE's backends):
      * a forward coset NTT evaluates on g<w>: the input, in natural order,
        is multiplied by the powers g^i before the transform;
      * an inverse coset NTT interpolates from g<w>: the output is
        multiplied by g^-i after the transform;
      * R/M orderings permute the named side by the bit reversal (see
        config.Ordering for NM == NR, MN == RN).
    The transform is `ntt_natural` (K5 from NTT_BLOCK_MIN_LOG up, K3 below;
    K14 for the other Fr), the coset products K1 (K12) launches against
    `powers_mont` tables, the bit reversals gathers."""
    cfg = cfg or NTTConfig()
    spec = spec or FR_SPEC
    lb._check(x, "x", spec.words)
    squeeze = x.dim() == 2
    if squeeze:
        x = x.unsqueeze(0)
    elif x.dim() != 3:
        raise ValueError(f"ntt: want (words, n), (B, words, n) or (n, words, B), "
                         f"got {tuple(x.shape)}")
    elif cfg.columns_batch:
        x = x.permute(2, 1, 0)  # (n, 8, B) -> (B, 8, n)
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    dom = get_domain(log_n, x.device, spec)
    x = x.contiguous()
    if cfg.ordering in (Ordering.RN, Ordering.RR, Ordering.MN):
        x = x[..., dom.bitrev]  # bring the input to natural order
    if cfg.coset_gen is not None and not inverse:
        x = lb.mont_mul(x, powers_mont(cfg.coset_gen, log_n, x.device, spec), spec)
    y = ntt_natural(x, dom, inverse=inverse)
    if cfg.coset_gen is not None and inverse:
        g_inv = pow(cfg.coset_gen, -1, spec.modulus)
        y = lb.mont_mul(y, powers_mont(g_inv, log_n, y.device, spec), spec)
    if cfg.ordering in (Ordering.NR, Ordering.RR, Ordering.NM):
        y = y[..., dom.bitrev]
    if squeeze:
        return y[0]
    if cfg.columns_batch:
        return y.permute(2, 1, 0).contiguous()
    return y


def ntt_inplace(x: torch.Tensor, inverse: bool = False, cfg=None, spec=None) -> torch.Tensor:
    """`ntt` written back IN PLACE into x (ICICLE's ntt_inplace); returns x."""
    x.copy_(ntt(x, inverse=inverse, cfg=cfg, spec=spec))
    return x
