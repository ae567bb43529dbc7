"""The four-step NTT over a device mesh (kernel K15 for its twiddle pass).

The port's counterpart of icicle_snark_tpu/parallel/ntt_dist.py: a length-n
transform over a mesh of D shards as

  view x[i1 * n2 + i2] as a matrix A[i1][i2], n = n1 n2, sharded on i2
  1. local column NTTs   (length n1, batch B n2/D; K5)
  2. twiddle multiply    A[k1][i2] *= w_n^(k1 i2), written per destination
                         shard (K15 `four_step_twiddle`)
  3. all_to_all          i2-sharded -> k1-sharded
  4. local row NTTs      (length n2, batch B n1/D; K5)
  5. all_to_all + local transpose -> natural order, contiguous shards.

Layout. The JAX package's shard is (16, B, n1, n2/D) 16-bit limbs; the
port's is (B, n2/D, 8, n1): row (b, i2_loc) holds the column over i1 with
its 8 words beside it, as K5 transforms a (rows, 8, L) batch along L.
K15 writes its output as the blocks the exchange sends, (D, B, n1/D, 8,
n2/D), so the row NTTs read the concatenated blocks with no transpose;
`ntt_four_step_partial` returns (B, n1/D, 8, n2), X[k1 + n1 k2] at row
(b, k1_loc), lane k2 (the JAX package's intermediate [k1_loc][k2] order).
The transposes that remain (steps 0 and 5, the natural-order gathers of a
local transform) are torch ops, as the JAX package leaves them to XLA.

Every function takes and returns sharded values: a list with one tensor
per local shard of the mesh (parallel/mesh.py).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fields import limbs as lb
from ..fields.limbs import FR_SPEC, NLIMB, OP_MUL
from ..ops import ntt as ntt_ops
from ..ops.ntt import powers_mont
from ..refmath.field import R_MOD, W
from .mesh import on_device


def split_logs(log_n: int, d: int) -> tuple:
    """(log_n1, log_n2) four-step factorization for a D-shard mesh.
    Both factors must be divisible by D for the all_to_alls to tile."""
    log_n2 = max((log_n + 1) // 2, (d - 1).bit_length())
    log_n1 = log_n - log_n2
    return log_n1, log_n2


def can_distribute(log_n: int, d: int) -> bool:
    log_n1, log_n2 = split_logs(log_n, d)
    return log_n1 >= 0 and (1 << log_n1) % d == 0 and (1 << log_n2) % d == 0


# ---------------------------------------------------------------- K15

# K15's tiles (k1, i2_loc), csrc/four_step.cu's order, and the one it runs
# (read at every call, so the chip script can sweep them)
FOUR_STEP_TILES = ((32, 8), (32, 16), (64, 8))
FOUR_STEP_TILE = (32, 8)

_TABLES: dict = {}


def twiddle_tables(log_n: int, device, inverse: bool) -> tuple:
    """(tlo, thi, s): the powers w^0 .. w^(2^s - 1) and (w^(2^s))^0 ..
    (w^(2^s))^(n/2^s - 1), Montgomery and lane-major, (., 8): an entry's 8
    words side by side, as K15 reads them; w the 2^log_n-th root (its inverse
    when `inverse`), s = ceil(log_n / 2); w^e = thi[e >> s] tlo[e & (2^s -
    1)]. Built once per (log_n, device, direction)."""
    key = (log_n, str(torch.device(device)), inverse)
    if key not in _TABLES:
        w = pow(W[log_n], -1, R_MOD) if inverse else W[log_n]
        s = (log_n + 1) // 2
        _TABLES[key] = (powers_mont(w, s, device).t().contiguous(),
                        powers_mont(pow(w, 1 << s, R_MOD), log_n - s, device).t().contiguous(),
                        s)
    return _TABLES[key]


def four_step_twiddle_plain(x: torch.Tensor, tables: tuple, shard: int, d: int) -> torch.Tensor:
    """The plain PyTorch version of K15's twiddle pass: x (B, n2/D, 8, n1)
    times w^(k1 i2), i2 = shard n2/D + i2_loc, as (D, B, n1/D, 8, n2/D)."""
    tlo, thi, s = tables
    b, n2_loc, _, n1 = x.shape
    dev = x.device
    i2 = shard * n2_loc + torch.arange(n2_loc, device=dev)
    e = (i2[:, None] * torch.arange(n1, device=dev)[None, :]).flatten()
    f = lb.field_op_plain(OP_MUL, thi[e >> s].t(), tlo[e & ((1 << s) - 1)].t(), FR_SPEC)
    f = f.reshape(NLIMB, n2_loc, n1).permute(1, 0, 2)  # (n2/D, 8, n1)
    y = lb.field_op_plain(OP_MUL, x.reshape(b * n2_loc, NLIMB, n1), f, FR_SPEC)
    y = y.reshape(b, n2_loc, NLIMB, d, n1 // d)
    return y.permute(3, 0, 4, 2, 1).contiguous()


def four_step_twiddle(x: torch.Tensor, tables: tuple, shard: int, d: int) -> torch.Tensor:
    """Step 2 of the four-step NTT on one shard: x (B, n2/D, 8, n1) int32,
    the column NTTs' output, times w^(k1 i2) with `tables` from
    `twiddle_tables` (forward or inverse), written as the (D, B, n1/D, 8,
    n2/D) blocks of the exchange. One K15 launch for a CUDA tensor."""
    tlo, thi, s = tables
    if x.dtype != torch.int32 or x.dim() != 4 or x.shape[2] != NLIMB or not x.is_contiguous():
        raise ValueError(f"four_step_twiddle: want contiguous int32 (B, n2/D, 8, n1), "
                         f"got {tuple(x.shape)}")
    b, n2_loc, _, n1 = x.shape
    n = n1 * n2_loc * d
    if (n1 % d or n != 1 << (n.bit_length() - 1) or not 0 <= shard < d
            or tlo.shape != (1 << s, NLIMB) or thi.shape != (n >> s, NLIMB)):
        raise ValueError(f"four_step_twiddle: bad shard {shard}/{d} or tables "
                         f"{tuple(tlo.shape)}, {tuple(thi.shape)} for n = {n}")
    if x.device.type == "cpu":
        return four_step_twiddle_plain(x, tables, shard, d)
    if x.device.type != "cuda":
        raise RuntimeError(f"four_step_twiddle: unsupported device {x.device}")
    out = torch.empty((d, b, n1 // d, NLIMB, n2_loc), dtype=torch.int32, device=x.device)
    kernels.FOUR_STEP.launch(out.data_ptr(), x.data_ptr(), tlo.contiguous().data_ptr(),
                             thi.contiguous().data_ptr(), b, n1, n2_loc, d, shard, s,
                             FOUR_STEP_TILES.index(FOUR_STEP_TILE))
    return out


# ---------------------------------------------------------------- the transform

def _local_ntt_last(x: torch.Tensor, dom, inverse: bool, scale: torch.Tensor) -> torch.Tensor:
    """Natural-order NTT of every row of x (R, 8, L) (K5 from
    ntt.NTT_BLOCK_MIN_LOG up, K3 below); an inverse multiplies its outputs
    by `scale` (8, 1)."""
    if inverse:
        y = x.clone()
        ntt_ops._inverse_(y, dom, scale)
        return y.index_select(-1, dom.bitrev)
    y = x.index_select(-1, dom.bitrev).contiguous()
    ntt_ops._forward_(y, dom)
    return y


def ntt_four_step_partial(mesh, xs: list, log_n1: int, log_n2: int, inverse: bool,
                          unscaled: bool = False) -> list:
    """Steps 1-4: each shard's (B, n2/D, 8, n1) block in, its (B, n1/D, 8,
    n2) block of the INTERMEDIATE order out (X[k1 + n1 k2] at row (b,
    k1_loc), lane k2). An inverse scales its column and row transforms by
    1/n1 and 1/n2, so the whole transform carries 1/n, unless `unscaled`."""
    d, n1, n2 = mesh.size, 1 << log_n1, 1 << log_n2
    blocks = []
    for shard, x, dev in zip(mesh.local, xs, mesh.local_devices):
        b = x.shape[0]
        if x.shape != (b, n2 // d, NLIMB, n1):
            raise ValueError(f"ntt_four_step_partial: shard {shard} is {tuple(x.shape)}, want "
                             f"(B, {n2 // d}, 8, {n1})")
        dom1 = ntt_ops.get_domain(log_n1, dev)
        with on_device(dev):
            s1 = lb.one_mont(FR_SPEC, dev) if unscaled else dom1.n_inv_mont
            cols = _local_ntt_last(x.reshape(b * (n2 // d), NLIMB, n1), dom1, inverse, s1)
            blocks.append(four_step_twiddle(cols.reshape(x.shape),
                                            twiddle_tables(log_n1 + log_n2, dev, inverse),
                                            shard, d))
    rows = mesh.all_to_all(blocks, 0, 4)  # (1, B, n1/D, 8, n2): i2 from every shard
    out = []
    for r, dev in zip(rows, mesh.local_devices):
        b = r.shape[1]
        dom2 = ntt_ops.get_domain(log_n2, dev)
        with on_device(dev):
            s2 = lb.one_mont(FR_SPEC, dev) if unscaled else dom2.n_inv_mont
            y = _local_ntt_last(r.reshape(b * (n1 // d), NLIMB, n2), dom2, inverse, s2)
        out.append(y.reshape(b, n1 // d, NLIMB, n2))
    return out


def to_natural(mesh, ps: list) -> list:
    """Step 5: the intermediate blocks (B, n1/D, 8, n2) -> natural order,
    each shard's contiguous (B, 8, n/D) chunk: exchange k2 blocks, then
    [k2_loc][k1] is the chunk's own order."""
    qs = mesh.all_to_all(ps, 3, 1)  # (B, n1, 8, n2/D)
    return [q.permute(0, 2, 3, 1).reshape(q.shape[0], NLIMB, -1).contiguous() for q in qs]


def ntt_four_step_local(mesh, xs: list, log_n1: int, log_n2: int, inverse: bool,
                        unscaled: bool = False) -> list:
    """The whole four-step transform: each shard's (B, n2/D, 8, n1) block
    in, its natural-order contiguous (B, 8, n/D) chunk out."""
    return to_natural(mesh, ntt_four_step_partial(mesh, xs, log_n1, log_n2, inverse, unscaled))


def make_dist_ntt(mesh, log_n: int, batch: int, inverse: bool = False):
    """The natural-order transform of (B, 8, n) over `mesh`, sharded
    contiguously on n in and out (the JAX make_dist_ntt's sharding): the
    returned fn takes this process's shards, (B, 8, n/D) each, and returns
    theirs. Step 0 reshards the contiguous chunks onto i2 blocks (an
    all_to_all, where the JAX package's shard_map lets XLA reshard)."""
    d, n = mesh.size, 1 << log_n
    log_n1, log_n2 = split_logs(log_n, d)
    n1, n2 = 1 << log_n1, 1 << log_n2
    if not can_distribute(log_n, d):
        raise ValueError(f"make_dist_ntt: a mesh of {d} does not tile 2^{log_n}")

    def fn(xs: list) -> list:
        for x in xs:
            if x.shape != (batch, NLIMB, n // d):
                raise ValueError(f"dist ntt: want shards ({batch}, 8, {n // d}), "
                                 f"got {tuple(x.shape)}")
        blocks = mesh.all_to_all([x.reshape(batch, NLIMB, n1 // d, n2) for x in xs], 3, 2)
        cols = [b.permute(0, 3, 1, 2).contiguous() for b in blocks]  # (B, n2/D, 8, n1)
        return ntt_four_step_local(mesh, cols, log_n1, log_n2, inverse)

    return fn
