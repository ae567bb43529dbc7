"""Element-wise field vector ops and reductions (kernels K1, K9, K10, and
K12, K16, K17 over the other curves' fields).

API parity with ICICLE's VecOps surface and with
icicle_snark_tpu/ops/vec_ops.py: add / accumulate / sub / mul / div / neg /
inv, scalar-vector variants, sum and product reductions, mixed-field
multiply, config-driven batches, and Montgomery conversion. Every function
takes and returns the port's (..., words, n) limb-major int32 tensors over
the chosen field (default BN254 Fr, 8 words), in Montgomery form, and runs
on the input's own device:

  * add, sub, mul, neg, accumulate, the scalar ops, mixed_mul, the *_cfg
    ops, to_mont and from_mont are one K1 launch (csrc/field_vec.cu) each,
    a scalar or a base-field vector broadcast by K1's rule; over the other
    curves' fields (curves/device.py `curve_specs`) one K12 launch
    (csrc/field_vec_n.cu) by the same rule;
  * inv is one K9 launch (csrc/field_pow.cu, a^(p-2) per lane; inv(0) = 0),
    div one K9 and one K1; over the other fields K16
    (csrc/field_pow_n.cu) and K12;
  * sum_reduce and product_reduce are K10 (csrc/field_reduce.cu), K17
    (csrc/field_reduce_n.cu) over the other fields: one launch over spans
    of each row, and one more, a block a row, over the spans' partials when
    a row has several. The sum takes spans of REDUCE_BLOCK_ELEMS elements;
    the product (csrc/field_product.cuh) a few blocks an SM
    (`product_blocks`), each thread folding a long run into two
    accumulators;
  * product_reduce over a field of more than 8 words raises
    InvalidArgument, on every device, as the JAX package's does (its
    product_reduce, icicle_snark_tpu/ops/vec_ops.py:84, reshapes the
    Montgomery one to (NLIMB, 1) and fails at 12 and 24 words).

For CPU tensors each kernel's plain version runs instead.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..errors import InvalidArgument
from ..fields import limbs as lb
from ..fields.limbs import FR_SPEC, NLIMB

REDUCE_OPS = {"sum": 0, "product": 1}
# The sum: elements one block of 256 threads folds in its first launch (8 a thread)
REDUCE_BLOCK_ELEMS = 2048
# The product (csrc/field_product.cuh): blocks of PRODUCT_THREADS threads an
# SM in its first launch, split over the rows (about 124 elements a thread
# over a row of 2^24 on 132 SMs), and the fewest elements a thread folds, so
# that a short row takes fewer blocks. On an H100 a row of 2^24 took
# 0.52-0.54 ms at 2-4 blocks an SM and 0.55-0.57 at 1 (chip_smoke.py
# `product_sweep`, PERF.md PR 11).
PRODUCT_THREADS = 256
PRODUCT_BLOCKS_PER_SM = 4
PRODUCT_MIN_RUN = 16


def sm_count(device) -> int:
    """The SM count of the card `device` names."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


def product_blocks(rows: int, n: int, sms: int) -> int:
    """Blocks a row of the product's first launch: PRODUCT_BLOCKS_PER_SM
    blocks an SM over all rows, at most one for every PRODUCT_THREADS *
    PRODUCT_MIN_RUN elements of a row, at least one."""
    per_row = -(-sms * PRODUCT_BLOCKS_PER_SM // rows)
    return max(1, min(per_row, n // (PRODUCT_THREADS * PRODUCT_MIN_RUN)))


def add(a, b, spec=FR_SPEC):
    return lb.add_mod(a, b, spec)


def sub(a, b, spec=FR_SPEC):
    return lb.sub_mod(a, b, spec)


def mul(a, b, spec=FR_SPEC):
    return lb.mont_mul(a, b, spec)


def neg(a, spec=FR_SPEC):
    return lb.neg_mod(a, spec)


def inv(a, spec=FR_SPEC):
    """a^-1 per element (Fermat); 0 maps to 0."""
    return lb.mont_inv(a, spec)


def div(a, b, spec=FR_SPEC):
    """a / b per element; a / 0 is 0, as in the JAX package."""
    return lb.mont_mul(a, lb.mont_inv(b, spec), spec)


def accumulate(a, b, spec=FR_SPEC):
    """a += b, IN PLACE on a (ICICLE's semantics; the JAX package returns a
    new array); returns a."""
    a.copy_(lb.add_mod(a, b, spec))
    return a


def _scalar(s: torch.Tensor, spec) -> torch.Tensor:
    """s: (words,) or (words, 1) -> (words, 1), the constant K1 broadcasts
    over lanes."""
    if s.numel() != spec.words:
        raise ValueError(f"scalar: want ({spec.words},) or ({spec.words}, 1) limbs, "
                         f"got {tuple(s.shape)}")
    return s.reshape(spec.words, 1)


def scalar_add(s, v, spec=FR_SPEC):
    """s + v; s (words,) or (words, 1), v (..., words, n)."""
    return lb.add_mod(v, _scalar(s, spec), spec)


def scalar_sub(s, v, spec=FR_SPEC):
    """s - v (one K1 launch: b - a with the scalar as b)."""
    return lb.rsub_mod(v, _scalar(s, spec), spec)


def scalar_mul(s, v, spec=FR_SPEC):
    return lb.mont_mul(v, _scalar(s, spec), spec)


# ---------------------------------------------------------------- K10

def _fill(op: int, spec, device) -> torch.Tensor:
    """The padding of the JAX tree: 0 for the sum, the Montgomery one for
    the product."""
    return lb.one_mont(spec, device) if op else torch.zeros((spec.words, 1), dtype=torch.int32,
                                                              device=device)


def field_reduce_plain(op: int, v: torch.Tensor, spec) -> torch.Tensor:
    """The plain PyTorch version of K10 and K17: the JAX package's log-depth
    pairing (element 2j with 2j+1, an odd tail padded) over (..., words, n);
    returns (..., words, 1)."""
    code = lb.OP_MUL if op else lb.OP_ADD
    fill = _fill(op, spec, v.device)
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = torch.cat([v, fill.expand(v.shape[:-1] + (1,))], dim=-1)
        v = lb.field_op_plain(code, v[..., 0::2].contiguous(), v[..., 1::2].contiguous(), spec)
    return v


def field_reduce(op: int, v: torch.Tensor, spec) -> torch.Tensor:
    """Modular sum (op 0) or Montgomery product (op 1) over the last axis of
    (..., words, n), n >= 1; returns (..., words, 1), canonical. Two K10
    (BN254) or K17 launches, one when a row takes one block. The product
    takes fields of 8 words only (InvalidArgument otherwise), as the JAX
    package's product_reduce does."""
    w = spec.words
    lb._check(v, "v", w)
    if op not in (0, 1) or v.shape[-1] < 1:
        raise ValueError(f"field_reduce: want op 0 or 1 and n >= 1, got {op}, n = {v.shape[-1]}")
    if op and w > NLIMB:
        raise InvalidArgument(
            f"product_reduce: {spec.name} has {w} words; the JAX package's product_reduce "
            f"(icicle_snark_tpu/ops/vec_ops.py:84) reshapes its one to (NLIMB, 1) and fails "
            f"above {NLIMB} words")
    if v.device.type == "cpu":
        return field_reduce_plain(op, v, spec)
    if v.device.type != "cuda":
        raise RuntimeError(f"field_reduce: unsupported device {v.device}")
    if spec.field_id < 0:
        raise InvalidArgument(f"field_reduce: no kernel for the field {spec.name}")
    kernel = kernels.FIELD_REDUCE if spec.bn254 else kernels.FIELD_REDUCE_N
    v = v.contiguous()
    rows, n = v.numel() // (w * v.shape[-1]), v.shape[-1]

    def launch(src, n, blocks):
        out = torch.empty(v.shape[:-1] + (blocks,), dtype=torch.int32, device=v.device)
        kernel.launch(op, spec.field_id, out.data_ptr(), src.data_ptr(), rows, n, blocks)
        return out

    blocks = (product_blocks(rows, n, sm_count(v.device)) if op
              else -(-n // REDUCE_BLOCK_ELEMS))
    part = launch(v, n, blocks)
    return part if blocks == 1 else launch(part, blocks, 1)


def sum_reduce(v, spec=FR_SPEC):
    """Modular sum over the last axis: (..., words, n) -> (..., words)."""
    return field_reduce(REDUCE_OPS["sum"], v, spec)[..., 0]


def product_reduce(v, spec=FR_SPEC):
    """Modular product over the last axis (Montgomery in and out):
    (..., 8, n) -> (..., 8); fields of 8 words only."""
    return field_reduce(REDUCE_OPS["product"], v, spec)[..., 0]


# ---------------------------------------------------------------- mixed, cfg

def mixed_mul(ext, base, spec=FR_SPEC):
    """Extension-field vector times base-field vector, componentwise
    Montgomery products (ICICLE's mixed-type VecOps mul, e.g. Fq2 values
    scaled by Fq values): ext (k, 8, n), base (8, n); one K1 launch, base
    broadcast over the k components."""
    return lb.mont_mul(ext, base, spec)


def _apply_cfg(fn, a, b, cfg, spec):
    """Config-driven dispatch (ICICLE: VecOpsConfig + setup_config).
    batch_size splits each vector of n into batch_size rows of
    n / batch_size; an elementwise op over the rows is the op over the whole
    vector, so after the check the port launches once over all lanes."""
    if cfg is not None and cfg.batch_size > 1 and a.shape[-1] % cfg.batch_size:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide length {a.shape[-1]}")
    return fn(a, b, spec)


def add_cfg(a, b, cfg=None, spec=FR_SPEC):
    return _apply_cfg(lb.add_mod, a, b, cfg, spec)


def sub_cfg(a, b, cfg=None, spec=FR_SPEC):
    return _apply_cfg(lb.sub_mod, a, b, cfg, spec)


def mul_cfg(a, b, cfg=None, spec=FR_SPEC):
    return _apply_cfg(lb.mont_mul, a, b, cfg, spec)


def to_mont(a, spec=FR_SPEC):
    return lb.to_mont(a, spec)


def from_mont(a, spec=FR_SPEC):
    return lb.mont_reduce(a, spec)
