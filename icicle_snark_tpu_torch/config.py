"""Per-op configuration structs (a copy of icicle_snark_tpu/config.py,
which the port does not import).

API-shape parity with ICICLE's #[repr(C)] config structs and their
ConfigExtension knob map (icicle-core `{msm,ntt,vec_ops}/mod.rs`). Fields
that only make sense for explicit streams and device flags collapse into
documentation: arrays are torch tensors, each op runs on its input's
device, and kernels launch on PyTorch's current stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class NTTDir(Enum):
    FORWARD = 0
    INVERSE = 1


class Ordering(Enum):
    """kNN/kNR/kRN/kRR/kNM/kMN (ICICLE ntt/mod.rs).

    kNM/kMN are ICICLE's mixed-radix digit-reversed orderings; for a
    radix-2 transform the digit reversal IS the bit reversal, so
    NM == NR and MN == RN here: the round-trip contract (NM forward then
    MN inverse restores natural order, the coset-interpolation pattern)
    holds identically."""

    NN = 0
    NR = 1
    RN = 2
    RR = 3
    NM = 4
    MN = 5


@dataclass
class MSMConfig:
    """ICICLE's MSMConfig (msm/mod.rs). `c=0` = the port's `choose_c`;
    `precompute_factor` consumes bases produced by ops.msm.precompute_bases
    with the same factor and window size. `chunk` (the JAX package's
    prefix-scan chunk), `signed` (the port's digits are always signed),
    `batch_size` and `are_points_shared_in_batch` are accepted and
    ignored, as the JAX package's `_cfg_params` ignores them."""

    c: int = 0
    chunk: int = 32
    signed: bool = True
    precompute_factor: int = 1
    batch_size: int = 1
    are_points_shared_in_batch: bool = True
    ext: dict = field(default_factory=dict)


@dataclass
class NTTConfig:
    """ICICLE's NTTConfig (ntt/mod.rs). `coset_gen` is an arbitrary coset
    generator as a field INTEGER (standard form); `columns_batch=True`
    means the batch lives in the LAST axis, (n, 8, B) in the port's
    layout, column-major like ICICLE's columns_batch."""

    batch_size: int = 1
    ordering: Ordering = Ordering.NN
    coset_gen: int | None = None  # arbitrary generator; None = no coset
    columns_batch: bool = False
    ext: dict = field(default_factory=dict)


@dataclass
class VecOpsConfig:
    """ICICLE's VecOpsConfig (vec_ops/mod.rs). `batch_size` splits a
    vector into that many rows (ops/vec_ops.py `_apply_cfg`)."""

    batch_size: int = 1
    ext: dict = field(default_factory=dict)
