"""Build the port's ZKeyCache from the JAX package's cache state.

Takes the fields of an icicle_snark_tpu ZKeyCache as numpy arrays (its
(16, n) 16-bit limb layout) so both packages can run on identical state.
Imports nothing of the JAX package: the caller converts its arrays with
np.asarray. The cache derives its own tables from what is given here (K4's
point records, the bit-reversed scaled coset keys of K5's last inverse
pass), as a cache loaded from a zkey does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.limbs import from_jax_limbs
from ..ops.ntt import NTTDomain
from ..runtime import require_device
from .cache import ZKeyCache, build_r1cs_plan


def _t(arr: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _g1(pt, dev) -> tuple:
    return tuple(_t(from_jax_limbs(c), dev) for c in pt)


def _g2(pt, dev) -> tuple:
    # JAX (16, 2, n) -> (8, 2, n) -> the port's (2, 8, n)
    return tuple(_t(from_jax_limbs(c).transpose(1, 0, 2), dev) for c in pt)


def cache_from_jax_arrays(header, *, coefs, witness_idx, segments, level2,
                          points_a, points_b1, points_b2, points_c, points_h,
                          keys, msm_c: int = 0, msm_pre: int = 1, msm_c2: int = 0,
                          msm_pre2: int = 1, device="cuda") -> ZKeyCache:
    """header: the zkey header (either package's ZKeyHeader; fields are
    read by name). coefs (16, nnz); witness_idx, segments (nnz,); level2
    None or (segments2, num_segments2); points as JAX affine (x, y), with
    msm_pre / msm_pre2 interleaved precompute copies per base (the two
    packages share that layout, so only the limbs are repacked); keys
    (16, n) natural-order coset powers. msm_c / msm_c2 are the window
    sizes the copies were shifted for: required when a factor is above 1.
    The cache lives on the card unless `device` asks for the CPU; without a
    card that default raises."""
    if (msm_pre > 1 and not msm_c) or (msm_pre2 > 1 and not msm_c2):
        raise ValueError("a cache with precomputed bases needs the window size they were built for")
    dev = require_device(device)
    n = header.domain_size
    seg = np.asarray(segments).astype(np.int64)
    slots = np.asarray(level2[0]).astype(np.int64)[seg] if level2 is not None else seg
    real = slots < 2 * n  # drop the plan's padding records (slot 2n)
    plan = build_r1cs_plan(
        _t(slots[real], dev),
        _t(np.asarray(witness_idx).astype(np.int64)[real], dev),
        _t(from_jax_limbs(coefs)[:, real], dev),
        n,
    )
    return ZKeyCache(
        header=header,
        plan=plan,
        points_a=_g1(points_a, dev),
        points_b1=_g1(points_b1, dev),
        points_b2=_g2(points_b2, dev),
        points_c=_g1(points_c, dev),
        points_h=_g1(points_h, dev),
        keys=_t(from_jax_limbs(keys), dev),
        domain=NTTDomain(header.power, dev),
        msm_c=msm_c, msm_c2=msm_c2, msm_pre=msm_pre, msm_pre2=msm_pre2,
    )
