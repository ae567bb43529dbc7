"""Cheap batched test-point generation for profiling and tests.

The analog of the reference's `rand_host_many`
(icicle/include/icicle/curves/projective.h — host random point batches
used by its bench/test rigs) and of icicle_snark_tpu/_testpoints.py.
Generating `lanes` truly random points on the host is O(lanes * 254)
Python point ops; throughput probes only need well-formed on-curve data in
every lane, so we generate a small pool of distinct multiples of the
generator and tile it.
"""

from __future__ import annotations

import numpy as np

from .fields import limbs as lb
from .refmath import curve as rcv
from .refmath.field import fq_to_mont
from .runtime import require_device

_POOL = 64


def random_g1_batch(lanes: int, seed: int = 0, device="cuda"):
    """(x, y, z) Montgomery-form int32 limb tensors, each (8, lanes) on
    `device`: lanes on-curve affine points (z = 1 in Montgomery form),
    tiled from a pool of `_POOL` distinct generator multiples. The same
    integers as the JAX package's random_g1_batch for the same seed."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 1 << 31, size=min(lanes, _POOL), dtype=np.uint64)
    aff = [rcv.g1_to_affine(rcv.g1_mul(rcv.G1_GEN, int(k))) for k in ks]
    xs = lb.ints_to_limbs([fq_to_mont(a[0]) for a in aff], dev)
    ys = lb.ints_to_limbs([fq_to_mont(a[1]) for a in aff], dev)
    ones = lb.ints_to_limbs([fq_to_mont(1)] * xs.shape[1], dev)
    reps = -(-lanes // xs.shape[1])
    return tuple(t.repeat(1, reps)[:, :lanes].contiguous() for t in (xs, ys, ones))
