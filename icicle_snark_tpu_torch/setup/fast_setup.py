"""Device trusted-setup generator (fixture builder for the port's runs).

Point generation dominates setup cost (five fixed-base scalar multiplies
per constraint). As in icicle_snark_tpu/setup/fast_setup.py:

  * the host builds the window tables T[w][d] = d * 2^(8w) * G
    (32 x 256 points per group),
  * the device looks up T[w][digit_w(k_i)] and mixed-adds over 32 windows,
    n lanes in parallel: one K11 launch per chunk of lanes
    (`fixed_base_msm`, csrc/fixed_base.cu, one thread a lane; G1 in lazy
    Fq arithmetic, csrc/fq_lazy.cuh); its plain version
    `fixed_base_msm_plain` is the 32-step scan of gathers and plain-torch
    `pmadd`,
  * projective -> affine by a batched inverse, one Fermat inversion for
    several lanes (K7 point_to_affine, csrc/affine_batch.cuh),
  * coordinates come back Montgomery-form and are written to the zkey
    byte-for-byte identical to the host oracle's output.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..curve import jcurve as jc
from ..fields import limbs as lb
from ..ops.msm import point_records
from ..refmath import curve as cv
from ..refmath.field import fq_to_mont
from ..runtime import require_device
from ..trace import NULL, PhaseTimer
from .r1cs import R1CS
from .trusted_setup import FixedBase, SetupScalars, ToxicWaste, _fixed_bases, write_zkey

WINDOW = 8
N_WINDOWS = 256 // WINDOW


def _table_g1(fb: FixedBase, dev) -> tuple:
    """Host FixedBase table -> (x, y) each (8, 32*256), lane w*256 + d; the
    identity (d = 0) is (0, 0), which pmadd treats as the identity."""
    xs, ys = [0] * (N_WINDOWS * 256), [0] * (N_WINDOWS * 256)
    for w in range(N_WINDOWS):
        for d in range(1, 256):
            x, y = cv.g1_to_affine(fb.table[w][d])
            xs[w * 256 + d], ys[w * 256 + d] = fq_to_mont(x), fq_to_mont(y)
    return lb.ints_to_limbs(xs, dev), lb.ints_to_limbs(ys, dev)


def _table_g2(fb: FixedBase, dev) -> tuple:
    """(x, y) each (2, 8, 32*256)."""
    comps = [[[0] * (N_WINDOWS * 256) for _ in range(2)] for _ in range(2)]
    for w in range(N_WINDOWS):
        for d in range(1, 256):
            pt = cv.g2_to_affine(fb.table[w][d])
            for coord in range(2):
                for comp in range(2):
                    comps[coord][comp][w * 256 + d] = fq_to_mont(pt[coord][comp])
    return tuple(
        torch.stack([lb.ints_to_limbs(comps[coord][comp], dev) for comp in range(2)])
        for coord in range(2)
    )


def _digits(scalars: torch.Tensor) -> torch.Tensor:
    """(8, n) int32 scalars -> (32, n) int64 8-bit window digits."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(s >> (8 * j)) & 0xFF for j in range(4)], dim=1).reshape(N_WINDOWS, -1)


def fixed_base_msm_plain(scalars: torch.Tensor, table, ops):
    """The plain version of K11: P_i = k_i * G for all lanes, 32 steps of
    table gathers and `pmadd` (icicle_snark_tpu/setup/fast_setup.py
    _fixed_base_msm). With the plain ops (jc.G1_PLAIN, jc.G2_PLAIN) no kernel
    runs; with jc.G1 / jc.G2 on CUDA tensors every field operation is a K1
    launch, the route the device setup took before K11."""
    digs = _digits(scalars)
    acc = jc.identity(ops, scalars.shape[-1], scalars.device)
    for w in range(N_WINDOWS):
        idx = w * 256 + digs[w]
        acc = jc.pmadd(ops, acc, (table[0][..., idx], table[1][..., idx]))
    return acc


def fixed_base_msm(scalars: torch.Tensor, table, ops, records: torch.Tensor | None = None):
    """P_i = k_i * G for all lanes: scalars (8, n) int32 (integers below
    2^256), `table` the (x, y) window table of `_table_g1`/`_table_g2`, ops
    jc.G1 or jc.G2. Returns projective (x, y, z), each (8, n) or (2, 8, n).
    One K11 launch for CUDA tensors (`records`, the table's
    `point_records`, may be passed in to skip building them); the plain
    version for CPU tensors."""
    if scalars.dtype != torch.int32 or scalars.dim() != 2 or scalars.shape[0] != lb.NLIMB:
        raise ValueError(f"fixed_base_msm: want (8, n) int32 scalars, got {tuple(scalars.shape)}")
    if table[0].shape[-1] != N_WINDOWS * 256 or table[0].device != scalars.device:
        raise ValueError("fixed_base_msm: the table is (x, y) over 32 x 256 lanes on the "
                         "scalars' device")
    plain = jc.G2_PLAIN if ops.g2 else jc.G1_PLAIN
    if scalars.device.type == "cpu":
        return fixed_base_msm_plain(scalars, table, plain)
    if scalars.device.type != "cuda":
        raise RuntimeError(f"fixed_base_msm: unsupported device {scalars.device}")
    records = point_records(table) if records is None else records
    scalars = scalars.contiguous()
    n = scalars.shape[-1]
    coords = (2, lb.NLIMB) if ops.g2 else (lb.NLIMB,)
    out = torch.empty((3,) + coords + (n,), dtype=torch.int32, device=scalars.device)
    kernels.FIXED_BASE.launch(int(ops.g2), out.data_ptr(), scalars.data_ptr(),
                              records.data_ptr(), n)
    return jc.point_unstack(out)


def _to_affine_bytes(proj, ops) -> bytes:
    """Projective points -> snarkjs affine Montgomery bytes."""
    ax, ay = jc.to_affine(ops, proj)
    if ops.g2:
        cols = [ax[0], ax[1], ay[0], ay[1]]
    else:
        cols = [ax, ay]
    words = np.concatenate([lb.limbs_to_words(c) for c in cols], axis=1)
    return words.astype("<u4").tobytes()


def _points_bytes(scalars_ints, table, ops, dev, chunk: int) -> bytes:
    records = point_records(table) if dev.type == "cuda" else None
    parts = []
    for i in range(0, len(scalars_ints), chunk):
        sc = lb.ints_to_limbs(scalars_ints[i: i + chunk], dev)
        parts.append(_to_affine_bytes(fixed_base_msm(sc, table, ops, records), ops))
    return b"".join(parts)


def groth16_setup_device(r1cs: R1CS, zkey_path: str, vk_path: str | None = None,
                         seed: bytes = b"icicle-snark-tpu-test-setup",
                         chunk: int = 1 << 18, device="cuda", timer: PhaseTimer | None = None):
    """Device-backed trusted setup; byte-identical output to
    trusted_setup.groth16_setup (and to the JAX package's
    groth16_setup_device) for the same seed. `timer` (a
    pipeline.PhaseTimer) takes the phases scalars, tables, g1_points,
    g2_points and write."""
    dev = require_device(device)
    timer = timer or NULL
    waste = ToxicWaste(seed)
    scal = SetupScalars(r1cs, waste)
    timer.mark("scalars")
    fb1, fb2 = _fixed_bases()
    t1 = _table_g1(fb1, dev)
    t2 = _table_g2(fb2, dev)
    timer.mark("tables")

    def gen1(ints):
        return _points_bytes(ints, t1, jc.G1, dev, chunk)

    g1_points = {
        "a": gen1(scal.u),
        "b1": gen1(scal.v),
        "c": gen1(scal.c),
        "h": gen1(scal.h),
        # small host-side pieces (exact-form parity with the oracle)
        "ic": [fb1.mul(k) for k in scal.ic],
        "alpha": fb1.mul(waste.alpha),
        "beta": fb1.mul(waste.beta),
        "delta": fb1.mul(waste.delta),
    }
    timer.mark("g1_points")
    g2_points = {
        "b2": _points_bytes(scal.v, t2, jc.G2, dev, chunk),
        "beta": fb2.mul(waste.beta),
        "gamma": fb2.mul(waste.gamma),
        "delta": fb2.mul(waste.delta),
    }
    timer.mark("g2_points")
    vk = write_zkey(scal, r1cs, zkey_path, vk_path, g1_points, g2_points)
    timer.mark("write")
    return vk
