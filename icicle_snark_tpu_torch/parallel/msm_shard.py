"""The MSM over a device mesh (kernels K4 and K6).

The port's counterpart of icicle_snark_tpu/parallel/msm_shard.py: each
shard runs the grouped Pippenger window sums over its own lanes through
ops/msm.py `window_sums` (K4; in core or sliced is that function's
choice), and the window sums of all shards are gathered and summed by one
K6 launch in the JAX package's tree order over the shards (`sum_windows`).
The order is fixed, so the result is the same in every process.
"""

from __future__ import annotations

import torch

from ..ops import msm as msm_ops
from .mesh import on_device


def combine_windows(mesh, ws: list) -> torch.Tensor:
    """Every shard's window sums (3, coords..., G, W), gathered and summed
    in shard order by one K6 launch: the mesh's total, on this process's
    first device."""
    pts = mesh.all_gather(ws)
    with on_device(pts[0].device):
        return msm_ops.sum_windows(torch.stack(pts))


def msm_window_sums_local(mesh, scalars: list, widths, records: list, c: int,
                          max_lanes: int | None = None, pre: int = 1) -> torch.Tensor:
    """Grouped window sums over the mesh: per local shard, scalars (8,
    sum(widths)) and its K4 records (the lanes of each group concatenated,
    `pre` rows a lane) through `msm_ops.window_sums` (max_lanes None: its
    default cap); then `combine_windows`. Returns (3, coords..., len(widths), W)."""
    ws = []
    for sc, rec, dev in zip(scalars, records, mesh.local_devices):
        with on_device(dev):
            ws.append(msm_ops.window_sums(sc, widths, rec, c, pre, max_lanes))
    return combine_windows(mesh, ws)
