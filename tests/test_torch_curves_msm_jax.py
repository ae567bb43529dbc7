"""The other curves' MSM window sums in the port (K13's plain versions on the
CPU) against the JAX package's eager `msm_device_grouped`, window by window
in affine form: bls12-377 G1, bw6-761 G1 and bls12-381 G2 (see
tests/test_torch_curves_msm.py; the JAX calls take seconds each, so the
groups are spread over files)."""

import pytest
import torch
from test_torch_curves_msm import window_sums_match_jax

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


@pytest.mark.parametrize("name, g2", [("bls12_377", False), ("bw6_761", False),
                                      ("bls12_381", True)])
def test_window_sums_match_jax(name, g2):
    window_sums_match_jax(name, g2)
