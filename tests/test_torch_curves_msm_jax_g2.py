"""The other curves' G2 MSM window sums in the port (K13's plain versions on
the CPU) against the JAX package's eager `msm_device_grouped`, window by
window in affine form: bls12-377 G2 (u^2 = -5, b3 a product by a constant)
and bw6-761 G2 (the M-twist over Fq). See tests/test_torch_curves_msm.py."""

import pytest
import torch
from test_torch_curves_msm import window_sums_match_jax

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["bls12_377", "bw6_761"])
def test_g2_window_sums_match_jax(name):
    window_sums_match_jax(name, True)
