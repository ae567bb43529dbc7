"""The port's NTT (K3 plain version on the CPU) against the JAX package's
intt_dif / ntt_dit at batch 3: exact integer equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import ntt
from icicle_snark_tpu_torch.refmath.field import R_MOD, W

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def _batch(rng, log_n):
    """(3, 8, n) port tensor and the JAX (16, 3, n) array of the same
    canonical values (numpy seed)."""
    n = 1 << log_n
    words = rng.integers(0, 1 << 32, size=(3 * n, 8), dtype=np.uint64).astype(np.uint32)
    words[:, 7] = rng.integers(0, R_MOD >> 224, size=3 * n).astype(np.uint32)
    words[:3] = 0
    t = lb.words_to_limbs(words).reshape(8, 3, n).transpose(0, 1).contiguous()
    j = lb.to_jax_limbs(lb.words_to_limbs(words)).reshape(16, 3, n)
    return t, j


def _port_to_jax(t):
    """(B, 8, n) -> JAX (16, B, n)."""
    return lb.to_jax_limbs(t.transpose(0, 1).contiguous())


@pytest.mark.parametrize("log_n", [6, 10])
def test_intt_dif_and_ntt_dit_match_jax(log_n):
    rng = np.random.default_rng(log_n)
    x, jx = _batch(rng, log_n)
    dom = ntt.NTTDomain(log_n, "cpu")
    jdom = jntt.get_domain(log_n)

    coeffs = ntt.intt_dif(x, dom)
    jcoeffs = jax.jit(lambda a: jntt.intt_dif(a, jdom.tw_inv, jdom.n_inv_mont))(jnp.asarray(jx))
    assert np.array_equal(_port_to_jax(coeffs), np.asarray(jcoeffs))

    back = ntt.ntt_dit(coeffs, dom)
    jback = jax.jit(lambda a: jntt.ntt_dit(a, jdom.tw_fwd))(jcoeffs)
    assert np.array_equal(_port_to_jax(back), np.asarray(jback))
    assert torch.equal(back, x)


def test_domain_tables_match_jax():
    log_n = 6
    dom = ntt.NTTDomain(log_n, "cpu")
    jdom = jntt.get_domain(log_n)
    assert np.array_equal(lb.to_jax_limbs(dom.tw_fwd), np.asarray(jdom.tw_fwd))
    assert np.array_equal(lb.to_jax_limbs(dom.tw_inv), np.asarray(jdom.tw_inv))
    assert np.array_equal(lb.to_jax_limbs(dom.n_inv_mont), np.asarray(jdom.n_inv_mont)[:, :, 0])
    keys = ntt.powers_mont(W[log_n + 1], log_n, "cpu")
    assert np.array_equal(lb.to_jax_limbs(keys), np.asarray(jntt.powers_mont(W[log_n + 1], log_n)))
    assert dom.bitrev.tolist() == jntt.bitrev_permutation(log_n).tolist()


def test_stage_rejects_bad_shapes():
    dom = ntt.NTTDomain(4, "cpu")
    x = torch.zeros((3, 8, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt.ntt_stage(x[:, :, :8], dom.tw_fwd, 2, False)
    with pytest.raises(ValueError):
        ntt.ntt_stage(x, dom.tw_fwd, 3, False)
    assert jlb.NLIMB == 16  # the JAX layout the conversions assume
