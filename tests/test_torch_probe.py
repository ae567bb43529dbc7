"""The port's throughput probe (K8 plain version on the CPU) against the
JAX package's two Pallas probes run in interpret mode, and against Python
integers: the same numpy-seeded inputs through `make_pallas_chain` /
the `vpu_ceiling_probe` ops and through `probe_chain`. Integer chains agree
word for word; the f32 chain within 1e-5 relative at depth <= 64 (one side
fuses the multiply-add, the other rounds the product first)."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch.tools import throughput_probe as tp
from tools import pallas_microbench, vpu_ceiling_probe

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

SHAPE = (16, 128)
N = SHAPE[0] * SHAPE[1]
# the Pallas probes' ops, by the port's op code
PALLAS_OPS = {
    0: lambda a, b: a * b,
    1: lambda a, b: a + b,
    2: lambda a, b: (a * b) & np.uint32(0xFFFF),
    4: lambda a, b: a * b + b,
}


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("op", [0, 1, 2, 4], ids=[tp.OPS[i] for i in (0, 1, 2, 4)])
def test_chain_matches_pallas_microbench_interpreted(op, monkeypatch):
    depth = 24
    x, y = tp.probe_inputs(N, op, seed=op, device="cpu")
    monkeypatch.setattr(pallas_microbench.pl, "pallas_call",
                        partial(pallas_microbench.pl.pallas_call, interpret=True))
    view = np.float32 if op == 4 else np.uint32
    jx = jnp.asarray(x.numpy().view(view).reshape(SHAPE))
    jy = jnp.asarray(y.numpy().view(view).reshape(SHAPE))
    want = np.asarray(pallas_microbench.make_pallas_chain(depth, 8, PALLAS_OPS[op])(jx, jy))
    got = tp.probe_chain(x, y, op, 1, depth)[0].numpy().view(view).reshape(SHAPE)
    if op == 4:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name,op", [("mul", 0), ("mulmask", 2), ("fma", 4)])
def test_chain_matches_vpu_ceiling_probe_ops(name, op):
    """pallas_probe's recurrence acc = fn(a, acc) is the chain with y = a;
    its fma adds a, the chain adds y: the same word."""
    depth = 16
    x, y = tp.probe_inputs(N, op, seed=7 + op, device="cpu")
    view = np.float32 if op == 4 else np.uint32
    a, acc = jnp.asarray(y.numpy().view(view)), jnp.asarray(x.numpy().view(view))
    fn = vpu_ceiling_probe.OPS[name]
    for _ in range(depth):
        acc = fn(a, acc)
    got = tp.probe_chain(x, y, op, 1, depth)[0].numpy().view(view)
    if op == 4:
        np.testing.assert_allclose(got, np.asarray(acc), rtol=1e-5)
    else:
        assert np.array_equal(got, np.asarray(acc))


@pytest.mark.parametrize("width", tp.WIDTHS)
def test_integer_chains_match_python_ints(width):
    depth, n = 11, 24
    for op in range(4):
        x, y = tp.probe_inputs(n, op, seed=width, device="cpu")
        # full-width words too: the 16-bit seeds never carry out of 32 bits early
        x[0], y[0], x[1], y[1] = -1, -1, -(1 << 31), 0x7FFFFFFF
        out = _u32(tp.probe_chain(x, y, op, width, depth))
        xs, ys = _u32(x).tolist(), _u32(y).tolist()
        for w in range(width):
            for i in range(n):
                lo, hi = (xs[i] + w) & tp.M32, w
                for _ in range(depth):
                    if op == 0:
                        lo = lo * ys[i] & tp.M32
                    elif op == 1:
                        lo = (lo + ys[i]) & tp.M32
                    elif op == 2:
                        lo = lo * ys[i] & 0xFFFF
                    else:
                        s = lo * ys[i] + hi
                        lo, hi = s & tp.M32, s >> 32
                assert int(out[w, i]) == (lo ^ hi if op == 3 else lo), (op, w, i)


def test_fma_chain_within_tolerance_of_fused():
    """The kernel rounds once per step (fma.rn.f32); the plain version
    twice. Against a float64 evaluation rounded to float32 each step the
    plain chain stays within 1e-5 relative at depth 64."""
    depth = 64
    x, y = tp.probe_inputs(256, 4, seed=3, device="cpu")
    got = tp.probe_chain(x, y, 4, 2, depth).numpy().view(np.float32)
    yf = y.numpy().view(np.float32).astype(np.float64)
    for w in range(2):
        c = (x.numpy().view(np.float32) + np.float32(w)).astype(np.float32)
        for _ in range(depth):
            c = (c.astype(np.float64) * yf + yf).astype(np.float32)
        np.testing.assert_allclose(got[w], c, rtol=1e-5)


def test_probe_rejects_bad_arguments_and_needs_a_card():
    x, y = tp.probe_inputs(8, 0, seed=0, device="cpu")
    with pytest.raises(ValueError):
        tp.probe_chain(x, y, 0, 3, 4)
    with pytest.raises(ValueError):
        tp.probe_chain(x, y[:4], 0, 1, 4)
    with pytest.raises(ValueError):
        tp.probe_chain(x.to(torch.int64), y.to(torch.int64), 0, 1, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tp.measure(depth=4)
        assert tp.main([]) == 2
