"""The port's sharded prove phases (parallel/prove_step.py) on meshes of CPU
shards (plain versions) against the JAX package's on its virtual CPU mesh,
on identical zkeys and witnesses: phase A's h (R1CS and coset evaluation)
on the four-step route (D = 2), on the replicated route (D = 8, the domain
too small to tile the mesh) and on a plan whose long row K2 sums over fold
levels; phases B and C's window sums, compared as affine points, in core
with precompute factor 1 and sliced past a small max_lanes with factor 2.
Field values are compared as integers, points in affine form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icicle_snark_tpu.fields import limbs as jlb
from icicle_snark_tpu.io.wtns import WtnsFile as JWtnsFile
from icicle_snark_tpu.io.wtns import write_wtns
from icicle_snark_tpu.ops import msm as jmsm
from icicle_snark_tpu.ops import ntt as jntt
from icicle_snark_tpu.parallel import mesh as jmesh
from icicle_snark_tpu.parallel import prove_step as jps
from icicle_snark_tpu.prover import cache as jcache
from icicle_snark_tpu.setup.r1cs import (complex_circuit, complex_circuit_witness, fanin_circuit,
                                        fanin_witness)
from icicle_snark_tpu.setup.trusted_setup import groth16_setup
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.ops import msm as msm_ops
from icicle_snark_tpu_torch.parallel import mesh as pmesh
from icicle_snark_tpu_torch.parallel import prove_step
from icicle_snark_tpu_torch.prover import convert, pipeline
from icicle_snark_tpu_torch.prover.cache import load_zkey_cache
from icicle_snark_tpu_torch.refmath import curve as rcv

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

C = 8  # the window size of both MSMs here


def _make(tmp, r1cs, witness):
    zkey, wtns = str(tmp / "c.zkey"), str(tmp / "c.wtns")
    groth16_setup(r1cs, zkey)
    write_wtns(wtns, witness)
    return zkey, wtns


@pytest.fixture(scope="module")
def complex_fixture(tmp_path_factory):
    r1cs = complex_circuit(20, 26)  # domain 32: split (2, 3) at D = 2
    return _make(tmp_path_factory.mktemp("ps_complex"), r1cs, complex_circuit_witness(r1cs, a=9))


def _witnesses(wtns_path, port_cache):
    w = JWtnsFile(wtns_path).witness_limbs()
    return (jlb.u32x8_to_limbs_device(jnp.asarray(w)),
            lb.words_to_limbs(w, port_cache.keys_br_scaled.device))


def _jax_phase_a(mesh, jc, jw) -> np.ndarray:
    """build_r1cs_coset_step called as run_sharded_prove calls it; h (16, n)."""
    d = mesh.devices.size
    pads = jps.pad_cache_for_mesh(jc, d)
    seg2, nseg2 = jc.plan.level2 if jc.plan.level2 is not None else (
        jnp.zeros((1,), jnp.int32), 0)
    step = jps.build_r1cs_coset_step(mesh, jc.header.power, jc.plan.num_segments, nseg2)
    dom = jntt.get_domain(jc.header.power)
    return np.asarray(step(jps._pad_last(jw, d), pads["coefs"], pads["wit_idx"],
                           pads["segments"], seg2, jc.keys, dom.tw_fwd, dom.tw_inv,
                           dom.n_inv_mont))


def _port_h(mesh, cache, pw) -> torch.Tensor:
    return torch.cat(prove_step.r1cs_coset_step(mesh, cache, pw), -1)


def _port_of_jax_g(ws, g2: bool) -> np.ndarray:
    """JAX window sums (3, 16, [2,] G, W) -> the port's (3, [2,] 8, G, W)."""
    a = np.asarray(ws)
    return np.stack([lb.from_jax_limbs(a[i], fq2=g2) for i in range(3)])


def _affine(ws, g2: bool) -> list:
    to_host = msm_ops.window_points_to_host_g2 if g2 else msm_ops.window_points_to_host_g1
    to_aff = rcv.g2_to_affine if g2 else rcv.g1_to_affine
    return [[to_aff(p) for p in to_host(ws, g)] for g in range(ws.shape[-2])]


def test_phase_a_four_step_route_matches_jax(complex_fixture):
    zkey, wtns = complex_fixture
    jc, cache = jcache.load_zkey_cache(zkey), load_zkey_cache(zkey, "cpu")
    jw, pw = _witnesses(wtns, cache)
    mesh = pmesh.make_mesh(["cpu"] * 2)
    want = torch.from_numpy(lb.from_jax_limbs(_jax_phase_a(jmesh.make_mesh(jax.devices()[:2]),
                                                           jc, jw)))
    assert prove_step.pad_cache_for_mesh(cache, mesh).use_dist
    assert torch.equal(_port_h(mesh, cache, pw), want)
    assert torch.equal(want, pipeline.construct_r1cs(pw, cache))


def test_phase_a_replicated_route_matches_jax(complex_fixture):
    """D = 8: split (2, 3), 4 % 8 != 0, so both packages take the
    replicated route; each shard keeps its chunk of h."""
    zkey, wtns = complex_fixture
    jc, cache = jcache.load_zkey_cache(zkey), load_zkey_cache(zkey, "cpu")
    jw, pw = _witnesses(wtns, cache)
    mesh = pmesh.make_mesh(["cpu"] * 8)
    want = torch.from_numpy(lb.from_jax_limbs(_jax_phase_a(jmesh.make_mesh(jax.devices()[:8]),
                                                           jc, jw)))
    assert not prove_step.pad_cache_for_mesh(cache, mesh).use_dist
    chunks = prove_step.r1cs_coset_step(mesh, cache, pw)
    assert [c.shape[-1] for c in chunks] == [want.shape[-1] // 8] * 8
    assert torch.equal(torch.cat(chunks, -1), want)


def test_phase_a_folded_plan_matches_jax(tmp_path, monkeypatch):
    """One constraint of 40 A terms, K2's pieces patched to 4 terms: the
    shard holding that row sums it over fold levels of its own sub-plan;
    the JAX side's plan forced two-level as tests/test_multichip.py forces
    it (ISTPU_SEG_CHUNK=8)."""
    r1cs = fanin_circuit(40)
    zkey, wtns = _make(tmp_path, r1cs, fanin_witness(r1cs))
    monkeypatch.setattr(pipeline, "R1CS_PIECE", 4)
    monkeypatch.setenv("ISTPU_SEG_CHUNK", "8")
    jc, cache = jcache.load_zkey_cache(zkey), load_zkey_cache(zkey, "cpu")
    assert jc.plan.level2 is not None
    jw, pw = _witnesses(wtns, cache)
    mesh = pmesh.make_mesh(["cpu"] * 2)
    want = torch.from_numpy(lb.from_jax_limbs(_jax_phase_a(jmesh.make_mesh(jax.devices()[:2]),
                                                           jc, jw)))
    got = _port_h(mesh, cache, pw)
    parts = prove_step.pad_cache_for_mesh(cache, mesh)
    assert parts.use_dist
    levels = [pipeline.r1cs_fold_plan(p, 4)[1] for p in parts.plans]
    assert max(len(lv) for lv in levels) >= 2  # 40 terms: 10 pieces, then 3, then 1
    assert torch.equal(got, want)


def _precomputed(jc, factor: int):
    """The JAX cache with both MSMs' bases precomputed (window C, `factor`
    copies, the JAX package's host oracle), and the port's cache of it.
    Changes jc in place."""
    for name in ("points_a", "points_b1", "points_c", "points_h"):
        setattr(jc, name, jmsm.precompute_bases_host(
            tuple(np.asarray(a) for a in getattr(jc, name)), C, factor))
    jc.points_b2 = jmsm.precompute_bases_host(tuple(np.asarray(a) for a in jc.points_b2), C,
                                              factor, g2=True)
    jc.msm_pre = jc.msm_pre2 = factor
    jc.msm_c = jc.msm_c2 = C
    plan = jc.plan
    cache = convert.cache_from_jax_arrays(
        jc.header, coefs=np.asarray(plan.coefs), witness_idx=np.asarray(plan.witness_idx),
        segments=np.asarray(plan.segments), level2=None,
        points_a=tuple(np.asarray(c) for c in jc.points_a),
        points_b1=tuple(np.asarray(c) for c in jc.points_b1),
        points_b2=tuple(np.asarray(c) for c in jc.points_b2),
        points_c=tuple(np.asarray(c) for c in jc.points_c),
        points_h=tuple(np.asarray(c) for c in jc.points_h),
        keys=np.asarray(jc.keys), msm_c=C, msm_pre=factor, msm_c2=C, msm_pre2=factor,
        device="cpu")
    return jc, cache


@pytest.mark.parametrize("max_lanes,factor", [(None, 1), (32, 2)], ids=["in_core_f1", "sliced_f2"])
def test_phases_b_c_match_jax(complex_fixture, max_lanes, factor):
    """The four grouped G1 MSMs and the G2 MSM at D = 2, c = 8: equal to
    the JAX build_msm_g1_step / build_msm_g2_step window sums as affine
    points, in core (factor 1) and sliced (slices of 32 point lanes G1, 16
    G2, factor 2: several slices a shard)."""
    zkey, wtns = complex_fixture
    jc = jcache.load_zkey_cache(zkey)
    if factor == 1:
        cache = load_zkey_cache(zkey, "cpu")
    else:
        jc, cache = _precomputed(jc, factor)
    jw, pw = _witnesses(wtns, cache)
    jmesh2, mesh = jmesh.make_mesh(jax.devices()[:2]), pmesh.make_mesh(["cpu"] * 2)
    jh, jws1, jws2 = jps.run_sharded_prove(jmesh2, jc, jw, c=C, k=8, max_lanes=max_lanes, c2=C)
    h, ws1, ws2 = prove_step.run_sharded_prove(mesh, cache, pw, c=C, max_lanes=max_lanes, c2=C)
    assert torch.equal(torch.cat(h, -1), torch.from_numpy(lb.from_jax_limbs(np.asarray(jh))))
    parts = prove_step.pad_cache_for_mesh(cache, mesh)
    if max_lanes:  # every shard runs several slices of both MSMs
        assert sum(parts.g1_widths) * factor > max_lanes
        assert parts.b2_width * factor > max_lanes // 2
    assert ws1.shape == (3, 8, 4, msm_ops.merged_windows(C, factor))
    assert _affine(ws1.numpy(), False) == _affine(_port_of_jax_g(jws1, False), False)
    assert _affine(ws2.numpy(), True) == _affine(_port_of_jax_g(jws2, True), True)
