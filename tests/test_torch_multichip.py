"""The port's sharded prove end to end on meshes of CPU shards (plain
versions): at D = 2 its deterministic proof is byte-identical to the JAX
package's prove_multichip at D = 2 and to the port's single-device prove;
at D = 4 (four-step route) and D = 8 (replicated route) to the
single-device prove; a randomized sharded proof verifies; two processes of
two shards each over gloo give the same proof
(icicle_snark_tpu_torch/tools/multiproc_dryrun.py, as tests/test_multiproc.py
runs the JAX package's); `make_mesh()` with no card raises."""

import os
import subprocess
import sys

import jax
import pytest
import torch

from icicle_snark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from icicle_snark_tpu.parallel.prove_step import prove_multichip as jax_prove_multichip
from icicle_snark_tpu.prover import cache as jcache
from icicle_snark_tpu.io.wtns import write_wtns
from icicle_snark_tpu.setup.r1cs import complex_circuit, complex_circuit_witness
from icicle_snark_tpu.setup.trusted_setup import groth16_setup
from icicle_snark_tpu_torch.parallel import mesh as pmesh
from icicle_snark_tpu_torch.parallel.prove_step import prove_multichip
from icicle_snark_tpu_torch.prover import pipeline
from icicle_snark_tpu_torch.prover.cache import load_zkey_cache
from icicle_snark_tpu_torch.refmath import groth16 as oracle

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mc")
    r1cs = complex_circuit(20, 26)  # domain 32, as tests/test_multichip.py
    zkey, wtns = str(tmp / "c.zkey"), str(tmp / "c.wtns")
    vk = groth16_setup(r1cs, zkey)
    write_wtns(wtns, complex_circuit_witness(r1cs, a=9))
    cache = load_zkey_cache(zkey, "cpu")
    return zkey, wtns, vk, cache, pipeline.prove(wtns, cache, deterministic=True)


def test_d2_proof_matches_jax_prove_multichip_and_single_device(fixture):
    zkey, wtns, vk, cache, single = fixture
    jproof = jax_prove_multichip(jax_make_mesh(jax.devices()[:2]), wtns,
                                 jcache.load_zkey_cache(zkey), deterministic=True, c=8, k=8)
    got = prove_multichip(pmesh.make_mesh(["cpu"] * 2), wtns, cache, deterministic=True, c=8)
    assert got == jproof
    assert got == single
    assert oracle.verify(*got, vk)


@pytest.mark.parametrize("d", [4, 8])
def test_proof_matches_single_device(fixture, d):
    """D = 4 takes the four-step route (split (2, 3)), D = 8 the replicated
    one (4 % 8 != 0)."""
    _zkey, wtns, vk, cache, single = fixture
    mesh = pmesh.make_mesh(["cpu"] * d)
    assert prove_multichip(mesh, wtns, cache, deterministic=True) == single
    if d == 4:
        proof, public = prove_multichip(mesh, wtns, cache)
        assert proof != single[0]
        assert oracle.verify(proof, public, vk)


def test_two_process_gloo_prove():
    proc = subprocess.run(
        [sys.executable, "-m", "icicle_snark_tpu_torch.tools.multiproc_dryrun", "--timeout", "300"],
        cwd=REPO, capture_output=True, text=True, timeout=400)
    tail = (proc.stdout + proc.stderr)[-2000:]
    assert proc.returncode == 0, tail
    assert "byte-identical to the single-device proof" in proc.stdout, tail


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh() takes it")
    with pytest.raises(RuntimeError):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError):
        pmesh.make_mesh(["cuda:0", "cuda:0"])
