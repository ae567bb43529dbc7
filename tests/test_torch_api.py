"""The port's entry points on the CPU: the api and CLI round trip with
device="cpu", the default device (CUDA) raising where there is no card,
and the import isolation of the port from JAX and the JAX package."""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

from icicle_snark_tpu_torch import cli
from icicle_snark_tpu_torch.io.wtns import write_wtns
from icicle_snark_tpu_torch.prover import api
from icicle_snark_tpu_torch.prover.cache import load_zkey_cache
from icicle_snark_tpu_torch.refmath import groth16 as oracle
from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device
from icicle_snark_tpu_torch.setup.r1cs import multiplier_circuit, multiplier_witness
from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_api")
    r1cs = multiplier_circuit()
    zkey = str(tmp / "circuit_final.zkey")
    vk = str(tmp / "verification_key.json")
    groth16_setup(r1cs, zkey, vk)
    wtns = str(tmp / "witness.wtns")
    write_wtns(wtns, multiplier_witness(6, 7))
    return tmp, zkey, vk, wtns


def test_api_roundtrip_cpu(fixture):
    tmp, zkey, vk, wtns = fixture
    proof, public = str(tmp / "proof.json"), str(tmp / "public.json")
    cm = api.CacheManager("cpu")
    elapsed = api.groth16_prove(wtns, zkey, proof, public, cm, deterministic=True)
    assert elapsed > 0 and api.groth16_verify(proof, public, vk)
    with open(proof) as fh:
        got = json.load(fh)
    assert got == oracle.prove(zkey, wtns, deterministic=True)[0]
    assert cm.contains(zkey)
    api.groth16_prove(wtns, zkey, proof, public, cm)  # warm cache, randomized
    assert api.groth16_verify(proof, public, vk)


def test_cli_worker_protocol_cpu(fixture):
    tmp, zkey, vk, wtns = fixture
    proof, public, vk2 = (str(tmp / f) for f in ("cli_proof.json", "cli_public.json", "vk2.json"))
    script = (
        f"prove --witness {wtns} --zkey {zkey} --proof {proof} --public {public} --device CPU\n"
        f"verify --proof {proof} --public {public} --vk {vk}\n"
        f"export-vk --zkey {zkey} --vk {vk2}\n"
        f"prove --witness {wtns} --zkey {zkey} --proof {proof} --public {public} --device TPU\n"
        "exit\n"
    )
    out = io.StringIO()
    assert cli.run_worker(stdin=io.StringIO(script), stdout=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("proof took: ")
    assert lines.count(cli.SENTINEL) == 5
    assert "OK!" in lines
    assert any(line.startswith("ERROR: unknown device") for line in lines)
    with open(vk2) as fh, open(vk) as fh_ref:
        assert json.load(fh) == json.load(fh_ref)


def test_default_device_raises_without_cuda(fixture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    tmp, zkey, _vk, wtns = fixture
    with pytest.raises(RuntimeError, match="CUDA"):
        load_zkey_cache(zkey)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.CacheManager()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.groth16_prove(wtns, zkey, str(tmp / "p.json"), str(tmp / "u.json"))
    with pytest.raises(RuntimeError, match="CUDA"):
        groth16_setup_device(multiplier_circuit(), str(tmp / "x.zkey"))
    out = io.StringIO()
    cli.run_worker(stdin=io.StringIO(
        f"prove --witness {wtns} --zkey {zkey} --proof p --public u\nexit\n"), stdout=out)
    assert out.getvalue().splitlines()[0].startswith("ERROR: CUDA is not available")


def test_port_imports_neither_jax_nor_jax_package():
    """Importing every module of the port, and chip_smoke.py, loads no jax
    (a fresh interpreter: this test process imported jax already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import icicle_snark_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if m.name.endswith('__main__'):\n"
        "        continue\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'icicle_snark_tpu' or m.startswith('icicle_snark_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke script exits nonzero and prints no result;
    alone in a directory (without the package) it fails as well."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    res = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
