"""The benchmark's inputs, made from the configuration and the seed.

  * The zkey: one ceremony per circuit, as a deployment has. Made once a
    checkout by the port's device setup (`groth16_setup_device`, byte for
    byte the host setup's output for a seed) from the frozen builder's
    circuit and the configuration's `setup_seed`; beside it the reference's
    own verification key, worked out from the same circuit and seed.
  * The witnesses: made by the configuration's input module from the run's
    seed and written by the benchmark's own `.wtns` writer, with the public
    signals the reference expects. Where the module returns the seed's
    R1CS, its coefficient section is held against the zkey's first.

Everything lives under `.fixtures/<config>/<setup seed digest>/` inside the
benchmark's folder (git-ignored), at fixed paths, so a cell's later runs
reuse what an earlier run made.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os

import numpy as np

from .reference import groth16 as ref
from .reference import zkey as refzkey
from .wtns import write_wtns

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".fixtures")


class StructureMismatch(RuntimeError):
    """The seed's circuit is not the zkey's."""


def _write_json(path: str, obj):
    tmp = f"{path}.part"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def config_dir(config: dict, root: str = FIXTURES) -> str:
    tag = hashlib.sha256(config["setup_seed"].encode()).hexdigest()[:16]
    return os.path.join(root, config["name"], tag)


def builder(config: dict):
    return importlib.import_module(config["builder"])


def ensure_key(config: dict, device, log, root: str = FIXTURES) -> dict:
    """{zkey, vk}: the zkey made by the port's device setup and the
    reference's verification key, made unless the directory holds them."""
    d = config_dir(config, root)
    paths = {"zkey": os.path.join(d, "circuit_final.zkey"),
             "vk": os.path.join(d, "vk.reference.json")}
    if os.path.exists(paths["zkey"]) and os.path.exists(paths["vk"]):
        return paths
    from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device

    os.makedirs(d, exist_ok=True)
    r1cs = builder(config).setup_circuit(config["params"])
    seed = config["setup_seed"].encode()
    log(f"making the zkey of {config['name']}: {r1cs.n_constraints} constraints, "
        f"{r1cs.n_vars} signals")
    tmp = paths["zkey"] + ".part"
    groth16_setup_device(r1cs, tmp, None, seed=seed, device=device)
    os.replace(tmp, paths["zkey"])
    _write_json(paths["vk"], ref.verification_key(r1cs, seed))
    return paths


def seed_inputs(config: dict, seed: int, zkey_path: str, root: str = FIXTURES) -> dict:
    """{witnesses: [.wtns paths], public: [[decimal strings]]} of the
    seed, made unless its directory holds them. Raises StructureMismatch
    when the seed's circuit differs from the zkey's."""
    d = os.path.join(config_dir(config, root), "seeds", str(seed))
    index = os.path.join(d, "inputs.json")
    if not os.path.exists(index):
        _make_seed_inputs(config, seed, zkey_path, d, index)
    with open(index) as fh:
        out = json.load(fh)
    out["witnesses"] = [os.path.join(d, f) for f in out["witnesses"]]
    return out


def _make_seed_inputs(config: dict, seed: int, zkey_path: str, d: str, index: str):
    os.makedirs(d, exist_ok=True)
    r1cs, witnesses = builder(config).run_inputs(config["params"], seed)
    head = refzkey.header(zkey_path)
    if r1cs is not None:
        if (r1cs.n_vars, r1cs.n_public) != (head["n_vars"], head["n_public"]) or \
                refzkey.circuit_digest(r1cs) != refzkey.zkey_circuit_digest(zkey_path):
            raise StructureMismatch(
                f"seed {seed}: the circuit of {config['name']} differs from the zkey's")
        del r1cs
    out = {"witnesses": [], "public": []}
    for k, w in enumerate(witnesses):
        if len(w) != head["n_vars"]:
            raise StructureMismatch(f"seed {seed}: witness of {len(w)} signals, zkey "
                                    f"{head['n_vars']}")
        name = f"witness_{k}.wtns"
        write_wtns(os.path.join(d, name), w)
        out["witnesses"].append(name)
        out["public"].append([str(v) for v in w[1:head["n_public"] + 1]])
    _write_json(index, out)


def witness_words(path: str) -> np.ndarray:
    """The witness of a .wtns file as (n, 4) uint64 words."""
    off, size = refzkey.sections(path)[2]
    return np.fromfile(path, dtype="<u8", count=size // 8, offset=off).reshape(-1, 4)
