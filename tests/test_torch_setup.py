"""The port's device trusted setup (plain-torch pmadd over the K1 field
ops, here on the CPU) writes the same zkey bytes as the JAX package's
groth16_setup_device and the same verification key."""

import filecmp

import torch

from icicle_snark_tpu.setup.fast_setup import groth16_setup_device as jax_setup_device
from icicle_snark_tpu.setup.r1cs import complex_circuit
from icicle_snark_tpu_torch.setup import r1cs as port_r1cs
from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


def test_device_setup_zkey_bytes_match_jax(tmp_path):
    zk_jax = str(tmp_path / "jax.zkey")
    zk_port = str(tmp_path / "port.zkey")
    vk_jax = jax_setup_device(complex_circuit(10, 13), zk_jax)
    vk_port = groth16_setup_device(port_r1cs.complex_circuit(10, 13), zk_port, device="cpu")
    assert vk_port == vk_jax
    assert filecmp.cmp(zk_jax, zk_port, shallow=False), "zkey bytes differ"
