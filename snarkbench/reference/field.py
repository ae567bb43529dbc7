"""Frozen copy of `icicle_snark_tpu_torch/refmath/field.py`, the benchmark's plain reference: it imports nothing of the port.

Pure-Python BN254 base/scalar field arithmetic (host-side oracle).

This is the framework's "CPU reference device": slow, obviously-correct
arithmetic over Python ints, used for

  * the trusted-setup generator (test fixtures in snarkjs format),
  * the Groth16 verifier's host-side point/pairing math (the reference
    computes its pairing host-side too, reference icicle/src/pairing.cpp:168-182),
  * differential testing of the JAX/Pallas kernels.

Field parameters mirror the reference's compile-time tables
(reference icicle/include/icicle/fields/snark_fields/bn254_scalar.h,
 bn254_base.h) but are *computed* here rather than hardcoded wherever
possible.
"""

from __future__ import annotations

# BN254 (alt_bn128) parameters.
# Base field modulus q and scalar field modulus r.
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN curve parameter x: q(x), r(x), t(x) are the standard BN polynomials.
BN_X = 4965661367192848881

# Montgomery radix used by snarkjs / the reference (8 x 32-bit limbs).
MONT_BITS = 256
MONT_R = 1 << MONT_BITS
MONT_R_FR = MONT_R % R_MOD
MONT_R_FQ = MONT_R % Q
MONT_RINV_FR = pow(MONT_R, -1, R_MOD)
MONT_RINV_FQ = pow(MONT_R, -1, Q)

# 2-adicity of r - 1 and the canonical snarkjs root-of-unity tower W[i]
# (i-th entry is a primitive 2^i-th root of unity; matches the hardcoded
# table at reference src/cache.rs:25-56).
TWO_ADICITY = 28


def _build_root_tower() -> list:
    # snarkjs uses 5 as the smallest generator of Fr*; w = 5^((r-1)/2^28).
    g = 5
    w28 = pow(g, (R_MOD - 1) >> TWO_ADICITY, R_MOD)
    tower = [0] * (TWO_ADICITY + 1)
    tower[TWO_ADICITY] = w28
    for i in range(TWO_ADICITY - 1, -1, -1):
        tower[i] = tower[i + 1] * tower[i + 1] % R_MOD
    assert tower[0] == 1
    return tower


# W[i] = primitive 2^i-th root of unity in Fr.
W = _build_root_tower()


def fr_add(a: int, b: int) -> int:
    return (a + b) % R_MOD


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R_MOD


def fr_mul(a: int, b: int) -> int:
    return a * b % R_MOD


def fr_inv(a: int) -> int:
    return pow(a, -1, R_MOD)


def fr_to_mont(a: int) -> int:
    return a * MONT_R_FR % R_MOD


def fr_from_mont(a: int) -> int:
    return a * MONT_RINV_FR % R_MOD


def fq_to_mont(a: int) -> int:
    return a * MONT_R_FQ % Q


def fq_from_mont(a: int) -> int:
    return a * MONT_RINV_FQ % Q


def int_to_le(a: int, n8: int = 32) -> bytes:
    return a.to_bytes(n8, "little")


def le_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")
