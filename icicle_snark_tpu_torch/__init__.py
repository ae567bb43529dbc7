"""icicle-snark on PyTorch + CUDA: a Groth16 prover/verifier for BN254 on
an NVIDIA H100, ported from the JAX package `icicle_snark_tpu`.

It reads snarkjs `.zkey` proving keys and `.wtns` witnesses and writes
snarkjs-format `proof.json`/`public.json`. The device work runs in eleven
hand-written CUDA kernels (csrc/, registered in kernels.py): Fr/Fq vector
ops, powers and reductions, the R1CS rows, the NTT (stage by stage and
several stages a pass), the MSM bucket accumulate/reduce, point adds,
doublings and affine conversion, the fixed-base multiply of the device
setup, and a throughput probe.

Public API: prover/api.py (groth16_prove, groth16_verify, CacheManager) and
the ICICLE-style op surface: ops/vec_ops.py, ops/ntt.py (ntt, ntt_inplace,
initialize_domain, get_root_of_unity), ops/msm.py (msm_g1, msm_g1_many,
msm_g2, precompute_bases), config.py, runtime.py, errors.py.
Importing the package loads nothing but this docstring.
"""

__version__ = "0.1.0"
