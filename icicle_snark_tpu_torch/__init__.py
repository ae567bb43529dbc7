"""icicle-snark on PyTorch + CUDA: a Groth16 prover/verifier for BN254 on
an NVIDIA H100, ported from the JAX package `icicle_snark_tpu`.

It reads snarkjs `.zkey` proving keys and `.wtns` witnesses and writes
snarkjs-format `proof.json`/`public.json`. The device work runs in four
hand-written CUDA kernels (csrc/): Fr/Fq vector ops, the R1CS row
reduction, the NTT butterfly stage and the MSM bucket accumulate/reduce.

Public API (prover/api.py): groth16_prove, groth16_verify, CacheManager.
Importing the package loads nothing but this docstring.
"""

__version__ = "0.1.0"
