"""The benchmark of icicle_snark_tpu_torch, the PyTorch and CUDA port.

`python3 -m snarkbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on one card and prints
one JSON line. It imports neither JAX nor the JAX package; the program
under test is reached only through its API, its PhaseTimer and its kernel
launch counts.
"""
