"""Inputs of the complex-N configurations: the reference's ComplexCircuit
(benchmark/1600k/circuit.circom), a chain of squarings b[i] = b[i-1]^2 from
the private input a, with c = b[last] public.

The constraint structure is fixed by the sizes alone, so a run makes only
its witnesses: `witnesses_per_seed` values of a drawn from the seed, every
signal a uniform-looking field element.
"""

from __future__ import annotations

import random

from ..reference.field import R_MOD
from .r1cs import R1CS, complex_circuit, complex_circuit_witness


def setup_circuit(params: dict):
    return complex_circuit(params["num_variables"], params["num_constraints"])


def run_inputs(params: dict, seed: int) -> tuple:
    """(None, witnesses): no R1CS to hold against the zkey, the structure
    being the sizes'."""
    shape = R1CS(n_vars=3 + params["num_variables"], n_public=1)
    rng = random.Random(seed)
    return None, [complex_circuit_witness(shape, rng.randrange(2, R_MOD))
                  for _ in range(params["witnesses_per_seed"])]
