"""Frozen copy of `icicle_snark_tpu_torch/setup/r1cs.py`, the benchmark's input: a later change to the port's builders does not move the yardstick.

Minimal R1CS representation + built-in test circuits.

The reference ships circom sources for its benchmark suite
(reference benchmark/*/circuit.circom) and generates zkey/wtns via
circom+snarkjs (scripts/setup.sh). Neither tool exists in this
environment, so the framework carries its own R1CS builder and
trusted-setup generator producing byte-compatible snarkjs artifacts.

Signal ordering follows circom/snarkjs convention:
  0: constant one, 1..n_public: public signals, then private signals.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..reference.field import R_MOD


@dataclass
class R1CS:
    n_vars: int
    n_public: int  # public signals excluding the constant one
    # each constraint: three {signal: coef} dicts (A, B, C)
    constraints: list = field(default_factory=list)

    def add(self, a: dict, b: dict, c: dict):
        self.constraints.append((a, b, c))

    @property
    def n_constraints(self) -> int:
        return len(self.constraints)

    def check_witness(self, w: list) -> bool:
        def ev(lc):
            return sum(coef * w[s] for s, coef in lc.items()) % R_MOD

        return all(ev(a) * ev(b) % R_MOD == ev(c) for a, b, c in self.constraints)


def complex_circuit(num_variables: int, num_constraints: int) -> R1CS:
    """The reference's ComplexCircuit (benchmark/100k/circuit.circom):

        b[0] <== a*a;  b[i] <== b[i-1]*b[i-1];
        (num_constraints - num_variables) redundant squaring checks;
        c <== b[last].

    Signals: 0=one, 1=c (public output), 2=a (private input),
    3..3+num_variables-1 = b[i].
    """
    assert num_variables <= num_constraints
    r = R1CS(n_vars=3 + num_variables, n_public=1)
    a_sig, b0 = 2, 3
    r.add({a_sig: 1}, {a_sig: 1}, {b0: 1})
    for i in range(1, num_variables):
        r.add({b0 + i - 1: 1}, {b0 + i - 1: 1}, {b0 + i: 1})
    last = b0 + num_variables - 1
    for _ in range(num_variables, num_constraints):
        r.add({last - 1: 1}, {last - 1: 1}, {last: 1})
    # c <== b[last]: linear constraint (b_last) * (1) = c
    r.add({last: 1}, {0: 1}, {1: 1})
    return r


def complex_circuit_witness(r1cs: R1CS, a: int) -> list:
    num_variables = r1cs.n_vars - 3
    w = [0] * r1cs.n_vars
    w[0] = 1
    w[2] = a % R_MOD
    v = a * a % R_MOD
    w[3] = v
    for i in range(1, num_variables):
        v = v * v % R_MOD
        w[3 + i] = v
    w[1] = v  # public output c
    return w


def fanin_circuit(n_terms: int) -> R1CS:
    """High-fan-in circuit: one constraint whose A linear combination
    sums `n_terms` private signals — with coefficients i+1 so terms are
    position-sensitive: (sum_i (i+1)*x_i) * (x_0) = c. Exercises one
    long row of the R1CS plan (prover/cache.py build_r1cs_plan)."""
    r = R1CS(n_vars=2 + n_terms, n_public=1)
    # signals: 0=one, 1=c (public), 2..2+n_terms-1 = x_i
    a_lc = {2 + i: i + 1 for i in range(n_terms)}
    r.add(a_lc, {2: 1}, {1: 1})
    return r


def fanin_witness(r1cs: R1CS, seed: int = 7) -> list:
    n_terms = r1cs.n_vars - 2
    xs = [(seed * (i + 1) ** 2 + 3) % R_MOD for i in range(n_terms)]
    s = sum((i + 1) * xs[i] for i in range(n_terms)) % R_MOD
    c = s * xs[0] % R_MOD
    return [1, c] + xs


def multiplier_circuit() -> R1CS:
    """Tiny 1-constraint circuit: public c == private a * private b."""
    r = R1CS(n_vars=4, n_public=1)
    # signals: 0=one, 1=c, 2=a, 3=b
    r.add({2: 1}, {3: 1}, {1: 1})
    return r


def multiplier_witness(a: int, b: int) -> list:
    return [1, a * b % R_MOD, a % R_MOD, b % R_MOD]


def poseidon_bits_circuit(x: int, y: int) -> tuple:
    """A small circuit on the family's gadgets: public 1 = Poseidon(x, y)
    and 2 = x + y; x and y private, each bound to 254 booleanity-checked
    bits by one row whose packing sum sits in A, (sum_i 2^i b_i) * 1 = x
    (Num2Bits puts it in C, which K2 never evaluates). So A has slots of
    254 terms, which K2 sums over fold levels. Returns (R1CS, witness)."""
    from .poseidon import poseidon_gadget
    from .sha256_circuit import Builder

    assert 0 <= x < R_MOD and 0 <= y < R_MOD
    bld = Builder(n_public=2)
    xs, ys = bld.alloc(x), bld.alloc(y)
    for sig, v in ((xs, x), (ys, y)):
        bits = [bld.bool_sig((v >> i) & 1) for i in range(254)]
        bld.constrain({b: 1 << i for i, b in enumerate(bits)}, {0: 1}, {sig: 1})
    lc, digest = poseidon_gadget(bld, [({xs: 1}, x), ({ys: 1}, y)])
    bld.values[1], bld.values[2] = digest, (x + y) % R_MOD
    bld.constrain(lc, {0: 1}, {1: 1})
    bld.constrain({xs: 1, ys: 1}, {0: 1}, {2: 1})
    r1cs = R1CS(n_vars=len(bld.values), n_public=2)
    r1cs.constraints = bld.constraints
    return r1cs, bld.values
