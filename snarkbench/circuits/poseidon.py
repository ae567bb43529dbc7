"""Frozen copy of `icicle_snark_tpu_torch/setup/poseidon.py`, the benchmark's input: a later change to the port's builders does not move the yardstick.

Poseidon hash over BN254 Fr — host oracle + R1CS gadget.

The reference's anon_aadhaar benchmark circuit hashes with circomlib's
`Poseidon(n)` (reference benchmark/anon_aadhaar/helpers/nullifier.circom:11-29,
signature.circom:60-78; circuit.circom includes circomlib/poseidon.circom).
circomlib's hardcoded constants come from the Poseidon authors' Grain-LFSR
parameter script (generate_parameters_grain.sage, `poseidonperm_x5_254_t`);
this module regenerates them from that algorithm instead of vendoring
tables:

  * 80-bit Grain LFSR seeded with (field=1, sbox=0, n=254, t, R_F, R_P,
    30 ones), 160 warm-up steps, shrinking-generator output rule.
  * round constants: 254-bit draws, rejection-sampled below r.
  * MDS: Cauchy matrix 1/(x_i + y_j) from 2t further draws.

Known-answer tests against circomlib's published digests
(e.g. Poseidon([1,2])) pin the generation to the circomlib parameter set
— see tests/test_poseidon.py.

Hash convention (circomlib poseidon.circom): t = n_inputs + 1, state
starts [0, in_0..in_{n-1}], output is state[0] after the permutation;
R_F = 8 full rounds, R_P partial rounds from the per-t table.
"""

from __future__ import annotations

from ..reference.field import R_MOD
from .sha256_circuit import Builder, _lc_add, _lc_scale

# partial rounds per t (index t-2), Poseidon paper table for alpha=5, n=254
_N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
_R_F = 8

_TAPS = (1 << 62) | (1 << 51) | (1 << 38) | (1 << 23) | (1 << 13) | 1


class _Grain:
    """Grain LFSR in self-shrinking mode (Poseidon parameter generation)."""

    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254, field: int = 1,
                 sbox: int = 0):
        bits = []
        for value, width in ((field, 2), (sbox, 4), (n, 12), (t, 12),
                             (r_f, 10), (r_p, 10)):
            bits.extend(int(b) for b in format(value, f"0{width}b"))
        bits.extend([1] * 30)
        assert len(bits) == 80
        # state int: bit i (from LSB) holds b_i, b_0 = oldest
        self.state = sum(b << i for i, b in enumerate(bits))
        for _ in range(160):
            self._step()

    def _step(self) -> int:
        new_bit = (self.state & _TAPS).bit_count() & 1
        self.state = (self.state >> 1) | (new_bit << 79)
        return new_bit

    def bit(self) -> int:
        # shrinking rule: emit the bit following a 1; skip the bit after a 0
        while True:
            if self._step():
                return self._step()
            self._step()

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def field_element(self) -> int:
        while True:
            v = self.bits(254)
            if v < R_MOD:
                return v

    def field_element_mod(self) -> int:
        # MDS x/y draws are reduced, not rejection-sampled (create_mds_p)
        return self.bits(254) % R_MOD


_PARAM_CACHE: dict = {}


def poseidon_params(t: int) -> tuple:
    """(C, M) for state width t: round constants (R_F+R_P)*t and t×t MDS."""
    if t in _PARAM_CACHE:
        return _PARAM_CACHE[t]
    if not 2 <= t <= 17:
        raise ValueError(f"poseidon t={t} outside circomlib range [2,17]")
    r_p = _N_ROUNDS_P[t - 2]
    g = _Grain(t, _R_F, r_p)
    consts = [g.field_element() for _ in range((_R_F + r_p) * t)]
    # MDS x/y draws continue the SAME LFSR stream, reduced (not rejected) —
    # verified to reproduce circomlib's tables bit-for-bit (KATs below)
    xs = [g.field_element_mod() for _ in range(t)]
    ys = [g.field_element_mod() for _ in range(t)]
    mds = [[pow((xs[i] + ys[j]) % R_MOD, R_MOD - 2, R_MOD) for j in range(t)]
           for i in range(t)]
    _PARAM_CACHE[t] = (consts, mds)
    return consts, mds


def _permute(state: list, t: int) -> list:
    consts, mds = poseidon_params(t)
    r_p = _N_ROUNDS_P[t - 2]
    n_rounds = _R_F + r_p
    ci = 0
    for r in range(n_rounds):
        state = [(s + consts[ci + i]) % R_MOD for i, s in enumerate(state)]
        ci += t
        full = r < _R_F // 2 or r >= n_rounds - _R_F // 2
        for i in range(t if full else 1):
            s2 = state[i] * state[i] % R_MOD
            state[i] = s2 * s2 % R_MOD * state[i] % R_MOD
        state = [sum(mds[i][j] * state[j] for j in range(t)) % R_MOD
                 for i in range(t)]
    return state


def poseidon_hash(inputs: list) -> int:
    """circomlib-convention Poseidon: state [0, inputs...], return state[0]."""
    t = len(inputs) + 1
    state = [0] + [x % R_MOD for x in inputs]
    return _permute(state, t)[0]


# ---------------------------------------------------------------------------
# R1CS gadget


def poseidon_gadget(bld: Builder, inputs: list) -> tuple:
    """Poseidon over (lc, value) input pairs -> (lc, value) output.

    Linear layers (round constants, MDS mix) fold into lcs for free;
    each S-box costs 3 mul constraints (x2=x*x, x4=x2*x2, x5=x4*x), the
    same shape circomlib's Sigma template compiles to.
    """
    t = len(inputs) + 1
    consts, mds = poseidon_params(t)
    r_p = _N_ROUNDS_P[t - 2]
    n_rounds = _R_F + r_p
    state = [({}, 0)] + [(dict(lc), v % R_MOD) for lc, v in inputs]
    ci = 0

    def sbox(lc, v):
        v2 = v * v % R_MOD
        s2 = bld.alloc(v2)
        bld.constrain(lc, lc, {s2: 1})
        v4 = v2 * v2 % R_MOD
        s4 = bld.alloc(v4)
        bld.constrain({s2: 1}, {s2: 1}, {s4: 1})
        v5 = v4 * v % R_MOD
        s5 = bld.alloc(v5)
        bld.constrain({s4: 1}, lc, {s5: 1})
        return {s5: 1}, v5

    for r in range(n_rounds):
        state = [(_lc_add(lc, {0: consts[ci + i]}), (v + consts[ci + i]) % R_MOD)
                 for i, (lc, v) in enumerate(state)]
        ci += t
        full = r < _R_F // 2 or r >= n_rounds - _R_F // 2
        state = [sbox(lc, v) if (full or i == 0) else (lc, v)
                 for i, (lc, v) in enumerate(state)]
        state = [
            (
                _lc_add_many([_lc_scale(state[j][0], mds[i][j]) for j in range(t)]),
                sum(mds[i][j] * state[j][1] for j in range(t)) % R_MOD,
            )
            for i in range(t)
        ]
    return state[0]


def _lc_add_many(lcs: list) -> dict:
    out: dict = {}
    for lc in lcs:
        out = _lc_add(out, lc)
    return out
