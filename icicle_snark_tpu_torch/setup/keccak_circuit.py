"""Keccak-256 as an R1CS circuit — the `benchmark/keccak256` family.

The reference benchmarks vocdoni's keccak256-circom `Keccak(256, 256)`
(the reference's benchmark/keccak256/keccak.circom: 256-bit private
input, 256-bit public digest, one Keccak-f[1600] permutation with
in-circuit pad). This builds the equivalent system natively with the
same lc/mul Builder as the sha256 family (setup/sha256_circuit.py):

    theta   C = xor5 columns (4 muls/bit), D = C ^ rot(C,1) (1),
            A ^= D (1)
    rho/pi  pure bit permutations — no constraints
    chi     A = B ^ (~B' & B'') — 2 muls/bit
    iota    xor with a round constant — linear, free

~154k constraints for the 24 rounds (vocdoni reports ~151k).

Bit conventions follow the Keccak byte mapping: bit index i within a
lane is bit (i % 8) of byte (i // 8), LSB-first per byte — both for the
input `in[256]` and the public digest `out[256]` (matching the circom
circuit's indexing).
"""

from __future__ import annotations

from .r1cs import R1CS
from .sha256_circuit import Builder, Bit, _const_bit

_ROUNDS = 24

# iota round constants (Keccak-f[1600])
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, indexed [x][y]
_RHO = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(lane: list, n: int) -> list:
    """Rotate a 64-bit lane (LSB-first bit list) left by n."""
    n %= 64
    return [lane[(i - n) % 64] for i in range(64)]


def _not(b: Bit) -> Bit:
    from .sha256_circuit import _lc_add, _lc_scale

    return Bit(_lc_add({0: 1}, _lc_scale(b.lc, -1)), 1 - b.val)


def _keccak_f(bld: Builder, lanes: list) -> list:
    """24 rounds over a 5x5 list-of-lists of 64-bit lanes."""
    A = [[lanes[x][y] for y in range(5)] for x in range(5)]
    for rnd in range(_ROUNDS):
        # theta
        C = []
        for x in range(5):
            col = [A[x][y] for y in range(5)]
            C.append([
                bld.xor(bld.xor3(a, b, c), bld.xor(d, e))
                for a, b, c, d, e in zip(*col)
            ])
        D = [
            [bld.xor(a, b) for a, b in zip(C[(x - 1) % 5], _rotl(C[(x + 1) % 5], 1))]
            for x in range(5)
        ]
        A = [[[bld.xor(a, d) for a, d in zip(A[x][y], D[x])] for y in range(5)]
             for x in range(5)]
        # rho + pi
        B = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = _rotl(A[x][y], _RHO[x][y])
        # chi
        A = [
            [
                [
                    bld.xor(b, bld.mul(_not(b1), b2))
                    for b, b1, b2 in zip(B[x][y], B[(x + 1) % 5][y], B[(x + 2) % 5][y])
                ]
                for y in range(5)
            ]
            for x in range(5)
        ]
        # iota
        rc = _RC[rnd]
        A[0][0] = [
            _not(b) if (rc >> i) & 1 else b for i, b in enumerate(A[0][0])
        ]
        # _not of Bit flips value via linear lc — xor with const 1
    return A


def keccak256_circuit(input_bits: list) -> tuple:
    """Keccak(256, 256): 256 private input bits -> 256 public digest
    bits. Returns (R1CS, witness). Structure is input-independent."""
    assert len(input_bits) == 256
    bld = Builder(n_public=256)

    in_bits = []
    for v in input_bits:
        assert v in (0, 1)
        sig = bld.bool_sig(v)
        in_bits.append(Bit({sig: 1}, v))

    # pad to the 1088-bit rate block: msg || 0x01 || 0...0 || 0x80
    block = list(in_bits) + [_const_bit(0)] * (1088 - 256)
    block[256] = _const_bit(1)       # 0x01 domain bit (LSB of the next byte)
    block[1087] = _const_bit(1)      # MSB of the last rate byte (0x80)

    # absorb into the zero state: lane[x][y] bit i = block[64*(5y+x)+i]
    lanes = [[None] * 5 for _ in range(5)]
    for y in range(5):
        for x in range(5):
            idx = 64 * (5 * y + x)
            if idx < 1088:
                lanes[x][y] = block[idx : idx + 64]
            else:
                lanes[x][y] = [_const_bit(0)] * 64
    lanes = _keccak_f(bld, lanes)

    # squeeze 256 bits; bind to public signals 1..256 via one linear
    # constraint per bit: (digest_sig) * (1) = (state lc)
    for i in range(256):
        x, y, b = (i // 64) % 5, i // 320, i % 64
        bit = lanes[x][y][b]
        sig = 1 + i
        bld.values[sig] = bit.val
        bld.constrain({sig: 1}, {0: 1}, bit.lc)

    r1cs = R1CS(n_vars=len(bld.values), n_public=256)
    r1cs.constraints = bld.constraints
    assert all(v is not None for v in bld.values)
    return r1cs, bld.values


def digest_from_witness(witness: list) -> bytes:
    """32-byte digest from the public signals (LSB-first per byte)."""
    bits = witness[1:257]
    out = bytearray()
    for i in range(32):
        byte = 0
        for j in range(8):
            byte |= bits[i * 8 + j] << j
        out.append(byte)
    return bytes(out)
