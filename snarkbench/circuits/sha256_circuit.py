"""Frozen copy of `icicle_snark_tpu_torch/setup/sha256_circuit.py`, the benchmark's input: a later change to the port's builders does not move the yardstick.

SHA-256 as an R1CS circuit — the `benchmark/sha256` family.

The reference benchmarks circomlib's `Sha256(512)`
(the reference's benchmark/sha256/sha256_512.circom: 512-bit private
message, 256-bit public digest). circom is not a dependency of this
package, so this module builds a semantically equivalent constraint
system directly: same function (FIPS 180-4 SHA-256 of a 512-bit
message, two compression blocks with in-circuit padding), same
public/private signal split, same constraint class (~55k constraints vs
circomlib's ~59k — both dominated by per-bit XOR/Ch/Maj muls and
32-bit carry decompositions).

Circuit construction style mirrors what the circom compiler produces
after linear-signal elimination: every value is an affine linear
combination (lc) over signals, and ONLY true products allocate a
constraint + intermediate signal (`Builder.mul`). XOR/Ch/Maj reduce to
1-2 muls each:

    xor(a,b) = a + b - 2ab          1 mul
    ch(e,f,g) = g + e*(f - g)       1 mul
    maj(a,b,c) = t + c*(a+b-2t),    2 muls (t = ab)

Additions mod 2^32 cost one linear constraint plus booleanity
constraints for the 32+carry output bits.

Builder witness values are computed alongside the constraints, so one
call yields both the (input-independent) R1CS and a witness for the
given message.
"""

from __future__ import annotations

from ..reference.field import R_MOD
from .r1cs import R1CS

# FIPS 180-4 constants
_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def _lc_add(a: dict, b: dict) -> dict:
    out = dict(a)
    for s, c in b.items():
        v = (out.get(s, 0) + c) % R_MOD
        if v:
            out[s] = v
        else:
            out.pop(s, None)
    return out


def _lc_scale(a: dict, k: int) -> dict:
    k %= R_MOD
    if k == 0:
        return {}
    return {s: (c * k) % R_MOD for s, c in a.items()}


class Bit:
    """An affine combination of signals with a known 0/1 value."""

    __slots__ = ("lc", "val")

    def __init__(self, lc: dict, val: int):
        self.lc = lc
        self.val = val

    @property
    def is_const(self) -> bool:
        return all(s == 0 for s in self.lc)


def _const_bit(v: int) -> Bit:
    return Bit({0: v % R_MOD} if v else {}, v)


class Builder:
    """R1CS builder with value tracking (signals 0=one, 1..n_public
    public, then private)."""

    def __init__(self, n_public: int):
        self.n_public = n_public
        self.values: list = [1] + [None] * n_public
        self.constraints: list = []

    def alloc(self, val: int) -> int:
        self.values.append(val % R_MOD)
        return len(self.values) - 1

    def constrain(self, a: dict, b: dict, c: dict):
        self.constraints.append((a, b, c))

    # ---- lc algebra over Bit
    def badd(self, *bits) -> tuple:
        """Sum of bits as (lc, value) — no constraint."""
        lc, val = {}, 0
        for b in bits:
            lc = _lc_add(lc, b.lc)
            val += b.val
        return lc, val

    def mul(self, a: Bit, b: Bit) -> Bit:
        """Product: free if either side is constant, else 1 constraint."""
        if a.is_const:
            return Bit(_lc_scale(b.lc, a.val), a.val * b.val)
        if b.is_const:
            return Bit(_lc_scale(a.lc, b.val), a.val * b.val)
        v = a.val * b.val
        s = self.alloc(v)
        self.constrain(a.lc, b.lc, {s: 1})
        return Bit({s: 1}, v)

    def bool_sig(self, val: int, sig: int | None = None) -> int:
        """Allocate (or bind) a signal with a booleanity constraint."""
        if sig is None:
            sig = self.alloc(val)
        else:
            self.values[sig] = val % R_MOD
        self.constrain({sig: 1}, {sig: 1, 0: R_MOD - 1}, {})
        return sig

    # ---- bitwise gadgets. Each materializes its OUTPUT as the signal
    # allocated by its single mul constraint — circom's XOR/Ch/Maj
    # compile the same way ((2a)(b) = a+b-out). Returning {out: 1}
    # instead of an affine combination keeps every lc small; affine
    # outputs compound multiplicatively across keccak rounds (an lc-size
    # explosion measured at ~5x per round).
    def xor(self, a: Bit, b: Bit) -> Bit:
        if a.is_const:
            av = a.val & 1
            if av == 0:
                return b
            return Bit(_lc_add({0: 1}, _lc_scale(b.lc, -1)), 1 - b.val)
        if b.is_const:
            return self.xor(b, a)
        v = a.val ^ b.val
        s = self.alloc(v)
        self.constrain(
            _lc_scale(a.lc, 2), b.lc,
            _lc_add(_lc_add(a.lc, b.lc), {s: R_MOD - 1}),
        )
        return Bit({s: 1}, v)

    def xor3(self, a: Bit, b: Bit, c: Bit) -> Bit:
        return self.xor(self.xor(a, b), c)

    def ch(self, e: Bit, f: Bit, g: Bit) -> Bit:
        v = (e.val & f.val) | ((1 - e.val) & g.val)
        if e.is_const:
            return f if e.val else g
        fg = _lc_add(f.lc, _lc_scale(g.lc, -1))
        if not fg:  # f == g structurally
            return f
        s = self.alloc(v)
        self.constrain(e.lc, fg, _lc_add({s: 1}, _lc_scale(g.lc, -1)))
        return Bit({s: 1}, v)

    def maj(self, a: Bit, b: Bit, c: Bit) -> Bit:
        v = (a.val & b.val) ^ (a.val & c.val) ^ (b.val & c.val)
        t = self.mul(a, b)
        inner = Bit(
            _lc_add(_lc_add(a.lc, b.lc), _lc_scale(t.lc, R_MOD - 2)),
            a.val + b.val - 2 * t.val,
        )
        if c.is_const or inner.is_const:
            u = self.mul(c, inner)
            return Bit(_lc_add(t.lc, u.lc), v)
        s = self.alloc(v)
        self.constrain(c.lc, inner.lc, _lc_add({s: 1}, _lc_scale(t.lc, -1)))
        return Bit({s: 1}, v)

    def add32(self, words: list, out_sigs: list | None = None) -> list:
        """Sum word bit-lists (bit 0 = LSB) mod 2^32 -> 32 output Bits.

        One linear constraint ties the full integer sum to a fresh
        32+carry-bit decomposition; out_sigs (e.g. public digest
        signals) can bind the low 32 bits."""
        lc, total, max_total = {}, 0, 0
        for w in words:
            for i, b in enumerate(w):
                lc = _lc_add(lc, _lc_scale(b.lc, 1 << i))
                total += b.val << i
                # structural bound, NOT the data value: carry width must
                # be input-independent so the R1CS is one fixed circuit
                max_total += (b.val if b.is_const else 1) << i
        n_extra = max(max_total.bit_length() - 32, 0)
        out_bits, dec_lc = [], {}
        for i in range(32 + n_extra):
            bit_v = (total >> i) & 1
            sig = self.bool_sig(bit_v, out_sigs[i] if (out_sigs and i < 32) else None)
            dec_lc = _lc_add(dec_lc, {sig: 1 << i})
            if i < 32:
                out_bits.append(Bit({sig: 1}, bit_v))
        self.constrain(lc, {0: 1}, dec_lc)
        return out_bits


def _rotr(w: list, n: int) -> list:
    return [w[(i + n) % 32] for i in range(32)]


def _shr(w: list, n: int) -> list:
    return [w[i + n] if i + n < 32 else _const_bit(0) for i in range(32)]


def _const_word(v: int) -> list:
    return [_const_bit((v >> i) & 1) for i in range(32)]


def _compress(bld: Builder, state: list, block: list, digest_sigs=None) -> list:
    """One SHA-256 compression round over 16 message words; returns the
    new state words as bit-lists. digest_sigs (8 lists of 32 signal
    ids) binds the final feed-forward adds to the public digest."""
    w = list(block)
    for t in range(16, 64):
        s0 = [bld.xor3(a, b, c) for a, b, c in
              zip(_rotr(w[t - 15], 7), _rotr(w[t - 15], 18), _shr(w[t - 15], 3))]
        s1 = [bld.xor3(a, b, c) for a, b, c in
              zip(_rotr(w[t - 2], 17), _rotr(w[t - 2], 19), _shr(w[t - 2], 10))]
        w.append(bld.add32([w[t - 16], s0, w[t - 7], s1]))

    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = [bld.xor3(x, y, z) for x, y, z in
              zip(_rotr(e, 6), _rotr(e, 11), _rotr(e, 25))]
        ch = [bld.ch(x, y, z) for x, y, z in zip(e, f, g)]
        S0 = [bld.xor3(x, y, z) for x, y, z in
              zip(_rotr(a, 2), _rotr(a, 13), _rotr(a, 22))]
        mj = [bld.maj(x, y, z) for x, y, z in zip(a, b, c)]
        # T1 = h + S1 + ch + K[t] + w[t]; T2 = S0 + maj
        new_e = bld.add32([d, h, S1, ch, _const_word(_K[t]), w[t]])
        new_a = bld.add32([h, S1, ch, _const_word(_K[t]), w[t], S0, mj])
        a, b, c, d, e, f, g, h = new_a, a, b, c, new_e, e, f, g
    fed = []
    for i, (s, v) in enumerate(zip(state, [a, b, c, d, e, f, g, h])):
        fed.append(bld.add32([s, v], out_sigs=digest_sigs[i] if digest_sigs else None))
    return fed


def sha256_512_gadget(bld: Builder, in_bits: list, digest_sigs=None) -> list:
    """SHA-256 of a 512-bit message (two blocks, in-circuit padding) as
    a reusable gadget: in_bits = 512 Bits (MSB-first bit stream),
    returns the 256 digest Bits in the same MSB-first order
    (digest bit j = bit 7-(j%8) of digest byte j//8). digest_sigs
    optionally binds the output to pre-allocated signals (8 lists of 32
    LSB-first signal ids)."""
    assert len(in_bits) == 512

    def word(bits_msb: list) -> list:
        # bits_msb[0] is the word's MSB; internal layout is LSB-first
        return list(reversed(bits_msb))

    block1 = [word(in_bits[i * 32 : (i + 1) * 32]) for i in range(16)]
    pad = [_const_bit(0)] * 512
    pad[0] = _const_bit(1)  # 0x80 after the message
    block2 = [word(pad[i * 32 : (i + 1) * 32]) for i in range(16)]
    block2[15] = _const_word(512)  # big-endian length

    state = [_const_word(v) for v in _IV]
    state = _compress(bld, state, block1)
    state = _compress(bld, state, block2, digest_sigs=digest_sigs)
    out = []
    for w in state:  # LSB-first word bits -> MSB-first stream
        out.extend(reversed(w))
    return out


def sha256_512_circuit(message_bits: list) -> tuple:
    """Sha256(512) equivalent: 512 private input bits -> 256 public
    digest bits (MSB-first within each 32-bit word, like circomlib's
    out[] ordering). Returns (R1CS, witness list).

    The constraint system is input-independent; call once with any
    message for the proving key, and again per-message for witnesses.
    """
    assert len(message_bits) == 512
    bld = Builder(n_public=256)

    # private input bits, booleanity-constrained (circomlib Sha256 does
    # the same for its `in` signals via Bits2Num-style usage)
    in_bits = []
    for v in message_bits:
        assert v in (0, 1)
        sig = bld.bool_sig(v)
        in_bits.append(Bit({sig: 1}, v))

    # public digest signals: out[j] for j in 0..255, word i bit k (MSB
    # first) at public signal 1 + i*32 + k; add32 wants LSB-first ids
    digest_sigs = [
        [1 + i * 32 + (31 - k) for k in range(32)] for i in range(8)
    ]
    sha256_512_gadget(bld, in_bits, digest_sigs=digest_sigs)

    r1cs = R1CS(n_vars=len(bld.values), n_public=256)
    r1cs.constraints = bld.constraints
    assert all(v is not None for v in bld.values)
    return r1cs, bld.values


def sha256_512_witness(message_bits: list) -> list:
    """Witness for a new message (same circuit structure)."""
    _, wit = sha256_512_circuit(message_bits)
    return wit


def digest_from_witness(witness: list) -> bytes:
    """Extract the 32-byte digest from public signals (sanity check)."""
    bits = witness[1:257]
    out = bytearray()
    for i in range(32):
        byte = 0
        for j in range(8):
            byte = (byte << 1) | bits[i * 8 + j]
        out.append(byte)
    return bytes(out)
