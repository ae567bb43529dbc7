"""Frozen copy of `icicle_snark_tpu_torch/setup/rsa_circuit.py`, the benchmark's input: a later change to the port's builders does not move the yardstick.

RSA-2048 signature verification as R1CS — the `benchmark/rsa` family.

The reference benchmarks `RSAVerify65537(64, 32)` built on circom-bigint
(the reference's benchmark/rsa/{circuit,rsa,fp,bigint}.circom): verify a
PKCS#1 v1.5 SHA-1 signature under a 2048-bit public modulus, where
bigints are k=32 limbs of n=64 bits. This module builds the equivalent
system natively with the same constraint strategy:

  * FpMul(a, b, p) -> a*b mod p: quotient/remainder WITNESSED
    (computed by honest long division at witness time), verified via
    the polynomial-identity trick — evaluate a(x)*b(x) and
    p(x)*q(x)+r(x) at 2k-1 points (ONE mul constraint per point),
    interpolate the difference back to limb coefficients with a
    constant inverse-Vandermonde (free linear combinations), and
    carry-check the signed limb polynomial to zero
    (fp.circom:26-96 FpMul + CheckCarryToZero).
  * sig^65537 = 16 squarings + 1 multiply (rsa.circom FpPow65537Mod).
  * RSAPad: in-circuit PKCS#1 v1.5 bit layout with the SHA-1
    DigestInfo prefix and the modulus-length-aware 0xff run
    (rsa.circom RSAPad).
  * BigLessThan(signature, modulus) range check.

Public signals: the 32 modulus limbs (circuit.circom declares
`{public [modulus]}`). ~158k constraints — same class as the compiled
reference circuit.
"""

from __future__ import annotations

import hashlib

from ..reference.field import R_MOD
from .r1cs import R1CS
from .sha256_circuit import Builder, Bit, _const_bit, _lc_add, _lc_scale

N_BITS = 64   # bits per limb
K = 32        # limbs
E = 65537

_BASE_LEN = 280
_MSG_LEN = 160
_SHA1_PREFIX = 0x3021300906052B0E03021A05000414


class Big:
    """A bigint as k limb values: lcs + exact integer limb values."""

    __slots__ = ("lcs", "ints")

    def __init__(self, lcs: list, ints: list):
        self.lcs = lcs
        self.ints = ints

    @property
    def value(self) -> int:
        return sum(v << (N_BITS * i) for i, v in enumerate(self.ints))


def _num2bits(bld: Builder, lc: dict, value: int, nbits: int) -> list:
    """Allocate nbits booleanity-checked bits + one linear binding
    constraint (circomlib Num2Bits). Returns the bit signals."""
    assert 0 <= value < (1 << nbits), (value, nbits)
    sigs, dec = [], {}
    for i in range(nbits):
        s = bld.bool_sig((value >> i) & 1)
        sigs.append(s)
        dec = _lc_add(dec, {s: 1 << i})
    bld.constrain(lc, {0: 1}, dec)
    return sigs


def _alloc_limbs(bld: Builder, ints: list, range_check=True, sigs=None) -> Big:
    lcs = []
    for i, v in enumerate(ints):
        s = sigs[i] if sigs else bld.alloc(v)
        if sigs:
            bld.values[s] = v % R_MOD
        if range_check:
            _num2bits(bld, {s: 1}, v, N_BITS)
        lcs.append({s: 1})
    return Big(lcs, list(ints))


def _split_limbs(v: int, k: int = K, n: int = N_BITS) -> list:
    return [(v >> (n * i)) & ((1 << n) - 1) for i in range(k)]


def _eval_lc(lcs: list, x: int) -> dict:
    out = {}
    p = 1
    for lc in lcs:
        out = _lc_add(out, _lc_scale(lc, p))
        p = p * x % R_MOD
    return out


def _eval_int(ints: list, x: int) -> int:
    return sum(v * x**j for j, v in enumerate(ints))


_INTERP_CACHE: dict = {}


def _interp_matrix(npts: int) -> list:
    """Inverse Vandermonde mod R_MOD for points 0..npts-1: row i gives
    coefficient i as a combination of the evaluations."""
    if npts in _INTERP_CACHE:
        return _INTERP_CACHE[npts]
    # build V[x][j] = x^j and invert by Gauss-Jordan mod R_MOD
    V = [[pow(x, j, R_MOD) for j in range(npts)] for x in range(npts)]
    inv = [[int(i == j) for j in range(npts)] for i in range(npts)]
    M = [row[:] for row in V]
    for col in range(npts):
        piv = next(r for r in range(col, npts) if M[r][col])
        M[col], M[piv] = M[piv], M[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        s = pow(M[col][col], -1, R_MOD)
        M[col] = [v * s % R_MOD for v in M[col]]
        inv[col] = [v * s % R_MOD for v in inv[col]]
        for r in range(npts):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [(a - f * b) % R_MOD for a, b in zip(M[r], M[col])]
                inv[r] = [(a - f * b) % R_MOD for a, b in zip(inv[r], inv[col])]
    # coefficients = V^-1 . evals -> coefficient row j = row j of inv
    _INTERP_CACHE[npts] = inv
    return inv


def _check_carry_to_zero(bld: Builder, t_lcs: list, t_ints: list, m: int):
    """The signed limb polynomial sum t_i 2^(n i) is zero as an integer
    (fp.circom CheckCarryToZero): witness carries, range-proof each to
    |c| < 2^(m-n+1) via an offset Num2Bits."""
    L = len(t_lcs)
    assert sum(v << (N_BITS * i) for i, v in enumerate(t_ints)) == 0
    carry_bits = m - N_BITS + 2
    prev_lc, prev_int = {}, 0
    for i in range(L - 1):
        cur = t_ints[i] + prev_int
        assert cur % (1 << N_BITS) == 0, "carry chain broken"
        c = cur >> N_BITS
        s = bld.alloc(c % R_MOD)
        # t_i + prev = c * 2^n
        bld.constrain(
            _lc_add(t_lcs[i], prev_lc), {0: 1}, {s: 1 << N_BITS}
        )
        # range proof: c + 2^(carry_bits-1) in [0, 2^carry_bits)
        off = 1 << (carry_bits - 1)
        _num2bits(bld, _lc_add({s: 1}, {0: off}), c + off, carry_bits)
        prev_lc, prev_int = {s: 1}, c
    # last coefficient must cancel the final carry
    bld.constrain(_lc_add(t_lcs[L - 1], prev_lc), {0: 1}, {})
    assert t_ints[L - 1] + prev_int == 0


def _fp_mul(bld: Builder, a: Big, b: Big, p: Big) -> Big:
    """out = a*b mod p with witnessed quotient (fp.circom FpMul)."""
    ab = a.value * b.value
    q_int, r_int = divmod(ab, p.value)
    q = _alloc_limbs(bld, _split_limbs(q_int))
    r = _alloc_limbs(bld, _split_limbs(r_int))

    npts = 2 * K - 1
    v_ab_lcs, v_ab_ints = [], []
    v_pqr_lcs, v_pqr_ints = [], []
    for x in range(npts):
        va, vb = _eval_int(a.ints, x), _eval_int(b.ints, x)
        s_ab = bld.alloc(va * vb % R_MOD)
        bld.constrain(_eval_lc(a.lcs, x), _eval_lc(b.lcs, x), {s_ab: 1})
        v_ab_lcs.append({s_ab: 1})
        v_ab_ints.append(va * vb)

        vp, vq, vr = _eval_int(p.ints, x), _eval_int(q.ints, x), _eval_int(r.ints, x)
        s_pqr = bld.alloc((vp * vq + vr) % R_MOD)
        # (p_eval)(q_eval) = v_pqr - r_eval
        bld.constrain(
            _eval_lc(p.lcs, x), _eval_lc(q.lcs, x),
            _lc_add({s_pqr: 1}, _lc_scale(_eval_lc(r.lcs, x), -1)),
        )
        v_pqr_lcs.append({s_pqr: 1})
        v_pqr_ints.append(vp * vq + vr)

    # t = interp(v_ab - v_pqr) back to limb coefficients (free lcs);
    # integer values computed exactly from the limb convolutions
    inv = _interp_matrix(npts)
    t_lcs = []
    for j in range(npts):
        lc = {}
        for x in range(npts):
            w = inv[j][x]
            lc = _lc_add(lc, _lc_scale(v_ab_lcs[x], w))
            lc = _lc_add(lc, _lc_scale(v_pqr_lcs[x], R_MOD - w))
        t_lcs.append(lc)
    conv_ab = [0] * npts
    conv_pq = [0] * npts
    for i in range(K):
        for j in range(K):
            conv_ab[i + j] += a.ints[i] * b.ints[j]
            conv_pq[i + j] += p.ints[i] * q.ints[j]
    t_ints = [conv_ab[i] - conv_pq[i] - (r.ints[i] if i < K else 0) for i in range(npts)]

    m = N_BITS + N_BITS + (K - 1).bit_length() + 2
    _check_carry_to_zero(bld, t_lcs, t_ints, m)
    return r


def _is_zero(bld: Builder, lc: dict, value: int) -> Bit:
    """circomlib IsZero: out = 1 iff value == 0 (witnessed inverse)."""
    out_v = int(value % R_MOD == 0)
    inv_v = 0 if out_v else pow(value % R_MOD, -1, R_MOD)
    inv_s = bld.alloc(inv_v)
    out_s = bld.alloc(out_v)
    # out = 1 - in*inv ; in*out = 0
    bld.constrain(lc, {inv_s: 1}, _lc_add({0: 1}, {out_s: R_MOD - 1}))
    bld.constrain(lc, {out_s: 1}, {})
    return Bit({out_s: 1}, out_v)


def _less_than(bld: Builder, a_lc, a_v, b_lc, b_v, nbits: int) -> Bit:
    """circomlib LessThan(nbits): out = a < b (both < 2^nbits)."""
    shifted = a_v + (1 << nbits) - b_v
    lc = _lc_add(_lc_add(a_lc, {0: 1 << nbits}), _lc_scale(b_lc, -1))
    bits = _num2bits(bld, lc, shifted, nbits + 1)
    top = bits[nbits]
    out_v = 1 - ((shifted >> nbits) & 1)
    return Bit(_lc_add({0: 1}, {top: R_MOD - 1}), out_v)


def _big_less_than(bld: Builder, a: Big, b: Big) -> Bit:
    """a < b over k limbs (bigint.circom BigLessThan)."""
    res = _const_bit(0)
    for i in range(K):  # least significant upward: res = lt_i OR (eq_i AND res)
        lt = _less_than(bld, a.lcs[i], a.ints[i], b.lcs[i], b.ints[i], N_BITS)
        eq = _is_zero(
            bld,
            _lc_add(a.lcs[i], _lc_scale(b.lcs[i], -1)),
            a.ints[i] - b.ints[i],
        )
        keep = bld.mul(eq, res)
        res = Bit(_lc_add(lt.lc, keep.lc), lt.val | (eq.val & res.val))
        # lt and (eq and res) are mutually exclusive, so plain addition
        # stays boolean
    return res


def _rsa_verify_core(bld: Builder, sig: Big, mod: Big, em_low_bits: list,
                     msg_len: int, base_len: int, prefix: int):
    """Shared PKCS#1 v1.5 verification tail: pad layout + range check +
    sig^65537 == EM. em_low_bits = the msg_len low bits of the encoded
    message (LSB first)."""
    mod_bits = []
    for i in range(K):
        mod_bits += [
            Bit({s: 1}, (mod.ints[i] >> j) & 1)
            for j, s in enumerate(_num2bits(bld, mod.lcs[i], mod.ints[i], N_BITS))
        ]
    nk = N_BITS * K
    padded = [None] * nk
    for i in range(msg_len):
        padded[i] = em_low_bits[i]
    for i in range(msg_len, base_len):
        padded[i] = _const_bit((prefix >> (i - msg_len)) & 1)
    for i in range(base_len, base_len + 8):
        padded[i] = _const_bit(0)
    # 0xff run sized by the modulus bit-length (modulus_prefix loop)
    prefix_lc, prefix_v = {}, 0
    for i in range(nk - 1, base_len + 7, -1):
        if i + 8 < nk:
            prefix_lc = _lc_add(prefix_lc, mod_bits[i + 8].lc)
            prefix_v += mod_bits[i + 8].val
            if i % 8 == 0:
                z = _is_zero(bld, prefix_lc, prefix_v)
                padded[i] = Bit(_lc_add({0: 1}, _lc_scale(z.lc, -1)), 1 - z.val)
            else:
                padded[i] = padded[i + 1]
        else:
            padded[i] = _const_bit(0)
    for i in range(base_len + 8, base_len + 8 + 65):
        # at least 8 octets of 0xff guaranteed by the RFC
        bld.constrain(_lc_add(padded[i].lc, {0: R_MOD - 1}), {0: 1}, {})
        assert padded[i].val == 1, "modulus too short for PKCS#1 padding"
    padded_limbs = Big(
        [
            _lc_add({}, _eval_bits(padded[i * N_BITS : (i + 1) * N_BITS]))
            for i in range(K)
        ],
        [
            sum(padded[i * N_BITS + j].val << j for j in range(N_BITS))
            for i in range(K)
        ],
    )

    # ---- signature < modulus
    ok = _big_less_than(bld, sig, mod)
    bld.constrain(_lc_add(ok.lc, {0: R_MOD - 1}), {0: 1}, {})
    assert ok.val == 1, "signature not reduced mod modulus"

    # ---- sig^65537 mod modulus: 16 squarings + 1 mul
    acc = sig
    for _ in range(16):
        acc = _fp_mul(bld, acc, acc, mod)
    acc = _fp_mul(bld, sig, acc, mod)

    # ---- result == padded message (k linear constraints)
    for i in range(K):
        bld.constrain(
            _lc_add(acc.lcs[i], _lc_scale(padded_limbs.lcs[i], -1)),
            {0: 1}, {},
        )
        assert acc.ints[i] == padded_limbs.ints[i], "signature invalid"


def rsa_verify_circuit(signature: int, modulus: int, base_message: int) -> tuple:
    """RSAVerify65537(64, 32): check signature^65537 == pkcs1v15(sha1)
    under `modulus`. Public signals = the 32 modulus limbs. Returns
    (R1CS, witness); the structure is input-independent."""
    bld = Builder(n_public=K)

    mod = _alloc_limbs(
        bld, _split_limbs(modulus), range_check=False,
        sigs=list(range(1, K + 1)),
    )
    sig = _alloc_limbs(bld, _split_limbs(signature))  # includes range check
    msg = _alloc_limbs(bld, _split_limbs(base_message), range_check=False)

    msg_bits = []
    for i in range(K):
        msg_bits += [
            Bit({s: 1}, (msg.ints[i] >> j) & 1)
            for j, s in enumerate(_num2bits(bld, msg.lcs[i], msg.ints[i], N_BITS))
        ]
    nk = N_BITS * K
    for i in range(_MSG_LEN, nk):  # message is exactly 160 bits
        bld.constrain(msg_bits[i].lc, {0: 1}, {})
        assert msg_bits[i].val == 0

    _rsa_verify_core(bld, sig, mod, msg_bits[:_MSG_LEN], _MSG_LEN, _BASE_LEN, _SHA1_PREFIX)

    r1cs = R1CS(n_vars=len(bld.values), n_public=K)
    r1cs.constraints = bld.constraints
    assert all(v is not None for v in bld.values)
    return r1cs, bld.values


# SHA-256 DigestInfo prefix (19 bytes) for the rsa+sha256 composite
_SHA256_PREFIX = 0x3031300D060960864801650304020105000420
_SHA256_MSG_LEN = 256
_SHA256_BASE_LEN = _SHA256_MSG_LEN + 19 * 8


def rsa_sha256_verify_circuit(message: bytes, signature: int, modulus: int) -> tuple:
    """The anon_aadhaar SignatureVerifier core
    (the reference's benchmark/anon_aadhaar/helpers/signature.circom:
    Sha256 of the message IN-CIRCUIT feeding RSAVerify65537): verify a
    PKCS#1 v1.5 SHA-256 signature of a 64-byte message. Public signals
    = the 32 modulus limbs. Returns (R1CS, witness)."""
    assert len(message) == 64
    bld = Builder(n_public=K)

    mod = _alloc_limbs(
        bld, _split_limbs(modulus), range_check=False,
        sigs=list(range(1, K + 1)),
    )
    sig = _alloc_limbs(bld, _split_limbs(signature))

    from .sha256_circuit import sha256_512_gadget

    in_bits = []
    for i in range(512):
        v = (message[i // 8] >> (7 - i % 8)) & 1
        s = bld.bool_sig(v)
        in_bits.append(Bit({s: 1}, v))
    digest = sha256_512_gadget(bld, in_bits)  # 256 Bits, MSB-first stream

    # EM integer bit i (LSB first) = bit (i%8) of digest byte 31-i//8;
    # digest stream bit j = bit 7-(j%8) of byte j//8
    em_low = [
        digest[8 * (31 - i // 8) + 7 - (i % 8)] for i in range(_SHA256_MSG_LEN)
    ]
    _rsa_verify_core(
        bld, sig, mod, em_low, _SHA256_MSG_LEN, _SHA256_BASE_LEN, _SHA256_PREFIX
    )

    r1cs = R1CS(n_vars=len(bld.values), n_public=K)
    r1cs.constraints = bld.constraints
    assert all(v is not None for v in bld.values)
    return r1cs, bld.values


def _eval_bits(bits: list) -> dict:
    lc = {}
    for j, b in enumerate(bits):
        lc = _lc_add(lc, _lc_scale(b.lc, 1 << j))
    return lc


# ---------------------------------------------------------------- fixtures

def _miller_rabin(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    import random

    rng = random.Random(0xC0FFEE ^ n)
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _gen_prime(bits: int, seed: int) -> int:
    import random

    rng = random.Random(seed)
    while True:
        p = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if _miller_rabin(p):
            return p


def rsa_test_vector(message: bytes = b"icicle-snark-tpu rsa benchmark"):
    """Deterministic RSA-2048 keypair + PKCS#1 v1.5 SHA-1 signature
    matching the circuit's padding layout. Returns
    (signature, modulus, base_message) integers."""
    p = _gen_prime(1024, 1)
    q = _gen_prime(1024, 2)
    n = p * q
    d = pow(E, -1, (p - 1) * (q - 1))
    h = int.from_bytes(hashlib.sha1(message).digest(), "little")
    # padded = msg_bits || sha1-prefix || 0x00 || 0xff... || 0  per the
    # circuit's little-endian bit layout (rsa.circom RSAPad)
    padded = h | (_SHA1_PREFIX << _MSG_LEN)
    nbits = n.bit_length()  # 2048
    # PKCS#1 v1.5 EM = 0x00 || 0x01 || 0xff.. || 0x00 || DigestInfo:
    # the 0x01 lands at bit nbits-16, the 0xff run spans down to
    # base_len+8 (matches the circuit's modulus-prefix loop)
    for i in range(_BASE_LEN + 8, nbits - 15):
        padded |= 1 << i
    signature = pow(padded, d, n)
    return signature, n, h


def rsa_sha256_test_vector(message: bytes = bytes(range(64))):
    """Deterministic keypair + PKCS#1 v1.5 SHA-256 signature of a
    64-byte message. Returns (message, signature, modulus)."""
    assert len(message) == 64
    p = _gen_prime(1024, 1)
    q = _gen_prime(1024, 2)
    n = p * q
    d = pow(E, -1, (p - 1) * (q - 1))
    digest = hashlib.sha256(message).digest()
    h = int.from_bytes(digest, "big")  # big-endian: D[31] least significant
    padded = h | (_SHA256_PREFIX << _SHA256_MSG_LEN)
    nbits = n.bit_length()
    for i in range(_SHA256_BASE_LEN + 8, nbits - 15):
        padded |= 1 << i
    signature = pow(padded, d, n)
    return message, signature, n
