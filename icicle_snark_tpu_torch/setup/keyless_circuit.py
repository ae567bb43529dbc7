"""Aptos-keyless-style JWT circuit — the `benchmark/keyless` family.

The reference's keyless benchmark defers to the external
aptos-labs/keyless-zk-proofs circuit (reference benchmark/keyless/README.md).
Its main relation: an RS256-signed OIDC JWT, checked in-circuit, binds a
per-user identity commitment and an ephemeral public key. This module
builds the core of that relation natively:

  * dynamic-length SHA-256 over the signed `header.payload` string +
    PKCS#1 v1.5 RSA-65537 verification (shared gadgets with the
    anon_aadhaar family);
  * in-circuit base64url DECODE of the payload section (piecewise
    alphabet constraints — the keyless/zk-email Base64Decode shape);
  * claim extraction from the decoded JSON: `"sub"`, `"aud"`, `"nonce"`
    located by witnessed indices, key patterns + closing quote
    constrained, values packed little-endian;
  * identity commitment IdC = Poseidon(pepper, aud, uid_val, uid_key)
    (the Aptos identity-commitment structure);
  * nonce binding: the payload's nonce claim must equal
    Poseidon(epk_0, epk_1, epk_2, exp_date, blinder) — tying the proof
    to the public ephemeral key and expiry.

Simplifications vs the full Aptos circuit (tracked): the nonce claim is
a fixed-width 77-digit zero-padded decimal; `iss`/`email_verified`
checks and the extra-field blinding are not modelled; RSA limbs are this
framework's 64x32 split.

Public signals: 1 idc (output), 2..4 epk limbs, 5 exp_date.
"""

from __future__ import annotations

import hashlib

from ..refmath.field import R_MOD
from .r1cs import R1CS
from .rsa_circuit import (
    _SHA256_BASE_LEN,
    _SHA256_MSG_LEN,
    _SHA256_PREFIX,
    E,
    _alloc_limbs,
    _gen_prime,
    _less_than,
    _num2bits,
    _rsa_verify_core,
    _split_limbs,
)
from .aadhaar_circuit import (
    MAX_FIELD_BYTES,
    _array_selector,
    _bytes_to_int_chunks,
    _digit_bytes_to_number,
    _ev_sum,
    _log2_circom,
    _sha256_dynamic,
    _sign_pkcs1_sha256,
    _subarray_selector,
)
from .poseidon import poseidon_gadget, poseidon_hash
from .sha256_circuit import Bit, Builder, _lc_add, _lc_scale

B64_PAYLOAD_MAX = 512          # base64url chars of payload (mult of 4)
DECODED_MAX = B64_PAYLOAD_MAX // 4 * 3
NONCE_DIGITS = 77


def _pack_const(s: bytes) -> int:
    return int.from_bytes(s + bytes(MAX_FIELD_BYTES - len(s)), "little")


# ------------------------------------------------------------------ base64


# (flag index, delta = char - value, value range lo, hi) per segment;
# zero chars (masked tail) decode to value 0 via the last segment
_B64_SEGMENTS = [
    (65, 0, 26),    # 'A'-'Z' -> 0..25
    (71, 26, 52),   # 'a'-'z' -> 26..51
    (-4, 52, 62),   # '0'-'9' -> 52..61
    (-17, 62, 63),  # '-' -> 62
    (32, 63, 64),   # '_' -> 63
    (0, 0, 1),      # NUL (masked) -> 0
]


def _b64_char_value(c: int) -> int:
    if 65 <= c <= 90:
        return c - 65
    if 97 <= c <= 122:
        return c - 71
    if 48 <= c <= 57:
        return c + 4
    if c == 45:
        return 62
    if c == 95:
        return 63
    if c == 0:
        return 0
    raise ValueError(f"not a base64url char: {c}")


def _base64url_decode_gadget(bld: Builder, chars: list) -> list:
    """Decode base64url chars ((lc, val) pairs, NUL-masked tail) into
    3/4 as many bytes. Each char: one-hot segment flags + linear
    char/value relation + per-segment value range."""
    assert len(chars) % 4 == 0
    bit_cols = []  # per char: 6 value bits LSB-first
    for c_lc, c_v in chars:
        v = _b64_char_value(c_v)
        seg = next(i for i, (d, lo, hi) in enumerate(_B64_SEGMENTS)
                   if lo <= v < hi and c_v - v == d and (c_v != 0 or i == 5))
        flags = []
        for i in range(len(_B64_SEGMENTS)):
            s = bld.bool_sig(int(i == seg))
            flags.append(Bit({s: 1}, int(i == seg)))
        one_lc, one_v = _ev_sum([(f.lc, f.val) for f in flags])
        bld.constrain(_lc_add(one_lc, {0: R_MOD - 1}), {0: 1}, {})
        assert one_v == 1
        v_sig = bld.alloc(v)
        v_ids = _num2bits(bld, {v_sig: 1}, v, 6)
        v_lc = {s: 1 << j for j, s in enumerate(v_ids)}
        # char = value + sum(delta_k * flag_k)  (linear)
        delta_lc, delta_v = _ev_sum(
            [(_lc_scale(f.lc, d), f.val * d)
             for f, (d, _, _) in zip(flags, _B64_SEGMENTS)])
        bld.constrain(
            _lc_add(c_lc, _lc_scale(_lc_add(v_lc, delta_lc), -1)), {0: 1}, {})
        assert (c_v - v - sum(f.val * d for f, (d, _, _)
                              in zip(flags, _B64_SEGMENTS))) % R_MOD == 0
        # segment range: flag_k * (in_range_k - 1) == 0
        for f, (d, lo, hi) in zip(flags, _B64_SEGMENTS):
            if hi - lo == 1:  # exact value: flag * (v - lo) == 0
                bld.constrain(f.lc, _lc_add(v_lc, {0: -lo % R_MOD}), {})
                assert not f.val or v == lo
            else:
                below = _less_than(bld, v_lc, v, {0: hi}, hi, 6)
                at_least = _less_than(bld, {0: lo - 1}, lo - 1, v_lc, v, 6) \
                    if lo else below
                ok = bld.mul(below, at_least) if lo else below
                bld.constrain(f.lc, _lc_add({0: 1}, _lc_scale(ok.lc, -1)), {})
                assert not f.val or ok.val == 1
        bit_cols.append((v_lc, v))

    out = []
    for j in range(0, len(chars), 4):
        (l0, v0), (l1, v1), (l2, v2), (l3, v3) = bit_cols[j:j + 4]
        # b0 = v0*4 + v1>>4 ; b1 = (v1 & 15)*16 + v2>>2 ; b2 = (v2&3)*64 + v3
        # reassemble from the 6-bit decompositions (linear): recover the
        # individual bit signals from each v_lc ({sig: 1<<j})
        def bit_sigs(lc):
            return [s for s, _ in sorted(lc.items(), key=lambda kv: kv[1])]

        b0_lc, b0_v = {}, (v0 << 2 | v1 >> 4) & 0xFF
        for j2, s in enumerate(bit_sigs(l0)):
            b0_lc = _lc_add(b0_lc, {s: 1 << (j2 + 2)})
        for j2, s in enumerate(bit_sigs(l1)[4:]):
            b0_lc = _lc_add(b0_lc, {s: 1 << j2})
        b1_lc, b1_v = {}, ((v1 & 15) << 4 | v2 >> 2) & 0xFF
        for j2, s in enumerate(bit_sigs(l1)[:4]):
            b1_lc = _lc_add(b1_lc, {s: 1 << (j2 + 4)})
        for j2, s in enumerate(bit_sigs(l2)[2:]):
            b1_lc = _lc_add(b1_lc, {s: 1 << j2})
        b2_lc, b2_v = {}, ((v2 & 3) << 6 | v3) & 0xFF
        for j2, s in enumerate(bit_sigs(l2)[:2]):
            b2_lc = _lc_add(b2_lc, {s: 1 << (j2 + 6)})
        for j2, s in enumerate(bit_sigs(l3)):
            b2_lc = _lc_add(b2_lc, {s: 1 << j2})
        out.extend([(b0_lc, b0_v), (b1_lc, b1_v), (b2_lc, b2_v)])
    return out


# ------------------------------------------------------------- claim pull


def _extract_claim(bld: Builder, decoded: list, key: bytes, start_lc, start_v,
                   val_len_lc, val_len_v, val_max: int) -> list:
    """Constrain decoded[start..] matches `"key":"` and return the
    length-masked value window (val_max (lc,val) pairs). The byte after
    the value must be the closing quote."""
    pat = b'"' + key + b'":"'
    win_len = len(pat) + val_max + 1
    win = _subarray_selector(bld, decoded, start_lc, start_v,
                             {0: win_len}, win_len, win_len)
    for i, ch in enumerate(pat):
        bld.constrain(_lc_add(win[i][0], {0: -ch % R_MOD}), {0: 1}, {})
        assert win[i][1] == ch, (key, i, win[i][1])
    val = _subarray_selector(bld, win, {0: len(pat)}, len(pat),
                             val_len_lc, val_len_v, val_max)
    close_lc, close_v = _array_selector(
        bld, win, _lc_add(val_len_lc, {0: len(pat)}), val_len_v + len(pat),
        _log2_circom(win_len))
    bld.constrain(_lc_add(close_lc, {0: -ord('"') % R_MOD}), {0: 1}, {})
    assert close_v == ord('"')
    return val


# ------------------------------------------------------------ main circuit


def keyless_circuit(jwt: bytes, signature: int, modulus: int, pepper: int,
                    epk: tuple, exp_date: int, blinder: int,
                    sub_start: int, sub_len: int, aud_start: int,
                    aud_len: int, nonce_start: int,
                    max_jwt_len: int = 1024) -> tuple:
    """Build the keyless R1CS + witness. jwt = `header.payload` (both
    base64url, unpadded). Returns (r1cs, witness)."""
    assert max_jwt_len % 64 == 0
    n_pub = 5
    bld = Builder(n_public=n_pub)
    SIG_IDC, SIG_EPK0, SIG_EPK1, SIG_EPK2, SIG_EXP = 1, 2, 3, 4, 5
    for s, v in zip((SIG_EPK0, SIG_EPK1, SIG_EPK2, SIG_EXP),
                    (*epk, exp_date)):
        bld.values[s] = v % R_MOD

    # ---- SHA-padded JWT buffer
    non_padded = len(jwt)
    buf = bytearray(jwt)
    buf.append(0x80)
    while (len(buf) + 8) % 64:
        buf.append(0)
    buf += (non_padded * 8).to_bytes(8, "big")
    padded_len = len(buf)
    assert padded_len <= max_jwt_len
    buf += bytes(max_jwt_len - padded_len)

    data_sigs = [bld.alloc(b) for b in buf]
    data_vals = list(buf)
    len_sig = bld.alloc(padded_len)
    sig_big = _alloc_limbs(bld, _split_limbs(signature))
    mod_big = _alloc_limbs(bld, _split_limbs(modulus), range_check=False)
    pepper_sig = bld.alloc(pepper)
    blinder_sig = bld.alloc(blinder)

    # ---- RS256: dynamic SHA-256 + RSA verify
    digest = _sha256_dynamic(bld, data_sigs, data_vals, {len_sig: 1}, padded_len)
    em_low = [digest[8 * (31 - i // 8) + 7 - (i % 8)]
              for i in range(_SHA256_MSG_LEN)]
    _rsa_verify_core(bld, sig_big, mod_big, em_low, _SHA256_MSG_LEN,
                     _SHA256_BASE_LEN, _SHA256_PREFIX)

    # ---- payload section: jwt[dot+1 ..], '.' separator constrained
    dot_idx = jwt.index(b".")
    dot_sig = bld.alloc(dot_idx)
    b64_len = non_padded - dot_idx - 1
    b64_len_sig = bld.alloc(b64_len)
    data = [({s: 1}, v) for s, v in zip(data_sigs, data_vals)]
    dot_lc, dot_v = _array_selector(bld, data, {dot_sig: 1}, dot_idx, 12)
    bld.constrain(_lc_add(dot_lc, {0: -ord(".") % R_MOD}), {0: 1}, {})
    assert dot_v == ord(".")
    payload_b64 = _subarray_selector(
        bld, data, _lc_add({dot_sig: 1}, {0: 1}), dot_idx + 1,
        {b64_len_sig: 1}, b64_len, B64_PAYLOAD_MAX)
    decoded = _base64url_decode_gadget(bld, payload_b64)

    # ---- claims
    def priv(v):
        s = bld.alloc(v)
        return {s: 1}, v

    sub_val = _extract_claim(bld, decoded, b"sub", *priv(sub_start),
                             *priv(sub_len), MAX_FIELD_BYTES)
    aud_val = _extract_claim(bld, decoded, b"aud", *priv(aud_start),
                             *priv(aud_len), MAX_FIELD_BYTES)
    nonce_val = _extract_claim(bld, decoded, b"nonce", *priv(nonce_start),
                               *priv(NONCE_DIGITS), NONCE_DIGITS)

    # ---- nonce binding: decimal digits == Poseidon(epk, exp, blinder)
    nonce_lc, nonce_v = _digit_bytes_to_number(nonce_val)
    expect_lc, expect_v = poseidon_gadget(bld, [
        ({SIG_EPK0: 1}, epk[0] % R_MOD), ({SIG_EPK1: 1}, epk[1] % R_MOD),
        ({SIG_EPK2: 1}, epk[2] % R_MOD), ({SIG_EXP: 1}, exp_date % R_MOD),
        ({blinder_sig: 1}, blinder % R_MOD)])
    bld.constrain(_lc_add(nonce_lc, _lc_scale(expect_lc, -1)), {0: 1}, {})
    assert nonce_v == expect_v, "nonce does not commit to the ephemeral key"

    # ---- identity commitment
    sub_packed = _bytes_to_int_chunks(sub_val, 1)[0]
    aud_packed = _bytes_to_int_chunks(aud_val, 1)[0]
    idc_lc, idc_v = poseidon_gadget(bld, [
        ({pepper_sig: 1}, pepper % R_MOD), aud_packed, sub_packed,
        ({0: _pack_const(b"sub")}, _pack_const(b"sub"))])
    bld.values[SIG_IDC] = idc_v
    bld.constrain(_lc_add(idc_lc, {SIG_IDC: R_MOD - 1}), {0: 1}, {})

    r1cs = R1CS(n_vars=len(bld.values), n_public=n_pub)
    r1cs.constraints = bld.constraints
    assert all(v is not None for v in bld.values)
    return r1cs, bld.values


# ------------------------------------------------------------ test vector


def _b64url(b: bytes) -> bytes:
    import base64
    return base64.urlsafe_b64encode(b).rstrip(b"=")


def keyless_test_vector(max_jwt_len: int = 1024):
    """Synthetic OIDC JWT signed with the deterministic test key.
    Returns (kwargs for keyless_circuit, expected idc)."""
    p = _gen_prime(1024, 1)
    q = _gen_prime(1024, 2)
    n = p * q
    d = pow(E, -1, (p - 1) * (q - 1))

    epk = (111, 222, 333)
    exp_date = 1767225600
    blinder = 42424242
    pepper = 314159265358979
    nonce = poseidon_hash([*epk, exp_date, blinder])
    nonce_str = str(nonce).zfill(NONCE_DIGITS).encode()
    assert len(nonce_str) == NONCE_DIGITS

    sub = b"104953131415926535897"
    aud = b"407408718192.apps.example.com"
    header = _b64url(b'{"alg":"RS256","typ":"JWT"}')
    payload_json = (b'{"iss":"https://accounts.example.com","azp":"x",'
                    b'"aud":"' + aud + b'","sub":"' + sub + b'",'
                    b'"email_verified":true,"nonce":"' + nonce_str + b'",'
                    b'"iat":1700000000,"exp":1700003600}')
    payload = _b64url(payload_json)
    jwt = header + b"." + payload
    digest = hashlib.sha256(jwt).digest()
    signature = _sign_pkcs1_sha256(digest, n, d)

    # claim offsets in the DECODED payload: the decode gadget emits the
    # b64-aligned byte stream, which equals payload_json when the b64
    # section starts at offset 0 of the selector window
    def off(key):
        i = payload_json.index(b'"' + key + b'":"')
        return i

    sub_packed = int.from_bytes(sub + bytes(MAX_FIELD_BYTES - len(sub)), "little")
    aud_packed = int.from_bytes(aud + bytes(MAX_FIELD_BYTES - len(aud)), "little")
    expected_idc = poseidon_hash(
        [pepper, aud_packed, sub_packed, _pack_const(b"sub")])

    kwargs = dict(
        jwt=jwt, signature=signature, modulus=n, pepper=pepper, epk=epk,
        exp_date=exp_date, blinder=blinder,
        sub_start=off(b"sub"), sub_len=len(sub),
        aud_start=off(b"aud"), aud_len=len(aud),
        nonce_start=off(b"nonce"), max_jwt_len=max_jwt_len,
    )
    return kwargs, expected_idc
