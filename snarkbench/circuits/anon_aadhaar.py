"""Inputs of the anon_aadhaar configurations: the reference's
benchmark/anon_aadhaar AadhaarVerifier over a signed Aadhaar V2 QR payload.

A run draws the payload from its seed: the name, address and other text
fields, the reference ID's timestamp, the date of birth, gender, pin code,
state, mobile digits and the photo bytes, with the nullifier seed and the
signal hash. Every field keeps a fixed length, so each seed gives the
builder the same sizes and the MSMs the same kind of bit-valued witness.
The RSA key is fixed, as UIDAI's is, and signs the payload.

The constraint structure depends only on `max_data_length`; the run still
holds its R1CS against the zkey's (`reference/zkey.py`).
"""

from __future__ import annotations

import hashlib
import random

from .aadhaar_circuit import E, _gen_prime, _sign_pkcs1_sha256, aadhaar_test_vector, \
    aadhaar_verifier_circuit

STATES = (b"DELHI", b"KERALA", b"ASSAM", b"PUNJAB", b"BIHAR", b"GOA", b"ODISHA", b"TRIPURA")
_KEY = {}


def _key() -> tuple:
    """The fixed signing key (n, d), made once a process."""
    if not _KEY:
        p, q = _gen_prime(1024, 1), _gen_prime(1024, 2)
        _KEY["n"], _KEY["d"] = p * q, pow(E, -1, (p - 1) * (q - 1))
    return _KEY["n"], _KEY["d"]


def _text(rng, length: int) -> bytes:
    return bytes(rng.choice(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ ") for _ in range(length))


def _digits(rng, length: int) -> bytes:
    return bytes(rng.choice(b"0123456789") for _ in range(length))


def seeded_payload(params: dict, seed: int) -> dict:
    """Keyword arguments of `aadhaar_verifier_circuit` for the seed's
    payload. Days stay in 1-16 and years in range for the circuit's
    4-bit and 8-bit comparisons (extractor.circom)."""
    rng = random.Random(seed)
    n, d = _key()
    ts = b"%04d%02d%02d%02d%02d%02d" % (
        rng.randint(2019, 2031), rng.randint(1, 12), rng.randint(1, 16),
        rng.randint(0, 23), rng.randint(0, 59), rng.randint(0, 59))
    dob = b"%02d-%02d-%04d" % (rng.randint(1, 16), rng.randint(1, 12), rng.randint(1950, 2004))
    state = rng.choice(STATES)
    fields = {
        1: b"%d" % rng.randint(0, 3), 2: _digits(rng, 4) + ts, 3: _text(rng, 16), 4: dob,
        5: rng.choice((b"M", b"F", b"T")), 6: _text(rng, 12), 7: _text(rng, 10),
        8: _text(rng, 12), 9: _digits(rng, 3), 10: _text(rng, 10),
        11: bytes([rng.choice(b"123456789")]) + _digits(rng, 5), 12: _text(rng, 12),
        13: state + b" " * (8 - len(state)), 14: _text(rng, 12), 15: _text(rng, 12),
        16: _text(rng, 8), 17: _digits(rng, 4),
    }
    data, delims = bytearray(b"V2"), []
    for pos in range(1, 19):
        delims.append(len(data))
        data.append(255)
        if pos <= 17:
            data += fields[pos]
    data += bytes(rng.randrange(255) for _ in range(params["photo_bytes"]))
    non_padded_len = len(data)
    digest = hashlib.sha256(bytes(data)).digest()
    data.append(0x80)
    while (len(data) + 8) % 64:
        data.append(0)
    data += (non_padded_len * 8).to_bytes(8, "big")
    padded_len = len(data)
    max_len = params["max_data_length"]
    if padded_len > max_len:
        raise ValueError(f"payload of {padded_len} bytes exceeds maxDataLength {max_len}")
    data += bytes(max_len - padded_len)
    return dict(qr_data_padded=bytes(data), padded_len=padded_len,
                non_padded_len=non_padded_len, delimiter_indices=delims,
                signature=_sign_pkcs1_sha256(digest, n, d), modulus=n,
                nullifier_seed=rng.randrange(1, 1 << 64), signal_hash=rng.randrange(1, 1 << 128))


def setup_circuit(params: dict):
    kwargs, _ = aadhaar_test_vector(max_data_length=params["max_data_length"])
    return aadhaar_verifier_circuit(**kwargs)[0]


def run_inputs(params: dict, seed: int) -> tuple:
    """(R1CS, [witness]): one witness a seed, with the R1CS the builder
    made beside it."""
    r1cs, witness = aadhaar_verifier_circuit(**seeded_payload(params, seed))
    return r1cs, [witness]
