"""What the reference reads of a zkey: its header and its circuit.

The benchmark's zkey is made once per checkout by the program's setup; a
run builds its circuit again from the seed. `same_circuit` holds the zkey's
coefficient section (section 4: the A and B matrices and the public-input
binding rows, as snarkjs writes them) byte for byte against the one the
frozen builder's R1CS gives, by SHA-256, so a run never proves a circuit
other than the one it judges.
"""

from __future__ import annotations

import hashlib
import struct
from array import array

import numpy as np

from .field import MONT_R_FR, R_MOD, int_to_le

RECORD = np.dtype([("m", "<u4"), ("c", "<u4"), ("s", "<u4"), ("v", "u1", (32,))])


def sections(path: str) -> dict:
    """{section id: (offset, size)} of a snarkjs binary container."""
    out = {}
    with open(path, "rb") as fh:
        head = fh.read(12)
        if len(head) < 12:
            raise ValueError(f"{path}: truncated header")
        _magic, _version, count = struct.unpack("<4sII", head)
        pos = 12
        for _ in range(count):
            fh.seek(pos)
            sid, size = struct.unpack("<IQ", fh.read(12))
            out[sid] = (pos + 12, size)
            pos += 12 + size
    return out


def read_section(path: str, sid: int) -> np.ndarray:
    off, size = sections(path)[sid]
    return np.memmap(path, dtype=np.uint8, mode="r", offset=off, shape=(size,))


def header(path: str) -> dict:
    """n_vars, n_public and domain_size from section 2."""
    raw = read_section(path, 2)[:84].tobytes()
    n_vars, n_public, dom = struct.unpack_from("<III", raw, 72)
    return {"n_vars": n_vars, "n_public": n_public, "domain_size": dom}


def coefficient_records(r1cs) -> bytes:
    """Section 4 as the frozen builder's R1CS gives it: the record count,
    then (matrix, row, signal, coefficient * 2^256 mod r) per A and B term,
    row by row, then the binding rows."""
    m, c, s, k = array("I"), array("I"), array("I"), array("I")
    index = {}
    for row, (a_lc, b_lc, _c_lc) in enumerate(r1cs.constraints):
        for mat, lc in ((0, a_lc), (1, b_lc)):
            for sig, coef in lc.items():
                m.append(mat)
                c.append(row)
                s.append(sig)
                k.append(index.setdefault(coef % R_MOD, len(index)))
    nc = r1cs.n_constraints
    for sig in range(r1cs.n_public + 1):
        m.append(0)
        c.append(nc + sig)
        s.append(sig)
        k.append(index.setdefault(1, len(index)))
    values = np.frombuffer(b"".join(int_to_le(v * MONT_R_FR % R_MOD) for v in index),
                           dtype=np.uint8).reshape(-1, 32)
    rec = np.empty(len(m), dtype=RECORD)
    rec["m"], rec["c"], rec["s"] = (np.frombuffer(a, dtype=np.uint32) for a in (m, c, s))
    rec["v"] = values[np.frombuffer(k, dtype=np.uint32)]
    return struct.pack("<I", len(m)) + rec.tobytes()


def circuit_digest(r1cs) -> str:
    return hashlib.sha256(coefficient_records(r1cs)).hexdigest()


def zkey_circuit_digest(path: str) -> str:
    return hashlib.sha256(read_section(path, 4)).hexdigest()
