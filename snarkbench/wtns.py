"""The benchmark's own writer of snarkjs `.wtns` files (version 2).

  magic "wtns", version, section count, then per section: id u32, size u64;
  section 1: n8 u32, r (n8 bytes LE), witness count u32;
  section 2: the witness values, 32 bytes LE each, standard form.
"""

from __future__ import annotations

import os
import struct

from .reference.field import R_MOD, int_to_le


def write_wtns(path: str, witness: list):
    """Write `witness` (ints, signal 0 first) to `path`, through a
    temporary file beside it so a reader never sees half a file."""
    head = struct.pack("<I", 32) + int_to_le(R_MOD) + struct.pack("<I", len(witness))
    body = b"".join(int_to_le(v % R_MOD) for v in witness)
    tmp = f"{path}.part"
    with open(tmp, "wb") as fh:
        fh.write(b"wtns" + struct.pack("<II", 2, 2))
        for sid, payload in ((1, head), (2, body)):
            fh.write(struct.pack("<IQ", sid, len(payload)))
            fh.write(payload)
    os.replace(tmp, path)
