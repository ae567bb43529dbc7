"""snarkjs .wtns witness file reader/writer.

Format (mirrors reference src/file_wrapper.rs:169-177):
  section 1: n8 u32, r (n8 bytes LE), n_witness u32
  section 2: n_witness field elements, 32 bytes LE each, STANDARD form.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..refmath.field import R_MOD, int_to_le
from .binfile import BinFile, BinWriter


@dataclass
class WtnsHeader:
    n8: int
    q: int
    n_witness: int


class WtnsFile:
    def __init__(self, path: str):
        self.bin = BinFile(path, "wtns", max_version=2)
        hdr = self.bin.section(1).tobytes()
        n8 = struct.unpack_from("<I", hdr, 0)[0]
        q = int.from_bytes(hdr[4 : 4 + n8], "little")
        n_witness = struct.unpack_from("<I", hdr, 4 + n8)[0]
        self.header = WtnsHeader(n8, q, n_witness)

    def witness_limbs(self) -> np.ndarray:
        """Zero-copy (n_witness, n8/4) uint32 limb view of the witness."""
        raw = self.bin.section_u32(2)
        return raw.reshape(self.header.n_witness, self.header.n8 // 4)

    def witness_ints(self, start: int = 0, count: int | None = None) -> list:
        """Witness values [start, start+count) as Python ints.

        Slice BEFORE converting: the prove pipeline only needs the
        n_public+1 head for public signals, and converting a multi-
        million-entry witness to ints costs seconds at 1.6M+ vars."""
        n8 = self.header.n8
        if count is None:
            count = self.header.n_witness - start
        sec = self.bin.section(2)
        raw = sec[start * n8 : (start + count) * n8].tobytes()
        return [
            int.from_bytes(raw[i * n8 : (i + 1) * n8], "little")
            for i in range(count)
        ]


def write_wtns(path: str, witness: list, n8: int = 32):
    """Write a snarkjs v2 .wtns file from standard-form int witness values."""
    w = BinWriter("wtns", version=2)
    w.begin_section(1)
    w.write(struct.pack("<I", n8))
    w.write(int_to_le(R_MOD, n8))
    w.write(struct.pack("<I", len(witness)))
    w.end_section()
    w.begin_section(2)
    w.write(b"".join(int_to_le(v % R_MOD, n8) for v in witness))
    w.end_section()
    w.save(path)
