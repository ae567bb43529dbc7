"""snarkjs binary container format (.zkey / .wtns).

Layout (mirrors reference src/file_wrapper.rs:45-103):

    magic: 4 bytes ("zkey" / "wtns")
    version: u32 LE
    n_sections: u32 LE
    then per section: type u32 LE, size u64 LE, payload

Reading is zero-copy: the file is memory-mapped once and sections are
returned as numpy uint8 views into the map (the device ingest path
reinterprets them as uint32 limb arrays without copying, like the
reference's `from_u8` transmute, reference src/conversions.rs:336-343).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Section:
    pos: int
    size: int


class BinFile:
    """Memory-mapped snarkjs container reader."""

    def __init__(self, path: str, expected_type: str, max_version: int = 2):
        import os

        self.path = path
        if os.path.getsize(path) < 12:
            raise ValueError(f"{path}: truncated header ({os.path.getsize(path)} bytes)")
        self.data = np.memmap(path, dtype=np.uint8, mode="r")
        total = self.data.shape[0]
        raw = self.data[:12].tobytes()
        magic = raw[:4].decode("ascii", errors="replace")
        if magic != expected_type:
            raise ValueError(f"{path}: invalid file format (got {magic!r}, want {expected_type!r})")
        version, n_sections = struct.unpack_from("<II", raw, 4)
        if version > max_version:
            raise ValueError(f"{path}: unsupported version {version}")
        self.version = version
        self.sections: dict[int, list[Section]] = {}
        pos = 12
        for _ in range(n_sections):
            if pos + 12 > total:
                raise ValueError(f"{path}: truncated section header at {pos}")
            ht, hl = struct.unpack("<IQ", self.data[pos : pos + 12].tobytes())
            pos += 12
            if pos + hl > total:
                raise ValueError(f"{path}: section {ht} overruns file")
            self.sections.setdefault(ht, []).append(Section(pos, hl))
            pos += hl

    def section(self, section_id: int) -> np.ndarray:
        """Zero-copy uint8 view of a unique section's payload."""
        secs = self.sections.get(section_id)
        if not secs:
            raise KeyError(f"{self.path}: missing section {section_id}")
        if len(secs) > 1:
            raise ValueError(f"{self.path}: duplicated section {section_id}")
        s = secs[0]
        return self.data[s.pos : s.pos + s.size]

    def section_u32(self, section_id: int) -> np.ndarray:
        """Section payload reinterpreted as little-endian uint32 limbs."""
        raw = self.section(section_id)
        return raw.view(np.uint32)


class BinWriter:
    """snarkjs container writer (used by the trusted-setup generator)."""

    def __init__(self, file_type: str, version: int = 1):
        assert len(file_type) == 4
        self._buf = io.BytesIO()
        self._buf.write(file_type.encode("ascii"))
        self._buf.write(struct.pack("<I", version))
        self._nsec_pos = self._buf.tell()
        self._buf.write(struct.pack("<I", 0))
        self._n_sections = 0
        self._open_section = None

    def begin_section(self, section_id: int):
        assert self._open_section is None
        self._buf.write(struct.pack("<I", section_id))
        self._open_section = self._buf.tell()
        self._buf.write(struct.pack("<Q", 0))
        self._n_sections += 1

    def write(self, data: bytes):
        assert self._open_section is not None
        self._buf.write(data)

    def end_section(self):
        assert self._open_section is not None
        end = self._buf.tell()
        size = end - self._open_section - 8
        self._buf.seek(self._open_section)
        self._buf.write(struct.pack("<Q", size))
        self._buf.seek(end)
        self._open_section = None

    def save(self, path: str):
        assert self._open_section is None
        data = self._buf.getvalue()
        data = data[: self._nsec_pos] + struct.pack("<I", self._n_sections) + data[self._nsec_pos + 4 :]
        with open(path, "wb") as fh:
            fh.write(data)
