"""snarkjs .wtns witness file reader/writer.

Format (mirrors reference src/file_wrapper.rs:169-177):
  section 1: n8 u32, r (n8 bytes LE), n_witness u32
  section 2: n_witness field elements, 32 bytes LE each, STANDARD form.

The header and the public signals are read through the file's memory map;
the prove reads section 2 with plain positioned reads in chunks, a few in
flight at once (`read_words`).
"""

from __future__ import annotations

import functools
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .. import trace
from ..refmath.field import R_MOD, int_to_le
from .binfile import BinFile, BinWriter


@functools.cache
def _reader_pool(readers: int) -> ThreadPoolExecutor:
    """The process's threads for `readers` witness reads in flight, started
    once: starting and joining threads on every read cost more than the
    reads on an H100 host (PERF.md, Findings)."""
    return ThreadPoolExecutor(readers, thread_name_prefix="wtns-read")


# a forked child has none of its parent's threads
os.register_at_fork(after_in_child=_reader_pool.cache_clear)


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

    def read_words(self, out: np.ndarray, chunk: int, readers: int):
        """Read the witness section into `out` (C-contiguous, as many bytes
        as the section holds) with plain positioned reads of at most `chunk`
        bytes, `readers` of them in flight on threads of their own; yields
        each chunk's byte range (lo, hi) in order once it has landed, the
        wait for it in a host span `ingest.read`. Raises ValueError where
        the section's size is not n_witness * n8 bytes, not the size of
        `out`, or the file ends inside it."""
        sec = self.bin.section_range(2)
        size = self.header.n_witness * self.header.n8
        if sec.size != size or out.nbytes != size:
            raise ValueError(f"{self.bin.path}: witness section of {sec.size} bytes, want {size} "
                             f"({self.header.n_witness} x {self.header.n8}) into {out.nbytes}")
        buf = out.reshape(-1).view(np.uint8)
        ranges = [(lo, min(lo + chunk, size)) for lo in range(0, size, chunk)]
        pool = _reader_pool(readers)
        fd = os.open(self.bin.path, os.O_RDONLY)
        reads = []
        try:
            reads += [pool.submit(os.preadv, fd, [buf[lo:hi]], sec.pos + lo) for lo, hi in ranges]
            for (lo, hi), read in zip(ranges, reads):
                with trace.span("ingest.read", host=True):
                    got = read.result()
                if got != hi - lo:
                    raise ValueError(f"{self.bin.path}: the witness section ends after "
                                     f"{lo + got} of {size} bytes")
                yield lo, hi
        finally:
            for read in reads:  # none may write into `out` or read `fd` after this
                if not read.cancel():
                    read.exception()
            os.close(fd)

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
