"""snarkjs .zkey (Groth16 proving key) reader.

Section map (mirrors reference src/{zkey.rs,cache.rs}):
  1: protocol id (1 = Groth16)
  2: header: n8q, q, n8r, r, nVars, nPublic, domainSize,
     then vk points alpha1,beta1 (G1) beta2,gamma2 (G2) delta1 (G1) delta2 (G2)
     - all affine, coordinates Montgomery-form LE
  3: IC points (verifier part; unused by the prover)
  4: coefficient records: u32 count prefix is absent; the reference
     derives n_coef = (size - 4)/(12 + n8r) and starts at offset 4
     (reference src/cache.rs:126-166). Record: m u32, c u32, s u32,
     coef (n8r bytes, Montgomery).
  5..9: points A, B1, B2, C, H (affine, Montgomery coordinates).

All bulk payloads are returned as zero-copy numpy uint32 limb arrays;
conversion out of Montgomery form happens on-device (the device field layer
uses Montgomery internally, so scalars/points upload with NO conversion
at all — the reference needed explicit from_mont kernels instead,
reference src/cache.rs:208-214).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..refmath.field import fq_from_mont
from .binfile import BinFile

GROTH16_PROTOCOL_ID = 1


@dataclass
class ZKeyHeader:
    n8q: int
    q: int
    n8r: int
    r: int
    n_vars: int
    n_public: int
    domain_size: int
    power: int
    # vk points as affine coordinate ints in STANDARD (non-Montgomery) form
    vk_alpha_1: tuple
    vk_beta_1: tuple
    vk_beta_2: tuple
    vk_gamma_2: tuple
    vk_delta_1: tuple
    vk_delta_2: tuple


def _read_g1(raw: bytes, pos: int):
    x = fq_from_mont(int.from_bytes(raw[pos : pos + 32], "little"))
    y = fq_from_mont(int.from_bytes(raw[pos + 32 : pos + 64], "little"))
    return (x, y), pos + 64


def _read_g2(raw: bytes, pos: int):
    x0 = fq_from_mont(int.from_bytes(raw[pos : pos + 32], "little"))
    x1 = fq_from_mont(int.from_bytes(raw[pos + 32 : pos + 64], "little"))
    y0 = fq_from_mont(int.from_bytes(raw[pos + 64 : pos + 96], "little"))
    y1 = fq_from_mont(int.from_bytes(raw[pos + 96 : pos + 128], "little"))
    return ((x0, x1), (y0, y1)), pos + 128


class ZKeyFile:
    def __init__(self, path: str):
        self.path = path
        self.bin = BinFile(path, "zkey", max_version=2)
        proto = struct.unpack("<I", self.bin.section(1)[:4].tobytes())[0]
        if proto != GROTH16_PROTOCOL_ID:
            raise ValueError(f"{path}: protocol {proto} not supported (Groth16 only)")
        self.header = self._read_header()

    def _read_header(self) -> ZKeyHeader:
        raw = self.bin.section(2).tobytes()
        pos = 0
        n8q = struct.unpack_from("<I", raw, pos)[0]
        pos += 4
        q = int.from_bytes(raw[pos : pos + n8q], "little")
        pos += n8q
        n8r = struct.unpack_from("<I", raw, pos)[0]
        pos += 4
        r = int.from_bytes(raw[pos : pos + n8r], "little")
        pos += n8r
        n_vars, n_public, domain_size = struct.unpack_from("<III", raw, pos)
        pos += 12
        power = domain_size.bit_length() - 1

        vk_alpha_1, pos = _read_g1(raw, pos)
        vk_beta_1, pos = _read_g1(raw, pos)
        vk_beta_2, pos = _read_g2(raw, pos)
        vk_gamma_2, pos = _read_g2(raw, pos)
        vk_delta_1, pos = _read_g1(raw, pos)
        vk_delta_2, pos = _read_g2(raw, pos)

        return ZKeyHeader(
            n8q=n8q, q=q, n8r=n8r, r=r,
            n_vars=n_vars, n_public=n_public,
            domain_size=domain_size, power=power,
            vk_alpha_1=vk_alpha_1, vk_beta_1=vk_beta_1, vk_beta_2=vk_beta_2,
            vk_gamma_2=vk_gamma_2, vk_delta_1=vk_delta_1, vk_delta_2=vk_delta_2,
        )

    def coefficients(self):
        """Decode section 4 into (m, c, s, coef_limbs) numpy arrays.

        coef limbs stay raw (Montgomery form) — exactly what the device
        field layer wants as its internal representation.
        """
        raw = self.bin.section(4)
        n8r = self.header.n8r
        s_coef = 12 + n8r
        n_coef = (raw.shape[0] - 4) // s_coef
        body = raw[4 : 4 + n_coef * s_coef]
        rec = body.reshape(n_coef, s_coef)
        head = np.ascontiguousarray(rec[:, :12]).view(np.uint32).reshape(n_coef, 3)
        m = head[:, 0].copy()
        c = head[:, 1].copy()
        s = head[:, 2].copy()
        coef = np.ascontiguousarray(rec[:, 12:]).view(np.uint32).reshape(n_coef, n8r // 4)
        return m, c, s, coef

    def points_u32(self, section_id: int, coord_words: int) -> np.ndarray:
        """Affine point section as (n, 2*coord_words) uint32 (Montgomery)."""
        raw = self.bin.section_u32(section_id)
        return raw.reshape(-1, 2 * coord_words)

    def export_verification_key(self) -> dict:
        """snarkjs-format verification key from the zkey (the role of
        `snarkjs zkey export verificationkey`): header vk points +
        section-3 IC points, decimal-string encoded."""
        raw = self.bin.section(3).tobytes()
        n_ic = len(raw) // 64
        ic = []
        for i in range(n_ic):
            (x, y), _ = _read_g1(raw, i * 64)
            ic.append([str(x), str(y), "1"] if (x, y) != (0, 0) else ["0", "1", "0"])
        h = self.header

        def g1j(p):
            return [str(p[0]), str(p[1]), "1"]

        def g2j(p):
            return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])], ["1", "0"]]

        return {
            "protocol": "groth16",
            "curve": "bn128",
            "nPublic": h.n_public,
            "vk_alpha_1": g1j(h.vk_alpha_1),
            "vk_beta_2": g2j(h.vk_beta_2),
            "vk_gamma_2": g2j(h.vk_gamma_2),
            "vk_delta_2": g2j(h.vk_delta_2),
            "IC": ic,
        }

    def points_a(self):
        return self.points_u32(5, 8)

    def points_b1(self):
        return self.points_u32(6, 8)

    def points_b2(self):
        return self.points_u32(7, 16)

    def points_c(self):
        return self.points_u32(8, 8)

    def points_h(self):
        return self.points_u32(9, 8)
