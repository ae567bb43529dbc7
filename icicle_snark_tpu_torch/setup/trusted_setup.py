"""Groth16 trusted-setup generator emitting snarkjs-format .zkey files.

The reference relies on circom+snarkjs to produce its zkey/wtns fixtures
(reference scripts/setup.sh); this module replaces that external
dependency with an in-repo generator so tests and benchmarks are fully
self-contained.

Semantics replicated from snarkjs `zkey new` as evidenced by what the
reference prover consumes (reference src/{cache.rs,proof_helper.rs}):

  * domain_size = next power of two >= n_constraints + n_public + 1
  * coefficient records cover the A (m=0) and B (m=1) matrices only,
    plus the public-input binding rows A[n_constraints + s][s] = 1 for
    s = 0..n_public (the C matrix is never needed by the prover: at
    satisfied domain rows C(x_j) = A(x_j)*B(x_j), so the prover derives
    it pointwise, proof_helper.rs:108-114)
  * all field elements / point coordinates stored in Montgomery form
  * H points are coset-Lagrange combinations: the prover feeds
    (A*B - C)(g*w^i) = -2*h(g*w^i) carrying a Montgomery factor R^-2
    (the zkey coefficients contribute one R^-1 via the stored Montgomery
    form, the witness a second via the from_mont at proof_helper.rs:74),
    so H_i = R^2 * (-1/(2*delta)) * Z(tau) * lagrange_coset_i(tau) * G1.
    Z on the coset is the constant g^n - 1 = -2.
"""

from __future__ import annotations

import hashlib
import json
import struct

from ..refmath import curve as cv
from ..refmath import tower as tw
from ..refmath.field import MONT_R_FQ, MONT_R_FR, Q, R_MOD, W, fq_from_mont, int_to_le
from ..io.binfile import BinWriter
from .r1cs import R1CS


# ------------------------------------------------------------------
# fixed-base scalar multiplication with an 8-bit window table

class FixedBase:
    def __init__(self, gen, dbl, add, zero, window: int = 8, bits: int = 256):
        self.window = window
        self.n_windows = (bits + window - 1) // window
        self.add = add
        self.zero = zero
        # table[w][d] = d * 2^(8w) * G
        self.table = []
        base = gen
        for _ in range(self.n_windows):
            row = [zero]
            acc = zero
            for _ in range((1 << window) - 1):
                acc = add(acc, base)
                row.append(acc)
            self.table.append(row)
            for _ in range(window):
                base = dbl(base)

    def mul(self, k: int):
        acc = self.zero
        for w in range(self.n_windows):
            d = (k >> (w * self.window)) & 0xFF
            if d:
                acc = self.add(acc, self.table[w][d])
        return acc


_FB_G1 = None
_FB_G2 = None


def _fixed_bases():
    global _FB_G1, _FB_G2
    if _FB_G1 is None:
        _FB_G1 = FixedBase(cv.G1_GEN, cv.g1_dbl, cv.g1_add, cv.G1_ZERO)
        _FB_G2 = FixedBase(cv.G2_GEN, cv.g2_dbl, cv.g2_add, cv.G2_ZERO)
    return _FB_G1, _FB_G2


# ------------------------------------------------------------------
# serialization helpers (Montgomery-form snarkjs encoding)

def _g1_bytes(p) -> bytes:
    x, y = cv.g1_to_affine(p)
    if (x, y) == (0, 0):
        return b"\x00" * 64
    return int_to_le(x * MONT_R_FQ % Q) + int_to_le(y * MONT_R_FQ % Q)


def _g2_bytes(p) -> bytes:
    (x, y) = cv.g2_to_affine(p)
    if (x, y) == (tw.FQ2_ZERO, tw.FQ2_ZERO):
        return b"\x00" * 128
    return (
        int_to_le(x[0] * MONT_R_FQ % Q)
        + int_to_le(x[1] * MONT_R_FQ % Q)
        + int_to_le(y[0] * MONT_R_FQ % Q)
        + int_to_le(y[1] * MONT_R_FQ % Q)
    )


def _g1_json(p):
    x, y = cv.g1_to_affine(p)
    return [str(x), str(y), "1"] if (x, y) != (0, 0) else ["0", "1", "0"]


def _g2_json(p):
    x, y = cv.g2_to_affine(p)
    return [[str(x[0]), str(x[1])], [str(y[0]), str(y[1])], ["1", "0"]]


def _batch_inverse(vals: list) -> list:
    """Montgomery batch inversion mod R_MOD."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R_MOD
    inv_all = pow(prefix[n], -1, R_MOD)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R_MOD
        inv_all = inv_all * vals[i] % R_MOD
    return out


# ------------------------------------------------------------------

class ToxicWaste:
    """Deterministic 'ceremony' secrets for test/benchmark setups."""

    def __init__(self, seed: bytes = b"icicle-snark-tpu-test-setup"):
        def derive(tag: str) -> int:
            h = hashlib.sha512(seed + tag.encode()).digest()
            v = int.from_bytes(h, "little") % R_MOD
            return v if v != 0 else 1

        self.tau = derive("tau")
        self.alpha = derive("alpha")
        self.beta = derive("beta")
        self.gamma = derive("gamma")
        self.delta = derive("delta")


class SetupScalars:
    """All scalar multiples of G1/G2 a Groth16 CRS needs; point
    generation (host FixedBase or device fixed-base MSM) is a separate
    backend choice."""

    def __init__(self, r1cs: R1CS, waste: ToxicWaste):
        tau, alpha, beta, gamma, delta = (
            waste.tau, waste.alpha, waste.beta, waste.gamma, waste.delta,
        )
        self.waste = waste
        n_public = r1cs.n_public
        n_vars = r1cs.n_vars
        n_constraints = r1cs.n_constraints
        domain_size = 1
        while domain_size < n_constraints + n_public + 1:
            domain_size *= 2
        power = domain_size.bit_length() - 1
        if power + 1 >= len(W) or W[power + 1] == 0:
            raise ValueError("domain too large for the BN254 two-adicity")
        self.n_public, self.n_vars, self.domain_size = n_public, n_vars, domain_size

        w_n = W[power]          # primitive n-th root of unity
        g_coset = W[power + 1]  # coset shift g, g^2 = w_n ... g^n = -1

        # ---- Lagrange basis at tau over the standard domain ----------
        # l_row(tau) = Z(tau) * w^row / (n * (tau - w^row))
        n = domain_size
        z_tau = (pow(tau, n, R_MOD) - 1) % R_MOD
        roots = [1] * n
        for i in range(1, n):
            roots[i] = roots[i - 1] * w_n % R_MOD
        denoms = [(tau - roots[i]) % R_MOD for i in range(n)]
        inv_denoms = _batch_inverse(denoms)
        n_inv = pow(n, -1, R_MOD)
        lag = [z_tau * roots[i] % R_MOD * n_inv % R_MOD * inv_denoms[i] % R_MOD for i in range(n)]

        # ---- QAP evaluations u_s(tau), v_s(tau), w_s(tau) ------------
        u = [0] * n_vars
        v = [0] * n_vars
        w_poly = [0] * n_vars
        for row, (a_lc, b_lc, c_lc) in enumerate(r1cs.constraints):
            lrow = lag[row]
            for s, coef in a_lc.items():
                u[s] = (u[s] + coef * lrow) % R_MOD
            for s, coef in b_lc.items():
                v[s] = (v[s] + coef * lrow) % R_MOD
            for s, coef in c_lc.items():
                w_poly[s] = (w_poly[s] + coef * lrow) % R_MOD
        # public-input binding rows (snarkjs soundness fix)
        for s in range(n_public + 1):
            u[s] = (u[s] + lag[n_constraints + s]) % R_MOD
        self.u, self.v = u, v

        gamma_inv = pow(gamma, -1, R_MOD)
        delta_inv = pow(delta, -1, R_MOD)

        def kappa(s):
            return (beta * u[s] + alpha * v[s] + w_poly[s]) % R_MOD

        self.ic = [kappa(s) * gamma_inv % R_MOD for s in range(n_public + 1)]
        self.c = [kappa(s) * delta_inv % R_MOD for s in range(n_public + 1, n_vars)]

        # ---- H scalars on the coset-Lagrange basis -------------------
        # scalar_i = R^2 * (-1/(2 delta)) * Z(tau) * lc_i(tau)
        # lc_i(tau) = -Zc(tau)*g*w^i / (n*(tau - g*w^i)), Zc(tau) = tau^n + 1
        zc_tau = (pow(tau, n, R_MOD) + 1) % R_MOD
        coset_roots = [g_coset * roots[i] % R_MOD for i in range(n)]
        coset_inv = _batch_inverse([(tau - cr) % R_MOD for cr in coset_roots])
        r2 = MONT_R_FR * MONT_R_FR % R_MOD
        pref = (
            r2
            * pow(2 * delta % R_MOD, -1, R_MOD) % R_MOD
            * z_tau % R_MOD
            * zc_tau % R_MOD
            * n_inv % R_MOD
        )
        self.h = [
            pref * coset_roots[i] % R_MOD * coset_inv[i] % R_MOD for i in range(n)
        ]


def write_zkey(scal: SetupScalars, r1cs: R1CS, zkey_path: str,
               vk_path: str | None, g1_points: dict, g2_points: dict):
    """Serialize a zkey (+ vk json) from precomputed point arrays.

    g1_points: {'a','b1','c','h','ic','alpha','beta','delta'} — host
    projective points OR raw 64-byte Montgomery affine encodings.
    g2_points: {'b2','beta','gamma','delta'}."""
    n_public, n_vars = scal.n_public, scal.n_vars
    n_constraints = r1cs.n_constraints
    domain_size = scal.domain_size

    def enc1(p):
        return p if isinstance(p, (bytes, bytearray)) else _g1_bytes(p)

    def enc2(p):
        return p if isinstance(p, (bytes, bytearray)) else _g2_bytes(p)

    # ---- write the zkey ----------------------------------------------
    zw = BinWriter("zkey", version=1)
    zw.begin_section(1)
    zw.write(struct.pack("<I", 1))  # Groth16
    zw.end_section()

    zw.begin_section(2)
    zw.write(struct.pack("<I", 32) + int_to_le(Q))
    zw.write(struct.pack("<I", 32) + int_to_le(R_MOD))
    zw.write(struct.pack("<III", n_vars, n_public, domain_size))
    zw.write(enc1(g1_points["alpha"]) + enc1(g1_points["beta"]) + enc2(g2_points["beta"]))
    zw.write(enc2(g2_points["gamma"]) + enc1(g1_points["delta"]) + enc2(g2_points["delta"]))
    zw.end_section()

    zw.begin_section(3)
    for p in g1_points["ic"]:
        zw.write(enc1(p))
    zw.end_section()

    # coefficient records (A and B matrices + binding rows)
    records = []
    for row, (a_lc, b_lc, _c_lc) in enumerate(r1cs.constraints):
        for s, coef in a_lc.items():
            records.append((0, row, s, coef % R_MOD))
        for s, coef in b_lc.items():
            records.append((1, row, s, coef % R_MOD))
    for s in range(n_public + 1):
        records.append((0, n_constraints + s, s, 1))

    zw.begin_section(4)
    zw.write(struct.pack("<I", len(records)))
    for m, c, s, coef in records:
        zw.write(struct.pack("<III", m, c, s))
        zw.write(int_to_le(coef * MONT_R_FR % R_MOD))
    zw.end_section()

    for sec_id, pts, enc in (
        (5, g1_points["a"], enc1),
        (6, g1_points["b1"], enc1),
        (7, g2_points["b2"], enc2),
        (8, g1_points["c"], enc1),
        (9, g1_points["h"], enc1),
    ):
        zw.begin_section(sec_id)
        if isinstance(pts, (bytes, bytearray)):
            zw.write(pts)  # pre-concatenated device download
        else:
            for p in pts:
                zw.write(enc(p))
        zw.end_section()

    zw.save(zkey_path)

    # ---- verification key json ---------------------------------------
    def json1(p):
        return _g1_json(p) if not isinstance(p, (bytes, bytearray)) else _g1_json_bytes(p)

    def json2(p):
        return _g2_json(p) if not isinstance(p, (bytes, bytearray)) else _g2_json_bytes(p)

    vk = {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": n_public,
        "vk_alpha_1": json1(g1_points["alpha"]),
        "vk_beta_2": json2(g2_points["beta"]),
        "vk_gamma_2": json2(g2_points["gamma"]),
        "vk_delta_2": json2(g2_points["delta"]),
        "IC": [json1(p) for p in g1_points["ic"]],
    }
    if vk_path:
        with open(vk_path, "w") as fh:
            json.dump(vk, fh, indent=1)
    return vk


def _g1_json_bytes(b: bytes):
    x = fq_from_mont(int.from_bytes(b[:32], "little"))
    y = fq_from_mont(int.from_bytes(b[32:64], "little"))
    return [str(x), str(y), "1"] if (x, y) != (0, 0) else ["0", "1", "0"]


def _g2_json_bytes(b: bytes):
    v = [fq_from_mont(int.from_bytes(b[32 * i : 32 * (i + 1)], "little")) for i in range(4)]
    return [[str(v[0]), str(v[1])], [str(v[2]), str(v[3])], ["1", "0"]]


def groth16_setup(r1cs: R1CS, zkey_path: str, vk_path: str | None = None,
                  seed: bytes = b"icicle-snark-tpu-test-setup"):
    """Host-oracle trusted setup (FixedBase Python points). For large
    circuits use setup.fast_setup.groth16_setup_device instead."""
    waste = ToxicWaste(seed)
    scal = SetupScalars(r1cs, waste)
    fb1, fb2 = _fixed_bases()

    g1_points = {
        "a": [fb1.mul(k) for k in scal.u],
        "b1": [fb1.mul(k) for k in scal.v],
        "c": [fb1.mul(k) for k in scal.c],
        "h": [fb1.mul(k) for k in scal.h],
        "ic": [fb1.mul(k) for k in scal.ic],
        "alpha": fb1.mul(waste.alpha),
        "beta": fb1.mul(waste.beta),
        "delta": fb1.mul(waste.delta),
    }
    g2_points = {
        "b2": [fb2.mul(k) for k in scal.v],
        "beta": fb2.mul(waste.beta),
        "gamma": fb2.mul(waste.gamma),
        "delta": fb2.mul(waste.delta),
    }
    return write_zkey(scal, r1cs, zkey_path, vk_path, g1_points, g2_points)
