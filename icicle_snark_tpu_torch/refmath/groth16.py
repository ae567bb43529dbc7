"""Pure-Python Groth16 prover/verifier oracle.

The prover replicates the reference pipeline's value flow *exactly*
(reference src/proof_helper.rs:31-317) over Python ints, so the
device pipeline can be differential-tested against it down to the byte
level of proof.json. It is O(n log n) host math — test scale only.

Key value-flow facts (see SURVEY.md section 3.1):
  * zkey coefficients are stored Montgomery; from_mont gives true c
  * the witness is stored standard; the reference still applies
    from_mont (proof_helper.rs:74), so the R1CS evaluation carries an
    extra R^-1 that the zkey's H points compensate (R^2 baked in)
  * MSM scalars are the raw limb integers: true witness values for
    A/B1/B2/C, and (A*B-C)(coset)*R^-2 for H
"""

from __future__ import annotations

import json

from . import curve as cv
from . import pairing as pr
from . import tower as tw
from .field import R_MOD, W, fr_from_mont
from ..io.wtns import WtnsFile
from ..io.zkey import ZKeyFile


def _limbs_to_int(limbs) -> int:
    v = 0
    for i, x in enumerate(limbs):
        v |= int(x) << (32 * i)
    return v


def _point_g1(limbs) -> tuple:
    from .field import fq_from_mont

    x = fq_from_mont(_limbs_to_int(limbs[:8]))
    y = fq_from_mont(_limbs_to_int(limbs[8:16]))
    if x == 0 and y == 0:
        return cv.G1_ZERO
    return (x, y, 1)


def _point_g2(limbs) -> tuple:
    from .field import fq_from_mont

    x = (fq_from_mont(_limbs_to_int(limbs[:8])), fq_from_mont(_limbs_to_int(limbs[8:16])))
    y = (fq_from_mont(_limbs_to_int(limbs[16:24])), fq_from_mont(_limbs_to_int(limbs[24:32])))
    if x == tw.FQ2_ZERO and y == tw.FQ2_ZERO:
        return cv.G2_ZERO
    return (x, y, tw.FQ2_ONE)


def ntt(values: list, root: int, invert: bool = False) -> list:
    """Iterative radix-2 NTT over Fr, natural order in and out."""
    n = len(values)
    a = list(values)
    if invert:
        root = pow(root, -1, R_MOD)
    # bit-reverse permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(root, n // length, R_MOD)
        for i in range(0, n, length):
            w = 1
            for k in range(i, i + length // 2):
                u, v = a[k], a[k + length // 2] * w % R_MOD
                a[k] = (u + v) % R_MOD
                a[k + length // 2] = (u - v) % R_MOD
                w = w * wlen % R_MOD
        length <<= 1
    if invert:
        n_inv = pow(n, -1, R_MOD)
        a = [x * n_inv % R_MOD for x in a]
    return a


def _msm_g1(scalars, points):
    acc = cv.G1_ZERO
    for k, p in zip(scalars, points):
        if k:
            acc = cv.g1_add(acc, cv.g1_mul(p, k))
    return acc


def _msm_g2(scalars, points):
    acc = cv.G2_ZERO
    for k, p in zip(scalars, points):
        if k:
            acc = cv.g2_add(acc, cv.g2_mul(p, k))
    return acc


def compute_h_scalars(zkey: ZKeyFile, witness_ints: list) -> list:
    """(A*B - C)(coset) * R^-2 — the integers fed to the H MSM."""
    hdr = zkey.header
    n = hdr.domain_size
    m_arr, c_arr, s_arr, coef_limbs = zkey.coefficients()

    a_vals = [0] * n
    b_vals = [0] * n
    for i in range(len(m_arr)):
        coef = fr_from_mont(_limbs_to_int(coef_limbs[i]))  # true coefficient
        wit = fr_from_mont(witness_ints[s_arr[i]])  # reference's extra from_mont
        res = coef * wit % R_MOD
        if m_arr[i] == 0:
            a_vals[c_arr[i]] = (a_vals[c_arr[i]] + res) % R_MOD
        else:
            b_vals[c_arr[i]] = (b_vals[c_arr[i]] + res) % R_MOD
    c_vals = [a_vals[i] * b_vals[i] % R_MOD for i in range(n)]

    root = W[hdr.power]
    inc = W[hdr.power + 1]
    keys = [1] * n
    for i in range(1, n):
        keys[i] = keys[i - 1] * inc % R_MOD

    def coset_eval(vals):
        coeffs = ntt(vals, root, invert=True)
        shifted = [coeffs[i] * keys[i] % R_MOD for i in range(n)]
        return ntt(shifted, root)

    a_odd = coset_eval(a_vals)
    b_odd = coset_eval(b_vals)
    c_odd = coset_eval(c_vals)
    return [(a_odd[i] * b_odd[i] - c_odd[i]) % R_MOD for i in range(n)]


def prove(zkey_path: str, wtns_path: str, deterministic: bool = True, rng=None):
    """Full oracle prove; returns (proof_dict, public_signals_list)."""
    zkey = ZKeyFile(zkey_path)
    hdr = zkey.header
    wtns = WtnsFile(wtns_path)
    if wtns.header.q != hdr.r:
        raise ValueError("witness curve does not match proving key")
    if wtns.header.n_witness != hdr.n_vars:
        raise ValueError(f"invalid witness length: circuit {hdr.n_vars}, witness {wtns.header.n_witness}")
    witness = wtns.witness_ints()

    h_scalars = compute_h_scalars(zkey, witness)

    points_a = [_point_g1(p) for p in zkey.points_a()]
    points_b1 = [_point_g1(p) for p in zkey.points_b1()]
    points_b2 = [_point_g2(p) for p in zkey.points_b2()]
    points_c = [_point_g1(p) for p in zkey.points_c()]
    points_h = [_point_g1(p) for p in zkey.points_h()]

    pi_a = _msm_g1(witness, points_a)
    pi_b1 = _msm_g1(witness, points_b1)
    pi_b = _msm_g2(witness, points_b2)
    pi_c = _msm_g1(witness[hdr.n_public + 1 :], points_c)
    pi_h = _msm_g1(h_scalars, points_h)

    alpha1 = cv.g1_from_affine(hdr.vk_alpha_1)
    beta1 = cv.g1_from_affine(hdr.vk_beta_1)
    delta1 = cv.g1_from_affine(hdr.vk_delta_1)
    beta2 = cv.g2_from_affine(hdr.vk_beta_2)
    delta2 = cv.g2_from_affine(hdr.vk_delta_2)

    if deterministic:
        r = s = 1  # the reference's `no-randomness` mode (proof_helper.rs:287-295)
    else:
        import secrets

        r = (rng or secrets).randbelow(R_MOD)
        s = (rng or secrets).randbelow(R_MOD)

    pi_a = cv.g1_add(pi_a, cv.g1_add(alpha1, cv.g1_mul(delta1, r)))
    pi_b = cv.g2_add(pi_b, cv.g2_add(beta2, cv.g2_mul(delta2, s)))
    pi_b1 = cv.g1_add(pi_b1, cv.g1_add(beta1, cv.g1_mul(delta1, s)))
    pi_c = cv.g1_add(pi_c, pi_h)
    pi_c = cv.g1_add(pi_c, cv.g1_mul(pi_a, s))
    pi_c = cv.g1_add(pi_c, cv.g1_mul(pi_b1, r))
    pi_c = cv.g1_add(pi_c, cv.g1_neg(cv.g1_mul(delta1, r * s % R_MOD)))

    public_signals = [str(witness[i]) for i in range(1, hdr.n_public + 1)]
    proof = serialize_proof(pi_a, pi_b, pi_c)
    return proof, public_signals


def serialize_proof(pi_a, pi_b, pi_c) -> dict:
    ax, ay = cv.g1_to_affine(pi_a)
    cx, cy = cv.g1_to_affine(pi_c)
    bx, by = cv.g2_to_affine(pi_b)
    return {
        "pi_a": [str(ax), str(ay), "1"],
        "pi_b": [[str(bx[0]), str(bx[1])], [str(by[0]), str(by[1])], ["1", "0"]],
        "pi_c": [str(cx), str(cy), "1"],
        "protocol": "groth16",
        "curve": "bn128",
    }


def _deser_g1(data):
    return (int(data[0]), int(data[1]), 1) if int(data[2] if len(data) > 2 else 1) else cv.G1_ZERO


def _deser_g2(data):
    return ((int(data[0][0]), int(data[0][1])), (int(data[1][0]), int(data[1][1])), tw.FQ2_ONE)


def verify(proof: dict, public: list, vk: dict) -> bool:
    """Groth16 verification: the 4-pairing product check
    (mirrors reference src/proof_helper.rs:319-372)."""
    pi_a = _deser_g1(proof["pi_a"])
    pi_b = _deser_g2(proof["pi_b"])
    pi_c = _deser_g1(proof["pi_c"])

    n_public = int(vk["nPublic"])
    ic = [_deser_g1(p) for p in vk["IC"]]
    cpub = ic[0]
    for i in range(min(n_public, len(public))):
        cpub = cv.g1_add(cpub, cv.g1_mul(ic[i + 1], int(public[i]) % R_MOD))

    neg_a = cv.g1_neg(pi_a)
    pairs = [
        (cv.g1_to_affine(neg_a), cv.g2_to_affine(pi_b)),
        (cv.g1_to_affine(cpub), _deser_g2_affine(vk["vk_gamma_2"])),
        (cv.g1_to_affine(pi_c), _deser_g2_affine(vk["vk_delta_2"])),
        (_deser_g1_affine(vk["vk_alpha_1"]), _deser_g2_affine(vk["vk_beta_2"])),
    ]
    return pr.multi_pairing_is_one(pairs)


def _deser_g1_affine(data):
    return (int(data[0]), int(data[1]))


def _deser_g2_affine(data):
    return ((int(data[0][0]), int(data[0][1])), (int(data[1][0]), int(data[1][1])))


def verify_files(proof_path: str, public_path: str, vk_path: str) -> bool:
    with open(proof_path) as fh:
        proof = json.load(fh)
    with open(public_path) as fh:
        public = json.load(fh)
    with open(vk_path) as fh:
        vk = json.load(fh)
    return verify(proof, public, vk)
