"""The plain reference that judges the program's proofs.

It works out the verification key again from the circuit and the
ceremony's seed, never from the program's zkey, and checks each answer the
program wrote:

  * the ceremony: tau, alpha, beta, gamma, delta from the seed, as the
    setup derives them (SHA-512 of seed + tag, little-endian, mod r; 0 -> 1);
  * the key: alpha G1, beta / gamma / delta G2 and, for each public signal s
    (0 the constant one), IC_s = (beta u_s(tau) + alpha v_s(tau) + w_s(tau))
    / gamma G1, with u, v, w the QAP columns over the domain's Lagrange
    basis and the public-input binding rows A[n_constraints + s][s] = 1;
  * an answer: proof.json's points are canonical and on their curves,
    public.json is the witness's public signals, and the four-pairing
    product e(-A, B) e(IC(pub), gamma) e(C, delta) e(alpha, beta) is one;
    `batch_check` holds many answers to it at once, by random weights.
"""

from __future__ import annotations

import hashlib

from . import curve as cv
from . import pairing as pr
from . import tower as tw
from .field import Q, R_MOD, W


def ceremony(seed: bytes) -> dict:
    """The toxic waste of a seeded ceremony."""
    def derive(tag: str) -> int:
        v = int.from_bytes(hashlib.sha512(seed + tag.encode()).digest(), "little") % R_MOD
        return v or 1

    return {k: derive(k) for k in ("tau", "alpha", "beta", "gamma", "delta")}


def domain_size(n_constraints: int, n_public: int) -> int:
    n = 1
    while n < n_constraints + n_public + 1:
        n *= 2
    return n


def _g1_json(p) -> list:
    x, y = cv.g1_to_affine(p)
    return [str(x), str(y), "1"] if (x, y) != (0, 0) else ["0", "1", "0"]


def _g2_json(p) -> list:
    x, y = cv.g2_to_affine(p)
    return [[str(x[0]), str(x[1])], [str(y[0]), str(y[1])], ["1", "0"]]


def verification_key(r1cs, seed: bytes) -> dict:
    """The snarkjs-form verification key of `r1cs` (an R1CS of the frozen
    builders) under the ceremony of `seed`."""
    waste = ceremony(seed)
    tau = waste["tau"]
    npub, nc = r1cs.n_public, r1cs.n_constraints
    n = domain_size(nc, npub)
    w_n = W[n.bit_length() - 1]
    # rows where a public signal (or the constant one) has a coefficient
    cols = {s: [0, 0, 0] for s in range(npub + 1)}
    terms = []
    for row, lcs in enumerate(r1cs.constraints):
        for k, lc in enumerate(lcs):
            for s, coef in lc.items():
                if s <= npub:
                    terms.append((row, k, s, coef))
    terms += [(nc + s, 0, s, 1) for s in range(npub + 1)]
    rows = sorted({t[0] for t in terms})
    z_tau = (pow(tau, n, R_MOD) - 1) % R_MOD
    n_inv = pow(n, -1, R_MOD)
    roots = {row: pow(w_n, row, R_MOD) for row in rows}
    # batch inverse of (tau - w^row)
    dens = [(tau - roots[row]) % R_MOD for row in rows]
    prefix = [1]
    for d in dens:
        prefix.append(prefix[-1] * d % R_MOD)
    inv = pow(prefix[-1], -1, R_MOD)
    lag = {}
    for i in range(len(rows) - 1, -1, -1):
        row = rows[i]
        lag[row] = z_tau * roots[row] % R_MOD * n_inv % R_MOD * (prefix[i] * inv % R_MOD) % R_MOD
        inv = inv * dens[i] % R_MOD
    for row, k, s, coef in terms:
        cols[s][k] = (cols[s][k] + coef * lag[row]) % R_MOD
    gamma_inv = pow(waste["gamma"], -1, R_MOD)
    ic = [(waste["beta"] * u + waste["alpha"] * v + w) * gamma_inv % R_MOD
          for u, v, w in (cols[s] for s in range(npub + 1))]
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": npub,
        "vk_alpha_1": _g1_json(cv.g1_mul(cv.G1_GEN, waste["alpha"])),
        "vk_beta_2": _g2_json(cv.g2_mul(cv.G2_GEN, waste["beta"])),
        "vk_gamma_2": _g2_json(cv.g2_mul(cv.G2_GEN, waste["gamma"])),
        "vk_delta_2": _g2_json(cv.g2_mul(cv.G2_GEN, waste["delta"])),
        "IC": [_g1_json(cv.g1_mul(cv.G1_GEN, k)) for k in ic],
    }


# ------------------------------------------------------------ answers

def _fq(s) -> int:
    v = int(s)
    if not 0 <= v < Q:
        raise ValueError(f"coordinate {s} is not canonical")
    return v


def parse_proof(proof: dict) -> tuple:
    """(A, B, C) as affine points from a snarkjs proof.json; raises
    ValueError unless the encoding is canonical and each point lies on its
    curve."""
    if proof.get("protocol") != "groth16" or proof.get("curve") != "bn128":
        raise ValueError("not a groth16 bn128 proof")
    pa, pb, pc = proof["pi_a"], proof["pi_b"], proof["pi_c"]
    if pa[2] != "1" or pc[2] != "1" or pb[2] != ["1", "0"]:
        raise ValueError("proof points are not affine")
    a = (_fq(pa[0]), _fq(pa[1]))
    c = (_fq(pc[0]), _fq(pc[1]))
    b = ((_fq(pb[0][0]), _fq(pb[0][1])), (_fq(pb[1][0]), _fq(pb[1][1])))
    if a == (0, 0) or c == (0, 0) or b == (tw.FQ2_ZERO, tw.FQ2_ZERO):
        raise ValueError("a proof point is the identity")
    if not (cv.g1_is_on_curve((*a, 1)) and cv.g1_is_on_curve((*c, 1))
            and cv.g2_is_on_curve((*b, tw.FQ2_ONE))):
        raise ValueError("a proof point is off its curve")
    return a, b, c


def _vk_g1(p) -> tuple:
    return (int(p[0]), int(p[1]))


def _vk_g2(p) -> tuple:
    return ((int(p[0][0]), int(p[0][1])), (int(p[1][0]), int(p[1][1])))


def public_point(public: list, vk: dict) -> tuple:
    """IC(pub) = IC_0 + sum_s pub_s IC_s, projective."""
    cpub = cv.g1_from_affine(_vk_g1(vk["IC"][0]))
    for k, ic in zip(public, vk["IC"][1:]):
        cpub = cv.g1_add(cpub, cv.g1_mul(cv.g1_from_affine(_vk_g1(ic)), k % R_MOD))
    return cpub


def pairing_check(points: tuple, public: list, vk: dict) -> bool:
    """The Groth16 equation for parsed proof points and integer publics."""
    a, b, c = points
    return pr.multi_pairing_is_one([
        (cv.g1_to_affine(cv.g1_neg((*a, 1))), b),
        (cv.g1_to_affine(public_point(public, vk)), _vk_g2(vk["vk_gamma_2"])),
        (c, _vk_g2(vk["vk_delta_2"])),
        (_vk_g1(vk["vk_alpha_1"]), _vk_g2(vk["vk_beta_2"])),
    ])


def batch_check(answers: list, vk: dict, rng) -> bool:
    """The Groth16 equation of many answers at once: [(points, publics)].
    With a random 64-bit weight r_i an answer (drawn from `rng`), the
    product of e(-r_i A_i, B_i) over the answers with
    e(sum r_i IC(pub_i), gamma) e(sum r_i C_i, delta) e((sum r_i) alpha, beta)
    is one: a Miller loop an answer, three more and one final
    exponentiation. An answer that fails its own equation makes the batch
    fail but with chance 2^-64."""
    f = tw.FQ12_ONE
    total, c_sum, by_public = 0, cv.G1_ZERO, {}
    for (a, b, c), public in answers:
        r = rng.getrandbits(64) | 1
        total += r
        minus_ra = cv.g1_to_affine(cv.g1_neg(cv.g1_mul((*a, 1), r)))
        f = tw.fq12_mul(f, pr.miller_loop(minus_ra, b))
        c_sum = cv.g1_add(c_sum, cv.g1_mul((*c, 1), r))
        key = tuple(public)
        by_public[key] = by_public.get(key, 0) + r
    l_sum = cv.G1_ZERO
    for public, weight in by_public.items():
        l_sum = cv.g1_add(l_sum, cv.g1_mul(public_point(list(public), vk), weight))
    alpha = cv.g1_mul(cv.g1_from_affine(_vk_g1(vk["vk_alpha_1"])), total)
    for p, q in ((l_sum, vk["vk_gamma_2"]), (c_sum, vk["vk_delta_2"]),
                 (alpha, vk["vk_beta_2"])):
        f = tw.fq12_mul(f, pr.miller_loop(cv.g1_to_affine(p), _vk_g2(q)))
    return pr.final_exponentiation(f) == tw.FQ12_ONE
