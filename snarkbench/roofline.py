"""The benchmark's own count of a prove's device work and its bound on the
H100 (NVIDIA H100 80GB HBM3, SXM, at its 700 W limit).

It counts what these inputs need, whatever implements it, and reads
nothing of the program's plan (its window size, precompute factor or fold
levels):

  * MSM: for each of the five MSMs (G1 A, B1, C, H; G2 B2), at the window
    size c* in 1..22 that minimises the count for its scalars, one mixed
    addition per nonzero c*-bit digit, a running-sum reduction of
    2 (2^c* - 1) additions in each window that holds a digit, and the
    window combine ((W - 1) c* doublings and W - 1 additions). The witness
    scalars are counted digit by digit; h's lanes as uniform in [0, r).
    Each operation costs a fixed number of Fq products (G1 mixed add 11,
    add 12, double 8; G2 39, 42, 27) of 264 32-bit multiplies each (the
    8-word Montgomery product, N (4N + 1)). Bytes: each base and each
    scalar read once, each result written once.
  * Bound: the larger of multiplies over 64 a clock on 132 SMs at
    1.98 GHz and bytes over 3.35 TB/s.
"""

from __future__ import annotations

import numpy as np

from .reference.field import R_MOD

SMS, CLOCK_HZ, MULS_PER_SM_CLOCK = 132, 1.98e9, 64
INT_MULS_PER_S = MULS_PER_SM_CLOCK * SMS * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
MULS_PER_PRODUCT = 8 * (4 * 8 + 1)
COSTS = {"g1": {"madd": 11, "add": 12, "dbl": 8}, "g2": {"madd": 39, "add": 42, "dbl": 27}}
POINT_BYTES = {"g1": 64, "g2": 128}
SCALAR_BYTES = 32
WINDOWS = range(1, 23)


def as_words(witness: list) -> np.ndarray:
    """Standard-form ints -> (n, 4) uint64 little-endian words."""
    raw = b"".join(int(v % R_MOD).to_bytes(32, "little") for v in witness)
    return np.frombuffer(raw, dtype="<u8").reshape(-1, 4)


def bit_lengths(words: np.ndarray) -> np.ndarray:
    """Bit length of each (n, 4) uint64 scalar."""
    out = np.zeros(len(words), dtype=np.int64)
    for q in range(4):
        col = words[:, q]
        nz = col != 0
        # float64 keeps the top bit of a 64-bit word: 2^k is exact
        out[nz] = 64 * q + np.floor(np.log2(col[nz].astype(np.float64))).astype(np.int64) + 1
    return out


class Scalars:
    """The scalars of an MSM, sorted by bit length, so a window's digits
    are read only from the lanes that reach it."""

    def __init__(self, words: np.ndarray):
        lengths = bit_lengths(words)
        order = np.argsort(lengths, kind="stable")
        self.words = words[order]
        self.lengths = lengths[order]

    def digit_counts(self, c: int) -> list:
        """Nonzero c-bit digits of each window, low window first, up to
        the largest scalar's top bit."""
        counts = []
        mask = np.uint64((1 << c) - 1)
        top = int(self.lengths[-1]) if len(self.lengths) else 0
        for lo in range(0, top, c):
            w = self.words[np.searchsorted(self.lengths, lo, side="right"):]
            q, sh = divmod(lo, 64)
            d = w[:, q] >> np.uint64(sh)
            if sh + c > 64 and q < 3:
                d = d | (w[:, q + 1] << np.uint64(64 - sh))
            counts.append(int(np.count_nonzero(d & mask)))
        while counts and not counts[-1]:  # a length read one bit long
            counts.pop()
        return counts


def digit_counts(words: np.ndarray, c: int) -> list:
    """Nonzero c-bit digits of each window over the (n, 4) uint64 scalars."""
    return Scalars(words).digit_counts(c)


def uniform_digit_counts(lanes: int, c: int) -> list:
    """Expected nonzero c-bit digits of each window over `lanes` scalars
    uniform in [0, r)."""
    out = []
    for lo in range(0, R_MOD.bit_length(), c):
        # P(digit == 0): count the x < r whose bits [lo, lo + c) are zero
        hi_vals = R_MOD >> (lo + c)
        zeros = hi_vals * (1 << lo) + min(R_MOD - (hi_vals << (lo + c)), 1 << lo)
        out.append(lanes * (1.0 - zeros / R_MOD))
    return out


def msm_products(counts: list, c: int, group: str) -> float:
    cost = COSTS[group]
    nonempty = sum(1 for k in counts if k)
    windows = len(counts)
    combine = max(windows - 1, 0)
    return (sum(counts) * cost["madd"] + nonempty * 2 * ((1 << c) - 1) * cost["add"]
            + combine * (c * cost["dbl"] + cost["add"]))


def best_msm(count_fn, group: str) -> dict:
    """The window c* in WINDOWS with the fewest products, given
    count_fn(c) -> per-window digit counts."""
    best = None
    for c in WINDOWS:
        products = msm_products(count_fn(c), c, group)
        if best is None or products < best["products"]:
            best = {"c": c, "products": products}
    return best


def prove_work(words: np.ndarray, n_public: int, domain: int) -> dict:
    """The MSM work of one prove of the witness `words` ((n_vars, 4)
    uint64, signal 0 first): per MSM {c, products, muls, bytes}, and the
    totals."""
    n_vars = len(words)
    full, head, cache = Scalars(words), Scalars(words[:n_public + 1]), {}

    def witness_counts(c, skip_head=False):
        if c not in cache:
            cache[c] = (full.digit_counts(c), head.digit_counts(c))
        counts, lead = cache[c]
        if not skip_head:
            return counts
        lead = lead + [0] * (len(counts) - len(lead))
        counts = [k - h for k, h in zip(counts, lead)]
        while counts and not counts[-1]:
            counts.pop()
        return counts

    msms = {
        "g1_a": (witness_counts, "g1", n_vars),
        "g1_b1": (witness_counts, "g1", n_vars),
        "g2_b2": (witness_counts, "g2", n_vars),
        "g1_c": (lambda c: witness_counts(c, True), "g1", n_vars - n_public - 1),
        "g1_h": (lambda c: uniform_digit_counts(domain, c), "g1", domain),
    }
    out = {}
    for name, (fn, group, lanes) in msms.items():
        best = best_msm(fn, group)
        best["muls"] = best["products"] * MULS_PER_PRODUCT
        best["bytes"] = lanes * (POINT_BYTES[group] + SCALAR_BYTES) + 3 * POINT_BYTES[group]
        out[name] = best
    out["msm_muls"] = sum(out[k]["muls"] for k in msms)
    out["msm_bytes"] = sum(out[k]["bytes"] for k in msms)
    return out


def bound_seconds(muls: float, nbytes: float) -> tuple:
    """(the least time the card could take, what bounds it)."""
    t_ops, t_bytes = muls / INT_MULS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
