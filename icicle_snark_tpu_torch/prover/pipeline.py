"""The Groth16 prove pipeline on the GPU (kernels K1-K7, K18).

Mirrors the reference's value flow (src/proof_helper.rs:31-317) and the
JAX package's pipeline (icicle_snark_tpu/prover/pipeline.py), so proofs are
byte-identical:

  stage                here                                      kernel
  -------------------  ----------------------------------------  ------
  witness ingest       the file's (n, 8) words read in chunks,   K18
                       a few at once, each copied up as it
                       lands; turned to (8, n) limbs on device
  R1CS evaluation      per row: sum_j coef*w mod r, REDC, and    K2
                       C = A*B, into the (3, 8, n) batch
  coset evaluation     bit-reversed INTT, key powers, NTT        K5 (K3, K1
  h values             (A*B - C) on the coset, times R^2         below 2^3)
  5 MSMs               grouped G1 (A, B1, C, H) + G2 (B2),       K4 (K6 sliced)
                       routed and combined by ops/msm.py
                       (`window_sums`, `host_points`)
  randomization        host projective ops (refmath), run while  -
                       the card works on the MSMs (below)
  serialization        decimal strings                           -

The host's MSM and randomisation work runs where it would otherwise wait
on the card (`commit_and_randomize`): r and s are drawn first; the products
that need no MSM result (`randomize_terms`) run while G1's kernels do; G1's
window sums are copied down as soon as its reduce is queued, and their
combine and the products that need them (`randomize_g1`) run while G2's
kernels do. After the last kernel only the G2 combine, B's last addition
(`randomize_g2`) and serialization are left.

Montgomery bookkeeping (R = 2^256, the snarkjs on-disk radix):
  coef_disk = c*R, witness = w (standard)
  mont_mul(coef_disk, w)     = c*w                     == res*R, res per reference
  a_vals = REDC(sum c*w)     = sum(res)                (standard: the oracle's)
  c_vals = mont_mul(a, b)    = a*b*R^-1                (carries R^-1)
  coset  = mont_mul(x, key*R/n) = x*key/n              (1/n and keys in one product)
  h_raw  = mont_mul(A_odd, B_odd) - C_odd              == h*R^-1
  h      = mont_mul(h_raw, R^2)                        (the H MSM scalar integers)

Large circuits take the same code. The JAX package switches to a matmul
NTT from 2^18, to an out-of-core MSM past 2^21 lanes and, at 2^22, to h
values staged one polynomial at a time with a forced fetch between the
stages, because its one-shot graph did not fit its chip's memory. Here the
NTT picks K5 from the domain size (ops/ntt.py), the MSM slices only past
ops/msm.py's lane cap (`window_sums`), and `construct_r1cs` has NO staged
variant: at the largest supported domain, 2^22, the (3, 8, 2^22) int32
batch is 3 * 8 * 4 * 2^22 = 403 MB, transformed in place, and the flow
holds beside it h (134 MB), the bit-reversed key table and the four
twiddle tables (604 MB): about 1.1 GB of an 80 GB card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels, trace
from ..fields import limbs as lb
from ..fields.limbs import FR_SPEC, MASK16, NLIMB
from ..io.wtns import WtnsFile
from ..ops import msm as msm_ops
from ..ops import ntt as ntt_ops
from ..refmath import curve as cv
from ..refmath.field import R_MOD
from ..refmath.groth16 import serialize_proof
from ..trace import PhaseTimer
from .cache import R1CSPlan, ZKeyCache


# ---------------------------------------------------------------- K2

# The most terms (or partial sums) one K2 thread adds: a slot with more is
# summed in pieces of at most R1CS_PIECE by fold launches first. Read at
# every call (tests patch it); the fold tables are built once per value.
R1CS_PIECE = 32


def r1cs_fold_plan(plan: R1CSPlan, piece: int):
    """(long_slots, levels) of K2 for slots of more than `piece` terms:
    long_slots (L,) int32, sorted; levels a list of (lo, hi) int32 ranges,
    one per piece. Level 0's ranges index the terms, each later level's the
    previous level's partial sums, which lie slot by slot; the last level
    leaves one partial per long slot. Built once per piece size, kept on
    the plan."""
    if piece in plan.folds:
        return plan.folds[piece]
    if piece < 2:
        raise ValueError(f"r1cs_fold_plan: pieces of {piece} term(s) never fold")
    offsets = plan.offsets.long()
    counts = offsets[1:] - offsets[:-1]
    long_slots = torch.nonzero(counts > piece).flatten()
    levels = []
    start, cur = offsets[long_slots], counts[long_slots]
    while cur.numel() and int(cur.max()) > 1:
        pieces = (cur + piece - 1) // piece
        owner = torch.repeat_interleave(torch.arange(cur.numel(), device=cur.device), pieces)
        first = torch.cumsum(pieces, 0) - pieces
        lo = start[owner] + (torch.arange(owner.numel(), device=cur.device) - first[owner]) * piece
        hi = torch.minimum(lo + piece, (start + cur)[owner])
        levels.append((lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()))
        start, cur = first, pieces
    plan.folds[piece] = (long_slots.to(torch.int32).contiguous(), levels)
    return plan.folds[piece]


def _redc_wide16(cols: torch.Tensor) -> torch.Tensor:
    """X * R^-1 mod r for lazy (16, n) int64 columns of X < R*r (16-bit
    limbs), canonical 16-bit limbs out."""
    p = FR_SPEC.p16(cols.device)
    n0 = FR_SPEC.n0inv16
    acc = torch.zeros((33, cols.shape[-1]), dtype=torch.int64, device=cols.device)
    acc[:16] = cols
    for i in range(16):
        m = ((acc[i] & MASK16) * n0) & MASK16
        acc[i:i + 16] += m.unsqueeze(0) * p
        acc[i + 1] += acc[i] >> 16
    return lb._cond_sub_p16(lb._normalize(acc[16:]), FR_SPEC)


def _range_cols(src: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Lazy (16, P) int64 columns of sum(src[:, lo[p]:hi[p]]) per range p."""
    lo, counts = lo.long(), (hi - lo).long()
    owner = torch.repeat_interleave(torch.arange(lo.numel(), device=src.device), counts)
    first = torch.cumsum(counts, 0) - counts
    idx = lo[owner] + torch.arange(owner.numel(), device=src.device) - first[owner]
    cols = torch.zeros((16, lo.numel()), dtype=torch.int64, device=src.device)
    cols.index_add_(1, owner, lb._to16(src[:, idx]))
    return cols


def r1cs_rows_plain(witness: torch.Tensor, plan: R1CSPlan) -> torch.Tensor:
    """Plain version of K2, with its fold plan: the (3, 8, n) batch of A,
    B (per slot, the sum of mont_mul(coef, w[idx]) mod r times R^-1) and
    C = mont_mul(A, B)."""
    long_slots, levels = r1cs_fold_plan(plan, R1CS_PIECE)
    prod = lb.field_op_plain(lb.OP_MUL, plan.coefs, witness[:, plan.witness_idx.long()], FR_SPEC)
    r2 = lb.const(FR_SPEC.r2, witness.device)
    src = prod
    for lo, hi in levels:  # partial sums mod r: REDC, then times R^2
        part = lb._from16(_redc_wide16(_range_cols(src, lo, hi)))
        src = lb.field_op_plain(lb.OP_MUL, part, r2, FR_SPEC)
    cols = _range_cols(prod, plan.offsets[:-1], plan.offsets[1:])
    if long_slots.numel():
        cols[:, long_slots.long()] = lb._to16(src)
    vals = lb._from16(_redc_wide16(cols))
    n = plan.num_slots // 2
    a, b = vals[:, :n], vals[:, n:]
    return torch.stack([a, b, lb.field_op_plain(lb.OP_MUL, a, b, FR_SPEC)])


def r1cs_rows(witness: torch.Tensor, plan: R1CSPlan) -> torch.Tensor:
    """The batch K5 transforms, (3, 8, n): A and B evaluations (slots
    [0, n) and [n, 2n) of the plan, standard form) and C = A B R^-1."""
    if witness.dtype != torch.int32 or witness.dim() != 2 or witness.shape[0] != NLIMB:
        raise ValueError(f"r1cs_rows: want int32 (8, n_vars), got {tuple(witness.shape)}")
    if witness.device.type == "cpu":
        return r1cs_rows_plain(witness, plan)
    if witness.device.type != "cuda":
        raise RuntimeError(f"r1cs_rows: unsupported device {witness.device}")
    witness = witness.contiguous()
    piece = R1CS_PIECE
    long_slots, levels = r1cs_fold_plan(plan, piece)
    nnz, n = plan.coefs.shape[-1], plan.num_slots // 2
    prev = None
    for lo, hi in levels:
        part = torch.empty((NLIMB, lo.numel()), dtype=torch.int32, device=witness.device)
        kernels.R1CS.launch(
            1, part.data_ptr(), plan.coefs.data_ptr(), plan.witness_idx.data_ptr(),
            plan.offsets.data_ptr(), witness.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            None if prev is None else prev.data_ptr(), None, nnz, n, witness.shape[-1],
            0 if prev is None else prev.shape[-1], lo.numel(), piece,
        )
        prev = part
    out = torch.empty((3, NLIMB, n), dtype=torch.int32, device=witness.device)
    kernels.R1CS.launch(
        0, out.data_ptr(), plan.coefs.data_ptr(), plan.witness_idx.data_ptr(),
        plan.offsets.data_ptr(), witness.data_ptr(), None, None,
        None if prev is None else prev.data_ptr(), long_slots.data_ptr(), nnz, n,
        witness.shape[-1], 0, long_slots.numel(), piece,
    )
    return out


# ---------------------------------------------------------------- stages

def construct_r1cs(witness: torch.Tensor, cache: ZKeyCache) -> torch.Tensor:
    """(8, n_vars) standard witness -> (8, n) standard h scalars
    (reference: construct_r1cs, proof_helper.rs:31-170): K2 writes the
    (A, B, C) batch, K5 transforms it in place and writes h."""
    return ntt_ops.coset_h(r1cs_rows(witness, cache.plan), cache.domain, cache.keys_br_scaled)


def commit_and_randomize(witness: torch.Tensor, h_scalars: torch.Tensor, cache: ZKeyCache,
                         r: int, s: int):
    """The 5 MSMs (reference: groth16_commitments, proof_helper.rs:172-241)
      pi_a = <w, A>, pi_b1 = <w, B1>, pi_b = <w, B2> (G2),
      pi_c = <w[npub+1:], C>, pi_h = <h, H>,
    randomised with r and s (`draw_rs`; reference: groth16_prove_helper,
    proof_helper.rs:274-295). Returns the proof's (pi_a, pi_b, pi_c) as
    host projective points (standard-form ints).

    The host's work runs while the card works: the MSM-independent
    products while G1's kernels run, G1's combine and the products that
    need it while G2's run (the module's docstring)."""
    hdr = cache.header
    npub = hdr.n_public
    scalars = torch.cat([witness, witness, witness[:, npub + 1:], h_scalars], dim=-1)
    c, c2 = cache.msm_c, cache.msm_c2
    with trace.span("msm.g1"):
        ws1 = msm_ops.HostCopy(msm_ops.window_sums(scalars, cache.g1_sizes, cache.g1_records, c,
                                                   cache.msm_pre))
    with trace.span("assemble.precompute", host=True):
        terms = randomize_terms(hdr, r, s)
    with trace.span("msm.g2"):
        ws2 = msm_ops.window_sums(witness, [witness.shape[-1]], cache.b2_records, c2,
                                  cache.msm_pre2)
    with trace.span("msm.to_host"):
        ws1 = ws1.wait()
    with trace.span("msm.combine", host=True):
        g1 = msm_ops.host_points(ws1, c, 4, g2=False)
    with trace.span("assemble.randomize", host=True):
        pi_a, pi_c = randomize_g1(terms, r, s, *g1)
    with trace.span("msm.to_host"):
        ws2 = ws2.cpu().numpy()
    with trace.span("msm.combine", host=True):
        (pi_b,) = msm_ops.host_points(ws2, c2, 1, g2=True)
    with trace.span("assemble.randomize", host=True):
        return pi_a, randomize_g2(terms, pi_b), pi_c


# Bytes of the witness section read (and, on the card, copied) at a time,
# and the reads in flight. Read at every call (tests patch them).
INGEST_CHUNK = 4 << 20
INGEST_READERS = 4


def upload_words(wtns: WtnsFile, device) -> torch.Tensor:
    """The witness section's (n_witness, 8) int32 words on `device`, read
    from the file in chunks of INGEST_CHUNK bytes, INGEST_READERS at a time,
    into one host buffer. For CUDA the buffer is page-locked (torch's
    caching host allocator, which holds a block back from reuse until the
    copies from it are done) and each chunk's copy is launched on the
    current stream once the chunk has landed, so the reads that follow
    overlap it; the CPU reads into the words themselves. Counts the chunks
    (`chunks`)."""
    cuda = torch.device(device).type == "cuda"
    host = torch.empty((wtns.header.n_witness, NLIMB), dtype=torch.int32, pin_memory=cuda)
    words = torch.empty_like(host, device=device) if cuda else host
    src, dst = host.view(-1).view(torch.uint8), words.view(-1).view(torch.uint8)
    for lo, hi in wtns.read_words(host.numpy(), INGEST_CHUNK, INGEST_READERS):
        if cuda:
            dst[lo:hi].copy_(src[lo:hi], non_blocking=True)
        trace.count("chunks")
    return words


def read_witness(wtns_path: str, hdr, device):
    """The witness file checked against the proving key's header: returns
    (WtnsFile, (8, n_vars) standard-form limbs on `device`), the words
    uploaded as the file holds them and turned by K18 (on the CPU by its
    plain version)."""
    with trace.span("ingest.open", host=True):
        wtns = WtnsFile(wtns_path)
        if wtns.header.q != hdr.r:
            raise ValueError("witness curve does not match proving key")
        if wtns.header.n_witness != hdr.n_vars:
            raise ValueError(
                f"invalid witness length: circuit {hdr.n_vars}, witness {wtns.header.n_witness}"
            )
    with trace.span("ingest.copy"):
        return wtns, lb.words_to_device_limbs(upload_words(wtns, device))


def assemble_proof(hdr, wtns: WtnsFile, proof_points, timer):
    """Assembly on the host: the randomised (pi_a, pi_b, pi_c) as host
    projective points -> (proof_dict, public_signals); `timer` (a
    PhaseTimer, or trace.NULL) takes the phases randomize_assemble (since
    the randomisation runs under the MSMs, nothing but the mark on the
    single-device prove) and serialize."""
    timer.mark("randomize_assemble")
    with trace.span("assemble.public", host=True):
        public_signals = [str(v) for v in wtns.witness_ints(1, hdr.n_public)]
    with trace.span("assemble.serialize", host=True):
        proof = serialize_proof(*proof_points)
    timer.mark("serialize")
    return proof, public_signals


def draw_rs(deterministic: bool, rng) -> tuple:
    """(r, s): 1 and 1 when deterministic (the reference's `no-randomness`
    feature, proof_helper.rs:287-295), else r then s drawn below the group
    order from `rng` (anything with `randbelow`) or `secrets`."""
    if deterministic:
        return 1, 1
    import secrets

    src = rng or secrets
    r = src.randbelow(R_MOD)
    return r, src.randbelow(R_MOD)


class RandomizeTerms(NamedTuple):
    """The randomisation's products that need no MSM result: alpha1 + r
    delta1, beta1 + s delta1, beta2 + s delta2 (G2) and -(rs) delta1."""

    a: tuple
    b1: tuple
    b2: tuple
    rs: tuple


def randomize_terms(hdr, r: int, s: int) -> RandomizeTerms:
    """The MSM-independent part of the randomisation, from the proving
    key's alpha, beta and delta; host projective points."""
    delta1 = cv.g1_from_affine(hdr.vk_delta_1)
    return RandomizeTerms(
        a=cv.g1_add(cv.g1_from_affine(hdr.vk_alpha_1), cv.g1_mul(delta1, r)),
        b1=cv.g1_add(cv.g1_from_affine(hdr.vk_beta_1), cv.g1_mul(delta1, s)),
        b2=cv.g2_add(cv.g2_from_affine(hdr.vk_beta_2),
                     cv.g2_mul(cv.g2_from_affine(hdr.vk_delta_2), s)),
        rs=cv.g1_neg(cv.g1_mul(delta1, r * s % R_MOD)),
    )


def randomize_g1(terms: RandomizeTerms, r: int, s: int, pi_a, pi_b1, pi_c, pi_h):
    """The randomisation's part that needs the G1 MSMs alone: (A, C) with
    A = pi_a + alpha1 + r delta1, B1 = pi_b1 + beta1 + s delta1 and
    C = pi_c + pi_h + s A + r B1 - rs delta1, in the reference's order."""
    pi_a = cv.g1_add(pi_a, terms.a)
    pi_b1 = cv.g1_add(pi_b1, terms.b1)
    pi_c = cv.g1_add(pi_c, pi_h)
    pi_c = cv.g1_add(pi_c, cv.g1_mul(pi_a, s))
    pi_c = cv.g1_add(pi_c, cv.g1_mul(pi_b1, r))
    return pi_a, cv.g1_add(pi_c, terms.rs)


def randomize_g2(terms: RandomizeTerms, pi_b):
    """The randomisation's last part, after the G2 MSM: B = pi_b + beta2 +
    s delta2."""
    return cv.g2_add(pi_b, terms.b2)


def prove(wtns_path: str, cache: ZKeyCache, deterministic: bool = False, rng=None,
          timer: PhaseTimer | None = None):
    """Full prove from a witness file against a warm cache; returns
    (proof_dict, public_signals). Randomization runs on the host while the
    card works on the MSMs, assembly after them (proof_helper.rs:274-295;
    `commit_and_randomize`). A given `timer` takes the phases and,
    active for the call, its spans and counters (trace.py); without one
    the prove records nothing and never waits for the device to mark."""
    device = cache.keys_br_scaled.device
    timer = timer or trace.NULL
    with trace.activate(timer):
        wtns, witness = read_witness(wtns_path, cache.header, device)  # (8, n_vars) standard
        timer.mark("witness_ingest")

        with trace.span("r1cs_ntt"):
            h_scalars = construct_r1cs(witness, cache)
        timer.mark("r1cs_ntt")
        r, s = draw_rs(deterministic, rng)
        proof_points = commit_and_randomize(witness, h_scalars, cache, r, s)
        timer.mark("msm")
        return assemble_proof(cache.header, wtns, proof_points, timer)
