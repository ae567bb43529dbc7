"""Field vector arithmetic on 32-bit limbs: BN254 Fr / Fq on 8 words (kernel
K1), and the fields of the other curves on 8, 12 or 24 words (kernel K12).

Layout: a field vector is a (words, n) int32 tensor, limb-major, least
significant limb first, read as uint32 by the kernels. Leading dimensions
are batches: an Fq2 vector is (2, words, n), a batch of B polynomials
(B, words, n); the limb axis is always dim -2. Values are canonical (< p)
and in Montgomery form with R = 2^(32 words). For BN254 that is 2^256, the
snarkjs on-disk radix, so zkey coefficients and points upload with only a
transpose of their (n, 8) words. The JAX package's layout is (nlimb, n)
16-bit limbs with R = 2^(16 nlimb); `FieldSpec` takes words = nlimb / 2,
so R and every Montgomery value are the same integers (the tests convert
through `from_jax_limbs`/`to_jax_limbs`).

`mont_mul`, `add_mod`, `sub_mod`, `rsub_mod` and `neg_mod` launch
`csrc/field_vec.cu` (K1) for a BN254 spec and `csrc/field_vec_n.cu` (K12)
for the other curves' fields, for CUDA tensors, and run the plain version
`field_op_plain` for CPU tensors only; `mont_pow_const` (with `mont_inv`
and `batch_inv`) launches `csrc/field_pow.cu` (K9) for a BN254 spec and
`csrc/field_pow_n.cu` (K16) for the others, its plain version
`field_pow_plain`. The plain version works on
16-bit limbs held in int64 (torch on the CPU has no uint32 add or shift),
and gives the kernels' canonical results exactly.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..errors import InvalidArgument
from ..refmath.field import Q as _Q, R_MOD as _R

NLIMB = 8  # BN254's words
MASK16 = 0xFFFF

OP_MUL, OP_ADD, OP_SUB, OP_NEG, OP_RSUB = 0, 1, 2, 3, 4  # OP_RSUB: b - a


@dataclass(frozen=True)
class FieldSpec:
    """Field parameters for both limb widths (32-bit for the kernels,
    16-bit for the plain version). words = ceil((bits + 1) / 32), so that
    2p < R = 2^(32 words): half the JAX package's 16-bit limb count, and the
    same R (8 words for BN254 and the bls12 Fr, 12 for the bls12 Fq and the
    bw6-761 Fr, 24 for the bw6-761 Fq)."""

    modulus: int
    name: str
    # the kernels' field selector: for BN254 (K1, K9, K10) 0 = Fr, 1 = Fq,
    # found from the modulus when not given; for the other fields (K12, K14,
    # K16, K17) as curves/device.py `curve_specs` assigns it (-1: no kernel
    # has this field)
    field_id: int = -1
    # a scalar field's roots of unity, tower[i] of order 2^i, for
    # ops/ntt.py NTTDomain (empty: BN254's refmath tower for its Fr, else
    # none)
    root_tower: tuple = field(default=(), compare=False, repr=False)
    bn254: bool = field(init=False)    # K1's fields, not K12's
    words: int = field(init=False)     # 32-bit limbs
    n0inv: int = field(init=False)     # -p^-1 mod 2^32
    n0inv16: int = field(init=False)   # -p^-1 mod 2^16
    r_mod: int = field(init=False)     # R mod p (Montgomery 1)
    r2: int = field(init=False)        # R^2 mod p
    rinv: int = field(init=False)      # R^-1 mod p

    def __post_init__(self):
        p = self.modulus
        words = -(-(p.bit_length() + 1) // 32)
        bn254 = p in (_R, _Q)
        fid = self.field_id
        if fid < 0 and bn254:
            fid = 0 if p == _R else 1
        for name, value in (
                ("field_id", fid), ("bn254", bn254), ("words", words),
                ("n0inv", (-pow(p, -1, 1 << 32)) % (1 << 32)),
                ("n0inv16", (-pow(p, -1, 1 << 16)) % (1 << 16)),
                ("r_mod", (1 << (32 * words)) % p), ("r2", (1 << (64 * words)) % p),
                ("rinv", pow(1 << (32 * words), -1, p))):
            object.__setattr__(self, name, value)

    def p16(self, device) -> torch.Tensor:
        """(2 words, 1) int64 16-bit limbs of p."""
        n16 = 2 * self.words
        return torch.tensor(
            [(self.modulus >> (16 * i)) & MASK16 for i in range(n16)],
            dtype=torch.int64, device=device,
        ).reshape(n16, 1)


FR_SPEC = FieldSpec(modulus=_R, name="bn254_fr", field_id=0)
FQ_SPEC = FieldSpec(modulus=_Q, name="bn254_fq", field_id=1)


# ------------------------------------------------------------ conversions

def ints_to_words(vals, words: int = NLIMB) -> np.ndarray:
    """Iterable of ints (< 2^(32 words)) -> (n, words) uint32 words (for 8
    words, the snarkjs layout)."""
    vals = list(vals)
    raw = b"".join(int(v).to_bytes(4 * words, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(len(vals), words)


def words_to_host_limbs(words: np.ndarray) -> torch.Tensor:
    """(n, words) uint32 words -> (words, n) int32 limb tensor on the host
    (a transposed copy; reading a memory-mapped `words` happens here)."""
    w = np.array(np.asarray(words, dtype=np.uint32).T, order="C").view(np.int32)
    return torch.from_numpy(w)


def words_to_limbs(words: np.ndarray, device="cpu") -> torch.Tensor:
    """(n, words) uint32 words -> (words, n) int32 limb tensor on `device`."""
    return words_to_host_limbs(words).to(device)


def ints_to_limbs(vals, device="cpu", words: int = NLIMB) -> torch.Tensor:
    """Iterable of ints -> (words, n) int32 limb tensor."""
    return words_to_limbs(ints_to_words(vals, words), device)


def limbs_to_words(t: torch.Tensor) -> np.ndarray:
    """(words, n) limb tensor -> (n, words) uint32 words (host)."""
    return np.ascontiguousarray(t.detach().cpu().numpy().view(np.uint32).T)


def limbs_to_ints(t: torch.Tensor) -> list:
    """(words, n) limb tensor -> list of Python ints."""
    size = 4 * t.shape[0]
    raw = limbs_to_words(t).astype("<u4").tobytes()
    return [int.from_bytes(raw[size * i: size * (i + 1)], "little")
            for i in range(len(raw) // size)]


def from_jax_limbs(arr, fq2: bool = False) -> np.ndarray:
    """JAX (2 words, ...) 16-bit limb array -> (words, ...) int32 (limb axis
    0). fq2: a JAX Fq2 array (2 words, 2, ...) (the component axis after the
    limbs, icicle_snark_tpu/curves/device.py) -> the port's (2, words, ...)."""
    a = np.asarray(arr, dtype=np.uint32)
    out = np.ascontiguousarray(a[0::2] | (a[1::2] << np.uint32(16))).view(np.int32)
    return np.ascontiguousarray(np.moveaxis(out, 1, 0)) if fq2 else out


def to_jax_limbs(t, fq2: bool = False) -> np.ndarray:
    """(words, ...) int32 limbs (limb axis 0) -> JAX's (2 words, ...) uint32
    layout. fq2: the port's (2, words, ...) -> JAX's (2 words, 2, ...)."""
    a = np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)
    a = a.view(np.uint32)
    if fq2:
        a = np.moveaxis(a, 0, 1)
    out = np.empty((2 * a.shape[0],) + a.shape[1:], np.uint32)
    out[0::2] = a & np.uint32(0xFFFF)
    out[1::2] = a >> np.uint32(16)
    return out


def const(value: int, device, lanes: int = 1, words: int = NLIMB) -> torch.Tensor:
    """(words, lanes) int32 tensor holding `value` (as given: no Montgomery
    conversion) in every lane."""
    return ints_to_limbs([value], device, words).expand(words, lanes).contiguous()


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(..., words, n) -> (..., n) bool."""
    return (a == 0).all(dim=-2)


# ------------------------------------------------- plain version (16-bit)

def _to16(x: torch.Tensor) -> torch.Tensor:
    """(..., words, n) int32 -> (..., 2 words, n) int64 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK16, v >> 16], dim=-2).reshape(
        x.shape[:-2] + (2 * x.shape[-2], x.shape[-1]))


def _from16(l: torch.Tensor) -> torch.Tensor:
    """(..., 2 words, n) int64 16-bit limbs -> (..., words, n) int32 (two's
    complement of the uint32 words)."""
    w = l[..., 0::2, :] | (l[..., 1::2, :] << 16)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def _normalize(cols: torch.Tensor) -> torch.Tensor:
    """Propagate carries (or borrows) along the limb axis; the top limb
    keeps the final carry (negative for a final borrow)."""
    cols = cols.clone()
    # all columns at once, until no carry is left (a few rounds for lazy
    # columns; at most one per limb for a ripple through 0xffff limbs)
    while True:
        carry = cols[..., :-1, :] >> 16
        if not bool(carry.any()):
            return cols
        cols[..., :-1, :] &= MASK16
        cols[..., 1:, :] += carry


def _cond_sub_p16(l: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """l (..., >=L, n) normalized limbs of a value < 2p -> canonical L limbs
    (L = 2 words)."""
    n16 = 2 * spec.words
    top = l[..., n16:, :].sum(dim=-2) if l.shape[-2] > n16 else None
    d = _normalize(torch.cat([l[..., :n16, :] - spec.p16(l.device),
                              torch.zeros_like(l[..., :1, :])], dim=-2))
    ge = d[..., n16, :] >= 0
    if top is not None:
        ge = ge | (top > 0)
    return torch.where(ge.unsqueeze(-2), d[..., :n16, :], l[..., :n16, :])


def _mont_mul16(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """CIOS Montgomery product a*b*R^-1 mod p on L = 2 words 16-bit limbs,
    with lazy int64 columns (each stays below 2^40 at L = 48). The rounds
    index the limb axis moved to the front (plain integer indexing)."""
    n16 = 2 * spec.words
    p = spec.p16(a.device).reshape((n16,) + (1,) * (a.dim() - 1))
    n0 = spec.n0inv16
    a_t, b_t = a.movedim(-2, 0), b.movedim(-2, 0)
    acc = torch.zeros((2 * n16 + 1,) + a_t.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(n16):
        win = acc[i:i + n16]
        win.addcmul_(a_t[i], b_t)
        # the low 16 bits of acc_i n0 (< 2^56) depend on acc_i's low 16 only
        win.addcmul_((acc[i] * n0) & MASK16, p)
        acc[i + 1] += acc[i] >> 16
    return _cond_sub_p16(_normalize(acc[n16:].movedim(0, -2)), spec)


def _add16(a, b, spec):
    s = torch.cat([a + b, torch.zeros_like(a[..., :1, :])], dim=-2)
    return _cond_sub_p16(_normalize(s), spec)


def _sub16(a, b, spec):
    n16 = 2 * spec.words
    d = _normalize(torch.cat([a - b, torch.zeros_like(a[..., :1, :])], dim=-2))
    under = (d[..., n16, :] < 0).to(torch.int64).unsqueeze(-2)
    fixed = d[..., :n16, :] + under * spec.p16(a.device)
    # (a - b + R) + p: drop the R carried out of the top limb
    return _normalize(torch.cat([fixed, torch.zeros_like(fixed[..., :1, :])],
                                dim=-2))[..., :n16, :]


def _neg16(a, spec):
    z = (a == 0).all(dim=-2, keepdim=True)
    return torch.where(z, a, _sub16(torch.zeros_like(a), a, spec))


def _broadcast_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Expand b (nbb, words, m) to a's (nb, words, n) by the kernel's rule:
    block bb % nbb, lane i % m."""
    w = a.shape[-2]
    nb = a.numel() // (w * a.shape[-1])
    nbb = b.numel() // (w * b.shape[-1])
    b3 = b.reshape(nbb, w, b.shape[-1])
    b3 = b3.repeat(nb // nbb, 1, a.shape[-1] // b.shape[-1])
    return b3.reshape(a.shape)


def field_op_plain(op: int, a: torch.Tensor, b: torch.Tensor | None,
                   spec: FieldSpec) -> torch.Tensor:
    """The plain PyTorch version of K1 and K12, on any device."""
    a16 = _to16(a)
    if op == OP_NEG:
        return _from16(_neg16(a16, spec))
    b16 = _to16(_broadcast_b(a, b))
    if op == OP_MUL:
        r = _mont_mul16(a16, b16, spec)
    elif op == OP_ADD:
        r = _add16(a16, b16, spec)
    elif op == OP_SUB:
        r = _sub16(a16, b16, spec)
    elif op == OP_RSUB:
        r = _sub16(b16, a16, spec)
    else:
        raise ValueError(f"unknown field op {op}")
    return _from16(r)


# ------------------------------------------------------------ K1 / K12 wrapper

def _check(t: torch.Tensor, what: str, words: int = NLIMB):
    if t.dtype != torch.int32 or t.dim() < 2 or t.shape[-2] != words:
        raise ValueError(
            f"{what}: want int32 (..., {words}, n), got {t.dtype} {tuple(t.shape)}")


def field_op(op: int, a: torch.Tensor, b: torch.Tensor | None,
             spec: FieldSpec) -> torch.Tensor:
    """Elementwise field op; b broadcasts as (nbb, words, m) blocks/lanes.
    One K1 launch for a BN254 spec, one K12 launch for the other fields."""
    w = spec.words
    _check(a, "a", w)
    if b is not None:
        _check(b, "b", w)
        nb, n = a.numel() // (w * a.shape[-1]), a.shape[-1]
        nbb, m = b.numel() // (w * b.shape[-1]), b.shape[-1]
        if nbb == 0 or m == 0 or nb % nbb or n % m or b.device != a.device:
            raise ValueError(
                f"b {tuple(b.shape)} does not broadcast onto a {tuple(a.shape)}")
    if a.device.type == "cpu":
        return field_op_plain(op, a, b, spec)
    if a.device.type != "cuda":
        raise RuntimeError(f"field_op: unsupported device {a.device}")
    if spec.field_id < 0:
        raise InvalidArgument(f"field_op: no kernel for the field {spec.name}")
    a = a.contiguous()
    b = a if b is None else b.contiguous()
    out = torch.empty_like(a)
    kernel = kernels.FIELD_VEC if spec.bn254 else kernels.FIELD_VEC_N
    kernel.launch(
        op, spec.field_id, out.data_ptr(), a.data_ptr(), b.data_ptr(),
        a.numel() // (w * a.shape[-1]), a.shape[-1],
        b.numel() // (w * b.shape[-1]), b.shape[-1],
    )
    return out


def mont_mul(a, b, spec: FieldSpec):
    """a * b * R^-1 mod p (Montgomery product)."""
    return field_op(OP_MUL, a, b, spec)


def add_mod(a, b, spec: FieldSpec):
    return field_op(OP_ADD, a, b, spec)


def sub_mod(a, b, spec: FieldSpec):
    return field_op(OP_SUB, a, b, spec)


def rsub_mod(a, b, spec: FieldSpec):
    """b - a mod p (b broadcast as in field_op: a constant minus a vector)."""
    return field_op(OP_RSUB, a, b, spec)


def neg_mod(a, spec: FieldSpec):
    """-a mod p; 0 stays 0."""
    return field_op(OP_NEG, a, None, spec)


def to_mont(a, spec: FieldSpec):
    """Standard form -> Montgomery form: a * R mod p."""
    return mont_mul(a, const(spec.r2, a.device, words=spec.words), spec)


def mont_reduce(a, spec: FieldSpec):
    """REDC by one factor: a * R^-1 mod p (mont_mul by the standard 1; the
    from_mont of the op surface)."""
    return mont_mul(a, const(1, a.device, words=spec.words), spec)


def one_mont(spec: FieldSpec, device, lanes: int = 1) -> torch.Tensor:
    """(words, lanes) Montgomery one (R mod p)."""
    return const(spec.r_mod, device, lanes, spec.words)


# ------------------------------------------------------------ K9 / K16 wrapper

# the widest exponent each kernel's argument struct holds, in bits
POW_EXPONENT_BITS = {True: 32 * NLIMB, False: 32 * 24}


def field_pow_plain(a: torch.Tensor, exponent: int, spec: FieldSpec) -> torch.Tensor:
    """The plain PyTorch version of K9 and K16: square-and-multiply from the
    top bit of the exponent, one plain Montgomery product a step (as
    icicle_snark_tpu/fields/limbs.py mont_pow_const)."""
    a16 = _to16(a)
    acc = _to16(one_mont(spec, a.device, a.shape[-1]).expand(a.shape))
    for bit in bin(exponent)[2:] if exponent else ():
        acc = _mont_mul16(acc, acc, spec)
        if bit == "1":
            acc = _mont_mul16(acc, a16, spec)
    return _from16(acc)


def kernel_exponent(exponent: int, spec: FieldSpec) -> int:
    """An exponent with the same power of every element of the field that
    fits the kernel's argument: itself if it does, else (e - 1) mod (p - 1)
    + 1, which lies in [1, p - 1] and agrees with e modulo p - 1 (Fermat)
    and is positive as e is (so 0 still maps to 0)."""
    if exponent.bit_length() <= POW_EXPONENT_BITS[spec.bn254]:
        return exponent
    return (exponent - 1) % (spec.modulus - 1) + 1


def mont_pow_const(a: torch.Tensor, exponent: int, spec: FieldSpec) -> torch.Tensor:
    """a^exponent per element (Montgomery form in and out), any exponent >=
    0; exponent 0 gives the Montgomery one. One K9 launch (BN254) or K16
    launch (the other curves' fields) for a CUDA tensor."""
    _check(a, "a", spec.words)
    if exponent < 0:
        raise ValueError("mont_pow_const: the exponent must be >= 0")
    if a.device.type == "cpu":
        return field_pow_plain(a, exponent, spec)
    if a.device.type != "cuda":
        raise RuntimeError(f"mont_pow_const: unsupported device {a.device}")
    if spec.field_id < 0:
        raise InvalidArgument(f"mont_pow_const: no kernel for the field {spec.name}")
    e = kernel_exponent(exponent, spec)
    a = a.contiguous()
    out = torch.empty_like(a)
    nw = POW_EXPONENT_BITS[spec.bn254] // 32
    words = (ctypes.c_uint32 * nw)(*(int(w) for w in ints_to_words([e], nw)[0]))
    kernel = kernels.FIELD_POW if spec.bn254 else kernels.FIELD_POW_N
    kernel.launch(
        spec.field_id, out.data_ptr(), a.data_ptr(), ctypes.addressof(words),
        e.bit_length(), a.numel() // (spec.words * a.shape[-1]), a.shape[-1],
    )
    return out


def mont_inv(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Modular inverse per element by Fermat, a^(p-2); 0 maps to 0."""
    return mont_pow_const(a, spec.modulus - 2, spec)


def batch_inv(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Inverse of every element along the last axis (the JAX package's
    Montgomery batch-inversion trick gives the same values, the inverse
    being unique). Elementwise K9 or K16: a zero maps to 0 and poisons
    nothing."""
    return mont_inv(a, spec)
