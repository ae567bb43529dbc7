"""Batched radix-2 NTT over BN254 Fr (kernel K3).

The prove pipeline never needs natural->natural transforms: `intt_dif`
takes natural-order values to BIT-REVERSED coefficients (Gentleman-Sande,
scaled by 1/n), the coset key powers are gathered into bit-reversed order,
and `ntt_dit` takes bit-reversed input to natural-order values
(Cooley-Tukey), as in icicle_snark_tpu/ops/ntt.py. Each stage is one
launch of `csrc/ntt.cu` for CUDA tensors, or its plain version
`ntt_stage_plain` for CPU tensors.

Data layout: (B, 8, n) int32, Montgomery form (fields/limbs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..fields import limbs as lb
from ..fields.limbs import FR_SPEC, NLIMB, OP_ADD, OP_MUL, OP_SUB
from ..refmath.field import W


def bitrev_permutation(log_n: int) -> np.ndarray:
    """Index array: out[i] = bit-reverse of i."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def powers_mont(base_int: int, log_n: int, device, spec=FR_SPEC) -> torch.Tensor:
    """(8, 2^log_n) Montgomery-form powers base^0..base^(n-1), by doubling:
    powers [2^k, 2^(k+1)) are powers [0, 2^k) times base^(2^k), one K1
    product per step with the constant broadcast over the lanes."""
    p = spec.modulus
    table = lb.const(spec.r_mod, device)
    step = base_int % p
    for _ in range(log_n):
        factor = lb.const(step * spec.r_mod % p, device)
        table = torch.cat([table, lb.mont_mul(table, factor, spec)], dim=-1)
        step = step * step % p
    return table


class NTTDomain:
    """Twiddle tables of one transform size on one device (the analog of
    the reference's NTT domain)."""

    def __init__(self, log_n: int, device):
        if log_n >= len(W):
            raise ValueError(f"bn254_fr supports NTTs up to 2^{len(W) - 1}")
        self.log_n = log_n
        self.n = 1 << log_n
        self.w = W[log_n]
        self.tw_fwd = powers_mont(self.w, log_n, device)
        self.tw_inv = powers_mont(pow(self.w, -1, FR_SPEC.modulus), log_n, device)
        self.n_inv_mont = lb.const(
            pow(self.n, -1, FR_SPEC.modulus) * FR_SPEC.r_mod % FR_SPEC.modulus, device)
        self.bitrev = torch.from_numpy(bitrev_permutation(log_n)).to(device)


# ---------------------------------------------------------------- K3

def ntt_stage_plain(x: torch.Tensor, tw: torch.Tensor, m: int, inverse: bool,
                    scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K3: one butterfly stage of span m over
    (B, 8, n); returns the new tensor."""
    b, _, n = x.shape
    h = m // 2
    xr = x.reshape(b, NLIMB, n // m, 2, h).permute(0, 2, 3, 1, 4)  # (B, n/m, 2, 8, h)
    u, v = xr[:, :, 0], xr[:, :, 1]
    w = tw[:, : h * (n // m): n // m]  # (8, h)

    def op(code, a, c):
        return lb.field_op_plain(code, a, c, FR_SPEC)

    if inverse:
        lo = op(OP_ADD, u, v)
        hi = op(OP_MUL, op(OP_SUB, u, v), w)
        if scale is not None:
            lo, hi = op(OP_MUL, lo, scale), op(OP_MUL, hi, scale)
    else:
        vw = op(OP_MUL, v, w)
        lo, hi = op(OP_ADD, u, vw), op(OP_SUB, u, vw)
    out = torch.stack([lo, hi], dim=2)  # (B, n/m, 2, 8, h)
    return out.permute(0, 3, 1, 2, 4).reshape(b, NLIMB, n)


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, m: int, inverse: bool,
              scale: torch.Tensor | None = None) -> None:
    """One butterfly stage of span m, IN PLACE on x (B, 8, n) int32:
    DIF (u+v, (u-v)w) when inverse, else DIT (u+vw, u-vw); `scale` (8, 1)
    multiplies both outputs (the 1/n of the last inverse stage)."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != NLIMB or not x.is_contiguous():
        raise ValueError(f"ntt_stage: want contiguous int32 (B, 8, n), got {tuple(x.shape)}")
    b, _, n = x.shape
    if tw.shape != (NLIMB, n) or m < 2 or n % m:
        raise ValueError(f"ntt_stage: bad twiddles {tuple(tw.shape)} or span {m} for n={n}")
    if x.device.type == "cpu":
        x.copy_(ntt_stage_plain(x, tw, m, inverse, scale))
        return
    if x.device.type != "cuda":
        raise RuntimeError(f"ntt_stage: unsupported device {x.device}")
    tw = tw.contiguous()
    scale = None if scale is None else scale.contiguous()
    kernels.NTT.launch(
        x.data_ptr(), tw.data_ptr(), None if scale is None else scale.data_ptr(),
        b, n, m, int(inverse),
    )


def intt_dif(x: torch.Tensor, dom: NTTDomain) -> torch.Tensor:
    """Inverse NTT of (B, 8, n), natural input -> BIT-REVERSED output, times 1/n."""
    y = x.clone().contiguous()
    for s in range(dom.log_n, 0, -1):
        m = 1 << s
        ntt_stage(y, dom.tw_inv, m, True, dom.n_inv_mont if m == 2 else None)
    return y


def ntt_dit(x: torch.Tensor, dom: NTTDomain) -> torch.Tensor:
    """Forward NTT of (B, 8, n), BIT-REVERSED input -> natural output."""
    y = x.clone().contiguous()
    for s in range(1, dom.log_n + 1):
        ntt_stage(y, dom.tw_fwd, 1 << s, False)
    return y
