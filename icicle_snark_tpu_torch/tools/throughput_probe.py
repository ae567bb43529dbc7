"""Instruction-throughput probe of the GPU (kernel K8).

    python -m icicle_snark_tpu_torch.tools.throughput_probe [--depth 4096]

The counterpart of the JAX package's two Pallas probes
(tools/pallas_microbench.py, tools/vpu_ceiling_probe.py): dependent chains
`x = op(x, y)` held in fast memory, W independent chains per lane. Each
thread of `csrc/probe.cu` keeps W chains in registers for `depth` steps.
It prints one line per (op, W), in T op/s on the card, and the integer
multiply rate beside the 64 per SM per clock of NVIDIA's arithmetic
throughput table for compute capability 9.0, the rate the port's bounds
assume.

`probe_chain` launches the kernel for CUDA tensors and runs the plain
version `probe_chain_plain` for CPU tensors (int64 masked to 32 bits: torch
on the CPU has no uint32 arithmetic). Integer ops agree word for word; the
f32 chain agrees within 1e-5 relative at depth <= 64, because the kernel
fuses each multiply-add and torch rounds the product first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import kernels

OPS = ("u32_mul", "u32_add", "u32_mulmask", "u32_mad_wide", "f32_fma")
WIDTHS = (1, 2, 4, 8)
# multiply instructions per op (mad.lo.cc + madc.hi for the wide step)
MULS_PER_OP = {"u32_mul": 1, "u32_add": 0, "u32_mulmask": 1, "u32_mad_wide": 2, "f32_fma": 0}
M32 = 0xFFFFFFFF


def _mul_lo(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 on int64 tensors of 32-bit words, without overflow."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def probe_chain_plain(x: torch.Tensor, y: torch.Tensor, op: int, width: int,
                      depth: int) -> torch.Tensor:
    """Plain version of K8: (n,) words -> (width, n) final words."""
    if op == 4:
        yf = y.view(torch.float32)
        c = x.view(torch.float32).unsqueeze(0) + torch.arange(
            width, dtype=torch.float32, device=x.device).unsqueeze(1)
        for _ in range(depth):
            c = c * yf + yf
        return c.view(torch.int32)
    w = torch.arange(width, dtype=torch.int64, device=x.device).unsqueeze(1)
    yy = y.to(torch.int64) & M32
    lo = ((x.to(torch.int64) & M32).unsqueeze(0) + w) & M32
    hi = w.expand_as(lo) if op == 3 else None
    for _ in range(depth):
        if op == 0:
            lo = _mul_lo(lo, yy)
        elif op == 1:
            lo = (lo + yy) & M32
        elif op == 2:
            lo = _mul_lo(lo, yy) & 0xFFFF
        else:  # (hi, lo) = lo * y + hi, the product in 16-bit halves of y
            p0, p1 = lo * (yy & 0xFFFF), lo * (yy >> 16)
            low = p0 + ((p1 & 0xFFFF) << 16) + hi
            lo, hi = low & M32, (p1 >> 16) + (low >> 32)
    out = lo ^ hi if op == 3 else lo
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def probe_chain(x: torch.Tensor, y: torch.Tensor, op: int, width: int, depth: int) -> torch.Tensor:
    """`width` chains per lane, chain w from x + w, `depth` times x = op(x, y);
    x, y (n,) int32 words (float32 bit patterns for op 4). Returns (width, n)
    int32 final words. op indexes OPS."""
    if (x.dtype != torch.int32 or y.dtype != torch.int32 or x.dim() != 1 or x.shape != y.shape
            or x.device != y.device):
        raise ValueError(f"probe_chain: want two int32 (n,) tensors, got {tuple(x.shape)}")
    if not 0 <= op < len(OPS) or width not in WIDTHS or depth < 0:
        raise ValueError(f"probe_chain: bad op {op}, width {width} or depth {depth}")
    if x.device.type == "cpu":
        return probe_chain_plain(x, y, op, width, depth)
    if x.device.type != "cuda":
        raise RuntimeError(f"probe_chain: unsupported device {x.device}")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((width, x.shape[0]), dtype=torch.int32, device=x.device)
    kernels.PROBE.launch(op, width, out.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[0], depth)
    return out


def probe_inputs(n: int, op: int, seed: int, device) -> tuple:
    """Numpy-seeded (x, y) words: 16-bit integers as in the Pallas probes
    (y odd, so a product chain never collapses to 0), floats in [0.5, 1.5)
    for x and within 2^-10 of 1 for y (a long fma chain stays finite)."""
    rng = np.random.default_rng(seed)
    if op == 4:
        x = (rng.random(n, dtype=np.float32) + np.float32(0.5)).view(np.int32)
        y = (np.float32(1) + (rng.random(n, dtype=np.float32) - np.float32(0.5))
             * np.float32(2.0 ** -10)).astype(np.float32).view(np.int32)
    else:
        x = rng.integers(0, 1 << 16, size=n, dtype=np.int64).astype(np.int32)
        y = (rng.integers(0, 1 << 15, size=n, dtype=np.int64) * 2 + 1).astype(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def measure(depth: int = 4096, lanes: int | None = None, reps: int = 3, seed: int = 0) -> list:
    """Time every (op, W) on the card with CUDA events; returns one dict per
    (op, W) with T op/s. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("throughput_probe: no CUDA device")
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    # 2048 resident threads per SM, 8 waves
    lanes = lanes or props.multi_processor_count * 2048 * 8
    rows = []
    for op, name in enumerate(OPS):
        x, y = probe_inputs(lanes, op, seed, dev)
        for width in WIDTHS:
            probe_chain(x, y, op, width, depth)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                probe_chain(x, y, op, width, depth)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / reps
            rows.append({"op": name, "width": width, "depth": depth, "lanes": lanes, "ms": ms,
                         "t_ops_per_s": lanes * width * depth / (ms * 1e-3) / 1e12})
    return rows


def sm_clocks_mhz() -> dict:
    """The card's current and maximum SM clocks as nvidia-smi reads them
    (empty when it cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        now, top = (float(v) for v in out.split(","))
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return {}
    return {"sm_clock_mhz_after_run": now, "sm_clock_mhz_max": top}


def multiply_rate(rows: list) -> dict:
    """The best measured 32-bit multiply-instruction rate, and what it is
    per SM per clock at the card's maximum SM clock, beside the 64 that the
    port's bounds assume (None when nvidia-smi gives no clock: none is
    assumed in its place)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    best = max(rows, key=lambda r: r["t_ops_per_s"] * MULS_PER_OP[r["op"]])
    rate = best["t_ops_per_s"] * MULS_PER_OP[best["op"]] * 1e12
    out = {"op": best["op"], "width": best["width"], "multiplies_per_s": rate, "sms": sms,
           "assumed_per_sm_per_clock": 64, **sm_clocks_mhz()}
    clock_mhz = out.get("sm_clock_mhz_max")
    out["per_sm_per_clock_at_max_clock"] = (
        None if clock_mhz is None else rate / sms / (clock_mhz * 1e6))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=4096)
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("throughput_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    rows = measure(args.depth, args.lanes, seed=args.seed)
    for r in rows:
        print(f"{r['op']:13s} W={r['width']}  depth {r['depth']}  {r['ms']:9.3f} ms  "
              f"{r['t_ops_per_s']:8.3f} T op/s", flush=True)
    print("multiply rate: " + json.dumps(multiply_rate(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
