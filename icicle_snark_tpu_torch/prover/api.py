"""Library API: prove / verify / cache management.

The analog of the reference's lib.rs surface (src/lib.rs:219-268) and of
icicle_snark_tpu/prover/api.py: `groth16_prove` writes snarkjs-format
proof.json/public.json, `groth16_verify` runs the 4-pairing check on the
host, and a `CacheManager` keeps parsed proving keys resident on the
device across calls. The device is CUDA unless the caller asks for the
CPU (which runs the kernels' plain versions).
"""

from __future__ import annotations

import json
import time

from .. import trace
from ..refmath import groth16 as refproto
from . import pipeline
from .cache import CacheManager, ZKeyCache, load_zkey_cache  # noqa: F401

__all__ = ["CacheManager", "ZKeyCache", "groth16_prove", "groth16_verify", "load_zkey_cache"]


def groth16_prove(
    witness_path: str,
    zkey_path: str,
    proof_path: str,
    public_path: str,
    cache_manager: CacheManager | None = None,
    deterministic: bool = False,
    device="cuda",
    timer: pipeline.PhaseTimer | None = None,
) -> float:
    """Prove and write snarkjs-format outputs; returns the prove's seconds
    (the reference prints `proof took:`, src/lib.rs:227-244). A given
    cache_manager fixes the device. A given `timer` (pipeline.PhaseTimer)
    is active for the whole call, under its root span `prove`."""
    with trace.activate(timer):
        cache_manager = cache_manager or CacheManager(device)
        with trace.span("api.lookup", host=True):
            cache = cache_manager.get(zkey_path)

        start = time.perf_counter()
        proof, public = pipeline.prove(
            witness_path, cache, deterministic=deterministic, timer=timer)
        elapsed = time.perf_counter() - start

        with trace.span("api.write", host=True):
            with open(proof_path, "w") as fh:
                json.dump(proof, fh, indent=1)
            with open(public_path, "w") as fh:
                json.dump(public, fh, indent=1)
        return elapsed


def groth16_verify(proof_path: str, public_path: str, vk_path: str) -> bool:
    """Host-side verification (the reference's pairing is host-side too)."""
    return refproto.verify_files(proof_path, public_path, vk_path)
