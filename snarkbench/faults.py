"""Breaks planted under the program's timed path, to show that the
reference's checks catch them. The benchmark's own runs plant none.

  deterministic  the program's own deterministic path (r = s = 1): proofs
                 of one witness repeat, which breaks zero knowledge.
  truncated      h's top 16 bits dropped before the H MSM (scalars mod
                 2^240, the MSM's top c = 16 window skipped): the control,
                 exact arithmetic taken one step below what the
                 configuration states.
  once           the truncation of `truncated` in the second prove alone:
                 one wrong answer among many.
  unchanged      every prove returns the first prove's answer.
  half           the H MSM over half of h's lanes, the rest zeroed.
  public         one public signal altered where it is produced.
  point          one coordinate of pi_c altered where it is produced.
"""

from __future__ import annotations

import contextlib
import functools

MODES = ("deterministic", "truncated", "once", "unchanged", "half", "public", "point")


@contextlib.contextmanager
def planted(mode: str):
    """Patch the program for the span of the block."""
    from icicle_snark_tpu_torch.prover import api, pipeline

    saved = {}

    def patch(mod, name, fn):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)

    if mode == "deterministic":
        patch(api, "groth16_prove", functools.partial(api.groth16_prove, deterministic=True))
    elif mode in ("truncated", "once", "half"):
        orig, calls = pipeline.construct_r1cs, []

        def construct(witness, cache):
            h = orig(witness, cache).clone()
            calls.append(1)
            if mode == "half":
                h[:, h.shape[-1] // 2:] = 0
            elif mode == "truncated" or len(calls) == 2:
                h[7] &= 0xFFFF
            return h

        patch(pipeline, "construct_r1cs", construct)
    elif mode == "unchanged":
        orig, first = pipeline.prove, []

        def prove(*args, **kwargs):
            if not first:
                first.append(orig(*args, **kwargs))
            return first[0]

        patch(pipeline, "prove", prove)
    elif mode in ("public", "point"):
        orig = pipeline.assemble_proof

        def assemble(*args, **kwargs):
            proof, public = orig(*args, **kwargs)
            if mode == "public":
                public = [str(int(public[0]) + 1)] + public[1:]
            else:
                proof = dict(proof, pi_c=[str(int(proof["pi_c"][0]) + 1)] + proof["pi_c"][1:])
            return proof, public

        patch(pipeline, "assemble_proof", assemble)
    else:
        raise ValueError(f"unknown fault {mode!r}; one of {MODES}")
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
