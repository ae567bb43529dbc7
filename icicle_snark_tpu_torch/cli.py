"""Interactive CLI worker: stdin line protocol.

The same protocol as the reference's worker REPL (src/main.rs:39-186) and
icicle_snark_tpu/cli.py: a caller spawns one process, streams commands
over stdin, and waits for the `COMMAND_COMPLETED` sentinel after each, so
the device-resident ZKeyCache and the built kernels serve every proof.

Commands:
  prove  --witness W --zkey Z --proof P --public U [--device CUDA|CPU] [--deterministic 1]
  verify --proof P --public U --vk V
  export-vk --zkey Z --vk V
  exit

`--device` defaults to CUDA; without a card the command fails (it never
falls back to the CPU).
"""

from __future__ import annotations

import json
import shlex
import sys

SENTINEL = "COMMAND_COMPLETED"
DEVICES = ("cuda", "cpu")


def _parse_flags(tokens: list) -> dict:
    flags = {}
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected token: {tok}")
        if i + 1 >= len(tokens):
            raise ValueError(f"missing value for {tok}")
        flags[tok[2:]] = tokens[i + 1]
        i += 2
    return flags


def run_worker(stdin=None, stdout=None):
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    from .prover.api import CacheManager, groth16_prove, groth16_verify

    managers = {}  # device -> CacheManager

    def out(line: str):
        print(line, file=stdout, flush=True)

    for raw in stdin:
        line = raw.strip()
        if not line:
            continue
        tokens = shlex.split(line)
        cmd, rest = tokens[0], tokens[1:]
        try:
            if cmd == "exit":
                out(SENTINEL)
                return 0
            elif cmd == "prove":
                f = _parse_flags(rest)
                name = f.get("device", "CUDA").lower()
                if name not in DEVICES:
                    raise ValueError(f"unknown device {f['device']!r} (CUDA or CPU)")
                if name not in managers:
                    managers[name] = CacheManager(name)
                elapsed = groth16_prove(
                    f["witness"], f["zkey"], f["proof"], f["public"], managers[name],
                    deterministic=f.get("deterministic", "0") in ("1", "true"),
                )
                out(f"proof took: {elapsed:.3f}s")  # the reference prints the same
                out(SENTINEL)
            elif cmd == "export-vk":
                from .io.zkey import ZKeyFile

                f = _parse_flags(rest)
                vk = ZKeyFile(f["zkey"]).export_verification_key()
                with open(f["vk"], "w") as fh:
                    json.dump(vk, fh, indent=1)
                out(SENTINEL)
            elif cmd == "verify":
                f = _parse_flags(rest)
                ok = groth16_verify(f["proof"], f["public"], f["vk"])
                out("OK!" if ok else "INVALID proof")
                out(SENTINEL)
                if not ok:
                    return 1
            else:
                out(f"ERROR: unknown command {cmd!r}")
                out(SENTINEL)
        except Exception as exc:  # keep the worker alive like the reference REPL
            out(f"ERROR: {exc}")
            out(SENTINEL)
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] in ("prove", "verify", "export-vk"):
        # one-shot mode: same flags, single command, then exit
        import io

        return run_worker(
            stdin=io.StringIO(" ".join(shlex.quote(a) for a in argv) + "\nexit\n"))
    return run_worker()


if __name__ == "__main__":
    sys.exit(main())
