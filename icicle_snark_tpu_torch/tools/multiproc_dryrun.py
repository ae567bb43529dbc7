"""The sharded prove across processes on one machine.

Spawns --procs processes of --shards shards each (one mesh spanning them
all), joined by torch.distributed on a free local port: gloo with CPU
shards, or with --cuda NCCL, each process on its own card (--procs
defaults to the card count there). Each process proves the same circuit
through `init_distributed` -> `make_mesh` -> `prove_multichip` (whose
`globalize` keeps each process's span of every sharded array, and whose
exchanges and gathers cross processes through torch.distributed): one
deterministic proof, which must equal the single-device prove's byte for
byte in every process, then one randomized proof timed by phase, which
must verify. The counterpart of tools/multiproc_dryrun.py of the JAX
package.

    python -m icicle_snark_tpu_torch.tools.multiproc_dryrun     # 2 x 2 CPU shards, gloo
    python -m icicle_snark_tpu_torch.tools.multiproc_dryrun --cuda --constraints 1600000

The circuit is complex_circuit(20, 26) (domain 32: the four-step route at
up to 4 shards), or complex_circuit(N, N) with --constraints N. With
--json PATH the parent writes the phase times of every process there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fixture(directory: str, constraints: int, device) -> dict:
    """zkey, vk and witness of the circuit; the device setup on a card,
    the host setup on the CPU."""
    from icicle_snark_tpu_torch.io.wtns import write_wtns
    from icicle_snark_tpu_torch.setup.fast_setup import groth16_setup_device
    from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness
    from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup

    paths = {k: os.path.join(directory, f) for k, f in
             (("zkey", "c.zkey"), ("vk", "vk.json"), ("wtns", "c.wtns"))}
    r1cs = complex_circuit(constraints, constraints) if constraints else complex_circuit(20, 26)
    if device.type == "cuda":
        groth16_setup_device(r1cs, paths["zkey"], paths["vk"], device=device)
    else:
        groth16_setup(r1cs, paths["zkey"], paths["vk"])
    write_wtns(paths["wtns"], complex_circuit_witness(r1cs, a=9))
    return paths


def child(directory: str, shards: int, cuda: bool) -> None:
    import torch
    import torch.distributed as dist

    from icicle_snark_tpu_torch.parallel.mesh import make_mesh
    from icicle_snark_tpu_torch.parallel.prove_step import prove_multichip
    from icicle_snark_tpu_torch.prover import pipeline
    from icicle_snark_tpu_torch.prover.cache import load_zkey_cache

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    mesh = make_mesh([dev] * shards)  # joins the group of the environment
    assert mesh.distributed and mesh.size == int(os.environ["WORLD_SIZE"]) * shards
    cache = load_zkey_cache(os.path.join(directory, "c.zkey"), dev)
    wtns = os.path.join(directory, "c.wtns")
    proof, public = prove_multichip(mesh, wtns, cache, deterministic=True)
    timer = pipeline.PhaseTimer(dev)
    t0 = time.perf_counter()
    rproof, rpublic = prove_multichip(mesh, wtns, cache, timer=timer)
    secs = time.perf_counter() - t0
    with open(os.path.join(directory, f"proof_{rank}.json"), "w") as fh:
        json.dump({"proof": proof, "public": public, "randomized": [rproof, rpublic],
                   "prove_s": secs, "phases_s": timer.phases, "shards": list(mesh.local),
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None}, fh)
    dist.destroy_process_group()
    print(f"[child {rank}] proofs written over shards {list(mesh.local)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=0,
                    help="processes (default 2; with --cuda the card count)")
    ap.add_argument("--shards", type=int, default=0,
                    help="shards a process (default 2; with --cuda 1)")
    ap.add_argument("--cuda", action="store_true", help="one card a process, NCCL")
    ap.add_argument("--constraints", type=int, default=0,
                    help="prove complex_circuit(N, N) (default: complex_circuit(20, 26))")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the processes")
    ap.add_argument("--json", default=None, help="write the processes' phase times here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)  # the shared directory
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.shards, args.cuda)
        return 0

    import torch

    from icicle_snark_tpu_torch.prover import api, pipeline
    from icicle_snark_tpu_torch.prover.cache import load_zkey_cache

    torch.set_num_threads(1)
    if args.cuda:
        from icicle_snark_tpu_torch import kernels

        kernels.lib()  # build once, before the processes load it
        dev = torch.device("cuda", 0)
        procs, shards = args.procs or torch.cuda.device_count(), args.shards or 1
        if procs > torch.cuda.device_count():
            raise SystemExit(f"--procs {procs}: only {torch.cuda.device_count()} cards")
    else:
        dev, procs, shards = torch.device("cpu"), args.procs or 2, args.shards or 2
    directory = tempfile.mkdtemp(prefix="multiproc_dryrun_")
    try:
        paths = _fixture(directory, args.constraints, dev)
        cache = load_zkey_cache(paths["zkey"], dev)
        single = pipeline.prove(paths["wtns"], cache, deterministic=True)
        timer = pipeline.PhaseTimer(dev)  # a warm single-device prove, for comparison
        pipeline.prove(paths["wtns"], cache, timer=timer)
        del cache
        if args.cuda:
            torch.cuda.empty_cache()
        port = _free_port()
        children = []
        for rank in range(procs):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       RANK=str(rank), WORLD_SIZE=str(procs))
            cmd = [sys.executable, "-m", "icicle_snark_tpu_torch.tools.multiproc_dryrun",
                   "--child", directory, "--shards", str(shards)] + (["--cuda"] if args.cuda
                                                                    else [])
            children.append(subprocess.Popen(cmd, env=env, cwd=REPO))
        deadline = time.time() + args.timeout
        rc = 0
        try:
            for p in children:
                p.wait(timeout=max(deadline - time.time(), 1))
                rc |= p.returncode
        finally:
            for p in children:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rc:
            print(f"FAIL: a process exited with {rc}")
            return 1
        runs = []
        for rank in range(procs):
            with open(os.path.join(directory, f"proof_{rank}.json")) as fh:
                runs.append(json.load(fh))
        want = json.loads(json.dumps({"proof": single[0], "public": single[1]}))
        same = all({"proof": r["proof"], "public": r["public"]} == want for r in runs)
        rand = runs[0]["randomized"]
        with open(os.path.join(directory, "rp.json"), "w") as fh:
            json.dump(rand[0], fh)
        with open(os.path.join(directory, "ru.json"), "w") as fh:
            json.dump(rand[1], fh)
        verifies = api.groth16_verify(os.path.join(directory, "rp.json"),
                                      os.path.join(directory, "ru.json"), paths["vk"])
        summary = {"procs": procs, "shards_a_process": shards, "mesh": procs * shards,
                   "device": torch.cuda.get_device_name(0) if args.cuda else "cpu",
                   "constraints": args.constraints, "single_device_phases_s": timer.phases,
                   "same_as_single": same, "randomized_verifies": verifies,
                   "processes": [{k: r[k] for k in ("shards", "prove_s", "phases_s", "peak_gb")}
                                 for r in runs]}
        print(json.dumps(summary), flush=True)
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
            with open(args.json, "w") as fh:
                json.dump(summary, fh, indent=1)
        ok = same and verifies
        print(f"OK: {procs}-process x {shards}-shard proof byte-identical to the single-device "
              "proof, the randomized one verifies" if ok else
              f"FAIL: same as the single-device proof {same}, randomized verifies {verifies}")
        return 0 if ok else 1
    finally:
        shutil.rmtree(directory, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
