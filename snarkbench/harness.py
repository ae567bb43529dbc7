"""One run of one cell: inputs, set-up, the measured window, the trace,
the reference's judgement and the result line.

Everything that belongs to one configuration, traffic mix, metric or
kernel is found by name: `configs/<config>.json` (with its input module,
named in it), `traffic/<traffic>.json` (with `traffic/<kind>.py`, its
driver), `metrics/<metric>.py` (a `read(run)` that returns a number or
None) and `kernels/<kernel>.json` (the CUDA functions of a kernel that
`kernels.counts()` names, where its name is not part of theirs). A later
cell or kernel adds files and a `workloads` entry; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

from . import fixtures
from . import phases as ph
from .reference import groth16 as ref

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "icicle_snark_tpu")
# answers held to the pairing equation at once (reference.groth16.batch_check)
PAIRING_BATCH = 32
TRACE_ATTEMPTS = 3


def forbidden_modules(names) -> list:
    """The module names whose top-level name (before the first dot) is,
    whole, one of FORBIDDEN: `icicle_snark_tpu_torch` is not
    `icicle_snark_tpu`."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def resolve(workload: str, bench: dict | None = None, data: str = PKG) -> tuple:
    """(cell, config, traffic, end-to-end metric specs, per-layer metric
    specs) of the workload named, from BENCHMARK.json and the files named
    after its configuration and traffic under `data`."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if not cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[0]
    config = load_json(data, "configs", f"{cell['config']}.json")
    traffic = load_json(data, "traffic", f"{cell['traffic']}.json")

    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without `workloads` is read in every cell that
    # reports the end-to-end metric it moves
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", ()) or
             "workloads" not in m and m["moves"] in reported]
    return cell, config, traffic, e2e, layer


def traffic_driver(kind: str):
    return importlib.import_module(f"{__package__}.traffic.{kind}")


def kernel_functions(name: str, data: str = PKG) -> list:
    """The CUDA function names of the port's kernel `name`, from
    kernels/<name>.json; without a file, the kernel's own name."""
    path = os.path.join(data, "kernels", f"{name}.json")
    return load_json(path)["functions"] if os.path.exists(path) else [name]


def metric_reader(name: str, data: str = PKG):
    """The `read` function of metrics/<name>.py (a name may hold dots)."""
    path = os.path.join(data, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of
    the values at or below it."""
    xs = sorted(values)
    k = max(1, -(-len(xs) * q // 100))
    return xs[int(k) - 1]


class Prover:
    """The entry the CLI worker's `prove` command calls,
    `api.groth16_prove(witness, zkey, proof, public, cache_manager)`, with
    files in and out: each request writes its own proof.json and
    public.json under `out_dir`."""

    def __init__(self, device, zkey: str, witnesses: list, out_dir: str):
        from icicle_snark_tpu_torch.prover import api

        self.api, self.device, self.zkey = api, device, zkey
        self.witnesses, self.out_dir = witnesses, out_dir
        self.cm = api.CacheManager(device)
        self.count = 0

    def call(self, w: int, timer_factory=None, cm=None) -> dict:
        """One request on witness `w`: its host-clock latency from the
        call to the return, both files written. `timer_factory(i)` makes
        the request's PhaseTimer, just before the call."""
        i = self.count
        self.count += 1
        proof = os.path.join(self.out_dir, f"proof_{i}.json")
        public = os.path.join(self.out_dir, f"public_{i}.json")
        req = {"i": i, "w": w, "proof": proof, "public": public, "error": None}
        timer = timer_factory(i) if timer_factory else None
        t0 = time.perf_counter()
        try:
            self.api.groth16_prove(self.witnesses[w], self.zkey, proof, public, cm or self.cm,
                                   timer=timer)
        except Exception as exc:  # noqa: BLE001 - a failed request is counted, not fatal
            req["error"] = f"{type(exc).__name__}: {exc}"
        req["t0"], req["t1"] = t0, time.perf_counter()
        req["latency"] = req["t1"] - t0
        if timer is not None:
            timer.close()
            req["phases"] = dict(timer.phases)
            req["spans"] = timer
        return req


class Run:
    """State of one run; the metric readers read it."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", bench: dict | None = None, log=None,
                 t_start: float | None = None, data: str = PKG,
                 fixture_root: str = fixtures.FIXTURES):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.device, self.data = device, data
        (self.cell, self.config, self.traffic, self.e2e_specs,
         self.layer_specs) = resolve(workload, bench, data)
        self.log = log or (lambda msg: print(f"[snarkbench] {msg}", file=sys.stderr, flush=True))
        self.inputs_s = 0.0
        self.parts, self._mark = {}, self.t_start
        self.requests, self.window_requests, self.profiled = [], [], []
        self.warmup_requests = []
        self.cache_phases, self.work = {}, {}
        self.fixture_root = fixture_root
        # an end-to-end metric from the device trace: the window is traced
        # (on a card; elsewhere such a metric finds nothing to read)
        self.window_trace = (not trace and str(device).startswith("cuda") and
                             any(m["source"] == "device_trace" for m in self.e2e_specs))
        self.window_tracer, self.window_busy_s = None, None

    # ---------------------------------------------------------------- steps

    def part(self, name: str) -> float:
        """Seconds since the last part ended, kept as part `name`."""
        now = time.perf_counter()
        took, self._mark = now - self._mark, now
        self.parts[name] = self.parts.get(name, 0.0) + took
        return took

    def make_inputs(self):
        """The zkey (once a checkout), the reference's key and the seed's
        witnesses; seconds kept apart from set-up."""
        self.key = fixtures.ensure_key(self.config, self.device, self.log, self.fixture_root)
        self.inputs = fixtures.seed_inputs(self.config, self.seed, self.key["zkey"],
                                           self.fixture_root)
        self.vk = load_json(self.key["vk"])
        self.inputs_s += self.part("inputs")
        self.log(f"inputs of seed {self.seed}: {len(self.inputs['witnesses'])} witness(es), "
                 f"{self.inputs_s:.3f} s (kept out of setup_s)")

    def bring_up(self, out_dir: str):
        """The worker: kernels loaded, the zkey cache resident, the warm-up
        proves made (every shape the window uses)."""
        from icicle_snark_tpu_torch.prover.pipeline import PhaseTimer

        self.prover = Prover(self.device, self.key["zkey"], self.inputs["witnesses"], out_dir)
        timer = PhaseTimer(self.device)
        self.part("port_import")
        self.prover.cm.get(self.key["zkey"], timer=timer)
        self.cache_load_s = self.part("cache_load")
        self.cache_phases = dict(timer.phases)
        self.log("cache load " + json.dumps(self.cache_phases))
        for k in range(self.traffic["warmup_proves"]):
            self._warm_up(k)
            self.part(f"warmup_{k}")

    def _warm_up(self, k: int):
        req = self.prover.call(k % len(self.inputs["witnesses"]))
        if req["error"]:
            raise RuntimeError(f"warm-up prove failed: {req['error']}")
        self.warmup_requests.append(req)  # judged with the rest

    def start_window_trace(self):
        """The benchmark's tracer of the card, started after set-up: one
        prove more as its warm-up step (its records dropped), then it
        records the window. Its seconds are the benchmark's, kept out of
        setup_s as the inputs' are."""
        t0 = time.perf_counter()
        self.window_tracer = make_window_tracer(self.device)
        self.window_tracer.start()
        self._warm_up(len(self.warmup_requests))
        self.window_tracer.step()
        self.log(f"window tracer started in {time.perf_counter() - t0:.3f} s "
                 "(kept out of setup_s)")

    def drive(self):
        """The measured window, by the traffic's driver."""
        timer_factory = None
        if self.trace:
            spans = ph.timer_class()
            timer_factory = (lambda i: spans(self.device, f"w{i}"))  # noqa: E731
        before = self._launches()
        try:
            self.window_requests = traffic_driver(self.traffic["kind"]).drive(
                self.prover, self.traffic, self.seconds, timer_factory)
        finally:
            if self.window_tracer is not None:
                self.window_tracer.stop()
        if self.window_tracer is not None:
            self._read_window_trace(before, self._launches())
        self.requests = self.warmup_requests + self.window_requests
        self.window_s = self.window_requests[-1]["t1"] - self.window_requests[0]["t0"]
        first = [round(r["latency"] * 1e3, 2) for r in self.window_requests[:3]]
        lat = sorted(r["latency"] * 1e3 for r in self.window_requests)
        self.log(f"window: {len(lat)} requests in {self.window_s:.3f} s; latency ms min "
                 f"{lat[0]:.2f} p10 {percentile(lat, 10):.2f} p50 {percentile(lat, 50):.2f} "
                 f"p90 {percentile(lat, 90):.2f} max {lat[-1]:.2f}; the first three {first}")

    def _launches(self) -> dict:
        if not self.window_trace:
            return {}
        from icicle_snark_tpu_torch import kernels

        return dict(kernels.counts())

    def _read_window_trace(self, before: dict, after: dict):
        """window_busy_s: the union of the device operations' intervals in
        the window's trace; left None where a port kernel that launched in
        the window left no device record."""
        from torch.autograd import DeviceType

        t0 = time.perf_counter()
        # the tracer's own records, unparsed: a window holds some 10^5
        device = [(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
                  for e in self.window_tracer.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
        self.window_tracer = None
        names = " ".join({name for name, _, _ in device})
        launched = {k: n - before.get(k, 0) for k, n in after.items() if n > before.get(k, 0)}
        missing = [k for k in launched
                   if not any(f in names for f in kernel_functions(k, self.data))]
        ops = sum(1 for name, _, _ in device if "kernel" in name)
        self.log(f"window trace: {len(device)} device records, {ops} of kernels; "
                 f"{sum(launched.values())} port kernel launches; read in "
                 f"{time.perf_counter() - t0:.3f} s")
        if missing:
            self.log(f"window trace: {missing} launched but left no device record: "
                     "device_trace metrics are left out")
            return
        self.window_busy_s = sum(b - a for a, b in ph.merge([(s, e) for _, s, e in device]))

    def profile(self):
        """A profiled stretch after the window: one prove to start the
        tracer, then `traced_proves` proves whose phase ranges and device
        records are read. A stretch counts only if every port kernel that
        launched in a prove left a device record inside it; it is tried
        TRACE_ATTEMPTS times, and then the device metrics are left out."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule

        from icicle_snark_tpu_torch import kernels

        spans = ph.timer_class()
        n = self.traffic["traced_proves"]
        nw = len(self.inputs["witnesses"])
        activities = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        for attempt in range(TRACE_ATTEMPTS):
            done = []
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
                for k in range(n + 1):
                    before = kernels.counts()
                    tag = f"a{attempt}p{k}"
                    req = self.prover.call(
                        k % nw, timer_factory=lambda i, tag=tag: spans(self.device, tag))
                    after = kernels.counts()
                    req["launched"] = {name for name in after if after[name] > before[name]}
                    done.append(req)
                    prof.step()
            self.requests += done
            got = self._read_trace(prof, done[1:], DeviceType.CUDA)
            if got is not None:
                self.profiled = got
                return
        self.log(f"no complete device trace in {TRACE_ATTEMPTS} attempts: "
                 "the device metrics are left out")

    def _read_trace(self, prof, reqs: list, cuda) -> list | None:
        events = prof.events()
        ranges, device = {}, []
        for e in events:
            if e.name.startswith(ph.SPAN_PREFIX):
                if e.device_type == cuda:
                    continue  # the range's mirror on the device timeline, not an operation
                ranges[e.name[len(ph.SPAN_PREFIX):]] = (e.time_range.start / 1e6,
                                                        e.time_range.end / 1e6)
            elif e.device_type == cuda:
                device.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
        out = []
        for req in reqs:
            t = req["spans"]
            keys = [f"{t.tag}.{j}" for j in range(len(t.names))]
            if req["error"] or not all(k in ranges for k in keys):
                self.log(f"trace: prove {req['i']} has no phase ranges")
                return None
            spans = [(name, *ranges[k]) for name, k in zip(t.names, keys)]
            got = ph.attribute(spans, device)
            names = " ".join(got["ops"])
            missing = [k for k in req["launched"]
                       if not any(f in names for f in kernel_functions(k, self.data))]
            if missing:
                self.log(f"trace: prove {req['i']} launched {missing} but the trace holds no "
                         "device record of them")
                return None
            got["req"] = req
            out.append(got)
        return out

    def count_work(self):
        """The benchmark's own count of each witness's prove work."""
        from . import roofline
        from .reference import zkey as refzkey

        head = refzkey.header(self.key["zkey"])
        for w, path in enumerate(self.inputs["witnesses"]):
            self.work[w] = roofline.prove_work(fixtures.witness_words(path), head["n_public"],
                                               head["domain_size"])
            bound, by = roofline.bound_seconds(self.work[w]["msm_muls"], self.work[w]["msm_bytes"])
            windows = {k: v["c"] for k, v in self.work[w].items() if isinstance(v, dict)}
            self.log(f"MSM bound of witness {w}: {bound * 1e3:.4f} ms ({by}), c* {windows}; "
                     f"card {card_power()}")

    # --------------------------------------------------------------- checks

    def judge(self) -> dict:
        """The reference's judgement of every answer (warm-up, window and
        profiled proves), after the window:
        `wrong` counts the requests whose files are missing or malformed,
        whose points are off their curves or whose public signals are not
        the witness's, and those whose proof fails the pairing check
        under the reference's key: every answer, in batches of
        PAIRING_BATCH, each answer of a batch that fails checked alone;
        `repeated` counts proofs equal to an earlier one (randomized
        proofs never repeat)."""
        wrong, seen, repeated, parsed = 0, set(), 0, {}
        for req in self.requests:
            try:
                if req["error"]:
                    raise ValueError(req["error"])
                with open(req["proof"]) as fh:
                    proof = json.load(fh)
                with open(req["public"]) as fh:
                    public = json.load(fh)
                if public != self.inputs["public"][req["w"]]:
                    raise ValueError("public signals differ from the witness's")
                parsed[req["i"]] = ref.parse_proof(proof)
            except (OSError, ValueError, KeyError, IndexError, TypeError) as exc:
                wrong += 1
                req["wrong"] = str(exc)
                continue
            key = json.dumps([proof["pi_a"], proof["pi_b"], proof["pi_c"]])
            repeated += key in seen
            seen.add(key)
        ids = sorted(parsed)
        rng = random.Random(self.seed)
        t0 = time.perf_counter()
        by_id = {r["i"]: r for r in self.requests}
        publics = {w: [int(v) for v in p] for w, p in enumerate(self.inputs["public"])}
        for k in range(0, len(ids), PAIRING_BATCH):
            batch = [(i, (parsed[i], publics[by_id[i]["w"]])) for i in ids[k:k + PAIRING_BATCH]]
            if ref.batch_check([a for _, a in batch], self.vk, rng):
                continue
            failed = [i for i, (points, pub) in batch
                      if not ref.pairing_check(points, pub, self.vk)]
            for i in failed or [batch[0][0]]:  # a batch that fails is never passed
                wrong += 1
                by_id[i]["wrong"] = "the pairing check fails"
        for req in [r for r in self.requests if "wrong" in r][:3]:
            self.log(f"request {req['i']} (witness {req['w']}) is wrong: {req['wrong'][:300]}")
        self.log(f"reference: {len(self.requests)} answers read, {len(ids)} verified by "
                 f"pairing in {time.perf_counter() - t0:.3f} s")
        return {"wrong": {"value": wrong, "limit": 0},
                "repeated": {"value": repeated, "limit": 0}}

    # ---------------------------------------------------------------- result

    def metrics(self, specs: list) -> dict:
        out = {}
        for spec in specs:
            value = metric_reader(spec["name"], self.data)(self)
            if value is None:
                self.log(f"metric {spec['name']}: nothing to read")
                continue
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
        return out

    def breakdown(self) -> dict:
        ops, gaps = {}, []
        for p in self.profiled:
            for name, s in p["ops"].items():
                key = ph.kernel_name(name)[:96]
                ops[key] = ops.get(key, 0.0) + s
            gaps += p["gaps"]
        return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:10],
                "idle_gaps": [list(g) for g in sorted(gaps, key=lambda x: -x[1])[:10]]}

    def trace_device(self) -> dict:
        """busy_s and window_s of the profiled stretch (one card)."""
        if not self.profiled:
            return {}
        return {"busy_s": sum(p["busy_total"] for p in self.profiled),
                "window_s": sum(p["span"] for p in self.profiled)}


def make_window_tracer(device):
    """A profiler of the card's activity alone whose first step starts
    the tracer and is dropped, and whose second step, the window, is kept;
    `stop` ends it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if torch.device(device).type != "cuda":
        raise ValueError("a device trace needs a CUDA card")
    return profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))


def execute(run: Run) -> dict:
    """Steps of a run after the look for a card: returns the result
    object (without printing it)."""
    import torch

    on_cuda = torch.device(run.device).type == "cuda"
    out_dir = tempfile.mkdtemp(prefix="snarkbench-")
    try:
        if on_cuda:
            from icicle_snark_tpu_torch import kernels

            torch.zeros(1, device=run.device)
            run.part("cuda_context")
            kernels.lib()  # nvcc on the first run in a checkout: set-up
            run.part("kernel_library")
        run.make_inputs()
        run.bring_up(out_dir)
        if on_cuda:
            torch.cuda.synchronize()
        run.part("sync")
        run.setup_s = time.perf_counter() - run.t_start - run.inputs_s
        parts = {k: round(v, 6) for k, v in run.parts.items() if k != "inputs"}
        run.log(f"setup_s {run.setup_s:.6f}, its parts {json.dumps(parts)}")
        if run.window_trace:
            run.start_window_trace()
        run.drive()
        if run.trace:
            run.profile()
        memory_peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
        if run.trace:
            run.count_work()
        run.prover = None  # the program's state freed before the reference runs
        checks = run.judge()
        metrics = run.metrics(run.layer_specs if run.trace else run.e2e_specs)
        failed = sum(1 for r in run.requests if r["error"])
        device = {"platform": "gpu" if on_cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
                  "count": 1, "memory_peak_bytes": memory_peak}
        result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
                  "attempted": len(run.requests), "failed": failed, "metrics": metrics,
                  "device": device}
        if run.trace:
            device.update(run.trace_device())
            result["breakdown"] = run.breakdown()
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
