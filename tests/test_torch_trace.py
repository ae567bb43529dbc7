"""The port's recorder (icicle_snark_tpu_torch/trace.py) on the CPU: the
span tree of a timed prove, request ids, a prove without a timer that
records and synchronises nothing, the module's no-ops outside a recorder,
the counting of blocking waits, and the clock shared with the profiler."""

import warnings

import pytest
import torch

from icicle_snark_tpu_torch import trace
from icicle_snark_tpu_torch.io.wtns import write_wtns
from icicle_snark_tpu_torch.prover import api, pipeline
from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness
from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

PHASES = ["witness_ingest", "r1cs_ntt", "msm", "randomize_assemble", "serialize"]
# (span, parent) of one prove, in the order the spans open
# The randomisation runs inside the msm phase: its MSM-independent products
# (assemble.precompute) between G1's launches and G2's, G1's combine and the
# products that need it between G2's launches and G2's download, B's last
# addition after G2's combine.
TREE = [("prove", None), ("api.lookup", "prove"), ("ingest.open", "prove"),
        ("ingest.copy", "prove"), ("ingest.read", "ingest.copy"), ("r1cs_ntt", "prove"),
        ("msm.g1", "prove"), ("msm.sort", "msm.g1"), ("msm.accumulate", "msm.g1"),
        ("msm.reduce", "msm.g1"), ("assemble.precompute", "prove"), ("msm.g2", "prove"),
        ("msm.sort", "msm.g2"), ("msm.accumulate", "msm.g2"), ("msm.reduce", "msm.g2"),
        ("msm.to_host", "prove"), ("msm.combine", "prove"), ("assemble.randomize", "prove"),
        ("msm.to_host", "prove"), ("msm.combine", "prove"), ("assemble.randomize", "prove"),
        ("assemble.public", "prove"), ("assemble.serialize", "prove"), ("api.write", "prove")]
HOST = {"api.lookup", "ingest.open", "ingest.read", "assemble.precompute", "msm.combine",
        "assemble.randomize", "assemble.public", "assemble.serialize", "api.write"}


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    """Two timed deterministic proves of the complex circuit (domain 64)
    through api.groth16_prove on the CPU, on one warm cache."""
    tmp = tmp_path_factory.mktemp("torch_trace")
    r1cs = complex_circuit(40, 50)
    zkey, vk, wtns = (str(tmp / f) for f in ("circuit_final.zkey", "vk.json", "witness.wtns"))
    groth16_setup(r1cs, zkey, vk)
    write_wtns(wtns, complex_circuit_witness(r1cs, a=7))
    cm = api.CacheManager("cpu")
    cm.get(zkey)
    timers, proofs = [], []
    for k in range(2):
        timers.append(pipeline.PhaseTimer("cpu"))
        proof = str(tmp / f"proof_{k}.json")
        api.groth16_prove(wtns, zkey, proof, str(tmp / f"public_{k}.json"), cm,
                          deterministic=True, timer=timers[-1])
        proofs.append(open(proof).read())
    return tmp, zkey, vk, wtns, cm, timers, proofs


def test_a_timed_prove_records_its_span_tree(proved):
    *_, timers, _ = proved
    t = timers[0]
    recs = t.records
    assert [(r.name, None if r.parent is None else recs[r.parent].name) for r in recs] == TREE
    assert {r.name for r in recs if r.host} == HOST
    assert all(r.stream_idle for r in recs)  # the CPU has no stream to wait on
    for r in recs:
        assert r.start <= r.end
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start <= r.start and r.end <= p.end, r.name
    # siblings follow one another
    for a, b in zip(recs, recs[1:]):
        if a.parent == b.parent:
            assert a.end <= b.start
    total = sum(t.self_ns(name) for name in {r.name for r in recs})
    assert total == pytest.approx(recs[0].duration_ns, rel=0.01)
    assert t.self_ns("msm.g1") == recs[6].duration_ns - sum(r.duration_ns for r in recs[7:10])
    assert t.self_ns(lambda r: r.name.startswith("msm.g")) == \
        t.self_ns("msm.g1") + t.self_ns("msm.g2")
    # the witness fits one chunk: one read, one chunk counted, no wait
    assert recs[3].counts == {"chunks": 1} and recs[4].counts == {}


def test_the_g2_level0_counts_its_jacobian_items(proved):
    """`msm.accumulate` under `msm.g2` counts the items of G2's level 0, which
    adds in Jacobian coordinates (`g2_jacobian`); G1's counts nothing."""
    *_, timers, _ = proved
    for t in timers:
        recs = t.records
        acc = {recs[r.parent].name: r.counts for r in recs if r.name == "msm.accumulate"}
        assert acc["msm.g1"] == {} and acc["msm.g2"]["g2_jacobian"] > 0


def test_the_sort_counts_its_pairs_and_key_bits(proved):
    """`msm.sort` under each MSM counts the pairs of its one radix sort
    (`sort_items`: W * total) and the key bits the sort walks (`sort_bits`:
    those of W * (G + 1)(H + 1) - 1)."""
    from icicle_snark_tpu_torch.ops import msm

    tmp, zkey, vk, wtns, cm, timers, proofs = proved
    cache = cm.get(zkey)
    want = {}
    for name, sizes, c, f in (("msm.g1", cache.g1_sizes, cache.msm_c, cache.msm_pre),
                              ("msm.g2", [cache.b2_records.shape[0] // cache.msm_pre2],
                               cache.msm_c2, cache.msm_pre2)):
        windows = msm.merged_windows(c, f)
        kr = (len(sizes) + 1) * ((1 << (c - 1)) + 1)
        want[name] = {"sort_items": windows * sum(sizes) * f,
                      "sort_bits": (windows * kr - 1).bit_length()}
    for t in timers:
        recs = t.records
        assert {recs[r.parent].name: r.counts for r in recs if r.name == "msm.sort"} == want


def test_phases_of_a_timed_prove_are_unchanged(proved):
    *_, timers, proofs = proved
    for t in timers:
        assert list(t.phases) == PHASES and all(v >= 0 for v in t.phases.values())
    assert proofs[0] == proofs[1]


def test_every_timer_is_a_request_of_its_own(proved):
    *_, timers, _ = proved
    a, b = timers
    assert b.request != a.request and trace.PhaseTimer().request != b.request
    # the second prove's spans lie after the first's
    assert a.records[0].end <= b.records[0].start


def test_a_prove_without_a_timer_records_and_waits_for_nothing(proved, monkeypatch):
    tmp, zkey, vk, wtns, cm, timers, proofs = proved

    def refuse(*_a, **_k):
        raise AssertionError("a prove without a timer touched the device's sync state")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    opened = []
    real = trace.Span.__enter__
    monkeypatch.setattr(trace.Span, "__enter__", lambda self: opened.append(self) or real(self))
    proof, public = str(tmp / "proof_untimed.json"), str(tmp / "public_untimed.json")
    api.groth16_prove(wtns, zkey, proof, public, cm, deterministic=True)
    assert opened == [] and trace._CURRENT.get() is None
    assert open(proof).read() == proofs[0] and api.groth16_verify(proof, public, vk)
    # so does pipeline.prove called directly
    pipeline.prove(wtns, cm.get(zkey), deterministic=True)
    assert opened == []


def test_spans_and_counts_outside_a_recorder_do_nothing():
    assert trace._CURRENT.get() is None
    with trace.span("x", host=True) as s:
        trace.count("syncs")
    assert s is None and trace.span("y") is trace.span("z")
    assert trace.activate(None) is trace.activate(trace.NULL)
    trace.NULL.mark("witness_ingest")
    t = trace.PhaseTimer()
    with trace.activate(t):
        with trace.activate(t):
            with trace.span("a"):
                trace.count("n", 3)
    assert [r.name for r in t.records] == ["prove", "a"] and t.records[1].counts == {"n": 3}
    trace.count("n")
    with trace.span("after"):
        pass
    assert len(t.records) == 2


def test_blocking_waits_are_counted_by_open_span(monkeypatch):
    """The counting path of a CUDA timer, with torch's warning raised by
    hand: each flagged call counts against the innermost open span, a
    mark's own synchronisation does not, other warnings pass on, and the
    mode and the warning filters are restored."""
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now={"warn": 1}.get(m, m)))
    flagged = trace.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp:1.)"
    t = trace.PhaseTimer()
    t.sync = lambda: warnings.warn(flagged)  # what a device timer's mark does
    filters = list(warnings.filters)
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *a, **k: seen.append(str(message))
        with trace.activate(t):
            assert mode["now"] == 1
            with trace.span("a"):
                warnings.warn(flagged)
                warnings.warn(flagged)
                with trace.span("b"):
                    warnings.warn(flagged)
                    warnings.warn("another warning")
                t.mark("phase")
            warnings.warn(flagged)
        assert seen == ["another warning"]
    assert mode["now"] == 0 and warnings.filters == filters
    counts = {r.name: r.counts for r in t.records}
    assert counts == {"prove": {"syncs": 1}, "a": {"syncs": 2}, "b": {"syncs": 1}}
    assert list(t.phases) == ["phase"]


def test_recorders_on_two_threads_count_their_own_waits(monkeypatch):
    """Two CUDA timers active on two threads at once, the first leaving
    before the second: the mode stays "warn" until the last leaves, each
    flagged call counts against its own thread's recorder, and after both
    the mode, the filters and the hook are as they were, and a flagged
    call outside any recorder counts nothing."""
    import threading

    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now={"warn": 1}.get(m, m)))
    flagged = trace.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp:1.)"
    a, b = trace.PhaseTimer(), trace.PhaseTimer()
    a.sync = b.sync = lambda: None
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    faults, seen = [], []

    def first():
        with trace.activate(a):
            warnings.warn(flagged)
            a_in.set()
            b_in.wait(10)
            warnings.warn(flagged)
        a_out.set()

    def second():
        a_in.wait(10)
        with trace.activate(b):
            b_in.set()
            a_out.wait(10)
            if mode["now"] != 1:
                faults.append("the mode was restored while a recorder was active")
            for _ in range(3):
                warnings.warn(flagged)

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 - reported by the test's thread
                faults.append(repr(exc))
        return run

    filters = list(warnings.filters)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        hook = warnings.showwarning = lambda message, *a, **k: seen.append(str(message))
        threads = [threading.Thread(target=guarded(f)) for f in (first, second)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert warnings.showwarning is hook and mode["now"] == 0
        warnings.warn(flagged)
        assert seen == [flagged]
    assert faults == [] and warnings.filters == filters
    assert [r.counts for r in a.records] == [{"syncs": 2}]
    assert [r.counts for r in b.records] == [{"syncs": 3}]


def test_span_times_map_onto_the_profilers_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    t = trace.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.warm_up"):  # the profiler's first range pays its set-up
            pass
        with trace.activate(t):
            with record_function("test.range"):
                with trace.span("inner", host=True):
                    sum(range(200000))
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "test.range" and e.device_type() == DeviceType.CPU]
    assert len(ranges) == 1
    inner = t.records[1]
    start, end = t.to_trace_ns(inner.start), t.to_trace_ns(inner.end)
    assert abs(start - ranges[0].start_ns()) < 1e6 and abs(end - ranges[0].end_ns()) < 1e6


@pytest.mark.chip
def test_the_ingest_waits_for_nothing_on_the_card(proved):
    """A timed prove on the card: the witness's chunks are copied without a
    blocking wait (`ingest.copy` counts its chunk and no sync), its one read
    opens with the card's stream empty, and the proof is the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp, zkey, vk, wtns, cm, timers, proofs = proved
    cuda = api.CacheManager("cuda")
    proof, public = str(tmp / "proof_card.json"), str(tmp / "public_card.json")
    api.groth16_prove(wtns, zkey, proof, public, cuda, deterministic=True)  # warm-up
    t = pipeline.PhaseTimer("cuda")
    api.groth16_prove(wtns, zkey, proof, public, cuda, deterministic=True, timer=t)
    recs = t.records
    assert [(r.name, None if r.parent is None else recs[r.parent].name)
            for r in recs[:6]] == TREE[:6]
    counts = {r.name: r.counts for r in recs if r.name.startswith("ingest.")}
    assert counts == {"ingest.open": {}, "ingest.copy": {"chunks": 1}, "ingest.read": {}}
    assert recs[4].name == "ingest.read" and recs[4].stream_idle
    assert open(proof).read() == proofs[0]


@pytest.mark.chip
def test_the_g2_level0_launch_is_counted_on_the_card(proved):
    """A timed prove on the card launches G2's level 0 once on the Jacobian
    route (the K4 wrapper's `g2_jacobian` variant), counts its items in
    `msm.g2`'s `msm.accumulate` as the CPU's prove does, and gives the CPU's
    proof."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from icicle_snark_tpu_torch import kernels

    tmp, zkey, vk, wtns, cm, timers, proofs = proved
    cuda = api.CacheManager("cuda")
    proof, public = str(tmp / "proof_card.json"), str(tmp / "public_card.json")
    api.groth16_prove(wtns, zkey, proof, public, cuda, deterministic=True)  # warm-up
    before = kernels.MSM_ACCUMULATE.variants.get("g2_jacobian", 0)
    t = pipeline.PhaseTimer("cuda")
    api.groth16_prove(wtns, zkey, proof, public, cuda, deterministic=True, timer=t)
    assert kernels.MSM_ACCUMULATE.variants["g2_jacobian"] == before + 1

    def g2_items(timer):
        return [r.counts.get("g2_jacobian") for r in timer.records
                if r.name == "msm.accumulate" and timer.records[r.parent].name == "msm.g2"]

    assert g2_items(t) == g2_items(timers[0])
    assert open(proof).read() == proofs[0]


@pytest.mark.chip
def test_the_sort_waits_for_nothing_on_the_card(proved):
    """A timed prove on the card: each `msm.sort` counts what the CPU's
    counts (K19's pairs and key bits) and no blocking wait, and the proof
    is the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp, zkey, vk, wtns, cm, timers, proofs = proved
    cuda = api.CacheManager("cuda")
    proof, public = str(tmp / "proof_card.json"), str(tmp / "public_card.json")
    api.groth16_prove(wtns, zkey, proof, public, cuda, deterministic=True)  # warm-up
    t = pipeline.PhaseTimer("cuda")
    api.groth16_prove(wtns, zkey, proof, public, cuda, deterministic=True, timer=t)

    def sorts(timer):
        return [r.counts for r in timer.records if r.name == "msm.sort"]

    assert sorts(t) == sorts(timers[0]) and all(trace.SYNCS not in c for c in sorts(t))
    assert open(proof).read() == proofs[0]
