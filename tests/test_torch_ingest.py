"""The port's witness ingest (prover/pipeline.py read_witness, upload_words;
io/wtns.py read_words): on the CPU, the chunked reader against the memory-
mapped turn at every chunk boundary, its chunk count, and the checks of a
short or foreign file; on the card (marked `chip`, skipped without one),
K18 `witness_limbs` against its plain version, uploads back to back behind
a busy stream, and proves of two witnesses against the CPU's.

The card's tests: `python -m pytest --noconftest -m chip
tests/test_torch_ingest.py tests/test_torch_trace.py` (the suite's
conftest imports JAX, which the card tests do not use)."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from icicle_snark_tpu_torch import kernels, trace
from icicle_snark_tpu_torch.fields import limbs as lb
from icicle_snark_tpu_torch.io.wtns import WtnsFile, write_wtns
from icicle_snark_tpu_torch.prover import api, pipeline
from icicle_snark_tpu_torch.refmath.field import R_MOD
from icicle_snark_tpu_torch.setup.r1cs import complex_circuit, complex_circuit_witness
from icicle_snark_tpu_torch.setup.trusted_setup import groth16_setup

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW = 32  # bytes a witness value
CHUNK = 16  # rows a chunk in the CPU tests
ROWS = [1, 7, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5]


def _witness(path, n: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed + n)
    vals = [int.from_bytes(rng.bytes(ROW), "little") % R_MOD for _ in range(n)]
    write_wtns(str(path), vals)
    return str(path)


def _header(n: int, r: int = R_MOD):
    return SimpleNamespace(r=r, n_vars=n)


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(pipeline, "INGEST_CHUNK", CHUNK * ROW)


@pytest.mark.parametrize("readers", [1, 3])
@pytest.mark.parametrize("n", ROWS)
def test_the_chunked_reader_gives_the_mapped_limbs(tmp_path, small_chunks, monkeypatch, n,
                                                   readers):
    monkeypatch.setattr(pipeline, "INGEST_READERS", readers)
    p = _witness(tmp_path / "w.wtns", n)
    wtns, limbs = pipeline.read_witness(p, _header(n), "cpu")
    want = lb.words_to_host_limbs(WtnsFile(p).witness_limbs())
    assert limbs.dtype == torch.int32 and limbs.shape == (8, n)
    assert torch.equal(limbs, want)
    assert wtns.header.n_witness == n


@pytest.mark.parametrize("n", ROWS)
def test_each_chunk_is_counted_and_read_in_a_span(tmp_path, small_chunks, n):
    p = _witness(tmp_path / "w.wtns", n)
    t = trace.PhaseTimer()
    with trace.activate(t):
        pipeline.read_witness(p, _header(n), "cpu")
    recs = t.records
    copy = [i for i, r in enumerate(recs) if r.name == "ingest.copy"]
    assert len(copy) == 1
    chunks = -(-n * ROW // (CHUNK * ROW))
    assert recs[copy[0]].counts == {"chunks": chunks}
    reads = [r for r in recs if r.name == "ingest.read"]
    assert len(reads) == chunks
    assert all(r.host and r.parent == copy[0] for r in reads)


def test_the_plain_turn_is_the_host_transpose():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(37, 8), dtype=np.uint64).astype(np.uint32)
    got = lb.words_to_device_limbs(torch.from_numpy(words.view(np.int32)))
    assert torch.equal(got, lb.words_to_host_limbs(words))
    for bad in (torch.zeros((4, 7), dtype=torch.int32), torch.zeros((4, 8), dtype=torch.int64),
                torch.zeros(8, dtype=torch.int32)):
        with pytest.raises(ValueError):
            lb.words_to_device_limbs(bad)


def _cut(path: str, keep: int):
    with open(path, "r+b") as fh:
        fh.truncate(keep)


def _words_offset(path: str) -> int:
    return WtnsFile(path).bin.section_range(2).pos


@pytest.mark.parametrize("keep", ["header", "half"])
def test_a_truncated_file_raises(tmp_path, small_chunks, keep):
    n = 3 * CHUNK + 5
    p = _witness(tmp_path / "w.wtns", n)
    pos = _words_offset(p)
    _cut(p, pos if keep == "header" else pos + n * ROW // 2)
    with pytest.raises(ValueError):
        pipeline.read_witness(p, _header(n), "cpu")


def test_a_file_cut_while_it_is_read_raises(tmp_path, small_chunks):
    """The file ends inside the witness section after it was opened: the
    reads come up short, and the reader says so."""
    n = 3 * CHUNK + 5
    p = _witness(tmp_path / "w.wtns", n)
    wtns = WtnsFile(p)
    _cut(p, _words_offset(p) + 2 * CHUNK * ROW + 3)
    with pytest.raises(ValueError, match="ends after"):
        pipeline.upload_words(wtns, "cpu")


def test_a_section_of_another_width_raises(tmp_path):
    p = str(tmp_path / "w40.wtns")
    write_wtns(p, [3, 5, 7], n8=40)
    with pytest.raises(ValueError, match="witness section"):
        pipeline.read_witness(p, _header(3), "cpu")


# A fresh interpreter reads a witness (its reader threads start), forks, and
# the child reads it again; the child dies after 60 s if its reads never run.
FORK_SCRIPT = """
import os, signal, sys
import numpy as np
from icicle_snark_tpu_torch.io.wtns import WtnsFile

path, n, chunk = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
want = WtnsFile(path).witness_limbs().view(np.int32)

def read():
    out = np.empty((n, 8), dtype=np.int32)
    for _ in WtnsFile(path).read_words(out, chunk, 2):
        pass
    return out

assert np.array_equal(read(), want)
pid = os.fork()
if pid == 0:
    signal.alarm(60)
    os._exit(0 if np.array_equal(read(), want) else 3)
sys.exit(os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]))
"""


def test_a_forked_child_reads_on_threads_of_its_own(tmp_path):
    """The reader threads are kept for the process: a child forked after a
    read has none of them, and its reads start their own."""
    n = 3 * CHUNK + 5
    p = _witness(tmp_path / "w.wtns", n)
    res = subprocess.run([sys.executable, "-c", FORK_SCRIPT, p, str(n), str(CHUNK * ROW)],
                         cwd=REPO, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]


def test_the_length_and_curve_checks_still_raise(tmp_path):
    p = _witness(tmp_path / "w.wtns", 9)
    with pytest.raises(ValueError, match="invalid witness length"):
        pipeline.read_witness(p, _header(10), "cpu")
    with pytest.raises(ValueError, match="curve"):
        pipeline.read_witness(p, _header(9, r=R_MOD - 2), "cpu")


# ---------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("n", [1, 31, 2**16 + 3, 1_600_003])
def test_k18_matches_its_plain_version(n):
    dev = _card()
    gen = torch.Generator().manual_seed(n)
    words = torch.randint(-2**31, 2**31, (n, 8), dtype=torch.int32, generator=gen)
    before = kernels.counts()["witness_limbs"]
    got = lb.words_to_device_limbs(words.to(dev))
    torch.cuda.synchronize()
    assert kernels.counts()["witness_limbs"] == before + 1
    assert torch.equal(got.cpu(), lb.words_to_device_limbs(words))


@pytest.mark.chip
def test_uploads_back_to_back_behind_a_busy_stream(tmp_path, small_chunks):
    """Three uploads queued behind a long kernel, so that the copies from one
    pinned buffer are still waiting when the next upload asks for one: each
    lands its own witness."""
    dev = _card()
    n = 3 * CHUNK + 5
    paths = [_witness(tmp_path / f"w{k}.wtns", n, seed=k) for k in range(2)]
    want = [lb.words_to_host_limbs(WtnsFile(p).witness_limbs()) for p in paths]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # about 50 ms of the stream
    got = [pipeline.read_witness(paths[k], _header(n), dev)[1] for k in (0, 1, 0)]
    torch.cuda.synchronize()
    for k, g in zip((0, 1, 0), got):
        assert torch.equal(g.cpu(), want[k])


@pytest.fixture(scope="module")
def circuit(tmp_path_factory):
    """The complex circuit (domain 64), two witnesses, and each one's
    deterministic proof on the CPU."""
    _card()
    tmp = tmp_path_factory.mktemp("torch_ingest")
    r1cs = complex_circuit(40, 50)
    zkey, vk = str(tmp / "circuit_final.zkey"), str(tmp / "vk.json")
    groth16_setup(r1cs, zkey, vk)
    wtns = []
    for a in (7, 11):
        wtns.append(str(tmp / f"witness_{a}.wtns"))
        write_wtns(wtns[-1], complex_circuit_witness(r1cs, a=a))
    cm = api.CacheManager("cpu")
    plain = [_prove(tmp, zkey, w, cm, f"cpu_{k}") for k, w in enumerate(wtns)]
    return tmp, zkey, vk, wtns, plain


def _prove(tmp, zkey, wtns, cm, tag):
    proof, public = str(tmp / f"proof_{tag}.json"), str(tmp / f"public_{tag}.json")
    api.groth16_prove(wtns, zkey, proof, public, cm, deterministic=True)
    with open(proof) as fh, open(public) as gh:
        return fh.read(), gh.read()


@pytest.mark.chip
def test_two_witnesses_prove_on_the_card_as_on_the_cpu(circuit, monkeypatch):
    """Two witnesses back to back, then the first again, each in several
    chunks, one K18 launch a prove: every proof byte-identical to the
    CPU's."""
    tmp, zkey, vk, wtns, plain = circuit
    monkeypatch.setattr(pipeline, "INGEST_CHUNK", 5 * ROW + 3)
    cm = api.CacheManager("cuda")
    cm.get(zkey)
    for step, k in enumerate((0, 1, 0)):
        kernels.reset_counts()
        got = _prove(tmp, zkey, wtns[k], cm, f"cuda_{step}")
        assert kernels.counts()["witness_limbs"] == 1
        assert got == plain[k], (step, k)
    assert api.groth16_verify(str(tmp / "proof_cuda_2.json"), str(tmp / "public_cuda_2.json"),
                              vk)
    assert os.path.getsize(str(tmp / "proof_cuda_1.json")) > 0
