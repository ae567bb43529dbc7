"""Build, load and count the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` (one process per
source, all started together), then linked into one shared library with a
plain C interface that `ctypes` loads. The build happens at first use,
into `build/torch_kernels/` beside the package, keyed by a hash of the
sources; importing this module builds nothing.

Each kernel is a `Kernel` object: `launch(...)` calls the C entry on the
current CUDA stream, raises if it returns a CUDA error, and adds one to
`launches`. Wrappers call `launch` only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def _sources() -> list:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _tag() -> str:
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return h.hexdigest()[:16]


def build_logs() -> dict:
    """The compiler's output (`-Xptxas -v`: registers, stack, spills) of
    each source of the current build, by file name."""
    tag, out = _tag(), {}
    for src in _sources():
        path = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o.log")
        if os.path.exists(path):
            with open(path) as fh:
                out[os.path.basename(src)] = fh.read()
    return out


def build(verbose: bool = False) -> str:
    """Compile the kernels (if the sources changed) and return the library path."""
    tag = _tag()
    lib_path = os.path.join(BUILD_DIR, f"libsnark_kernels_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    units = [p for p in _sources() if p.endswith(".cu")]
    objs, procs = [], []
    t0 = time.perf_counter()
    for src in units:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj]
        # output to a file: a full pipe would stall nvcc while another is waited on
        log = open(obj + ".log", "w+")
        procs.append((src, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                 text=True)))
    failed, secs = [], {}
    while len(secs) < len(procs):
        for src, _log, proc in procs:
            if src not in secs and proc.poll() is not None:
                secs[src] = time.perf_counter() - t0
        time.sleep(0.05)
    for src, log, proc in procs:
        log.seek(0)
        out = log.read()
        log.close()
        if verbose or proc.returncode:
            print(f"[nvcc {os.path.basename(src)}] {secs[src]:.1f} s\n{out}", flush=True)
        if proc.returncode:
            failed.append(os.path.basename(src))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    tmp = lib_path + f".tmp{os.getpid()}"
    subprocess.run([nvcc, NVCC_FLAGS[0], "-shared", *objs, "-o", tmp], check=True)
    os.replace(tmp, lib_path)
    return lib_path


_LIB = None
_LIB_LOCK = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


_SIGNATURES = {
    # op, field, out, a, b, nb, n, nbb, m, stream
    "snark_field_vec": [_I, _I, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _VP],
    # mode, out, coefs, widx, offsets, witness, starts, ends, prev, long_slots,
    # nnz, n, n_vars, n_prev, n_items, piece, stream
    "snark_r1cs_rows": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                        _LL, _LL, _LL, _LL, _LL, _I, _VP],
    # x, tw (natural), scale, batch, n, m, inverse, stream
    "snark_ntt_stage": [_VP, _VP, _VP, _LL, _LL, _LL, _I, _VP],
    # x, tw (stage-major), scale, batch, n, low, r, inverse, stream
    "snark_ntt_radix": [_VP, _VP, _VP, _LL, _LL, _I, _I, _I, _VP],
    # g2, affine, out, src, n_src, order, negs, start, len, n_items, stream
    "snark_msm_accumulate": [_I, _I, _VP, _VP, _LL, _VP, _VP, _VP, _VP, _LL, _VP],
    # g2, stage, out, seg_s, seg_t, buckets, windows, groups, half, seg, nt, stream
    "snark_msm_reduce": [_I, _I, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _I, _VP],
    # x, tw, mul, mul_lanes, out, batch, n, log_n, low, k, tcols_log, inverse, stream
    "snark_ntt_block": [_VP, _VP, _VP, _LL, _VP, _LL, _LL, _I, _I, _I, _I, _I, _VP],
    # g2, out, stacks, s, n, stream
    "snark_point_sum": [_I, _VP, _VP, _LL, _LL, _VP],
    # g2, out, in, n, k, stream
    "snark_point_dbl_k": [_I, _VP, _VP, _LL, _I, _VP],
    # g2, out_x, out_y, in, n, stream
    "snark_point_to_affine": [_I, _VP, _VP, _VP, _LL, _VP],
    # g2, lanes a thread (4, 8, 16, 32), out_x, out_y, in, n, stream (the chip
    # script's sweep; snark_point_to_affine chooses the lanes from n)
    "snark_point_to_affine_lanes": [_I, _I, _VP, _VP, _VP, _LL, _VP],
    # op, width, out, x, y, n, depth, stream
    "snark_probe_chain": [_I, _I, _VP, _VP, _VP, _LL, _I, _VP],
    # field, out, a, exponent (8 host words), nbits, nb, n, stream
    "snark_field_pow": [_I, _VP, _VP, _VP, _I, _LL, _LL, _VP],
    # op, field, out, in, rows, n, blocks, stream
    "snark_field_reduce": [_I, _I, _VP, _VP, _LL, _LL, _LL, _VP],
    # g2, out, scalars, table, n, stream
    "snark_fixed_base_msm": [_I, _VP, _VP, _VP, _LL, _VP],
    # op, field (curves/device.py KERNEL_FIELDS), out, a, b, nb, n, nbb, m, stream
    "snark_field_vec_n": [_I, _I, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _VP],
    # curve, then snark_msm_accumulate's arguments
    "snark_msm_accumulate_n": [_I, _I, _I, _VP, _VP, _LL, _VP, _VP, _VP, _VP, _LL, _VP],
    # curve, g2, stage, out, m_out, t_out, m_in, t_in, windows, groups, n, k,
    # the program table (ops/point_programs.py) and its meta (7 host ints), stream
    "snark_msm_reduce_n": [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _VP, _VP,
                           _VP],
    # curve, g2, meta: blocks of the tree kernel an SM holds (no launch)
    "snark_msm_n_occupancy": [_I, _I, _VP],
    # field, x, tw (stage-major), scale, batch, n, m, inverse, stream
    "snark_ntt_stage_n": [_I, _VP, _VP, _VP, _LL, _LL, _LL, _I, _VP],
    # field, x, tw (stage-major), scale, batch, n, low, r, inverse, stream
    "snark_ntt_radix_n": [_I, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _VP],
    # out, x, tlo, thi, batch, n1, n2_loc, d, shard, s_log, tile, stream
    "snark_four_step": [_VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _LL, _I, _I, _VP],
    # field (KERNEL_FIELDS), out, a, exponent (host words), nbits, nb, n, stream
    "snark_field_pow_n": [_I, _VP, _VP, _VP, _I, _LL, _LL, _VP],
    # op, field (KERNEL_FIELDS), out, in, rows, n, blocks, stream
    "snark_field_reduce_n": [_I, _I, _VP, _VP, _LL, _LL, _LL, _VP],
    # field (KERNEL_FIELDS), x, tw (stage-major), mul, mul_lanes, batch, n, log_n, low, k,
    # tcols_log, inverse, stream
    "snark_ntt_block_n": [_I, _VP, _VP, _VP, _LL, _LL, _LL, _I, _I, _I, _I, _I, _VP],
    # out (8, n), words (n, 8), n, stream
    "snark_witness_limbs": [_VP, _VP, _LL, _VP],
    # keys, vals, scalars, base, n, words, c, wp, f, kr_step, stream
    "snark_msm_sort_keys": [_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _LL, _VP],
    # n, end_bit, bytes (a host long long): the sort's temporary storage (no launch)
    "snark_msm_sort_bytes": [_LL, _I, _VP],
    # keys, keys_alt, vals, vals_alt, n, end_bit, temp, temp_bytes, selector (a host int),
    # stream
    "snark_msm_sort": [_VP, _VP, _VP, _VP, _LL, _I, _VP, _LL, _VP, _VP],
}


class Kernel:
    """One C entry of the library, with its launch count, and the launches
    of each named variant a wrapper marks (`variants`)."""

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        self.name = name
        self.entry = entry
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.variants = {}

    def launch(self, *args, variant: str | None = None):
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib(), self.entry)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1


FIELD_VEC = Kernel(
    "field_vec", "snark_field_vec", "icicle_snark_tpu_torch/csrc/field_vec.cu",
    "icicle_snark_tpu/fields/limbs.py:375",
)
R1CS = Kernel(
    "r1cs_rows", "snark_r1cs_rows", "icicle_snark_tpu_torch/csrc/r1cs.cu",
    "icicle_snark_tpu/prover/pipeline.py:55",
)
NTT = Kernel(
    "ntt_stage", "snark_ntt_stage",
    "icicle_snark_tpu_torch/csrc/ntt.cu; icicle_snark_tpu_torch/csrc/ntt_radix.cuh",
    "icicle_snark_tpu/ops/ntt.py:180",
)
NTT_RADIX = Kernel(
    "ntt_radix", "snark_ntt_radix",
    "icicle_snark_tpu_torch/csrc/ntt.cu; icicle_snark_tpu_torch/csrc/ntt_radix.cuh",
    "icicle_snark_tpu/ops/ntt.py:158; icicle_snark_tpu/ops/ntt.py:180",
)
MSM_ACCUMULATE = Kernel(
    "msm_accumulate", "snark_msm_accumulate", "icicle_snark_tpu_torch/csrc/msm.cu",
    "icicle_snark_tpu/ops/msm.py:609",
)
MSM_REDUCE = Kernel(
    "msm_reduce", "snark_msm_reduce", "icicle_snark_tpu_torch/csrc/msm_reduce.cu",
    "icicle_snark_tpu/ops/msm.py:701",
)
NTT_BLOCK = Kernel(
    "ntt_block", "snark_ntt_block", "icicle_snark_tpu_torch/csrc/ntt_block.cu",
    "icicle_snark_tpu/ops/mxu_ntt.py:350",
)
POINT_ADD = Kernel(
    "point_add", "snark_point_sum",
    "icicle_snark_tpu_torch/csrc/point_vec.cu; icicle_snark_tpu_torch/csrc/point_sum.cuh",
    "icicle_snark_tpu/ops/msm.py:961; icicle_snark_tpu/parallel/msm_shard.py:35",
)
POINT_DBL_K = Kernel(
    "point_dbl_k", "snark_point_dbl_k", "icicle_snark_tpu_torch/csrc/precompute.cu",
    "icicle_snark_tpu/ops/msm.py:431",
)
POINT_TO_AFFINE = Kernel(
    "point_to_affine", "snark_point_to_affine",
    "icicle_snark_tpu_torch/csrc/affine_batch.cuh; icicle_snark_tpu_torch/csrc/precompute.cu",
    "icicle_snark_tpu/ops/msm.py:414",
)
PROBE = Kernel(
    "probe_chain", "snark_probe_chain", "icicle_snark_tpu_torch/csrc/probe.cu",
    "tools/pallas_microbench.py:53; tools/vpu_ceiling_probe.py:105",
)
FIELD_POW = Kernel(
    "field_pow", "snark_field_pow", "icicle_snark_tpu_torch/csrc/field_pow.cu",
    "icicle_snark_tpu/fields/limbs.py:516",
)
FIELD_REDUCE = Kernel(
    "field_reduce", "snark_field_reduce",
    "icicle_snark_tpu_torch/csrc/field_reduce.cu; icicle_snark_tpu_torch/csrc/field_product.cuh",
    "icicle_snark_tpu/ops/vec_ops.py:68; icicle_snark_tpu/ops/vec_ops.py:80",
)
FIXED_BASE = Kernel(
    "fixed_base_msm", "snark_fixed_base_msm",
    "icicle_snark_tpu_torch/csrc/fixed_base.cu; icicle_snark_tpu_torch/csrc/fq_lazy.cuh",
    "icicle_snark_tpu/setup/fast_setup.py:81",
)
# The other curves (bls12-377, bls12-381, bw6-761)
FIELD_VEC_N = Kernel(
    "field_vec_n", "snark_field_vec_n", "icicle_snark_tpu_torch/csrc/field_vec_n.cu",
    "icicle_snark_tpu/curves/device.py:41",
)
_MSM_N_SOURCES = "; ".join(f"icicle_snark_tpu_torch/csrc/msm_{c}.cu"
                           for c in ("bls12_377", "bls12_381", "bw6_761"))
MSM_ACCUMULATE_N = Kernel(
    "msm_accumulate_n", "snark_msm_accumulate_n", _MSM_N_SOURCES,
    "icicle_snark_tpu/curves/device.py:255; icicle_snark_tpu/ops/msm.py:609",
)
MSM_REDUCE_N = Kernel(
    "msm_reduce_n", "snark_msm_reduce_n",
    "icicle_snark_tpu_torch/csrc/msm_kernels_n.cuh; " + _MSM_N_SOURCES,
    "icicle_snark_tpu/curves/device.py:255; icicle_snark_tpu/ops/msm.py:701",
)
NTT_N = Kernel(
    "ntt_stage_n", "snark_ntt_stage_n",
    "icicle_snark_tpu_torch/csrc/ntt_n.cu; icicle_snark_tpu_torch/csrc/ntt_radix.cuh",
    "icicle_snark_tpu/ops/ntt.py:180",
)
NTT_RADIX_N = Kernel(
    "ntt_radix_n", "snark_ntt_radix_n",
    "icicle_snark_tpu_torch/csrc/ntt_n.cu; icicle_snark_tpu_torch/csrc/ntt_radix.cuh",
    "icicle_snark_tpu/ops/ntt.py:158; icicle_snark_tpu/ops/ntt.py:180",
)
FIELD_POW_N = Kernel(
    "field_pow_n", "snark_field_pow_n", "icicle_snark_tpu_torch/csrc/field_pow_n.cu",
    "icicle_snark_tpu/fields/limbs.py:516",
)
FIELD_REDUCE_N = Kernel(
    "field_reduce_n", "snark_field_reduce_n",
    "icicle_snark_tpu_torch/csrc/field_reduce_n.cu; icicle_snark_tpu_torch/csrc/field_product.cuh",
    "icicle_snark_tpu/ops/vec_ops.py:68; icicle_snark_tpu/ops/vec_ops.py:80",
)
NTT_BLOCK_N = Kernel(
    "ntt_block_n", "snark_ntt_block_n",
    "icicle_snark_tpu_torch/csrc/ntt_block_n.cu; icicle_snark_tpu_torch/csrc/ntt_block_n.cuh",
    "icicle_snark_tpu/ops/ntt.py:158; icicle_snark_tpu/ops/ntt.py:180",
)
# The sharded prove (parallel/)
FOUR_STEP = Kernel(
    "four_step_twiddle", "snark_four_step",
    "icicle_snark_tpu_torch/csrc/four_step.cu; icicle_snark_tpu_torch/csrc/four_step.cuh",
    "icicle_snark_tpu/parallel/ntt_dist.py:70",
)
# The witness ingest (prover/pipeline.py read_witness)
WITNESS_LIMBS = Kernel(
    "witness_limbs", "snark_witness_limbs", "icicle_snark_tpu_torch/csrc/witness_limbs.cu",
    "icicle_snark_tpu/fields/limbs.py:153; icicle_snark_tpu/prover/pipeline.py:371",
)
# The MSM's bucket sort (ops/msm.py sort_windows): the pairs, then cub's radix
# sort, whose kernels the source puts in the namespace msm_sort
MSM_SORT_KEYS = Kernel(
    "msm_sort_keys", "snark_msm_sort_keys", "icicle_snark_tpu_torch/csrc/msm_sort.cu",
    "icicle_snark_tpu/ops/msm.py:167; icicle_snark_tpu/ops/msm.py:594",
)
MSM_SORT = Kernel(
    "msm_sort", "snark_msm_sort", "icicle_snark_tpu_torch/csrc/msm_sort.cu",
    "icicle_snark_tpu/ops/msm.py:653; icicle_snark_tpu/ops/msm.py:664",
)
ALL = (FIELD_VEC, R1CS, NTT, MSM_ACCUMULATE, MSM_REDUCE,
       NTT_BLOCK, POINT_ADD, POINT_DBL_K, POINT_TO_AFFINE, PROBE,
       FIELD_POW, FIELD_REDUCE, FIXED_BASE,
       FIELD_VEC_N, MSM_ACCUMULATE_N, MSM_REDUCE_N, NTT_N, FOUR_STEP,
       FIELD_POW_N, FIELD_REDUCE_N, NTT_BLOCK_N, NTT_RADIX, NTT_RADIX_N, WITNESS_LIMBS,
       MSM_SORT_KEYS, MSM_SORT)


def reset_counts():
    for k in ALL:
        k.launches = 0
        k.variants = {}


def counts() -> dict:
    return {k.name: k.launches for k in ALL}
