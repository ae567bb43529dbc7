"""The port's runtime (device policy on torch), configuration structs and
error taxonomy against the JAX package's: the same classes, fields and
defaults; "CUDA" without a card raises DeviceError, with no fallback."""

import dataclasses
import enum

import pytest
import torch

from icicle_snark_tpu import config as jcfg
from icicle_snark_tpu import errors as jerrors
from icicle_snark_tpu_torch import config as cfg
from icicle_snark_tpu_torch import errors
from icicle_snark_tpu_torch import runtime as rt

# Several test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)


@pytest.fixture
def cpu_runtime():
    """The runtime set to the CPU for one test, then back to its default."""
    saved = rt._default
    rt.set_device("CPU")
    yield
    rt._default = saved


def test_device_introspection(cpu_runtime):
    assert rt.get_device() == "cpu"
    assert rt.default_device() == torch.device("cpu")
    assert "cpu" in rt.available_devices()
    props = rt.device_properties()
    assert props == rt.DeviceProperties(using_host_memory=True, num_memory_regions=1,
                                        supports_pinned_memory=False)


def test_warmup_and_sync(cpu_runtime):
    rt.warmup()
    rt.sync()


def test_cuda_without_a_card_raises():
    """No fallback: selecting CUDA on a machine without a card raises, and
    the default device (CUDA) refuses to hand out a device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    saved = rt._default
    try:
        with pytest.raises(errors.DeviceError):
            rt.set_device("CUDA")
        assert rt.get_device() == saved.type
        rt._default = torch.device("cuda")
        with pytest.raises(errors.DeviceError):
            rt.default_device()
        with pytest.raises(errors.DeviceError):
            rt.warmup()
        assert rt.available_devices() == ["cpu"]
    finally:
        rt._default = saved


def test_unknown_device_raises():
    with pytest.raises(errors.DeviceError):
        rt.set_device("TPU")


def test_domain_defaults_to_the_runtime_device(cpu_runtime):
    from icicle_snark_tpu_torch.ops import ntt

    dom = ntt.initialize_domain(2)
    assert dom.tw_fwd.device.type == "cpu"
    ntt.release_domain(2)


@pytest.mark.parametrize("name", ["NTTDir", "Ordering", "MSMConfig", "NTTConfig",
                                  "VecOpsConfig"])
def test_config_matches_jax(name):
    """The same fields with the same defaults (enum members by name and
    value), or the same enum members."""
    def plain(v):
        return (type(v).__name__, v.name, v.value) if isinstance(v, enum.Enum) else v

    def fields(cls):
        return [(f.name, plain(f.default if f.default is not dataclasses.MISSING
                               else f.default_factory())) for f in dataclasses.fields(cls)]

    ours, theirs = getattr(cfg, name), getattr(jcfg, name)
    if dataclasses.is_dataclass(ours):
        assert fields(ours) == fields(theirs)
    else:
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]


def test_config_defaults():
    m = cfg.MSMConfig()
    assert m.signed and m.c == 0 and m.chunk == 32 and m.precompute_factor == 1
    n = cfg.NTTConfig()
    assert n.ordering is cfg.Ordering.NN and n.coset_gen is None and not n.columns_batch
    v = cfg.VecOpsConfig()
    assert v.batch_size == 1 and v.ext == {}


@pytest.mark.parametrize("name", ["DeviceError", "InvalidArgument", "FileFormatError",
                                  "AllocationError"])
def test_error_taxonomy_matches_jax(name):
    ours, theirs = getattr(errors, name), getattr(jerrors, name)
    assert issubclass(ours, errors.IcicleSnarkError)
    assert issubclass(theirs, jerrors.IcicleSnarkError)
    assert ours.__mro__[1].__name__ == theirs.__mro__[1].__name__
