"""The reference's argument `assert`s that the port raises as typed errors.

Eight `assert` statements of the JAX package guard a caller's bad input.
The port keeps each check but raises a typed exception instead (a check
that `python -O` cannot strip). Each site is called here with the same bad
input in both packages, and each package's exception type is pinned: the
JAX package's AssertionError, the port's TypeError or ValueError. The
device loop's site runs on CPU engines, as the port's device-loop tests
run it.
"""
import importlib

import pytest
import torch

torch.set_num_threads(1)

PACKAGES = {"jax": "foundationdb_tpu", "port": "foundationdb_tpu_torch"}


def mod(pkg, name):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def small_cfg(pkg):
    return mod(pkg, "ops.conflict_kernel").KernelConfig(
        key_words=2, capacity=1024, max_reads=64, max_writes=64, max_txns=32)


def key_range_of_str(pkg):
    mod(pkg, "core.types").KeyRange("a", b"b")


def atomic_op_of_a_set(pkg):
    types = mod(pkg, "core.types")
    types.CommitTransaction().atomic_op(b"k", b"v", types.MutationType.SET_VALUE)


def unsorted_split_keys(pkg):
    mod(pkg, "core.keyshard").KeyShardMap([b"b", b"a"])


def empty_split_key(pkg):
    mod(pkg, "core.keyshard").KeyShardMap([b""])


def uniform_past_256_shards(pkg):
    mod(pkg, "core.keyshard").KeyShardMap.uniform(257)


def flip_not_above_newest(pkg):
    ks = mod(pkg, "core.keyshard")
    epoched = ks.EpochedKeyShardMap(ks.KeyShardMap.uniform(2), flip_version=100)
    epoched.flip(ks.KeyShardMap.uniform(4), 100)


def dispatch_unit_over_queue_slots(pkg):
    dl = mod(pkg, "ops.device_loop")
    cfg = small_cfg(pkg)
    kw = {"device": "cpu"} if pkg == "port" else {}
    eng = dl.DeviceLoopEngine(cfg, queue_slots=2, **kw)
    eng._dispatch_unit(cfg, [[{"gc": 0}]] * 3)


def pipeline_depth_zero(pkg):
    mod(pkg, "pipeline.resolver_pipeline").ResolverPipeline(None, depth=0)


#: site -> (the JAX package's line, JAX's exception, the port's exception)
SITES = {
    key_range_of_str: ("core/types.py:66 KeyRange.__post_init__", AssertionError, TypeError),
    atomic_op_of_a_set: ("core/types.py:219 CommitTransaction.atomic_op", AssertionError,
                         ValueError),
    unsorted_split_keys: ("core/keyshard.py:38 KeyShardMap.__init__", AssertionError,
                          ValueError),
    empty_split_key: ("core/keyshard.py:39 KeyShardMap.__init__", AssertionError, ValueError),
    uniform_past_256_shards: ("core/keyshard.py:48 KeyShardMap.uniform", AssertionError,
                              ValueError),
    flip_not_above_newest: ("core/keyshard.py:148 EpochedKeyShardMap.flip", AssertionError,
                            ValueError),
    dispatch_unit_over_queue_slots: ("ops/device_loop.py:327 DeviceLoopEngine._dispatch_unit",
                                     AssertionError, ValueError),
    pipeline_depth_zero: ("pipeline/resolver_pipeline.py:255 ResolverPipeline.__init__",
                          AssertionError, ValueError),
}


@pytest.mark.parametrize("site", list(SITES), ids=lambda f: f.__name__)
def test_raise_site_types_in_both_packages(site):
    where, jax_type, port_type = SITES[site]
    with pytest.raises(jax_type) as jax_err:
        site("jax")
    assert type(jax_err.value) is jax_type, where
    with pytest.raises(port_type) as port_err:
        site("port")
    assert type(port_err.value) is port_type, where


def test_eight_sites_pinned():
    assert len(SITES) == 8
    assert len({where for where, _, _ in SITES.values()}) == 8


def test_port_refuses_a_gc_horizon_before_the_last_chunk():
    """The port's loop also refuses a unit whose GC horizon rides a chunk
    but the last (the captured program applies it after the last chunk
    only); the JAX package does not check this."""
    dl = mod("port", "ops.device_loop")
    cfg = small_cfg("port")
    eng = dl.DeviceLoopEngine(cfg, queue_slots=2, device="cpu")
    with pytest.raises(ValueError, match="GC horizon"):
        eng._dispatch_unit(cfg, [[{"gc": 5}], [{"gc": 0}]])
