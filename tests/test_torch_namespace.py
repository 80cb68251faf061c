"""The port's public namespace against the reference's: the root
package's ``__all__`` (less ``analysis``: branchlint checks the port from
the JAX package and is not ported) and lazy submodules, and each
subpackage's ``__all__`` (less ``distributed.shard_map``, which one host
process driving every shard has no use for, plus the names the port's
``distributed`` already exported), every name resolving to the port's own
object."""

import importlib

import numpy as np
import pytest
import torch

import repro
import repro_torch

SUBPACKAGES = [name for name in repro.__all__
               if name not in ("__version__", "analysis")]
#: names of a reference subpackage the port does not export, and names the
#: port exports beyond the reference's
MISSING = {"distributed": {"shard_map"}}
EXTRA = {"distributed": {"DeviceMesh", "all_gather", "broadcast", "psum",
                         "sanitize", "spec_for_param"}}


def test_root_namespace_matches_the_reference():
    assert repro_torch.__version__ == repro.__version__
    assert repro_torch.__all__ == [n for n in repro.__all__
                                   if n != "analysis"]
    assert dir(repro_torch) == sorted(repro_torch.__all__)
    for name in SUBPACKAGES:
        assert getattr(repro_torch, name) is importlib.import_module(
            f"repro_torch.{name}")
    with pytest.raises(AttributeError):
        repro_torch.analysis


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_match_the_reference(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    want = set(getattr(ref, "__all__", ()))
    got = set(getattr(port, "__all__", ()))
    assert want - got == MISSING.get(name, set())
    assert got - want == EXTRA.get(name, set())
    for attr in got:
        obj = getattr(port, attr)
        mod = getattr(obj, "__module__", None) or ""
        assert not mod.startswith(("repro.", "jax")), (name, attr, mod)


def test_kernels_bind_the_wrappers():
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_chunk_attention)
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    assert (K.flash_attention, K.paged_attention, K.paged_chunk_attention,
            K.ssd_scan) == (flash_attention, paged_attention,
                            paged_chunk_attention, ssd_scan)


def test_runtime_models_and_configs_names():
    from repro.configs import ASSIGNED_ARCHS as want
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import Model, decode_state_specs, init_params
    from repro_torch.runtime import (
        FaultTolerantTrainer, TrainState, build_train_step)
    from repro_torch.runtime.fault import FaultTolerantTrainer as F
    from repro_torch.runtime.train_loop import TrainState as T
    from repro_torch.runtime.train_loop import build_train_step as B
    assert ASSIGNED_ARCHS == want
    assert (FaultTolerantTrainer, TrainState, build_train_step) == (F, T, B)
    cfg = reduced(get_config("qwen2-1.5b"))
    a = init_params(cfg, torch.Generator().manual_seed(3))
    b = Model(cfg).init(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(
        torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)))
    specs = decode_state_specs(cfg, 2, 16)
    from repro.configs import get_config as jax_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import decode_state_specs as jax_specs
    ref = jax_specs(jax_reduced(jax_config("qwen2-1.5b")), 2, 16)
    assert {k: tuple(v[0]) for k, v in specs.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert {k: str(v[1]).split(".")[-1] for k, v in specs.items()} == {
        k: np.dtype(v.dtype).name for k, v in ref.items()}
