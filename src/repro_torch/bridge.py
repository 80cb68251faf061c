"""Parameter bridge: the JAX package's weights, as numpy, into the port.

The JAX side converts its parameter pytree leaf by leaf with
``np.asarray``; :func:`params_from_jax` turns that tree of numpy arrays
into the port's dict of tensors.  The layouts are the same on both sides
(layers stacked ``[L, ...]``; a multi-codebook ``embed`` ``[cb, V, d]`` and
``lm_head`` ``[d, cb * V]``; the VLM stub's ``frontend_proj`` ``[d, d]``; an
MLP without ``wg`` for sqrelu), so the bridge checks names and converts
dtypes: bfloat16 arrives as ``ml_dtypes.bfloat16`` and crosses
as its ``uint16`` bit pattern, as ``repro/checkpoint/serialization.py``
stores it, so no value is rounded on the way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import TO_PORT

TOP = {"embed", "frontend_proj", "layers", "final_norm", "lm_head"}
LAYER = {"ln1", "ln2", "attn", "mlp"}
ATTN = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
MLP = {"wg", "wu", "wd"}
SSM_LAYER = {"ln", "mamba"}
MAMBA = {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
         "out_proj"}


def tensor_from_numpy(a: np.ndarray, device: Any = None) -> torch.Tensor:
    """One array to a tensor of the same dtype and bits, on ``device``
    (the card unless the caller names one)."""
    device = resolve_device(device)
    a = np.array(a)       # a writable, contiguous copy torch may own
    if a.dtype.name == "bfloat16":
        bits = a.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


#: parameters of the families still to port -> where ROADMAP queues them
NOT_PORTED = {"shared": TO_PORT["hybrid"], "moe": TO_PORT["moe"]}


def _check_keys(tree: Dict[str, Any], allowed: set, where: str) -> None:
    for name, item in NOT_PORTED.items():
        if name in tree:
            raise NotImplementedError(
                f"{where}: {name!r} belongs to a family the port does not "
                f"serve yet ({item})")
    extra = set(tree) - allowed
    if extra:
        raise NotImplementedError(
            f"{where}: parameters {sorted(extra)} belong to a family the "
            "port does not serve (it serves dense, vlm, audio and SSM)")


def params_from_jax(tree: Dict[str, Any], device: Any = None
                    ) -> Dict[str, Any]:
    """The JAX package's dense-, vlm-, audio- or SSM-family parameter tree
    (numpy leaves) as the port's parameter dict on ``device`` (the card unless
    the caller names one)."""
    device = resolve_device(device)
    _check_keys(tree, TOP, "params")
    layers = tree["layers"]
    if "mamba" in layers:
        _check_keys(layers, SSM_LAYER, "params['layers']")
        _check_keys(layers["mamba"], MAMBA, "params['layers']['mamba']")
    else:
        _check_keys(layers, LAYER, "params['layers']")
        _check_keys(layers["attn"], ATTN, "params['layers']['attn']")
        _check_keys(layers["mlp"], MLP, "params['layers']['mlp']")

    def conv(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return tensor_from_numpy(x, device)

    return conv(tree)
