"""Parameter bridge: the JAX package's weights, as numpy, into the port.

The JAX side converts its parameter pytree leaf by leaf with
``np.asarray``; :func:`params_from_jax` turns that tree of numpy arrays
into the port's dict of tensors.  The layouts are the same on both sides
(layers stacked ``[L, ...]``; a multi-codebook ``embed`` ``[cb, V, d]`` and
``lm_head`` ``[d, cb * V]``; the VLM stub's ``frontend_proj`` ``[d, d]``; an
MLP without ``wg`` for sqrelu; an MoE layer's ``moe`` with its f32
``router`` ``[d, E]`` and experts ``[E, ...]``; the hybrid's ``shared``
block with ``w_concat`` ``[2d, d]``), so the bridge checks names and
converts dtypes: bfloat16 arrives as ``ml_dtypes.bfloat16`` and crosses
as its ``uint16`` bit pattern, as ``repro/checkpoint/serialization.py``
stores it, so no value is rounded on the way.

:func:`train_state_from_jax` carries a whole reference ``TrainState`` (as
numpy) over: the parameters, the optimizer state (AdamW's ``mu``/``nu``
or SGD's ``velocity``, each a tree like the parameters, and its ``step``)
and the error-feedback residual, so both packages can train from one
state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.compress import ErrorFeedbackState
from repro_torch.runtime.train_loop import TrainState

TOP = {"embed", "frontend_proj", "layers", "final_norm", "lm_head", "shared"}
LAYER = {"ln1", "ln2", "attn", "mlp"}
MOE_LAYER = {"ln1", "ln2", "attn", "moe"}
ATTN = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
MLP = {"wg", "wu", "wd"}
MOE = {"router", "wg", "wu", "wd"}
SHARED = {"w_concat", "ln1", "ln2", "attn", "mlp"}
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


def _check_keys(tree: Dict[str, Any], allowed: set, where: str,
                required: set = frozenset()) -> None:
    extra = set(tree) - allowed
    if extra:
        raise NotImplementedError(
            f"{where}: parameters {sorted(extra)} are not part of any "
            "family the port serves")
    missing = set(required) - set(tree)
    if missing:
        raise NotImplementedError(f"{where}: missing {sorted(missing)}")


def _check_block(tree: Dict[str, Any], keys: set, where: str) -> None:
    """An attention + FFN block (a layer, or the hybrid's shared block):
    exactly ``keys``, and the attention's, the MLP's or the MoE's names."""
    _check_keys(tree, keys, where, keys)
    _check_keys(tree["attn"], ATTN, f"{where}['attn']",
                {"wq", "wk", "wv", "wo"})
    if "moe" in tree:
        _check_keys(tree["moe"], MOE, f"{where}['moe']",
                    {"router", "wu", "wd"})
    else:
        _check_keys(tree["mlp"], MLP, f"{where}['mlp']", {"wu", "wd"})


def params_from_jax(tree: Dict[str, Any], device: Any = None
                    ) -> Dict[str, Any]:
    """The JAX package's parameter tree of any family it registers (numpy
    leaves) as the port's parameter dict on ``device`` (the card unless the
    caller names one).  The names of every subtree are checked; the MoE
    router stays f32 as it arrives."""
    device = resolve_device(device)
    _check_keys(tree, TOP, "params")
    layers = tree["layers"]
    if "mamba" in layers:
        _check_keys(layers, SSM_LAYER, "params['layers']", SSM_LAYER)
        _check_keys(layers["mamba"], MAMBA, "params['layers']['mamba']",
                    MAMBA)
    else:
        if "shared" in tree:
            raise NotImplementedError(
                "params: a 'shared' block belongs to the hybrid family, "
                "whose layers are Mamba2 blocks")
        _check_block(layers, MOE_LAYER if "moe" in layers else LAYER,
                     "params['layers']")
    if "shared" in tree:
        _check_block(tree["shared"], SHARED, "params['shared']")

    def conv(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return tensor_from_numpy(x, device)

    return conv(tree)


def train_state_from_jax(state: Any, device: Any = None) -> TrainState:
    """The JAX package's ``TrainState`` (numpy leaves; any object with its
    ``params``, ``opt_state``, ``ef`` and ``step``) as the port's, on
    ``device`` (the card unless the caller names one)."""
    device = resolve_device(device)
    opt = {k: (tensor_from_numpy(v, device) if k == "step"
               else params_from_jax(v, device))
           for k, v in state.opt_state.items()}
    ef = (None if state.ef is None else ErrorFeedbackState(
        residual=params_from_jax(state.ef.residual, device)))
    return TrainState(params=params_from_jax(state.params, device),
                      opt_state=opt, ef=ef,
                      step=tensor_from_numpy(state.step, device))
