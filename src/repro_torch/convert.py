"""Load the JAX reference's parameters into the port.

:func:`params_from_numpy` turns the reference's parameter pytree, taken
as numpy arrays (``jax.tree.map(np.asarray, params)``), into a state
dict for :class:`repro_torch.models.lm.LM`: nested dict keys join with
``.``, tuple entries (TT cores) become indices, and the stacked
``[L, ...]`` leaves under ``layers`` split into ``layers.<l>.<...>``.
Layouts are unchanged (``Dense.w`` stays ``[d_in, d_out]``, cores keep
their shapes), so both packages compute the same function from the same
numbers.  This module imports neither JAX nor the reference: it only
walks dicts, tuples and arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_numpy(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """State dict of host tensors for ``LM(cfg)`` from the reference's
    numpy parameter tree; ``model.load_state_dict(...)`` copies each one
    onto the model's device."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    sd: dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        if name.startswith("layers."):
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"num_layers {cfg.num_layers}")
            rest = name[len("layers."):]
            for li in range(cfg.num_layers):
                sd[f"layers.{li}.{rest}"] = torch.from_numpy(
                    np.array(arr[li]))
        else:
            sd[name] = torch.from_numpy(np.array(arr))
    return sd
