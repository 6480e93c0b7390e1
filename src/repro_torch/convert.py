"""Move parameters between the JAX reference's tree and the port.

:func:`params_from_numpy` turns the reference's parameter pytree, taken
as numpy arrays (``jax.tree.map(np.asarray, params)``), into a state
dict for :class:`repro_torch.models.lm.LM` or
:class:`repro_torch.models.encdec.EncDec`: nested dict keys join with
``.``, tuple entries (TT cores) become indices, and the stacked
``[L, ...]`` leaves under ``layers`` (``num_layers``), ``enc_layers``
(``num_enc_layers``) and ``dec_layers`` (``num_dec_layers``) split into
``<stack>.<l>.<...>``.
:func:`to_numpy_tree` is its reverse, for a state dict or anything keyed
like one (gradients, optimizer moments): it rebuilds the reference's
nested tree with the per-layer tensors stacked again.  Every other
leaf (``embed``, ``lm_head``, ``ln_f``, ``ln_enc``, the hybrid's
``shared.*``) is one tensor in both.
:func:`reference_ndim` is the rank a port tensor has as a reference leaf
(one more under a stack), which the optimizer's weight-decay rule
reads: every per-layer ``ln*.scale`` of a stack is a slice of a 2-D leaf
and decayed as there; a MoE layer's router ``layers.<l>.mlp.router.w`` and its
expert-stacked cores ``layers.<l>.mlp.experts.<gate|up|down>.cores.<i>``
(``[E, ...]``) are slices of ``[L, ...]`` leaves, decayed as there.  Layouts are unchanged (``Dense.w`` stays ``[d_in, d_out]``, cores
keep their shapes), so both packages compute the same function from the
same numbers.  This module imports neither JAX nor the reference: it only
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


#: the stacked leaves' prefixes and the config field that counts each
STACKS = {"layers": "num_layers", "enc_layers": "num_enc_layers",
          "dec_layers": "num_dec_layers"}


def _stack(name: str) -> str | None:
    """The stack a (reference or port) name lies in, if any."""
    head = name.split(".", 1)[0]
    return head if head in STACKS and "." in name else None


def params_from_numpy(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """State dict of host tensors for ``LM(cfg)`` or ``EncDec(cfg)`` from
    the reference's numpy parameter tree; ``model.load_state_dict(...)``
    copies each one onto the model's device."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    sd: dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        stack = _stack(name)
        if stack is None:
            sd[name] = torch.from_numpy(np.array(arr))
            continue
        depth = getattr(cfg, STACKS[stack])
        if arr.shape[0] != depth:
            raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                             f"{STACKS[stack]} {depth}")
        rest = name[len(stack) + 1:]
        for li in range(depth):
            sd[f"{stack}.{li}.{rest}"] = torch.from_numpy(np.array(arr[li]))
    return sd


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """Rank of the reference leaf that holds the port tensor ``name``:
    per-layer tensors are slices of a stacked ``[L, ...]`` leaf."""
    return t.dim() + 1 if _stack(name) is not None else t.dim()


def _tupled(tree):
    """Dicts keyed ``"0".."n-1"`` become tuples (the reference's core
    tuples), recursively."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _tupled(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return tuple(tree[str(i)] for i in range(len(tree)))
    return tree


def to_numpy_tree(sd: dict[str, torch.Tensor], cfg) -> dict:
    """The reference's nested numpy tree from a port state dict (or
    gradients / moments keyed the same way): per-layer tensors stacked
    along a leading axis of their stack's depth.  bf16 tensors come back
    as f32 (numpy has no bf16)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    flat: dict[str, np.ndarray] = {}
    per_layer: dict[str, list] = {}
    for name, t in sd.items():
        stack = _stack(name)
        if stack is None:
            flat[name] = host(t)
            continue
        li, rest = name[len(stack) + 1:].split(".", 1)
        depth = getattr(cfg, STACKS[stack])
        per_layer.setdefault(f"{stack}.{rest}", [None] * depth)[int(li)] = t
    for key, ts in per_layer.items():
        if any(t is None for t in ts):
            raise ValueError(f"{key}: missing layers")
        flat[key] = np.stack([host(t) for t in ts])
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return _tupled(tree)
