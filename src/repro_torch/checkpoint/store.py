"""Checkpoint store: atomic, resumable, in the reference's layout.

Port of ``src/repro/checkpoint/store.py``.  One directory per step::

    <root>/step_00000120/
        meta.json            # shapes, dtypes, step, device count, extra
        shard_00000.npz      # every leaf, as one full array each
        COMMITTED            # written last: its absence means torn

* **Atomicity**: a writer fills ``step_X.tmp`` and renames it after the
  ``COMMITTED`` marker; :func:`latest_step` and :func:`restore` only read
  committed steps.
* **Restart**: ``latest_step`` + ``restore`` resume from the last
  committed step; the data pipeline is a pure function of the step, so no
  iterator state is stored.
* **The reference's layout, leaf for leaf.**  The npz keys
  ``leaf_00000...`` follow ``jax.tree_util`` flatten order of the
  reference's state ``{"opt": OptState(m, v, step, master), "params":
  ...}``: dict keys sorted, ``OptState`` fields in order (``master=None``
  gives no leaves), core tuples in index order, and the per-layer tensors
  stacked into ``[L, ...]`` leaves (the tree
  :func:`repro_torch.convert.to_numpy_tree` builds).  A state dict of the
  port (``{name: tensor}``, names joined with ``.``, layers as
  ``layers.<l>.<...>``) is walked in that order by :func:`leaf_slots`, a copy
  of the flatten order kept here so the port imports nothing of the
  reference.  bf16 is stored as a ``uint16`` view, as the reference
  stores it.  A checkpoint written by either package restores in the
  other (``tests/test_torch_checkpoint.py``).

:func:`restore` copies into the template's own tensors, in place: a
template's parameters are the model's, so a restore updates the model.
The reference's elastic re-mesh (sharded restore onto another mesh)
waits for the distributed slice (ROADMAP.md, queue A item 8).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import telemetry as tm


def _key(i: int) -> str:
    return f"leaf_{i:05d}"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _nest(flat: dict) -> dict:
    """A state dict as the reference's nested tree whose leaves are
    *slots*: a list of the port tensors one reference leaf holds (one, or
    one per layer for a stacked ``layers.*`` leaf)."""
    root: dict = {}
    stacks: dict[tuple, dict[int, torch.Tensor]] = {}

    def put(path, slot):
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if path[-1] in node:
            raise ValueError(f"duplicate checkpoint leaf {'.'.join(path)}")
        node[path[-1]] = slot

    for name, t in flat.items():
        parts = tuple(name.split("."))
        if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
            stacks.setdefault(("layers",) + parts[2:], {})[int(parts[1])] = t
        else:
            put(parts, [t])
    depths = {len(by_layer) for by_layer in stacks.values()}
    if len(depths) > 1:
        raise ValueError(f"layers.* leaves have differing depths {depths}")
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"layers.*.{'.'.join(path[1:])}: missing "
                             "layers")
        put(path, [by_layer[i] for i in range(len(by_layer))])
    return root


def _walk(node) -> list[list]:
    """Slots of a nested tree in flatten order: sorted keys, and dicts
    keyed ``"0".."n-1"`` (the reference's core tuples) in index order."""
    if isinstance(node, list):
        return [node]
    keys = (sorted(node, key=int) if node and all(k.isdigit() for k in node)
            else sorted(node))
    return [s for k in keys for s in _walk(node[k])]


def leaf_slots(tree) -> list[list]:
    """Every reference leaf of ``tree`` (dicts, tuples, ``NamedTuple``s,
    None and tensors; a dict of tensors is a state dict) as a slot."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [[tree]]
    if isinstance(tree, dict):
        if tree and all(torch.is_tensor(v) for v in tree.values()):
            return _walk(_nest(tree))
        return [s for k in sorted(tree) for s in leaf_slots(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for x in tree for s in leaf_slots(x)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _to_numpy(slot: list) -> np.ndarray:
    t = slot[0] if len(slot) == 1 else torch.stack(
        [s.detach().cpu() for s in slot])
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x)).to(like.dtype)


def _device_count() -> int:
    return torch.cuda.device_count() or 1


def save(root: str, step: int, state, *, extra: dict | None = None) -> str:
    """Write a checkpoint of ``state`` (the train loop's ``{"params":
    ..., "opt": OptState}``, or any tree :func:`leaf_slots` walks)."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    slots = leaf_slots(state)
    arrays = {_key(i): _to_numpy(s) for i, s in enumerate(slots)}
    np.savez(os.path.join(tmp, "shard_00000.npz"), **arrays)
    meta = {
        "step": step,
        # informational only: restore() follows the caller's template
        "treedef": "{opt: OptState(m, v, step, master), params}",
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [_dtype_name(s[0].dtype) for s in slots],
        "device_count": _device_count(),
        "process_count": 1,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, "COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(root: str, like, *, step: int | None = None) -> tuple[int, object]:
    """Restore step ``step`` (default: the latest committed) into the
    tensors of ``like``, in place, and return ``(step, like)``.  Each
    leaf is checked against its template's shape; dtypes convert to the
    template's (a bf16 leaf from its ``uint16`` view)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    path = os.path.join(root, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"checkpoint {path} is not committed")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            saved_devices = json.load(f).get("device_count")
    except (OSError, ValueError):
        saved_devices = None
    if saved_devices is not None and saved_devices != _device_count():
        tm.event("checkpoint.elastic_restore", step=step,
                 saved_devices=saved_devices,
                 restore_devices=_device_count())
    slots = leaf_slots(like)
    with np.load(os.path.join(path, "shard_00000.npz")) as data:
        if len(data.files) != len(slots):
            raise ValueError(f"{path} holds {len(data.files)} leaves, the "
                             f"template {len(slots)}")
        with torch.no_grad():
            for i, slot in enumerate(slots):
                x = _from_numpy(data[_key(i)], slot[0])
                want = tuple(slot[0].shape)
                if len(slot) > 1:
                    want = (len(slot),) + want
                if tuple(x.shape) != want:
                    raise ValueError(f"leaf {i}: saved {tuple(x.shape)}, "
                                     f"template {want}")
                for t, src in zip(slot, x if len(slot) > 1 else [x]):
                    t.copy_(src)
    return step, like


def retain(root: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(root):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(root)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(root, n, "COMMITTED")))
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)
