"""The port's checkpoints against the reference's, and resume.

* A checkpoint the port writes restores in the reference
  (``repro.checkpoint.store.restore`` into the reference's template
  ``{"params": ..., "opt": OptState(m, v, step, master)}``), and the
  reverse, every leaf equal bit for bit: the smoke LMs of
  ``paper_atis_tt`` and ``zamba2_7b`` (stacked layers, TT core tuples,
  the hybrid's ``shared.*``), with f32 moments and with bf16 moments
  and f32 master weights (a bf16 leaf, stored as its ``uint16`` view).
* A torn ``.tmp`` directory is ignored, ``retain`` keeps the newest N,
  and a manager snapshot does not change when AdamW steps in place after
  ``maybe_save`` returned.
* The train entry point in f32 on the CPU: a run that dies after step 3
  resumes from its checkpoint, and steps 3-5 give the uninterrupted
  run's losses exactly (the CPU is deterministic and the restored state
  is the saved one, bit for bit).
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim.adamw import AdamW, OptState  # noqa: E402

ARCHS = ["paper_atis_tt", "zamba2_7b"]
#: (moment dtype, master weights)
OPTS = [("float32", False), ("bfloat16", True)]


def _reference_tree(arch_id):
    """The reference smoke LM's parameter tree as seeded numpy arrays,
    and the port's config for the same model."""
    jarch, arch = jbase.get(arch_id), tbase.get(arch_id)
    jm = JLM(jarch.smoke(jarch.tnn_default))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    rng = np.random.default_rng(len(arch_id))
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    return tree, arch.smoke(arch.tnn_default)


def _moments(tree, rng, dtype):
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32).astype(dtype), tree)


def _reference_state(tree, moment_dtype, master, seed=1):
    """A reference train state with every leaf non-trivial."""
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if moment_dtype == "bfloat16" else np.float32
    return {"params": jax.tree.map(jnp.asarray, tree),
            "opt": JAdamW(moment_dtype=getattr(jnp, moment_dtype),
                          master_weights=master).init(tree)._replace(
                m=jax.tree.map(jnp.asarray, _moments(tree, rng, npdt)),
                v=jax.tree.map(jnp.asarray, _moments(tree, rng, npdt)),
                step=jnp.asarray(7, jnp.int32),
                master=(jax.tree.map(jnp.asarray,
                                     _moments(tree, rng, np.float32))
                        if master else None))}


def _port_state(tree, cfg, moment_dtype, master, zero=False):
    """The port's train state for the same model: ``zero`` gives an
    all-zeros template, otherwise the values of ``_reference_state``."""
    jstate = _reference_state(tree, moment_dtype, master)

    def sd(t, dtype=torch.float32):
        out = {n: v.to(dtype) for n, v in params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), t),
            cfg).items()}
        return {n: torch.zeros_like(v) for n, v in out.items()} if zero \
            else out

    mdt = getattr(torch, moment_dtype)
    opt = jstate["opt"]
    return {"params": sd(jstate["params"]),
            "opt": OptState(m=sd(opt.m, mdt), v=sd(opt.v, mdt),
                            step=torch.tensor(0 if zero else 7,
                                              dtype=torch.int32),
                            master=sd(opt.master) if master else None)}


def _leaves_equal(port_state, jtree, cfg):
    """Every port tensor equals its reference leaf bit for bit (bf16
    compared through its exact f32 value)."""
    want = jax.tree_util.tree_leaves(jtree)
    got = [s for s in store.leaf_slots(port_state)]
    assert len(got) == len(want)
    for i, (slot, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = torch.stack([t.detach() for t in slot]) if len(slot) > 1 \
            else slot[0].detach()
        assert str(g.dtype).split(".")[-1] == str(w.dtype), i
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32), err_msg=str(i))


@pytest.mark.parametrize("moment_dtype,master", OPTS)
@pytest.mark.parametrize("arch_id", ARCHS)
def test_port_checkpoint_restores_in_reference(arch_id, moment_dtype,
                                               master, tmp_path):
    tree, cfg = _reference_tree(arch_id)
    state = _port_state(tree, cfg, moment_dtype, master)
    store.save(str(tmp_path), 7, state, extra={"who": "port"})
    template = jax.tree.map(jnp.zeros_like,
                            _reference_state(tree, moment_dtype, master))
    step, got = jstore.restore(str(tmp_path), template)
    assert step == 7 and int(got["opt"].step) == 7
    _leaves_equal(state, got, cfg)
    meta = json.loads((tmp_path / "step_00000007" / "meta.json").read_text())
    assert meta["device_count"] == (torch.cuda.device_count() or 1)
    assert meta["extra"] == {"who": "port"}
    if moment_dtype == "bfloat16":
        assert "bfloat16" in meta["dtypes"]


@pytest.mark.parametrize("moment_dtype,master", OPTS)
@pytest.mark.parametrize("arch_id", ARCHS)
def test_reference_checkpoint_restores_in_port(arch_id, moment_dtype,
                                               master, tmp_path):
    tree, cfg = _reference_tree(arch_id)
    jstate = _reference_state(tree, moment_dtype, master)
    jstore.save(str(tmp_path), 7, jstate)
    template = _port_state(tree, cfg, moment_dtype, master, zero=True)
    ids = [id(t) for s in store.leaf_slots(template) for t in s]
    step, got = store.restore(str(tmp_path), template)
    assert step == 7 and got is template
    assert [id(t) for s in store.leaf_slots(got) for t in s] == ids  # in place
    _leaves_equal(got, jstate, cfg)


def test_restore_refuses_a_mismatched_template(tmp_path):
    tree, cfg = _reference_tree("paper_atis_tt")
    state = _port_state(tree, cfg, "float32", False)
    store.save(str(tmp_path), 1, state)
    with pytest.raises(ValueError, match="leaves"):
        store.restore(str(tmp_path), {"params": state["params"]})
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path / "none"), state)


def _small_state(value=0.0):
    params = {"w": torch.full((3, 2), value), "layers.0.b": torch.zeros(2),
              "layers.1.b": torch.ones(2)}
    return {"params": params, "opt": AdamW().init(params)}


def test_torn_tmp_is_ignored_and_retain_keeps_newest(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        store.save(root, s, _small_state(float(s)))
    # a writer that died before its rename, and one before COMMITTED
    store.save(root, 9, _small_state(9.0))
    os.rename(os.path.join(root, "step_00000009"),
              os.path.join(root, "step_00000009.tmp"))
    os.makedirs(os.path.join(root, "step_00000008"))
    assert store.latest_step(root) == 4
    step, got = store.restore(root, _small_state())
    assert step == 4 and float(got["params"]["w"][0, 0]) == 4.0
    store.retain(root, keep=2)
    assert sorted(os.listdir(root)) == ["step_00000003", "step_00000004",
                                        "step_00000008", "step_00000009.tmp"]
    with pytest.raises(FileNotFoundError, match="not committed"):
        store.restore(root, _small_state(), step=8)


def test_manager_snapshot_survives_in_place_updates(tmp_path, monkeypatch):
    """``maybe_save`` returns with a host copy taken: an AdamW step that
    writes the parameters and moments in place before the writer thread
    runs does not reach the checkpoint."""
    release = threading.Event()
    save = store.save

    def slow_save(*a, **k):
        release.wait(timeout=30)
        return save(*a, **k)

    monkeypatch.setattr(store, "save", slow_save)
    opt = AdamW(lr=0.1, warmup_steps=1)
    state = _small_state(1.0)
    saved = {n: t.clone() for n, t in state["params"].items()}
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    try:
        assert mgr.maybe_save(1, state, force=True)
        grads = {n: torch.ones_like(t) for n, t in state["params"].items()}
        params, new_opt, _ = opt.update(grads, state["opt"], state["params"])
        assert not torch.equal(params["w"], saved["w"])  # changed in place
        assert not mgr.maybe_save(3, state)
        release.set()
        mgr.wait()
    finally:
        release.set()
        mgr.close()
    assert not mgr._worker.is_alive()
    step, got = store.restore(str(tmp_path), _small_state())
    assert step == 1 and int(got["opt"].step) == 0
    for n, t in saved.items():
        assert torch.equal(got["params"][n], t), n
    assert all(float(t.abs().sum()) == 0 for t in got["opt"].m.values())


class _Died(RuntimeError):
    pass


def test_resume_gives_the_uninterrupted_losses(tmp_path, monkeypatch):
    build = steps_lib.build_model
    monkeypatch.setattr(steps_lib, "build_model", lambda *a, **k: build(
        *a, compute_dtype=torch.float32, **k))
    kw = dict(smoke=True, tnn=True, steps=6, global_batch=2, seq_len=16,
              lr=3e-3, device="cpu", log_every=100, tnn_backend="cuda",
              ckpt_every=3)
    whole = train_cli.train("paper_atis_tt",
                            ckpt_dir=str(tmp_path / "whole"), **kw)

    def die(step, metrics):
        if step == 3:
            raise _Died("step 3 lost")

    with pytest.raises(_Died):
        train_cli.train("paper_atis_tt", ckpt_dir=str(tmp_path / "cut"),
                        on_step=die, **kw)
    assert store.latest_step(str(tmp_path / "cut")) == 3
    resumed = train_cli.train("paper_atis_tt",
                              ckpt_dir=str(tmp_path / "cut"), **kw)
    assert resumed["start_step"] == 3 and len(resumed["losses"]) == 3
    assert resumed["losses"] == whole["losses"][3:]
    assert resumed["grad_norms"] == whole["grad_norms"][3:]
    assert int(resumed["state"]["opt"].step) == 6
    for n, t in whole["state"]["params"].items():
        assert torch.equal(resumed["state"]["params"][n], t), n
    assert dataclasses.is_dataclass(resumed["cfg"])
