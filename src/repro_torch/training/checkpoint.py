"""Checkpoints: atomic, keep-N, resumable, in the reference's layout.

Port of ``repro.training.checkpoint``.  One directory per step::

    ckpt_dir/
      step_00000100/
        manifest.json        # step, leaf shapes and dtypes, extra
        arr_00000.npy ...    # one file per leaf
      step_00000200/ ...
      LATEST                 # atomic pointer file

A step is written to ``step_XXXXXXXX.tmp`` and published with
``os.replace``, so a crash mid-save never corrupts the latest checkpoint;
``LATEST`` is replaced the same way, and only the newest ``keep`` steps
stay.

The leaves are the reference's, in its flatten order: the state is first
laid out as the reference's tree (a training state's model through
:func:`repro_torch.interop.params_to_numpy`, its AdamW state through
:func:`repro_torch.interop.opt_state_to_numpy`, blocks stacked on a
leading layer axis), then flattened as JAX flattens a pytree (a dict by
sorted key, a tuple or list in order), so ``opt`` (``ef``, ``mu``, ``nu``,
``step``) comes before ``params``.  A checkpoint written by either package
restores in the other.  The reference records its tree structure and
ignores it at restore; the port writes ``null`` there.

A sharded state (a mesh train step's: DTensor parameters and moments) is
gathered before it is written, and only rank 0 of the process group writes,
while the others wait at a barrier, so every rank calls
:func:`save_checkpoint`.  :func:`restore_checkpoint` with ``shardings``
(``train_loop.state_shardings`` for any mesh, the one it was saved from or
another) reads each full array and keeps this rank's slice.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch import interop
from repro_torch.distributed import sharding as shd

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps"]


def _is_train_state(state) -> bool:
    return isinstance(state, dict) \
        and isinstance(state.get("params"), nn.Module) and "opt" in state


def _gathered(tree):
    """``tree`` with every DTensor gathered into its full tensor."""
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    return shd.full(tree)


def _is_sharded(state) -> bool:
    from torch.distributed.tensor import DTensor

    if _is_train_state(state):
        return any(isinstance(p, DTensor)
                   for p in state["params"].parameters())
    if isinstance(state, dict):
        return any(_is_sharded(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return any(_is_sharded(v) for v in state)
    return isinstance(state, DTensor)


@torch.no_grad()
def _reference_tree(state):
    """``state`` as the reference's pytree of numpy arrays (DTensors
    gathered: a collective every rank of their mesh joins)."""
    if _is_train_state(state):
        model = state["params"]
        out = {k: _reference_tree(v) for k, v in state.items()
               if k not in ("params", "opt")}
        out["params"] = interop.named_to_numpy(
            model, {n: shd.full(p) for n, p in model.named_parameters()})
        out["opt"] = interop.opt_state_to_numpy(model,
                                                _gathered(state["opt"]))
        return out
    if isinstance(state, dict):
        return {k: _reference_tree(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_reference_tree(v) for v in state)
    if isinstance(state, torch.Tensor):
        t = shd.full(state).detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return state if state is None else np.asarray(state)


def _flatten(tree) -> list:
    """Leaves in JAX's flatten order: dict keys sorted, sequences in order,
    ``None`` no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`_flatten`'s order."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return None if template is None else next(leaves)


def _placed(t: torch.Tensor, sharding):
    """``t`` (full) as ``sharding`` places it, or ``t`` itself with none."""
    return t if sharding is None else shd.shard(t, sharding)


@torch.no_grad()
def _to_port(template, tree, shardings=None):
    """``tree`` (the reference's layout, numpy) as ``template``'s type: a
    training state's model is loaded in place (with ``shardings``, each
    parameter replaced by a DTensor of this rank's slice) and its AdamW
    state rebuilt on the model's device; tensors take the template's dtype
    and device."""
    sh = shardings or {}
    if _is_train_state(template):
        model = template["params"]
        dev = next(model.parameters()).device
        out = {k: _to_port(template[k], tree[k], sh.get(k)) for k in template
               if k not in ("params", "opt")}
        if shardings is None:
            interop.load_params_(model, tree["params"])
        else:
            full = interop.named_from_numpy(model, tree["params"], dev)
            for name, p in list(model.named_parameters()):
                mod, _, leaf = name.rpartition(".")
                owner = model.get_submodule(mod) if mod else model
                setattr(owner, leaf, nn.Parameter(
                    _placed(full.pop(name).to(p.dtype),
                            shardings["params"][name]),
                    requires_grad=p.requires_grad))
        out["params"] = model
        ostate = interop.opt_state_from_numpy(model, tree["opt"], dev)
        osh = sh.get("opt") or {}
        out["opt"] = {k: ({n: _placed(t, (osh.get(k) or {}).get(n))
                           for n, t in v.items()} if isinstance(v, dict)
                          else v) for k, v in ostate.items()}
        return out
    if isinstance(template, dict):
        return {k: _to_port(v, tree[k], sh.get(k))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        shs = shardings or [None] * len(template)
        return type(template)(_to_port(v, t, s)
                              for v, t, s in zip(template, tree, shs))
    if isinstance(template, torch.Tensor):
        a = np.asarray(tree, dtype=np.float32
                       if template.dtype == torch.bfloat16 else None)
        return _placed(torch.from_numpy(np.array(a)).to(template.device,
                                                        template.dtype),
                       shardings)
    return tree


def save_checkpoint(ckpt_dir, step: int, state: Any, *,
                    extra: Optional[dict] = None, keep: int = 3) -> Path:
    """Atomically write ``state`` (a training state, or a tree of tensors
    and arrays) for ``step``.  A sharded state is gathered on every rank
    (a collective) and written by rank 0 alone; the others wait at a
    barrier until it is published."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tree = _reference_tree(state)
    if _is_sharded(state):
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, tree, extra, keep)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, tree, extra, keep)


def _write(ckpt_dir: Path, step: int, tree, extra, keep: int) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    meta = {"step": step, "treedef": None, "extra": extra or {},
            "leaves": []}
    for i, leaf in enumerate(_flatten(tree)):
        arr = np.asarray(leaf)
        np.save(tmp / f"arr_{i:05d}.npy", arr)
        meta["leaves"].append({"file": f"arr_{i:05d}.npy",
                               "shape": list(arr.shape),
                               "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _write_latest(ckpt_dir, step)
    _gc(ckpt_dir, keep)
    return final


def _write_latest(ckpt_dir: Path, step: int):
    tmp = ckpt_dir / "LATEST.tmp"
    tmp.write_text(str(step))
    os.replace(tmp, ckpt_dir / "LATEST")


def _gc(ckpt_dir: Path, keep: int):
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)


def list_steps(ckpt_dir) -> list:
    ckpt_dir = Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and not p.name.endswith(".tmp"):
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    marker = ckpt_dir / "LATEST"
    if marker.exists():
        s = int(marker.read_text().strip())
        if (ckpt_dir / f"step_{s:08d}" / "manifest.json").exists():
            return s
    steps = [s for s in list_steps(ckpt_dir)
             if (ckpt_dir / f"step_{s:08d}" / "manifest.json").exists()]
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, template: Any, *,
                       step: Optional[int] = None, shardings: Any = None):
    """Restore into the structure of ``template`` (the latest step unless
    ``step`` is given).  A training state's model is loaded in place.
    ``shardings``: a matching tree of :class:`NamedSharding`
    (``train_loop.state_shardings`` on any mesh): every leaf becomes a
    DTensor of this rank's slice of the full array (elastic re-mesh: any
    rank count works); a sharded template keeps its own when none is
    given.  Raises ``FileNotFoundError`` when there is no checkpoint and
    ``ValueError`` when the leaf count or a shape differs from the
    template's, before anything is loaded.  Returns (state, step, extra)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((d / "manifest.json").read_text())
    tree_t = _reference_tree(template)
    flat_t = _flatten(tree_t)
    if len(flat_t) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, template has "
            f"{len(flat_t)} — structure mismatch")
    out = []
    for i, tleaf in enumerate(flat_t):
        arr = np.load(d / meta["leaves"][i]["file"])
        if list(arr.shape) != list(np.shape(tleaf)):
            raise ValueError(f"leaf {i}: shape {arr.shape} != template "
                             f"{np.shape(tleaf)}")
        out.append(arr.astype(np.asarray(tleaf).dtype))
    if shardings is None and _is_sharded(template):
        raise ValueError("restoring into a sharded template needs its "
                         "shardings (train_loop.state_shardings)")
    state = _to_port(template, _unflatten(tree_t, iter(out)), shardings)
    return state, step, meta.get("extra", {})
