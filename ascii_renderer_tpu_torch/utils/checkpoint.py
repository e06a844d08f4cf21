"""Checkpoint / resume (torch port of
``ascii_renderer_tpu/utils/checkpoint.py``).

Every piece of runtime state is a tree of dataclasses over tensors
(``FrameState``, ``AccumState``, ``Camera``), so checkpointing is
generic:

  - ``save_pytree`` / ``load_pytree``: a flat .npz in the JAX package's
    layout — keys are the field paths joined by ``/`` (a sequence index
    as its number, a dict key as ``['key']``), and a PRNG key (a
    dataclass field whose metadata holds ``prng_key``, e.g.
    ``FrameState.rng``) sits under ``__prngkey__/<path>`` as its uint32
    key words. Either package loads the other's checkpoints;
  - the scene JSON round trip via the builder's ``to_unified`` /
    ``from_object``.

Orbax checkpoints stay with the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

_KEY_PREFIX = "__prngkey__/"


def _leaves(tree, path=()):
    """(path, leaf, is_key) of every leaf, in JAX's flattening order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if f.metadata.get("prng_key"):
                yield path + (f.name,), v, True
            else:
                yield from _leaves(v, path + (f.name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    else:
        yield path, tree, False


def _rebuild(tree, values, path=()):
    """``tree`` with each leaf replaced by ``values[path]``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: (values[path + (f.name,)] if f.metadata.get("prng_key")
                     else _rebuild(getattr(tree, f.name), values,
                                   path + (f.name,)))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (f"[{k!r}]",))
                for k, v in tree.items()}
    return values[path]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of dataclasses / sequences / dicts over tensors as a
    flat .npz (keys = tree paths)."""
    out = {}
    for p, leaf, is_key in _leaves(tree):
        k = "/".join(p)
        if is_key:
            out[_KEY_PREFIX + k] = _host(leaf).astype(np.uint32)
        else:
            out[k] = _host(leaf)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **out)


def load_pytree(path: str, like: Any) -> Any:
    """Load a tree saved by ``save_pytree`` (of either package); ``like``
    gives the structure, and each leaf takes the dtype and device of its
    ``like`` leaf (a non-tensor ``like`` leaf gives a CPU tensor)."""
    with np.load(path) as z:
        data = dict(z)
    values = {}
    for p, leaf, is_key in _leaves(like):
        k = "/".join(p)
        k = _KEY_PREFIX + k if is_key else k
        if k not in data:
            raise ValueError(f"checkpoint missing key: {k}")
        v = torch.from_numpy(np.ascontiguousarray(data[k]))
        if isinstance(leaf, torch.Tensor):
            v = v.to(dtype=leaf.dtype, device=leaf.device)
        values[p] = v
    return _rebuild(like, values)


def save_scene_json(path: str, builder) -> None:
    """Persist a SceneBuilder as unified-schema JSON (the reference's
    serialization capability)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(builder.to_unified(), f, indent=1)


def load_scene_json(path: str):
    from ascii_renderer_tpu_torch.scene.builder import from_object
    with open(path) as f:
        return from_object(json.load(f))
