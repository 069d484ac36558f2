"""Checkpoint / resume (counterpart of ``tile_match_tpu.checkpoint``).

The whole Markov state is explicit — an ``EnvState`` is board channels,
timer and threefry key; an agent's state adds its networks, Adam's state,
the observation, the mask, a replay buffer and the step count — so a
restored checkpoint reproduces the exact future trajectory.

``save_pytree`` writes a tree of tensors, numbers, dataclasses, named
tuples, lists, dicts, ``nn.Module``s (their state dicts) and optimisers
(theirs) with ``torch.save`` as plain containers of tensors;
``restore_pytree`` reads it with ``weights_only=True`` and fills a template
of the same structure: tensors come back on the template's devices,
modules and optimisers are loaded in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn


def _plain(tree: Any) -> Any:
    if isinstance(tree, (nn.Module, torch.optim.Optimizer)):
        return tree.state_dict()
    if dataclasses.is_dataclass(tree):
        return {f.name: _plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {name: _plain(v) for name, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _fill(template: Any, saved: Any, path: str) -> Any:
    if isinstance(template, (nn.Module, torch.optim.Optimizer)):
        template.load_state_dict(saved)
        return template
    if torch.is_tensor(template):
        if not torch.is_tensor(saved) or saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(f"checkpoint {path}: expected {template.dtype}{list(template.shape)}")
        return saved.to(template.device)
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _fill(getattr(template, f.name), saved[f.name], f"{path}.{f.name}")
            for f in dataclasses.fields(template)
        })
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _fill(v, saved[name], f"{path}.{name}") for name, v in zip(template._fields, template)
        ))
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"checkpoint {path}: expected {len(template)} items")
        return type(template)(_fill(t, s, f"{path}[{i}]") for i, (t, s) in enumerate(zip(template, saved)))
    if isinstance(template, dict):
        return {k: _fill(v, saved[k], f"{path}[{k!r}]") for k, v in template.items()}
    return saved


def save_pytree(path: str, tree: Any) -> None:
    torch.save(_plain(tree), path)


def restore_pytree(path: str, template: Any) -> Any:
    """The tree saved at ``path``, in ``template``'s structure (modules and
    optimisers of ``template`` are loaded in place)."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return _fill(template, saved, "tree")


def save_env_state(path: str, state) -> None:
    """Checkpoint a batched EnvState."""
    save_pytree(path, state)


def restore_env_state(path: str, template):
    return restore_pytree(path, template)
