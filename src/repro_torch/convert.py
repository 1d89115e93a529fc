"""Parameters of the reference package <-> parameters of the port.

The reference's ``BlockedCNN`` keeps its parameters as a tree ``{"conv{i}":
layer, "head": [C, n_classes]}`` where a dense layer is ``{"w": [Co/Cob,
Ci/Cib, Hf, Wf, Cib, Cob], "b": [Co/Cob, Cob]}`` and a depthwise-separable
block nests two of them, ``{"dw": {"w", "b"}, "pw": {"w", "b"}}``.  The
port stores the same tensors, in the same layouts, as ``nn.Module``
parameters named by the same path: ``convs.{i}.w``, ``convs.{i}.dw.w``,
..., and ``head``.  Leaves are read with ``np.asarray``, so numpy arrays or
any array type that converts to one are accepted; this module imports
nothing of the reference.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy"]

_LEAVES = {"w", "b"}
_LEGS = {"dw", "pw"}


def _tensor(leaf, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(device)


def _is_layer(layer) -> bool:
    """A dense layer ``{"w", "b"}`` or a block ``{"dw": dense, "pw":
    dense}``."""
    if not isinstance(layer, Mapping):
        return False
    if set(layer) == _LEAVES:
        return True
    return set(layer) == _LEGS and all(
        isinstance(layer[k], Mapping) and set(layer[k]) == _LEAVES
        for k in _LEGS)


def params_from_jax(tree: Mapping[str, Any],
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """-> a ``state_dict`` for the port's ``BlockedCNN``
    (``model.load_state_dict(params_from_jax(tree, device))``)."""
    dev = resolve_device(device)
    n_convs = sum(1 for k in tree if k.startswith("conv"))
    if set(tree) != {f"conv{i}" for i in range(n_convs)} | {"head"} or \
            not all(_is_layer(tree[f"conv{i}"]) for i in range(n_convs)):
        raise ValueError(f"not a BlockedCNN parameter tree: keys {sorted(tree)}")
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                put(f"{prefix}.{k}", v)
        else:
            out[prefix] = _tensor(node, dev)

    for i in range(n_convs):
        put(f"convs.{i}", tree[f"conv{i}"])
    out["head"] = _tensor(tree["head"], dev)
    return out


_KEY = re.compile(r"convs\.(\d+)\.(?:(dw|pw)\.)?([wb])")


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a ``BlockedCNN``'s
    parameters as the reference's (nested) tree of f32 numpy arrays."""
    sd = model.state_dict()
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        if key == "head":
            tree["head"] = t.detach().to("cpu", torch.float32).numpy().copy()
            continue
        m = _KEY.fullmatch(key)
        if m is None:
            raise ValueError(f"not a BlockedCNN state_dict: key {key!r}")
        i, leg, leaf = m.groups()
        node = tree.setdefault(f"conv{i}", {})
        if leg is not None:
            node = node.setdefault(leg, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    n_convs = len(tree) - ("head" in tree)
    if "head" not in tree or set(tree) != (
            {f"conv{i}" for i in range(n_convs)} | {"head"}) or \
            not all(_is_layer(tree[f"conv{i}"]) for i in range(n_convs)):
        raise ValueError(f"not a BlockedCNN state_dict: keys {sorted(sd)}")
    return tree
