"""Parameters of the reference package <-> parameters of the port.

**BlockedCNN.**  The reference's ``BlockedCNN`` keeps its parameters as a
tree ``{"conv{i}": layer, "head": [C, n_classes]}`` where a dense layer is
``{"w": [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob], "b": [Co/Cob, Cob]}`` and a
depthwise-separable block nests two of them, ``{"dw": {"w", "b"}, "pw":
{"w", "b"}}``.  The port stores the same tensors, in the same layouts, as
``nn.Module`` parameters named by the same path: ``convs.{i}.w``,
``convs.{i}.dw.w``, ..., and ``head``; they are f32.

**LM.**  The reference's ``LM`` tree is ``{"embed": {"w"}, "layers":
{"b{j}": layer}, "final_norm": ..., ["lm_head"], ["pos"]}`` where every leaf
under ``layers`` is stacked over the layer-pattern periods on a leading
axis (``with_layers_axis``).  The port's ``LM`` keeps one module per layer,
so period ``p``'s slice of ``layers/b{j}/<path>`` becomes
``layers.{p * period + j}.<path>`` (``params_to_numpy`` restacks).  Dtypes
carry across: a bf16 leaf stays bf16.

Leaves are read with ``np.asarray``, so numpy arrays or any array type that
converts to one are accepted; this module imports nothing of the reference.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.nn.models import LM

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


def _leaf_tensor(leaf, device: torch.device) -> torch.Tensor:
    """A leaf in its own dtype: bf16 (numpy's ``bfloat16`` extension type)
    is carried bit for bit, every other float as f32."""
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, copy=True).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _flatten(prefix: str, node, out: Dict[str, Any]) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            _flatten(f"{prefix}.{k}" if prefix else k, v, out)
    else:
        out[prefix] = node


def _lm_from_jax(tree: Mapping[str, Any],
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    period = len(tree["layers"])           # one block b{j} per period layer
    flat: Dict[str, Any] = {}
    for key, node in tree.items():
        if key != "layers":
            _flatten(key, node, flat)
    out = {k: _leaf_tensor(v, dev) for k, v in flat.items()}
    for bname, sub in tree["layers"].items():
        j = int(bname[1:])
        leaves: Dict[str, Any] = {}
        _flatten("", sub, leaves)
        for path, leaf in leaves.items():
            stacked = _leaf_tensor(leaf, dev)
            for p in range(stacked.shape[0]):
                out[f"layers.{p * period + j}.{path}"] = stacked[p].clone()
    return out


def params_from_jax(tree: Mapping[str, Any],
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """-> a ``state_dict`` for the port's ``BlockedCNN`` or ``LM``
    (``model.load_state_dict(params_from_jax(tree, device))``)."""
    dev = resolve_device(device)
    if "embed" in tree:
        return _lm_from_jax(tree, dev)
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes            # numpy's bfloat16 type (ships with jax)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.to(torch.float32).numpy().copy()


def _lm_to_numpy(model: LM) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}

    def put(path: str, value) -> None:
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value

    per_block: Dict[str, list] = {}
    for key, t in model.state_dict().items():
        if key.startswith("layers."):
            _, i, path = key.split(".", 2)
            i = int(i)
            per_block.setdefault(f"layers.b{i % model.period}.{path}",
                                 []).append((i, t))
        else:
            put(key, _numpy(t))
    for path, items in per_block.items():
        put(path, np.stack([_numpy(t) for _, t in sorted(
            items, key=lambda it: it[0])]))
    return tree


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a ``BlockedCNN``'s
    parameters as the reference's (nested) tree of f32 numpy arrays, or an
    ``LM``'s as the reference's period-stacked tree in their own dtypes."""
    if isinstance(model, LM):
        return _lm_to_numpy(model)
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
