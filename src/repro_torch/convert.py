"""Parameters of the reference package <-> parameters of the port.

The reference's ``BlockedCNN`` keeps its parameters as a tree
``{"conv{i}": {"w": [Co/Cob, Ci/Cib, Hf, Wf, Cib, Cob], "b": [Co/Cob,
Cob]}, "head": [C, n_classes]}``.  The port stores the same tensors, in the
same layouts, as ``nn.Module`` parameters named ``convs.{i}.w``,
``convs.{i}.b`` and ``head``.  Leaves are read with ``np.asarray``, so numpy
arrays or any array type that converts to one are accepted; this module
imports nothing of the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy"]


def _tensor(leaf, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(device)


def params_from_jax(tree: Mapping[str, Any],
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """-> a ``state_dict`` for the port's ``BlockedCNN``
    (``model.load_state_dict(params_from_jax(tree, device))``)."""
    dev = resolve_device(device)
    n_convs = sum(1 for k in tree if k.startswith("conv"))
    if set(tree) != {f"conv{i}" for i in range(n_convs)} | {"head"}:
        raise ValueError(f"not a BlockedCNN parameter tree: keys {sorted(tree)}")
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_convs):
        layer = tree[f"conv{i}"]
        out[f"convs.{i}.w"] = _tensor(layer["w"], dev)
        out[f"convs.{i}.b"] = _tensor(layer["b"], dev)
    out["head"] = _tensor(tree["head"], dev)
    return out


def params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a ``BlockedCNN``'s
    parameters as the reference's tree of f32 numpy arrays."""
    sd = model.state_dict()
    n_convs = sum(1 for k in sd if k.startswith("convs.") and k.endswith(".w"))
    if set(sd) != ({f"convs.{i}.{p}" for i in range(n_convs) for p in "wb"}
                   | {"head"}):
        raise ValueError(f"not a BlockedCNN state_dict: keys {sorted(sd)}")

    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree: Dict[str, Any] = {
        f"conv{i}": {"w": leaf(sd[f"convs.{i}.w"]),
                     "b": leaf(sd[f"convs.{i}.b"])} for i in range(n_convs)}
    tree["head"] = leaf(sd["head"])
    return tree
