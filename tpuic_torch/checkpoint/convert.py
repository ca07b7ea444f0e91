"""Carry a ``tpuic`` variables tree into a port model, and synthetic weights.

``load_jax_variables(model, variables)`` takes the flax tree
``{"params": {"backbone": ..., "head": ...}, "batch_stats": {"backbone":
...}}`` with numpy leaves (what ``jax.tree.map(np.asarray, variables)``
gives) and writes it into the module of the same names:

=================================  ===========================  ===========
flax leaf                          port tensor                  mapping
=================================  ===========================  ===========
conv ``kernel`` [kh,kw,Cin,Cout]   ``Conv2d.weight``            HWIO->OIHW
Dense ``kernel`` [in, out]         ``Linear.weight``            transpose
``bias`` of a Dense                ``Linear.bias``              as is
BN ``scale``, ``bias``             ``weight``, ``bias``         as is
BN stats ``mean``, ``var``         ``running_mean``/``_var``    as is
=================================  ===========================  ===========

The load is strict: every leaf is consumed and every parameter and
running statistic of the model is written; a missing key, an extra key or
a shape mismatch raises naming the path.  Reading the tree needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from tpuic_torch.device import resolve_device

_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _port_name(collection: str, path: str) -> str:
    *mods, leaf = path.split("/")
    if collection == "batch_stats":
        name = _STAT_LEAF.get(leaf)
    elif leaf == "kernel":
        name = "weight"
    else:
        name = _PARAM_LEAF.get(leaf)
    if name is None:
        raise KeyError(f"{collection}/{path}: no port counterpart for leaf "
                       f"'{leaf}'")
    return ".".join(mods + [name])


def _to_port_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if arr.ndim == 2:
        return arr.T  # [in, out] -> [out, in]
    return arr


def _targets(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor a variables tree must write: parameters and BN running
    statistics (not torch's own ``num_batches_tracked`` counter)."""
    out = dict(model.named_parameters())
    out.update({k: v for k, v in model.named_buffers()
                if k.endswith(("running_mean", "running_var"))})
    return out


def _invalidate(model: nn.Module) -> None:
    for m in model.modules():
        if hasattr(m, "invalidate_packed"):
            m.invalidate_packed()


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Write a ``tpuic`` variables tree into ``model`` in place (strict);
    drops any folded-weight cache.  Returns ``model``."""
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if extra:
        raise KeyError(f"unexpected variable collections {extra}")
    targets = _targets(model)
    written = set()
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            name = _port_name(collection, path)
            if name not in targets:
                raise KeyError(f"{collection}/{path}: the model has no "
                               f"'{name}'")
            if name in written:
                raise KeyError(f"{collection}/{path}: '{name}' written twice")
            t = targets[name]
            src = _to_port_layout(arr)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{collection}/{path}: shape "
                                 f"{tuple(arr.shape)} does not fit '{name}' "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.tensor(src))
            written.add(name)
    missing = sorted(set(targets) - written)
    if missing:
        raise KeyError(f"variables tree lacks {len(missing)} model tensors, "
                       f"first: {missing[:5]}")
    _invalidate(model)
    return model


def init_synthetic(model: nn.Module, seed: int = 0,
                   device=None) -> nn.Module:
    """Seeded random weights for a smoke run, drawn from a CPU
    ``torch.Generator`` (the same numbers on any device), with the model
    placed on ``device`` (``None`` = the card).  Convs and linears get
    fan-in scaled normals; BN gets statistics near the identity, with the
    last BN of each residual branch scaled down so activations stay
    bounded through deep stacks.  It does not reproduce the numbers of a
    ``tpuic`` init."""
    model.to(resolve_device(device))
    g = torch.Generator().manual_seed(int(seed))

    def draw(shape, scale=1.0, offset=0.0):
        return torch.randn(shape, generator=g) * scale + offset

    tails = {f"{name}.{m.PAIRS[-1][1]}" for name, m in model.named_modules()
             if getattr(m, "PAIRS", None)}
    with torch.no_grad():
        for mod_name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(draw(m.weight.shape, (2.0 / fan_in) ** 0.5))
                if m.bias is not None:
                    m.bias.copy_(draw(m.bias.shape, 0.01))
            elif isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                gamma = 0.2 if mod_name in tails else 1.0
                m.weight.copy_(draw(c, 0.05, gamma))
                m.bias.copy_(draw(c, 0.05))
                m.running_mean.copy_(draw(c, 0.05))
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    _invalidate(model)
    return model
