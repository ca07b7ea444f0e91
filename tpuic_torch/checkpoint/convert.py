"""Carry a ``tpuic`` variables tree into a port model, and synthetic weights.

``load_jax_variables(model, variables)`` takes the flax tree
``{"params": {"backbone": ..., "head": ...}, "batch_stats": {"backbone":
...}}`` with numpy leaves (what ``jax.tree.map(np.asarray, variables)``
gives) and writes it into the module of the same names:

=================================  ===========================  ===========
flax leaf                          port tensor                  mapping
=================================  ===========================  ===========
conv ``kernel`` [kh,kw,Cin,Cout]   ``Conv2d.weight``            HWIO->OIHW
depthwise ``kernel`` [k,k,1,C]     ``Conv2d.weight`` [C,1,k,k]  HWIO->OIHW
Dense ``kernel`` [in, out]         ``Linear.weight``            transpose
``bias`` of a Dense or a conv      ``.bias``                    as is
BN, LayerNorm ``scale``, ``bias``  ``weight``, ``bias``         as is
BN stats ``mean``, ``var``         ``running_mean``/``_var``    as is
ViT ``cls``, ``pos_embed``         ``ViT.cls``, ``.pos_embed``  as is
=================================  ===========================  ===========

The load is strict: every leaf is consumed and every parameter and
running statistic of the model is written; a missing key, an extra key or
a shape mismatch raises naming the path.  ``merge_jax_variables`` is the
lenient mode beside it (a torch checkpoint's ``--init-from``, through
``torch_convert``): it writes what fits and leaves the rest as it was.
Reading the tree needs no JAX.

``load_jax_opt_state(opt_state, params_order)`` carries a ``tpuic``
optimizer state (numpy leaves) into the port's ``OptState``, by the same
leaf mapping, so both packages can continue from one mid-training state.

``init_params(model, seed)`` draws flax's default initialisation (what a
``tpuic`` Trainer starts from) for training; ``init_synthetic`` draws
weights and statistics for a serving smoke run.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from tpuic_torch.device import resolve_device
from tpuic_torch.models.layers import LayerNorm
from tpuic_torch.models.vit import ViT

_PARAM_LEAF = {"scale": "weight", "bias": "bias", "cls": "cls",
               "pos_embed": "pos_embed"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_STAT_LEAF_NAMES = tuple(_STAT_LEAF.values())


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{path: array}``; a leaf boxed with partitioning metadata (flax's
    ``Partitioned``, as the ViT's Dense kernels are) is read through its
    ``value``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(getattr(v, "value", v))
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


def _write_tree(model: nn.Module, variables: Mapping, strict: bool):
    """Write ``variables`` into ``model`` by the layout rules above:
    ``{collection: (names written, names the model has)}``.  ``strict``
    raises on a leaf without a counterpart, a shape mismatch, an extra
    collection or a tensor left unwritten; otherwise each of those leaves
    is skipped and the tensor keeps its value."""
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if extra and strict:
        raise KeyError(f"unexpected variable collections {extra}")
    targets = _targets(model)
    stats = {k for k in targets if k.endswith(_STAT_LEAF_NAMES)}
    names = {"params": set(targets) - stats, "batch_stats": stats}
    written = {"params": set(), "batch_stats": set()}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            try:
                name = _port_name(collection, path)
            except KeyError:
                if strict:
                    raise
                continue
            if name not in names[collection]:
                if strict:
                    raise KeyError(f"{collection}/{path}: the model has no "
                                   f"'{name}'")
                continue
            if name in written[collection]:
                raise KeyError(f"{collection}/{path}: '{name}' written twice")
            t = targets[name]
            src = _to_port_layout(arr)
            if tuple(src.shape) != tuple(t.shape):
                if strict:
                    raise ValueError(f"{collection}/{path}: shape "
                                     f"{tuple(arr.shape)} does not fit "
                                     f"'{name}' {tuple(t.shape)}")
                continue
            with torch.no_grad():
                t.copy_(torch.tensor(np.ascontiguousarray(src)))
            written[collection].add(name)
    missing = sorted(set(targets) - written["params"]
                     - written["batch_stats"])
    if missing and strict:
        raise KeyError(f"variables tree lacks {len(missing)} model tensors, "
                       f"first: {missing[:5]}")
    _invalidate(model)
    return {c: (written[c], names[c]) for c in written}


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Write a ``tpuic`` variables tree into ``model`` in place (strict);
    drops any folded-weight cache.  Returns ``model``."""
    _write_tree(model, variables, strict=True)
    return model


def merge_jax_variables(model: nn.Module, variables: Mapping) -> dict:
    """The lenient counterpart of :func:`load_jax_variables` (``tpuic``'s
    ``lenient_restore``, reference train.py:143-148): every leaf with a
    counterpart of the same shape is written, every other leaf is
    skipped, and a tensor the tree does not write keeps its value.
    Returns ``{collection: (names written, names the model has)}`` for
    ``params`` and ``batch_stats``."""
    return _write_tree(model, variables, strict=False)


def init_synthetic(model: nn.Module, seed: int = 0,
                   device=None) -> nn.Module:
    """Seeded random weights for a smoke run, drawn from a CPU
    ``torch.Generator`` (the same numbers on any device), with the model
    placed on ``device`` (``None`` = the card).  Convs and linears get
    fan-in scaled normals; BN gets statistics near the identity, with the
    last BN of each residual branch scaled down so activations stay
    bounded through deep stacks; LayerNorm gets a scale near 1 and a small
    bias; the ViT's ``cls`` and ``pos_embed`` get normals of std 0.02.
    Depthwise and SE convs (EfficientNet) and InceptionV3's aux head are
    drawn like any conv or linear.  It does not reproduce the numbers of a
    ``tpuic`` init."""
    model.to(resolve_device(device))
    g = torch.Generator().manual_seed(int(seed))

    def draw(shape, scale=1.0, offset=0.0):
        return torch.randn(shape, generator=g) * scale + offset

    tails = {f"{name}.{m.PAIRS[-1][1]}" for name, m in model.named_modules()
             if getattr(m, "PAIRS", None)}
    tails |= {f"{name}.project_bn" for name, m in model.named_modules()
              if getattr(m, "residual", False)}  # EfficientNet's MBConv
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
            elif isinstance(m, LayerNorm):
                m.weight.copy_(draw(m.features, 0.05, 1.0))
                m.bias.copy_(draw(m.features, 0.05))
            elif isinstance(m, ViT):
                m.cls.copy_(draw(m.cls.shape, 0.02))
                m.pos_embed.copy_(draw(m.pos_embed.shape, 0.02))
    _invalidate(model)
    return model


def init_params(model: nn.Module, seed: int = 0, device=None) -> nn.Module:
    """flax's default initialisation, drawn from a CPU ``torch.Generator``
    (the same numbers on any device), with the model placed on ``device``
    (``None`` = the card): conv and dense weights from
    ``lecun_normal`` (a normal truncated at two standard deviations,
    variance 1/fan_in), except the ViT's Dense layers (marked
    ``kernel_init = "xavier_uniform"``), which flax draws from
    ``xavier_uniform``; biases 0, BN and LayerNorm scale 1 and bias 0,
    running mean 0 and variance 1; the ViT's ``cls`` 0 and ``pos_embed``
    from a normal of std 0.02.  The distribution is flax's; the numbers
    are not a ``tpuic`` init's."""
    model.to(resolve_device(device))
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if getattr(m, "kernel_init", None) == "xavier_uniform":
                w = torch.empty(m.weight.shape)
                nn.init.xavier_uniform_(w, generator=g)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, ViT):
                m.cls.zero_()
                m.pos_embed.copy_(torch.randn(m.pos_embed.shape,
                                              generator=g) * 0.02)
    _invalidate(model)
    return model


_MOMENTS = ("trace", "mu", "nu")


def _collect_opt_state(node, path: str, counts: list, moments: dict) -> None:
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            v, sub = getattr(node, f), f"{path}{f}"
            if f == "count":
                counts.append((sub, np.asarray(v)))
            elif f in _MOMENTS:
                if f in moments:
                    raise KeyError(f"{sub}: a second '{f}' tree")
                moments[f] = v
            else:
                _collect_opt_state(v, sub + "/", counts, moments)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _collect_opt_state(v, f"{path}{i}/", counts, moments)
    elif isinstance(node, Mapping):
        for k, v in node.items():
            _collect_opt_state(v, f"{path}{k}/", counts, moments)
    elif node is not None:
        raise KeyError(f"{path or '<root>'}: optimizer-state leaf the port "
                       "does not carry")


def load_jax_opt_state(opt_state, params_order: Sequence[str], device=None):
    """A ``tpuic`` optimizer state -> the port's ``OptState`` on
    ``device`` (``None`` = the card).

    ``opt_state`` has numpy leaves (``jax.tree.map(np.asarray, ...)``):
    ``FusedLarsState(count, trace)``, ``FusedLambState(count, mu, nu)`` or
    an optax chain of ``ScaleByAdamState`` / ``TraceState`` /
    ``ScaleByScheduleState`` / empty states (adam, adamw, sgd, lars, lamb,
    with or without clipping).  ``params_order`` names the port
    parameters in ``model.named_parameters()`` order; every moment tree
    must map onto exactly those names.  Strict: a leaf the port does not
    carry, counts that disagree, or a missing or extra parameter raise."""
    from tpuic_torch.train.optimizer import OptState
    dev = resolve_device(device)
    counts: list = []
    moments: dict = {}
    _collect_opt_state(opt_state, "", counts, moments)
    if not counts:
        raise KeyError("optimizer state has no 'count'")
    values = {int(c) for _, c in counts}
    if len(values) != 1:
        raise ValueError(f"optimizer-state counts disagree: {counts}")
    order = list(params_order)
    lists: Dict[str, List[torch.Tensor]] = {}
    for name, tree in moments.items():
        by_name = {}
        for path, arr in _flatten(tree).items():
            port = _port_name("params", path)
            if port in by_name:
                raise KeyError(f"{name}/{path}: '{port}' written twice")
            by_name[port] = torch.tensor(np.ascontiguousarray(
                _to_port_layout(arr)), dtype=torch.float32, device=dev)
        if set(by_name) != set(order):
            missing = sorted(set(order) - set(by_name))
            extra = sorted(set(by_name) - set(order))
            raise KeyError(f"'{name}' does not match the parameters: "
                           f"missing {missing[:5]}, extra {extra[:5]}")
        lists[name] = [by_name[n] for n in order]
    count = torch.tensor(values.pop(), dtype=torch.int32, device=dev)
    return OptState(count=count, **lists)
