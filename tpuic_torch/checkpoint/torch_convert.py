"""Reference torch checkpoints -> the port's models
(``tpuic/checkpoint/torch_convert.py``, the families the port has).

The reference saves ``{'epoch', 'best_score', 'state_dict'}`` with DDP's
``module.`` prefix (train.py:177-179), where the model is
``Classifier(name, num_classes)``: a torchvision backbone whose ``fc`` was
replaced by a 4-layer MLP (``fc.0/2/4/6``, nn/classifier.py:26-34), hung
off an ``encoder`` attribute.  This module converts those checkpoints, or
plain torchvision ``resnet{18,34,50,101}``, ``inception_v3`` and ``vit_*``
state dicts and efficientnet_pytorch ``efficientnet-b{0..7}`` ones, into
``tpuic``'s ``{'params': ..., 'batch_stats': ...}`` tree (numpy leaves,
flax layout and names) with the same rules as ``tpuic``:

- conv weight OIHW -> HWIO; linear weight (out, in) -> kernel (in, out);
- BatchNorm weight/bias/running_mean/running_var -> scale/bias (params)
  and mean/var (batch_stats); ``num_batches_tracked`` dropped;
- ``layer{s}.{i}.<leaf>`` -> ``layer{s}_{i}/<leaf>``, ``downsample.0/1``
  -> ``downsample_conv``/``downsample_bn``; the MLP head ``fc.0/2/4/6`` ->
  ``head/fc0, fc1, fc2, out``, a plain ``fc`` -> ``head/out``;
- the ViT's ``conv_proj``, ``class_token``, ``pos_embedding``,
  ``in_proj_weight`` ([q; k; v] rows) and ``heads.head`` -> ``tpuic``'s
  ``patch_embed``, ``cls``, ``pos_embed``, fused ``qkv`` and head.
- Inception's ``Conv2d_1a_3x3``.. -> ``stem1``.., ``Mixed_6b.branch7x7_2``
  -> ``mixed6b/b7_2``, ``AuxLogits.conv0/conv1/fc`` -> ``aux``;
- EfficientNet's flat ``_blocks.{i}`` -> ``block{stage}_{repeat}`` (the
  variant's depth multiplier decides), ``_depthwise_conv`` -> ``dw_conv``
  (``[C, 1, k, k]`` -> ``[k, k, 1, C]``), ``_se_reduce/_se_expand`` (with
  their biases) -> ``se/reduce``, ``se/expand``, ``_fc`` -> ``head/out``.

:func:`init_from_torch` carries that tree into a port model through
``checkpoint/convert.py``'s layout rules in their lenient mode
(``merge_jax_variables``), so there is one name map, ``tpuic``'s, and the
port's own flax-to-torch rules.  Leniency is the reference's
(train.py:143-148, ``tpuic``'s ``init_state_from_torch``): an unmapped or
shape-mismatched leaf keeps its fresh initialisation.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    d = tree
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def strip_prefixes(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Drop DDP's ``module.`` and the reference's ``encoder.`` wrappers."""
    out = {}
    for k, v in state_dict.items():
        for pre in ("module.", "encoder."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = np.asarray(v.detach().cpu().numpy()
                            if hasattr(v, "detach") else v)
    return out


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)  # (out, in) -> (in, out)


# torchvision resnet leaf name within a block -> tpuic module name
_RESNET_LEAF = {
    "conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
    "bn1": "bn1", "bn2": "bn2", "bn3": "bn3",
    "downsample.0": "downsample_conv", "downsample.1": "downsample_bn",
}

def _head_fc_mapping(keys) -> Dict[str, str]:
    """Sequential Linear index -> tpuic head module, derived from the
    checkpoint's own ``fc.N.*`` keys: hidden layers in order become
    fc0..fcK-1, the LAST Linear is 'out'. For the reference head
    (nn/classifier.py:26-34) this yields {0: fc0, 2: fc1, 4: fc2, 6: out};
    nonstandard head_widths (any even-index spacing) map consistently, so
    export -> convert round-trips for every head shape."""
    idxs = sorted({int(m.group(1)) for k in keys
                   if (m := re.match(r"(?:.*\.)?fc\.(\d+)\.(weight|bias)$",
                                     k))})
    return {str(i): (f"fc{n}" if n < len(idxs) - 1 else "out")
            for n, i in enumerate(idxs)}

_BLOCK_RE = re.compile(r"^layer(\d+)\.(\d+)\.(.+)$")


def convert_resnet(state_dict: Mapping[str, Any],
                   backbone_scope: str = "backbone",
                   head_scope: str = "head") -> Dict[str, Dict]:
    """Convert a torchvision-style resnet (or reference Classifier-over-resnet)
    state_dict into ``{'params': ..., 'batch_stats': ...}`` nested dicts.

    Unknown keys are skipped (collected in the returned tree under no path);
    ``init_from_torch`` merges it into a model.
    """
    sd = strip_prefixes(state_dict)
    fc_map = _head_fc_mapping(sd)
    params: Dict = {}
    stats: Dict = {}

    def put_bn(scope: Tuple[str, ...], leaf: str, v: np.ndarray) -> None:
        if leaf == "weight":
            _set(params, scope + ("scale",), v)
        elif leaf == "bias":
            _set(params, scope + ("bias",), v)
        elif leaf == "running_mean":
            _set(stats, scope + ("mean",), v)
        elif leaf == "running_var":
            _set(stats, scope + ("var",), v)
        # num_batches_tracked intentionally dropped

    for key, v in sd.items():
        parts = key.rsplit(".", 1)
        if len(parts) != 2:
            continue
        name, leaf = parts

        # -- stem ------------------------------------------------------------
        if name == "conv1" and leaf == "weight":
            _set(params, (backbone_scope, "conv1", "kernel"), _conv(v))
            continue
        if name == "bn1":
            put_bn((backbone_scope, "bn1"), leaf, v)
            continue

        # -- stages ----------------------------------------------------------
        m = _BLOCK_RE.match(name)
        if m:
            stage, block, inner = m.group(1), m.group(2), m.group(3)
            mod = _RESNET_LEAF.get(inner)
            if mod is None:
                continue
            scope = (backbone_scope, f"layer{stage}_{block}", mod)
            if mod.startswith("conv") or mod == "downsample_conv":
                if leaf == "weight":
                    _set(params, scope + ("kernel",), _conv(v))
            else:
                put_bn(scope, leaf, v)
            continue

        # -- head ------------------------------------------------------------
        _put_head_fc(params, name, leaf, v, head_scope, fc_map)

    return {"params": params, "batch_stats": stats}


def _put_head_fc(params: Dict, name: str, leaf: str, v: np.ndarray,
                 head_scope: str, fc_map: Mapping[str, str]) -> bool:
    """Map an MLP head (``fc.N`` Sequential Linears, reference layout) or a
    plain single ``fc`` Linear onto the tpuic head scope. ``fc_map`` comes
    from ``_head_fc_mapping`` over the checkpoint's keys. Returns True when
    consumed."""
    if not (name == "fc" or name.startswith("fc.")):
        return False
    rest = name[2:].lstrip(".")
    target = fc_map.get(rest) if rest else "out"
    if target is None:
        return False
    if leaf == "weight":
        _set(params, (head_scope, target, "kernel"), _linear(v))
    elif leaf == "bias":
        _set(params, (head_scope, target, "bias"), v)
    return True


# ---------------------------------------------------------------------------
# Inception-v3 (torchvision naming; the reference's default backbone,
# nn/classifier.py:20-23). torchvision BasicConv2d children are `.conv`/`.bn`,
# exactly like tpuic's ConvBN (models/inception.py) — only block/branch names
# translate.
# ---------------------------------------------------------------------------

_INCEPTION_STEM = {
    "Conv2d_1a_3x3": "stem1", "Conv2d_2a_3x3": "stem2",
    "Conv2d_2b_3x3": "stem3", "Conv2d_3b_1x1": "stem4",
    "Conv2d_4a_3x3": "stem5",
}

# torchvision Mixed_* module -> inception block family (models/inception.py)
_INCEPTION_FAMILY = {
    "Mixed_5b": "A", "Mixed_5c": "A", "Mixed_5d": "A",
    "Mixed_6a": "B",
    "Mixed_6b": "C", "Mixed_6c": "C", "Mixed_6d": "C", "Mixed_6e": "C",
    "Mixed_7a": "D",
    "Mixed_7b": "E", "Mixed_7c": "E",
}

# per-family branch-name translation torchvision -> tpuic
_INCEPTION_BRANCH = {
    "A": {"branch1x1": "b1x1", "branch5x5_1": "b5_1", "branch5x5_2": "b5_2",
          "branch3x3dbl_1": "b3_1", "branch3x3dbl_2": "b3_2",
          "branch3x3dbl_3": "b3_3", "branch_pool": "bpool"},
    "B": {"branch3x3": "b3", "branch3x3dbl_1": "bd_1",
          "branch3x3dbl_2": "bd_2", "branch3x3dbl_3": "bd_3"},
    "C": {"branch1x1": "b1x1", "branch7x7_1": "b7_1", "branch7x7_2": "b7_2",
          "branch7x7_3": "b7_3", "branch7x7dbl_1": "bd_1",
          "branch7x7dbl_2": "bd_2", "branch7x7dbl_3": "bd_3",
          "branch7x7dbl_4": "bd_4", "branch7x7dbl_5": "bd_5",
          "branch_pool": "bpool"},
    "D": {"branch3x3_1": "b3_1", "branch3x3_2": "b3_2",
          "branch7x7x3_1": "b7_1", "branch7x7x3_2": "b7_2",
          "branch7x7x3_3": "b7_3", "branch7x7x3_4": "b7_4"},
    "E": {"branch1x1": "b1x1", "branch3x3_1": "b3_1",
          "branch3x3_2a": "b3_2a", "branch3x3_2b": "b3_2b",
          "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2",
          "branch3x3dbl_3a": "bd_3a", "branch3x3dbl_3b": "bd_3b",
          "branch_pool": "bpool"},
}


def convert_inception(state_dict: Mapping[str, Any],
                      backbone_scope: str = "backbone",
                      head_scope: str = "head") -> Dict[str, Dict]:
    """torchvision ``inception_v3`` (or reference Classifier-over-inception)
    state_dict -> ``{'params', 'batch_stats'}`` for tpuic InceptionV3.

    Covers the aux head (``AuxLogits.conv0/conv1/fc`` -> ``aux``), which the
    reference re-heads with a fresh Linear (nn/classifier.py:22-23). Unknown
    keys are skipped; merge with ``lenient_restore``.
    """
    sd = strip_prefixes(state_dict)
    fc_map = _head_fc_mapping(sd)
    params: Dict = {}
    stats: Dict = {}

    def put_convbn(scope: Tuple[str, ...], sub: str, leaf: str,
                   v: np.ndarray) -> None:
        if sub == "conv" and leaf == "weight":
            _set(params, scope + ("conv", "kernel"), _conv(v))
        elif sub == "bn":
            if leaf == "weight":
                _set(params, scope + ("bn", "scale"), v)
            elif leaf == "bias":
                _set(params, scope + ("bn", "bias"), v)
            elif leaf == "running_mean":
                _set(stats, scope + ("bn", "mean"), v)
            elif leaf == "running_var":
                _set(stats, scope + ("bn", "var"), v)

    for key, v in sd.items():
        parts = key.split(".")
        leaf = parts[-1]

        if parts[0] in _INCEPTION_STEM and len(parts) == 3:
            put_convbn((backbone_scope, _INCEPTION_STEM[parts[0]]),
                       parts[1], leaf, v)
            continue

        fam = _INCEPTION_FAMILY.get(parts[0])
        if fam is not None and len(parts) == 4:
            branch = _INCEPTION_BRANCH[fam].get(parts[1])
            if branch is None:
                continue
            put_convbn((backbone_scope, parts[0].lower().replace("_", ""),
                        branch), parts[2], leaf, v)
            continue

        if parts[0] == "AuxLogits":
            if parts[1] in ("conv0", "conv1") and len(parts) == 4:
                put_convbn((backbone_scope, "aux", parts[1]), parts[2],
                           leaf, v)
            elif parts[1] == "fc" and len(parts) == 3:
                if leaf == "weight":
                    _set(params, (backbone_scope, "aux", "fc", "kernel"),
                         _linear(v))
                elif leaf == "bias":
                    _set(params, (backbone_scope, "aux", "fc", "bias"), v)
            continue

        _put_head_fc(params, ".".join(parts[:-1]), leaf, v, head_scope,
                     fc_map)

    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# EfficientNet (efficientnet_pytorch naming; reference nn/classifier.py:17-18
# — that branch is broken upstream, here the intended behavior works).
# ---------------------------------------------------------------------------

# block-internal leaf module translation efficientnet_pytorch -> tpuic MBConv
_EFFNET_BLOCK_CONV = {
    "_expand_conv": "expand_conv", "_depthwise_conv": "dw_conv",
    "_project_conv": "project_conv",
}
_EFFNET_BLOCK_BN = {"_bn0": "expand_bn", "_bn1": "dw_bn", "_bn2": "project_bn"}
_EFFNET_SE = {"_se_reduce": "reduce", "_se_expand": "expand"}


def _effnet_block_coords(variant: str):
    """Flat efficientnet_pytorch block index -> tpuic ``block{stage}_{rep}``."""
    from tpuic_torch.models.efficientnet import (_BASE_BLOCKS, _SCALING,
                                                 _round_repeats)
    _, depth_mult, _ = _SCALING[variant]
    coords = []
    for si, (_, _, repeats, _, _) in enumerate(_BASE_BLOCKS):
        for r in range(_round_repeats(repeats, depth_mult)):
            coords.append(f"block{si}_{r}")
    return coords


def detect_efficientnet_variant(state_dict: Mapping[str, Any]) -> str:
    """Infer b0..b7 from the checkpoint itself.

    The flat block count separates b0 (16) and b3 (26); b1 and b2 both have
    23 blocks, so they are disambiguated by the final block's projection
    width (320 vs 352 — width multipliers 1.0 vs 1.1)."""
    from tpuic_torch.models.efficientnet import _SCALING, _round_filters

    sd = strip_prefixes(state_dict)
    idxs = [int(k.split(".")[1]) for k in sd if k.startswith("_blocks.")]
    if not idxs:
        raise ValueError("not an efficientnet_pytorch state_dict "
                         "(no _blocks.* keys)")
    n_blocks = max(idxs) + 1
    candidates = [v for v in _SCALING
                  if len(_effnet_block_coords(v)) == n_blocks]
    if not candidates:
        raise ValueError(f"no known efficientnet variant has {n_blocks} "
                         f"blocks (b0..b7 supported)")
    if len(candidates) > 1:
        proj = sd.get(f"_blocks.{n_blocks - 1}._project_conv.weight")
        if proj is not None:
            candidates = [v for v in candidates
                          if _round_filters(320, _SCALING[v][0])
                          == proj.shape[0]] or candidates
    return candidates[0]


def convert_efficientnet(state_dict: Mapping[str, Any], variant: str = "b3",
                         backbone_scope: str = "backbone",
                         head_scope: str = "head") -> Dict[str, Dict]:
    """efficientnet_pytorch state_dict -> ``{'params', 'batch_stats'}``.

    ``variant`` ('b0'..'b7') resolves the flat ``_blocks.{i}`` index into the
    tpuic ``block{stage}_{repeat}`` name (depth multiplier dependent). The
    package's ``_fc`` single Linear maps to ``head/out``; a reference-style
    MLP (``fc.0/2/4/6``) maps to the full head.
    """
    sd = strip_prefixes(state_dict)
    fc_map = _head_fc_mapping(sd)
    coords = _effnet_block_coords(variant)
    params: Dict = {}
    stats: Dict = {}

    def put_bn(scope: Tuple[str, ...], leaf: str, v: np.ndarray) -> None:
        if leaf == "weight":
            _set(params, scope + ("scale",), v)
        elif leaf == "bias":
            _set(params, scope + ("bias",), v)
        elif leaf == "running_mean":
            _set(stats, scope + ("mean",), v)
        elif leaf == "running_var":
            _set(stats, scope + ("var",), v)

    for key, v in sd.items():
        parts = key.split(".")
        leaf = parts[-1]

        if parts[0] == "_blocks" and len(parts) >= 4:
            idx = int(parts[1])
            if idx >= len(coords):
                continue
            block = coords[idx]
            mod = parts[2]
            if mod in _EFFNET_BLOCK_CONV and leaf == "weight":
                _set(params,
                     (backbone_scope, block, _EFFNET_BLOCK_CONV[mod],
                      "kernel"), _conv(v))
            elif mod in _EFFNET_BLOCK_BN:
                put_bn((backbone_scope, block, _EFFNET_BLOCK_BN[mod]),
                       leaf, v)
            elif mod in _EFFNET_SE:
                scope = (backbone_scope, block, "se", _EFFNET_SE[mod])
                if leaf == "weight":
                    _set(params, scope + ("kernel",), _conv(v))
                elif leaf == "bias":
                    _set(params, scope + ("bias",), v)
            continue

        if parts[0] == "_conv_stem" and leaf == "weight":
            _set(params, (backbone_scope, "stem_conv", "kernel"), _conv(v))
        elif parts[0] == "_bn0":
            put_bn((backbone_scope, "stem_bn"), leaf, v)
        elif parts[0] == "_conv_head" and leaf == "weight":
            _set(params, (backbone_scope, "head_conv", "kernel"), _conv(v))
        elif parts[0] == "_bn1":
            put_bn((backbone_scope, "head_bn"), leaf, v)
        elif parts[0] == "_fc":
            if leaf == "weight":
                _set(params, (head_scope, "out", "kernel"), _linear(v))
            elif leaf == "bias":
                _set(params, (head_scope, "out", "bias"), v)
        else:
            _put_head_fc(params, ".".join(parts[:-1]), leaf, v, head_scope,
                         fc_map)

    return {"params": params, "batch_stats": stats}


# torchvision encoder-block leaf -> (tpuic module path, is_layernorm)
_VIT_LN = {"ln_1": "ln1", "ln_2": "ln2"}
# both torchvision MLP namings: >=0.12 Sequential indices, older linear_N
_VIT_MLP = {"mlp.0": "mlp_up", "mlp.3": "mlp_down",
            "mlp.linear_1": "mlp_up", "mlp.linear_2": "mlp_down"}

_VIT_LAYER_RE = re.compile(r"^layers\.encoder_layer_(\d+)\.(.+)$")


def convert_vit(state_dict: Mapping[str, Any],
                backbone_scope: str = "backbone",
                head_scope: str = "head") -> Dict[str, Dict]:
    """torchvision ``vit_{b,l}_16``-style state_dict -> tpuic ViT trees.

    Key facts of the mapping (torchvision VisionTransformer):
    - ``conv_proj`` is the patch embedding (OIHW -> HWIO);
    - ``class_token``/``encoder.pos_embedding`` carry the same
      (cls-first, row-major patches) layout as tpuic's ``cls``/``pos_embed``;
    - ``self_attention`` is ``nn.MultiheadAttention``: ``in_proj_weight``
      is the stacked [3D, D] with rows [q; k; v] — its transpose is exactly
      tpuic's fused ``qkv`` kernel [D, 3D] (models/vit.py splits columns in
      q,k,v order, and both sides split heads contiguously);
    - ``encoder.ln`` is the final LayerNorm (-> ``ln_final``);
    - ``heads.head`` maps onto the tpuic head scope (a single Linear lands
      on 'out' and is shape-skipped by the lenient merge unless it fits —
      the reference's re-head semantics; an MLP-head Sequential maps fully).
    ViT has no BatchNorm: ``batch_stats`` is returned empty.
    """
    # ViT keys legitimately carry an inner 'encoder.' scope
    # (encoder.pos_embedding, encoder.layers...). strip_prefixes removes
    # ONE leading wrapper per kind, so a reference-wrapped checkpoint
    # ('module.encoder.' + torchvision keys) still leaves that inner scope
    # on some keys — normalize it off here.
    sd = {}
    for k, v in strip_prefixes(state_dict).items():
        if k.startswith("encoder."):
            k = k[len("encoder."):]
        sd[k] = v
    head_keys = {k[len("heads.head."):]: k for k in sd
                 if k.startswith("heads.head.")}
    # Sequential head indices -> fc0..fcK-1/out (same rule as
    # _head_fc_mapping, derived from the head's own Linear indices).
    idxs = sorted({int(m.group(1)) for k in head_keys
                   if (m := re.match(r"(\d+)\.(weight|bias)$", k))})
    head_map = {str(i): (f"fc{n}" if n < len(idxs) - 1 else "out")
                for n, i in enumerate(idxs)}
    params: Dict = {}

    def put_ln(scope: Tuple[str, ...], leaf: str, v: np.ndarray) -> None:
        if leaf == "weight":
            _set(params, scope + ("scale",), v)
        elif leaf == "bias":
            _set(params, scope + ("bias",), v)

    for key, v in sd.items():
        if key == "class_token":
            _set(params, (backbone_scope, "cls"), v)
            continue
        if key == "conv_proj.weight":
            _set(params, (backbone_scope, "patch_embed", "kernel"), _conv(v))
            continue
        if key == "conv_proj.bias":
            _set(params, (backbone_scope, "patch_embed", "bias"), v)
            continue
        if key == "pos_embedding":
            _set(params, (backbone_scope, "pos_embed"), v)
            continue
        if key in ("ln.weight", "ln.bias"):
            put_ln((backbone_scope, "ln_final"), key.split(".")[1], v)
            continue
        m = _VIT_LAYER_RE.match(key)
        if m:
            block = (backbone_scope, f"block{m.group(1)}")
            inner, leaf = m.group(2).rsplit(".", 1)
            if inner in _VIT_LN:
                put_ln(block + (_VIT_LN[inner],), leaf, v)
            elif inner == "self_attention" and leaf == "in_proj_weight":
                _set(params, block + ("attn", "qkv", "kernel"), _linear(v))
            elif inner == "self_attention" and leaf == "in_proj_bias":
                _set(params, block + ("attn", "qkv", "bias"), v)
            elif inner == "self_attention.out_proj":
                if leaf == "weight":
                    _set(params, block + ("attn", "out", "kernel"),
                         _linear(v))
                elif leaf == "bias":
                    _set(params, block + ("attn", "out", "bias"), v)
            elif inner in _VIT_MLP:
                if leaf == "weight":
                    _set(params, block + (_VIT_MLP[inner], "kernel"),
                         _linear(v))
                elif leaf == "bias":
                    _set(params, block + (_VIT_MLP[inner], "bias"), v)
            continue
        if key.startswith("heads.head."):
            rest = key[len("heads.head."):]
            parts = rest.rsplit(".", 1)
            if len(parts) == 1:  # bare heads.head.{weight,bias}: one Linear
                target, leaf = "out", parts[0]
            else:
                target, leaf = head_map.get(parts[0]), parts[1]
            if target is None:
                continue
            if leaf == "weight":
                _set(params, (head_scope, target, "kernel"), _linear(v))
            elif leaf == "bias":
                _set(params, (head_scope, target, "bias"), v)

    return {"params": params, "batch_stats": {}}


def detect_arch(state_dict: Mapping[str, Any]) -> str:
    """Sniff the backbone family from state_dict key shapes."""
    for k in state_dict:
        k = k.replace("module.", "").replace("encoder.", "")
        if k.startswith("Mixed_") or k.startswith("Conv2d_1a"):
            return "inceptionv3"
        if k.startswith("_blocks.") or k.startswith("_conv_stem"):
            return "efficientnet"
        if k == "class_token" or k.startswith("conv_proj."):
            return "vit"
        if k.startswith("layer1.") or k == "conv1.weight":
            return "resnet"
    raise ValueError("could not detect backbone family from state_dict keys")


def detect_resnet_depth(state_dict: Mapping[str, Any]) -> str:
    """'resnet{18,34,50,101,152}' from block kind + layer3 block count."""
    flat = strip_prefixes(state_dict)
    bottleneck = any(k.startswith("layer1.0.conv3") for k in flat)
    blocks = {int(m.group(1)) for k in flat
              if (m := re.match(r"layer3\.(\d+)\.", k))}
    n3 = (max(blocks) + 1) if blocks else 0
    if bottleneck:
        if n3 >= 36:
            return "resnet152"
        return "resnet101" if n3 >= 23 else "resnet50"
    return "resnet34" if n3 >= 6 else "resnet18"


def convert_state_dict(state_dict: Mapping[str, Any],
                       arch: str = "auto", **kw) -> Dict[str, Dict]:
    """Convert a supported torch state_dict to ``tpuic``'s trees.
    ``arch``: 'auto' | 'resnet*' | 'inceptionv3' | 'efficientnet-b{0..7}'
    | 'vit*'."""
    if arch == "auto":
        arch = detect_arch(state_dict)
    if arch.startswith("resnet"):
        return convert_resnet(state_dict, **kw)
    if arch.startswith("inception"):
        return convert_inception(state_dict, **kw)
    if arch.startswith("vit"):
        return convert_vit(state_dict, **kw)
    if arch.startswith("efficientnet"):
        # Bare 'efficientnet' (auto-detection): the variant comes from the
        # checkpoint; a guess would mis-key every block and the lenient
        # merge would skip the whole backbone.
        variant = (arch.rsplit("-", 1)[-1] if "-" in arch
                   else detect_efficientnet_variant(state_dict))
        return convert_efficientnet(state_dict, variant=variant, **kw)
    raise ValueError(f"unsupported arch '{arch}'")


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference ``torch.save`` checkpoint file (train.py:177-179).

    Returns ``{'epoch': int, 'best_score': float, 'state_dict': {...}}``; a
    bare state_dict file is wrapped with epoch=0/best_score=0.0."""
    import torch

    # weights_only: the payload is tensors + scalars; never unpickle code.
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "state_dict" in payload:
        return {"epoch": int(payload.get("epoch", 0)),
                "best_score": float(payload.get("best_score", 0.0)),
                "state_dict": payload["state_dict"]}
    return {"epoch": 0, "best_score": 0.0, "state_dict": payload}


def convert_reference_checkpoint(path: str,
                                 arch: str = "auto") -> Dict[str, Any]:
    """File -> ``{'params', 'batch_stats', 'epoch', 'best_score'}``."""
    payload = load_reference_checkpoint(path)
    tree = convert_state_dict(payload["state_dict"], arch=arch)
    tree["epoch"] = payload["epoch"]
    tree["best_score"] = payload["best_score"]
    return tree


def interpolate_pos_embed(pos: np.ndarray, n_target: int) -> np.ndarray:
    """Resize a ViT position embedding [1, N, D] to ``n_target`` tokens:
    the cls row passes through and the patch grid is resized as a 2D
    image, bilinearly with antialiasing (``jax.image.resize``'s
    ``"bilinear"``, which ``tpuic`` uses).  Both token counts must be cls
    + a square grid."""
    import torch
    import torch.nn.functional as F

    n_src = pos.shape[1]
    if n_src == n_target:
        return pos
    g_src = int(round((n_src - 1) ** 0.5))
    g_dst = int(round((n_target - 1) ** 0.5))
    if g_src * g_src + 1 != n_src or g_dst * g_dst + 1 != n_target:
        raise ValueError(f"non-square token grids: {n_src} -> {n_target}")
    d = pos.shape[-1]
    grid = torch.from_numpy(np.ascontiguousarray(
        pos[:, 1:], np.float32)).reshape(1, g_src, g_src, d)
    grid = F.interpolate(grid.permute(0, 3, 1, 2), size=(g_dst, g_dst),
                         mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)
    return np.concatenate(
        [pos[:, :1], grid.reshape(1, g_dst * g_dst, d).numpy()
         .astype(pos.dtype)], axis=1)


def init_from_torch(model, path: str, model_name: str, log=print) -> dict:
    """Convert the torch checkpoint at ``path`` and merge it leniently into
    the port ``model`` in place (``tpuic``'s ``init_state_from_torch``):
    the family is detected from the keys, and an unmapped or
    shape-mismatched leaf keeps the model's fresh value.  A ``*-s2d``
    model gets a pretrained 7x7 stem kernel re-indexed to its
    space-to-depth layout; a ViT whose token count differs from the
    checkpoint's gets the position embedding interpolated.  Logs and
    returns ``{"params": (loaded, total), "batch_stats": (loaded,
    total)}``, counted in leaves as ``tpuic`` counts them."""
    import torch

    from tpuic_torch.checkpoint.convert import merge_jax_variables

    tree = convert_reference_checkpoint(path)
    backbone = tree.get("params", {}).get("backbone", {})
    pe = backbone.get("pos_embed")
    live = getattr(getattr(model, "backbone", None), "pos_embed", None)
    if model_name.startswith("vit") and pe is not None and live is not None:
        n_target = live.shape[1]
        # Hidden sizes must agree already: a checkpoint of another width
        # is not mergeable, and interpolating it would only be skipped.
        if n_target != pe.shape[1] and live.shape[-1] == pe.shape[-1]:
            backbone["pos_embed"] = interpolate_pos_embed(np.asarray(pe),
                                                          n_target)
            log(f"[init] {path}: pos_embed interpolated "
                f"{pe.shape[1]} -> {n_target} tokens")
    if model_name.endswith("-s2d"):
        from tpuic_torch.models.resnet import s2d_stem_kernel
        conv1 = backbone.get("conv1")
        kshape = getattr((conv1 or {}).get("kernel"), "shape", None)
        if kshape is not None and kshape[0] == 7:
            conv1["kernel"] = s2d_stem_kernel(
                torch.from_numpy(np.asarray(conv1["kernel"]))).numpy()
        else:
            log(f"[init] {path}: no 7x7 stem kernel to convert for "
                f"{model_name} (found {kshape}); stem keeps fresh init")
    merged = merge_jax_variables(model, {"params": tree["params"],
                                         "batch_stats": tree["batch_stats"]})
    counts = {c: (len(written), len(names))
              for c, (written, names) in merged.items()}
    (n, total), (n_s, total_s) = counts["params"], counts["batch_stats"]
    log(f"[init] {path}: loaded {n}/{total} param and "
        f"{n_s}/{total_s} batch-stat leaves")
    return counts
