"""Reference torch checkpoints -> the port's models
(``tpuic/checkpoint/torch_convert.py``, the families the port has), and
back, with ``tpuic``'s CLI
(``python -m tpuic_torch.checkpoint.torch_convert``).

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

The inverse direction: ``export_resnet``, ``export_inception``,
``export_efficientnet``, ``export_vit`` and ``export_state_dict`` write a
``tpuic`` tree (a port model's, through ``convert.export_jax_variables``)
as a reference-layout state dict with DDP's ``module.encoder.`` prefix.

CLI: ``python -m tpuic_torch.checkpoint.torch_convert CKPT [--verify]``
prints what the file holds and, with ``--verify``, holds the port model
against ``checkpoint/torch_ref.py``'s bare replica on the same weights;
``--export-torch OUT CKPT_DIR/<model>/<track>`` writes a port checkpoint
out in the reference layout (``--verify`` then checks the written file).
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


def detect_vit_variant(state_dict: Mapping[str, Any]) -> str:
    """The model name (``tpuic``'s) from the patch-embedding shape
    [D, 3, p, p]."""
    sd = strip_prefixes(state_dict)
    w = sd.get("conv_proj.weight")
    if w is None:
        raise ValueError("no conv_proj.weight in state_dict")
    hidden, _, patch, _ = w.shape
    names = {(768, 16): "vit-b16", (1024, 16): "vit-l16",
             (768, 32): "vit-b32", (1024, 32): "vit-l32",
             (384, 16): "vit-s16", (64, 4): "vit-tiny"}
    name = names.get((int(hidden), int(patch)))
    if name is None:
        raise ValueError(
            f"no tpuic ViT for hidden={hidden}, patch={patch} "
            f"(supported: {sorted(names.values())})")
    return name


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


# ---------------------------------------------------------------------------
# Inverse direction: tpuic trees -> reference torch state_dict
# (``tpuic/checkpoint/torch_convert.py:711-995``; a port model gives its
# tree through ``convert.export_jax_variables``)
# ---------------------------------------------------------------------------

def _unbox(leaf):
    return np.asarray(getattr(leaf, "value", leaf))


def _conv_inv(w) -> np.ndarray:
    return np.transpose(_unbox(w), (3, 2, 0, 1))  # HWIO -> OIHW


_RESNET_LEAF_INV = {v: k for k, v in _RESNET_LEAF.items()}


def _put_bn_inv(sd: Dict[str, np.ndarray], tname: str,
                p: Mapping, s: Mapping) -> None:
    """Emit one BatchNorm's torch keys from tpuic params/stats subtrees
    (shared by every exporter; num_batches_tracked re-synthesized as 0)."""
    sd[f"{tname}.weight"] = _unbox(p["scale"])
    sd[f"{tname}.bias"] = _unbox(p["bias"])
    sd[f"{tname}.running_mean"] = _unbox(s["mean"])
    sd[f"{tname}.running_var"] = _unbox(s["var"])
    sd[f"{tname}.num_batches_tracked"] = np.asarray(0, np.int64)


def _export_head(head: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """tpuic head/{fc0..,out} -> fc.{0,2,4,...} Sequential keys (ReLUs take
    the odd slots), or the plain torchvision 'fc' for a single Linear."""
    sd: Dict[str, np.ndarray] = {}
    fcs = sorted((m for m in head if re.fullmatch(r"fc\d+", m)),
                 key=lambda m: int(m[2:]))
    for i, mod in enumerate(fcs):
        sd[f"fc.{2 * i}.weight"] = np.transpose(_unbox(head[mod]["kernel"]))
        sd[f"fc.{2 * i}.bias"] = _unbox(head[mod]["bias"])
    if "out" in head:
        out_name = f"fc.{2 * len(fcs)}" if fcs else "fc"
        sd[f"{out_name}.weight"] = np.transpose(_unbox(head["out"]["kernel"]))
        sd[f"{out_name}.bias"] = _unbox(head["out"]["bias"])
    return sd


def export_resnet(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                  prefix: str = "module.encoder.") -> Dict[str, np.ndarray]:
    """tpuic resnet {'params','batch_stats'} -> reference-layout state_dict.

    The exact inverse of ``convert_resnet`` (HWIO->OIHW convs, transposed
    linears, scale/bias->weight/bias, mean/var->running_mean/running_var,
    with num_batches_tracked=0 re-synthesized and DDP's ``module.encoder.``
    prefix re-applied by default — reference train.py:179 saves it). Lets a
    tpuic-trained model flow back into the reference's resume path
    (train.py:132-150) or any torchvision consumer.
    """
    bb = params.get("backbone", {})
    bs = batch_stats.get("backbone", {})
    head = params.get("head", {})
    if not any(n.startswith("layer") for n in bb):
        raise ValueError(
            "export_resnet: params['backbone'] has no 'layer*' modules — "
            f"not a resnet checkpoint (got {sorted(bb)[:6]}...); only the "
            "resnet family exports to the torch layout")
    sd: Dict[str, np.ndarray] = {}
    put_bn = lambda tname, p, s: _put_bn_inv(sd, tname, p, s)  # noqa: E731

    for name, sub in bb.items():
        if name == "conv1":
            sd["conv1.weight"] = _conv_inv(sub["kernel"])
        elif name == "bn1":
            put_bn("bn1", sub, bs["bn1"])
        elif name.startswith("layer"):
            stage, block = name[len("layer"):].split("_")
            for mod, leaves in sub.items():
                torch_mod = _RESNET_LEAF_INV.get(mod)
                if torch_mod is None:
                    continue
                tname = f"layer{stage}.{block}.{torch_mod}"
                if "kernel" in leaves:
                    sd[f"{tname}.weight"] = _conv_inv(leaves["kernel"])
                else:
                    put_bn(tname, leaves, bs[name][mod])
    sd.update(_export_head(head))
    return {prefix + k: v for k, v in sd.items()}


def export_inception(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any],
                     prefix: str = "module.encoder.") -> Dict[str, np.ndarray]:
    """tpuic InceptionV3 trees -> torchvision-layout state_dict (incl. the
    aux head) — the inverse of ``convert_inception``, covering the
    reference's DEFAULT backbone (train.py:122)."""
    bb = params.get("backbone", {})
    bs = batch_stats.get("backbone", {})
    if "mixed5b" not in bb:
        raise ValueError(
            "export_inception: params['backbone'] has no 'mixed5b' — not an "
            f"inception checkpoint (got {sorted(bb)[:6]}...)")
    stem_inv = {v: k for k, v in _INCEPTION_STEM.items()}
    block_inv = {k.lower().replace("_", ""): k for k in _INCEPTION_FAMILY}
    branch_inv = {fam: {v: k for k, v in m.items()}
                  for fam, m in _INCEPTION_BRANCH.items()}
    sd: Dict[str, np.ndarray] = {}

    def put_convbn(tname: str, p: Mapping, s: Mapping) -> None:
        sd[f"{tname}.conv.weight"] = _conv_inv(p["conv"]["kernel"])
        _put_bn_inv(sd, f"{tname}.bn", p["bn"], s["bn"])

    for name, sub in bb.items():
        if name in stem_inv:
            put_convbn(stem_inv[name], sub, bs[name])
        elif name in block_inv:
            tblock = block_inv[name]
            fam = _INCEPTION_FAMILY[tblock]
            for br, leaves in sub.items():
                tbranch = branch_inv[fam].get(br)
                if tbranch is not None:
                    put_convbn(f"{tblock}.{tbranch}", leaves, bs[name][br])
        elif name == "aux":
            for conv in ("conv0", "conv1"):
                if conv in sub:
                    put_convbn(f"AuxLogits.{conv}", sub[conv],
                               bs["aux"][conv])
            if "fc" in sub:
                sd["AuxLogits.fc.weight"] = np.transpose(
                    _unbox(sub["fc"]["kernel"]))
                sd["AuxLogits.fc.bias"] = _unbox(sub["fc"]["bias"])
    sd.update(_export_head(params.get("head", {})))
    return {prefix + k: v for k, v in sd.items()}


def export_efficientnet(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any],
                        prefix: str = "module.encoder."
                        ) -> Dict[str, np.ndarray]:
    """tpuic EfficientNet trees -> efficientnet_pytorch-layout state_dict.

    The inverse of ``convert_efficientnet``. The flat ``_blocks.{i}`` index
    is reconstructed by enumerating ``block{stage}_{repeat}`` names in
    (stage, repeat) order, so no variant knowledge is needed — any b0..b7
    tree round-trips. A single-Linear head exports as the package's
    ``_fc``; a reference-style MLP head exports as ``fc.{0,2,...}``.
    """
    bb = params.get("backbone", {})
    bs = batch_stats.get("backbone", {})
    if "stem_conv" not in bb or not any(n.startswith("block") for n in bb):
        raise ValueError(
            "export_efficientnet: params['backbone'] has no stem_conv/"
            f"block* modules — not an efficientnet checkpoint "
            f"(got {sorted(bb)[:6]}...)")
    conv_inv = {v: k for k, v in _EFFNET_BLOCK_CONV.items()}
    bn_inv = {v: k for k, v in _EFFNET_BLOCK_BN.items()}
    se_inv = {v: k for k, v in _EFFNET_SE.items()}
    sd: Dict[str, np.ndarray] = {}
    put_bn = lambda tname, p, s: _put_bn_inv(sd, tname, p, s)  # noqa: E731

    def coord_key(name: str) -> Tuple[int, int]:
        stage, rep = name[len("block"):].split("_")
        return int(stage), int(rep)

    blocks = sorted((n for n in bb if re.fullmatch(r"block\d+_\d+", n)),
                    key=coord_key)
    for i, name in enumerate(blocks):
        sub, stats = bb[name], bs.get(name, {})
        for mod, leaves in sub.items():
            if mod in conv_inv:
                sd[f"_blocks.{i}.{conv_inv[mod]}.weight"] = _conv_inv(
                    leaves["kernel"])
            elif mod in bn_inv:
                put_bn(f"_blocks.{i}.{bn_inv[mod]}", leaves, stats[mod])
            elif mod == "se":
                for part, tpart in se_inv.items():
                    sd[f"_blocks.{i}.{tpart}.weight"] = _conv_inv(
                        leaves[part]["kernel"])
                    sd[f"_blocks.{i}.{tpart}.bias"] = _unbox(
                        leaves[part]["bias"])
    sd["_conv_stem.weight"] = _conv_inv(bb["stem_conv"]["kernel"])
    put_bn("_bn0", bb["stem_bn"], bs["stem_bn"])
    sd["_conv_head.weight"] = _conv_inv(bb["head_conv"]["kernel"])
    put_bn("_bn1", bb["head_bn"], bs["head_bn"])
    head = params.get("head", {})
    if any(re.fullmatch(r"fc\d+", m) for m in head):
        sd.update(_export_head(head))      # reference MLP -> fc.{0,2,...}
    elif "out" in head:
        sd["_fc.weight"] = np.transpose(_unbox(head["out"]["kernel"]))
        sd["_fc.bias"] = _unbox(head["out"]["bias"])
    return {prefix + k: v for k, v in sd.items()}


def export_vit(params: Mapping[str, Any],
               batch_stats: Mapping[str, Any],
               prefix: str = "module.encoder.") -> Dict[str, np.ndarray]:
    """tpuic ViT trees -> torchvision vision_transformer-layout state_dict —
    the inverse of ``convert_vit`` (current >=0.12 ``mlp.{0,3}`` naming).
    ``batch_stats`` is accepted for dispatch symmetry; ViT has none."""
    del batch_stats
    bb = params.get("backbone", {})
    if "patch_embed" not in bb:
        raise ValueError(
            "export_vit: params['backbone'] has no 'patch_embed' — not a "
            f"ViT checkpoint (got {sorted(bb)[:6]}...)")
    sd: Dict[str, np.ndarray] = {}
    sd["class_token"] = _unbox(bb["cls"])
    sd["conv_proj.weight"] = _conv_inv(bb["patch_embed"]["kernel"])
    sd["conv_proj.bias"] = _unbox(bb["patch_embed"]["bias"])
    sd["encoder.pos_embedding"] = _unbox(bb["pos_embed"])
    sd["encoder.ln.weight"] = _unbox(bb["ln_final"]["scale"])
    sd["encoder.ln.bias"] = _unbox(bb["ln_final"]["bias"])
    ln_inv = {v: k for k, v in _VIT_LN.items()}
    mlp_inv = {"mlp_up": "mlp.0", "mlp_down": "mlp.3"}
    for name, sub in bb.items():
        if not name.startswith("block"):
            continue
        if "moe" in sub:
            # Switch-MoE experts/router have no torchvision layout —
            # exporting would silently drop every MoE MLP.
            raise ValueError(
                f"export_vit: {name} contains a Switch-MoE MLP; MoE ViTs "
                "(vit-*-moe) have no torch export target")
        t = f"encoder.layers.encoder_layer_{name[len('block'):]}"
        for mod, leaves in sub.items():
            if mod in ln_inv:
                sd[f"{t}.{ln_inv[mod]}.weight"] = _unbox(leaves["scale"])
                sd[f"{t}.{ln_inv[mod]}.bias"] = _unbox(leaves["bias"])
            elif mod == "attn":
                sd[f"{t}.self_attention.in_proj_weight"] = np.transpose(
                    _unbox(leaves["qkv"]["kernel"]))
                sd[f"{t}.self_attention.in_proj_bias"] = _unbox(
                    leaves["qkv"]["bias"])
                sd[f"{t}.self_attention.out_proj.weight"] = np.transpose(
                    _unbox(leaves["out"]["kernel"]))
                sd[f"{t}.self_attention.out_proj.bias"] = _unbox(
                    leaves["out"]["bias"])
            elif mod in mlp_inv:
                sd[f"{t}.{mlp_inv[mod]}.weight"] = np.transpose(
                    _unbox(leaves["kernel"]))
                sd[f"{t}.{mlp_inv[mod]}.bias"] = _unbox(leaves["bias"])
    # Head: _export_head emits fc.* keys ('fc.N.*' for the MLP Sequential,
    # bare 'fc.weight' for one Linear); torchvision's scope is heads.head.
    for k, v in _export_head(params.get("head", {})).items():
        sd["heads.head." + k[len("fc."):]] = v
    return {prefix + k: v for k, v in sd.items()}


def export_state_dict(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any],
                      prefix: str = "module.encoder.") -> Dict[str, np.ndarray]:
    """Auto-dispatch tpuic->torch export by sniffing the backbone tree."""
    bb = params.get("backbone", {})
    if any(n.startswith("layer") for n in bb):
        return export_resnet(params, batch_stats, prefix)
    if "mixed5b" in bb:
        return export_inception(params, batch_stats, prefix)
    if "stem_conv" in bb:
        return export_efficientnet(params, batch_stats, prefix)
    if "patch_embed" in bb:
        return export_vit(params, batch_stats, prefix)
    raise ValueError(
        "export_state_dict: unsupported backbone for torch export "
        f"(got {sorted(bb)[:6]}...); supported: resnet*, inceptionv3, "
        "efficientnet-b*, vit*")


# ---------------------------------------------------------------------------
# CLI:  python -m tpuic_torch.checkpoint.torch_convert <ckpt> [--verify]
# ---------------------------------------------------------------------------

def _infer_head(state_dict: Mapping[str, Any]) -> Tuple[int, bool]:
    """(num_classes, mlp_head) from the checkpoint's own head keys."""
    flat = strip_prefixes(state_dict)
    fc_map = _head_fc_mapping(flat)
    out_idx = next((i for i, t in fc_map.items() if t == "out"), None)
    if out_idx is not None:       # Sequential MLP head (reference layout)
        return int(flat[f"fc.{out_idx}.bias"].shape[0]), len(fc_map) > 1
    for k in ("fc.bias", "_fc.bias"):   # plain torchvision / effnet _fc
        if k in flat:
            return int(flat[k].shape[0]), False
    # ViT scope (torchvision heads.head): Sequential MLP or one Linear.
    hh = sorted(int(m.group(1)) for k in flat
                if (m := re.match(r"heads\.head\.(\d+)\.bias$", k)))
    if hh:
        return int(flat[f"heads.head.{hh[-1]}.bias"].shape[0]), len(hh) > 1
    if "heads.head.bias" in flat:
        return int(flat["heads.head.bias"].shape[0]), False
    raise ValueError("cannot infer num_classes: no fc head keys found")


def _iter_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _iter_leaves(v)
        else:
            yield v


def _export_port_checkpoint(path: str, out: str, device) -> dict:
    """``--export-torch``: the port checkpoint track at ``path``
    (``ckpt_dir/<model>/{best|latest}``) -> a reference-layout torch file
    ``{'epoch', 'best_score', 'state_dict'}`` at ``out``, keys under
    ``module.encoder.``.  The track's parameters are exported (not its
    EMA), as ``tpuic`` exports its Orbax ``params``."""
    import json
    import os
    import sys

    import torch

    from tpuic_torch.checkpoint.convert import export_jax_variables
    from tpuic_torch.checkpoint.loading import load_inference_variables
    from tpuic_torch.config import Config, DataConfig, OptimConfig, RunConfig
    from tpuic_torch.predict import serving_model_config

    path = os.path.abspath(path)
    root, track = os.path.split(path)
    ckpt_dir, model_name = os.path.split(root)
    sidecar = os.path.join(root, "config.json")
    if not os.path.isfile(sidecar):
        raise FileNotFoundError(
            f"{path}: no config.json beside the track (expected a port "
            "checkpoint, ckpt_dir/<model>/{best|latest})")
    with open(sidecar) as f:
        saved = json.load(f)
    cfg = Config(data=DataConfig(data_dir=".",
                                 resize_size=int(saved["data"]
                                                 ["resize_size"])),
                 model=serving_model_config(
                     model_name, int(saved["model"]["num_classes"])),
                 optim=OptimConfig(ema_decay=0.0),
                 run=RunConfig(ckpt_dir=ckpt_dir))
    model = load_inference_variables(
        cfg, track=track, device=device,
        log=lambda *a: print(*a, file=sys.stderr))
    tree = export_jax_variables(model)
    sd = export_state_dict(tree["params"], tree["batch_stats"])
    meta = {}
    meta_path = path + ".meta.json"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    epoch = int(meta.get("epoch", 0))
    torch.save({"epoch": epoch,
                "best_score": float(meta.get("best_score", 0.0)),
                "state_dict": {k: torch.as_tensor(np.asarray(v))
                               for k, v in sd.items()}}, out)
    return {"exported": out, "keys": len(sd), "epoch": epoch}


def _replica_state_dict(sd: Mapping[str, Any], arch: str) -> Dict[str, Any]:
    """The checkpoint's keys as the bare replica names them: DDP's and the
    reference's wrappers off; a ViT keeps its real inner ``encoder.``
    scope (one ``encoder.`` comes off only when the checkpoint is
    reference-wrapped, i.e. has no bare ``conv_proj`` at the top)."""
    import torch

    if arch.startswith("vit"):
        raw = {(k[len("module."):] if k.startswith("module.") else k): v
               for k, v in sd.items()}
        if not any(k.startswith("conv_proj") for k in raw):
            raw = {(k[len("encoder."):] if k.startswith("encoder.")
                    else k): v for k, v in raw.items()}
        return {k: torch.as_tensor(np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v))
            for k, v in raw.items()}
    return {k: torch.as_tensor(np.asarray(v))
            for k, v in strip_prefixes(sd).items()}


def main(argv=None) -> int:
    """Inspect a reference/torchvision checkpoint; optionally verify the
    port against it, or export a port checkpoint to it (``tpuic``'s CLI,
    ``tpuic/checkpoint/torch_convert.py:996``).

    ``--verify`` loads the checkpoint BOTH into a bare-torch replica of the
    reference Classifier (``checkpoint/torch_ref.py``, exact upstream
    module naming) and, through the converter and ``init_from_torch``'s
    lenient merge, into the port model, then prints the max |delta
    logits| on seeded random inputs.  Both forwards run on ``--device``
    (default: the card) with TF32 off; the port's is the serving forward,
    so on the card a ResNet runs the fused conv+BN+ReLU kernel and a ViT
    flash attention.  ``--export-torch OUT`` writes a port checkpoint out
    in the reference layout, and composes with ``--verify``, which then
    checks the file it wrote."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m tpuic_torch.checkpoint.torch_convert",
        description=main.__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", help="reference best_model/latest_model "
                    "file or a bare torch state_dict file; with "
                    "--export-torch, a port checkpoint track "
                    "(ckpt_dir/<model>/{best|latest})")
    ap.add_argument("--arch", default="auto",
                    help="backbone family (default: sniffed from keys)")
    ap.add_argument("--verify", action="store_true",
                    help="run the torch replica against the port model and "
                    "print the max logits delta")
    ap.add_argument("--export-torch", metavar="OUT", default="",
                    help="INVERSE direction: read a port checkpoint track "
                    "and write a reference-layout torch file (resnet, "
                    "inceptionv3, efficientnet, vit families) to OUT; "
                    "composes with --verify")
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="--verify failure threshold on max |delta|")
    ap.add_argument("--device", default=None,
                    help="where the port model and the replica run "
                    "(default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)

    if args.export_torch:
        print(json.dumps(_export_port_checkpoint(
            args.checkpoint, args.export_torch, args.device)))
        if not args.verify:
            return 0
        # --verify composes: validate the exported file like any
        # reference checkpoint.
        args.checkpoint = args.export_torch

    payload = load_reference_checkpoint(args.checkpoint)
    sd = payload["state_dict"]
    arch = args.arch if args.arch != "auto" else detect_arch(sd)
    if arch == "efficientnet":
        arch = f"efficientnet-{detect_efficientnet_variant(sd)}"
    elif arch == "resnet":
        arch = detect_resnet_depth(sd)
    elif arch == "vit":
        arch = detect_vit_variant(sd)
    tree = convert_state_dict(sd, arch=arch)
    n_params = len([1 for _ in _iter_leaves(tree["params"])])
    n_stats = len([1 for _ in _iter_leaves(tree["batch_stats"])])
    num_classes, mlp_head = _infer_head(sd)
    print(json.dumps({
        "checkpoint": args.checkpoint, "arch": arch,
        "epoch": payload["epoch"], "best_score": payload["best_score"],
        "num_classes": num_classes, "mlp_head": mlp_head,
        "param_leaves": n_params, "batch_stat_leaves": n_stats}))
    if not args.verify:
        return 0

    import torch

    from tpuic_torch.checkpoint.convert import init_params
    from tpuic_torch.checkpoint.torch_ref import build_reference_model
    from tpuic_torch.device import resolve_device
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.models import create_model

    dev = resolve_device(args.device)
    size = args.image_size
    if arch.startswith("vit"):
        # The pos-embedding length fixes the ViT's image size: verify at
        # the checkpoint's own size, whatever --image-size says.
        flat = strip_prefixes(sd)
        pe = flat.get("pos_embedding", flat.get("encoder.pos_embedding"))
        patch = flat["conv_proj.weight"].shape[-1]
        if pe is not None:
            size = int(patch) * int(round((pe.shape[1] - 1) ** 0.5))
    replica = build_reference_model(arch, num_classes, mlp_head=mlp_head,
                                    image_size=size).eval()
    missing, unexpected = replica.load_state_dict(
        _replica_state_dict(sd, arch), strict=False)
    replica.to(dev)
    kw = {} if mlp_head else {"head_widths": ()}
    # The serving forward: float32, fused conv+BN+ReLU, flash attention.
    model = init_params(create_model(
        arch, num_classes, dtype="float32", fused_conv_bn=True,
        attention="flash", image_size=size, device=dev, **kw), 0,
        device=dev).eval()
    counts = init_from_torch(model, args.checkpoint, arch,
                             log=lambda m: print(m, file=sys.stderr))
    (n_loaded, n_total), (n_s, n_s_total) = (counts["params"],
                                             counts["batch_stats"])
    x = np.random.default_rng(0).normal(
        size=(args.batch, size, size, 3)).astype(np.float32)
    with torch.no_grad(), no_tf32():
        xt = torch.from_numpy(x).to(dev)
        want = replica(xt.permute(0, 3, 1, 2)).float().cpu().numpy()
        got = model(xt).float().cpu().numpy()
    delta = float(np.abs(got - want).max())
    ok = (delta < args.tol and n_loaded == n_total and n_s == n_s_total
          and not missing)
    print(json.dumps({
        "verify": "ok" if ok else "FAIL",
        "max_logits_delta": delta,
        "params_mapped": f"{n_loaded}/{n_total}",
        "batch_stats_mapped": f"{n_s}/{n_s_total}",
        "replica_missing_keys": len(missing),
        "replica_unexpected_keys": len(unexpected)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
