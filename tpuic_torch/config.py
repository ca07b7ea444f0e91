"""Configuration dataclasses of the port (own copy of ``tpuic/config.py``).

Field names and defaults are ``tpuic``'s; a test holds every port field's
default equal to its ``tpuic`` counterpart.  The port carries the fields
of the slices it has ported (serving and single-device training); a
field whose feature is still to port stays in its dataclass, and the
``Trainer`` raises ``NotImplementedError`` naming it when it is set.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


#: ``tpuic``'s attention implementations (tpuic/models/vit.py).
ATTENTION_IMPLS = ("dense", "flash", "ring", "ring-flash", "ulysses",
                   "ulysses-flash")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input-pipeline settings (reference dp/loader.py + train.py:110-118)."""

    data_dir: str = ""
    # Image side length; reference hard-codes 299 (train.py:110).
    resize_size: int = 299
    # Per-device train batch size; reference default 4 per process (train.py:30).
    batch_size: int = 4
    # 0 => same as batch_size (the reference pins 1, train.py:118).
    val_batch_size: int = 0
    # Host worker threads and prefetch depth (reference: num_workers=6,
    # pin_memory=True, train.py:114).
    num_workers: int = 6
    prefetch: int = 2
    # ImageNet normalization stats (reference dp/loader.py:86-91).
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    # tpuic's native C++ decode/prep core: not ported (the NumPy path has
    # identical numerics); the Trainer refuses True.
    native: bool = True
    # tpuic's packed uint8 cache + device-side augmentation: not ported;
    # the Trainer refuses True.
    pack: bool = True
    # Global shuffle seed, folded with the epoch (pipeline.py).
    shuffle_seed: int = 0
    # Train-fold augmentation master switch (dp/loader.py:63-83).
    augment: bool = True
    # Augmentation probabilities (reference dp/loader.py:63-83).
    p_vflip: float = 0.5
    p_hflip: float = 0.5
    p_saturation: float = 0.05
    p_brightness: float = 0.05
    p_contrast: float = 0.05
    jitter_lo: float = 0.9
    jitter_hi: float = 1.1

    def resolved_val_batch_size(self) -> int:
        return self.val_batch_size or self.batch_size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model settings (reference nn/classifier.py + train.py:122-123)."""

    # Backbone name; reference default 'inceptionv3' (train.py:122).
    name: str = "inceptionv3"
    num_classes: int = 7
    # MLP head widths (reference nn/classifier.py:26-34: in->128->64->32->n).
    head_widths: Sequence[int] = (128, 64, 32)
    # Compute dtype; parameters stay float32.  bfloat16 runs convolutions
    # and matmuls in bf16 from float32 master parameters (BN statistics
    # and the loss stay float32); serving and predict compute in float32.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # BatchNorm momentum/eps matching torch defaults the reference inherits.
    bn_momentum: float = 0.9  # flax convention: ema = m*ema + (1-m)*batch
    bn_eps: float = 1e-5
    # BN batch-statistics accumulation dtype.  True (default) reduces in
    # float32 (torch/SyncBN semantics); False reduces in the compute dtype
    # (bf16), the ``--bn-bf16-stats`` bandwidth experiment.  ResNet family
    # only; InceptionV3 and EfficientNet keep float32 statistics.
    bn_f32_stats: bool = True
    # Rematerialization: not ported; the Trainer refuses True, so
    # remat_policy is carried for the config's shape only.
    remat: bool = False
    remat_policy: str = "dots"
    # Inception aux-logits loss weight (reference train.py:52).
    aux_loss_weight: float = 0.4
    # Inference-only fused conv+BN+ReLU kernel for the ResNet family
    # (tpuic_torch/kernels/conv_bn_relu.py): every conv -> BN -> ReLU of an
    # eval-mode forward is one kernel launch with BN folded into its
    # epilogue.  Parameter structure is unchanged; training ignores it.
    fused_conv_bn: bool = False
    # Attention implementation of the ViT family, one of ATTENTION_IMPLS:
    # 'dense' (matmul + f32 softmax in plain torch ops) or 'flash' (the K4
    # kernels, tpuic_torch/kernels/flash_attention.py); the ViT refuses
    # the sequence-parallel rest, which are not ported.  CNNs ignore it.
    attention: str = "dense"
    # Stochastic depth of the ViT family: not ported; the ViT refuses > 0.
    drop_path: float = 0.0
    # Training compute-dtype policy ('' | 'bf16' | 'f32'), see
    # resolve_compute_dtype.  '' leaves ``dtype`` in charge; 'bf16' forces
    # bf16 compute (the batch is cast once in the step, the loss is taken
    # on float32 logits); 'f32' forces float32.  Master parameters,
    # optimizer moments and checkpoints stay float32 either way.
    compute_dtype: str = ""

    def __post_init__(self):
        resolve_compute_dtype(self)  # validate eagerly


# Accepted spellings of the ModelConfig.compute_dtype policy -> canonical
# tag ('' = the per-model ``dtype`` field rules).
_COMPUTE_DTYPES = {"": "", "bf16": "bf16", "bfloat16": "bf16",
                   "f32": "f32", "float32": "f32"}


def resolve_compute_dtype(model: "ModelConfig") -> str:
    """Canonical compute-dtype tag of a ModelConfig: '', 'bf16' or 'f32'.
    The one normalisation point the Trainer (the model dtype override) and
    the train step (the batch cast, float32 logits) share."""
    key = str(getattr(model, "compute_dtype", "") or "").lower()
    if key not in _COMPUTE_DTYPES:
        raise ValueError(
            f"unknown compute_dtype {model.compute_dtype!r}; expected one "
            f"of {sorted(k for k in _COMPUTE_DTYPES if k)} (or '' for the "
            "per-model dtype default)")
    return _COMPUTE_DTYPES[key]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule (reference train.py:127, 156-158)."""

    optimizer: str = "adam"  # 'adam' | 'lars' | 'lamb' | 'sgd'
    # Reference lr=0.5e-5 (train.py:127).
    learning_rate: float = 0.5e-5
    # MultiStepLR milestones=[50, 80], gamma=0.5 (train.py:156).
    milestones: Sequence[int] = (50, 80)
    gamma: float = 0.5
    # CE class weights; the reference hard-codes a 7-class imbalance vector
    # (train.py:157-158).  Empty => unweighted.
    class_weights: Sequence[float] = (3.0, 3.0, 10.0, 1.0, 4.0, 4.0, 5.0)
    # Inverse-frequency weights from the train fold's class counts
    # (w_c = N / (K * n_c)); overrides class_weights.
    auto_class_weights: bool = False
    weight_decay: float = 0.0
    # Mixup / CutMix / random erasing: not ported; the Trainer refuses > 0.
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    random_erase: float = 0.0
    # LARS settings for the large-batch config (BASELINE.md config 5).
    lars_momentum: float = 0.9
    lars_trust_coefficient: float = 0.001
    # LAMB (arXiv:1904.00962) moments.
    lamb_b1: float = 0.9
    lamb_b2: float = 0.999
    lamb_eps: float = 1e-6
    # Goyal linear-scaling rule: peak lr = learning_rate * global_batch /
    # base_batch_size, reached by a linear warmup (0 disables).
    base_batch_size: int = 0
    warmup_epochs: int = 0
    grad_clip_norm: float = 0.0
    # Gradient accumulation: not ported; the Trainer refuses > 1.
    grad_accum_steps: int = 1
    label_smoothing: float = 0.0
    # Parameter EMA: not ported; the Trainer refuses > 0.
    ema_decay: float = 0.0
    # Head-only fine-tuning: not ported; the Trainer refuses True.
    freeze_backbone: bool = False
    # Fused weighted cross-entropy kernel K1
    # (tpuic_torch/kernels/cross_entropy.py) in the train step.
    fused_loss: bool = False
    # Fused multi-tensor LARS/LAMB update kernel K2
    # (tpuic_torch/kernels/optimizer_update.py) for 'lars' / 'lamb'.
    fused_optimizer: bool = False
    # Static loss scaling: the backward runs on loss * loss_scale, then
    # the loss and the gradients are divided by it.
    loss_scale: float = 1.0
    # Non-finite step guard: a NaN/Inf loss or gradient norm leaves the
    # whole state unchanged (params, optimizer state, BN statistics, step)
    # and counts the skip, with no host sync.
    skip_nonfinite: bool = True

    def __post_init__(self):
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1); got "
                             f"{self.ema_decay}")
        if not 0.0 <= self.random_erase <= 1.0:
            raise ValueError(f"random_erase is a probability in [0, 1]; "
                             f"got {self.random_erase}")
        if not self.loss_scale > 0.0:
            raise ValueError(f"loss_scale must be > 0; got "
                             f"{self.loss_scale}")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-loop settings (reference train.py:131-188)."""

    epochs: int = 100  # reference range(100), train.py:161
    # Checkpoints: {ckpt_dir}/{model name}/best on every val improvement,
    # /latest every save_period epochs (train.py:173-188); resume restores
    # the newest of the two (tpuic_torch/checkpoint/manager.py).
    ckpt_dir: str = "dtmodel/cp"
    save_period: int = 5
    resume: bool = True
    # A reference torch checkpoint to start from (``{'state_dict': ...}``
    # or a bare state_dict, family detected from its keys), merged
    # leniently (``checkpoint.torch_convert``).  Inference loading takes
    # it over the tracks; the Trainer does not take it yet.
    init_from: str = ""
    # Metric readback cadence: one host read per this many steps.
    log_every_steps: int = 50
    seed: int = 0
    # Stop after this many optimizer steps regardless of epochs (0 = no
    # cap); a mid-epoch stop skips the epoch's val pass.
    max_steps: int = 0
    # Write and commit a checkpoint on a background thread, after its
    # tensors were copied to the host on the caller's thread; False
    # commits before the save returns.
    async_checkpoint: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes.  The port trains on one device: an axis above 1,
    ``fsdp`` or ``zero1`` makes the Trainer raise."""

    data: int = 0  # 0 => all devices / (seq * model)
    seq: int = 1
    model: int = 1
    fsdp: bool = False
    zero1: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
