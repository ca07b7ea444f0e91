"""tpuic_torch — the PyTorch/CUDA port of ``tpuic`` for NVIDIA Hopper.

The JAX package ``tpuic`` stays the reference; this package reproduces its
behaviour and names in PyTorch idiom, one slice at a time.  It imports
``torch`` and never ``jax`` or anything of ``tpuic``: what it needs from
there it keeps as its own copy.

- ``tpuic_torch.config``     — the configuration dataclasses
- ``tpuic_torch.kernels``    — hand-written Hopper kernels, each beside its
                               plain PyTorch version (fused conv+BN+ReLU,
                               fused cross-entropy, fused LARS/LAMB, flash
                               attention)
- ``tpuic_torch.models``     — the ResNet, InceptionV3, EfficientNet, ViT
                               and Switch-MoE ViT families + the MLP
                               classifier head, with the flax module names
- ``tpuic_torch.checkpoint`` — carry a ``tpuic`` variables tree, optimizer
                               state or reference torch checkpoint into the
                               port, and a port model back out to both;
                               initialisation; the port's own checkpoints;
                               ``python -m
                               tpuic_torch.checkpoint.torch_convert``
                               (``--verify`` against the bare-torch
                               replicas of ``torch_ref``,
                               ``--export-torch``)
- ``tpuic_torch.data``       — ImageFolder decode/augment and the Loader
- ``tpuic_torch.train``      — loss, optimizers, schedules, steps and
                               their draws (mixup, CutMix, erasing,
                               drop-path), the Trainer and
                               ``python -m tpuic_torch.train``
- ``tpuic_torch.serve``      — the dynamic-batching inference engine (one
                               CUDA graph per padding bucket) and
                               ``python -m tpuic_torch.serve``; the front
                               tier over its replicas, stdlib only: the
                               router (``python -m
                               tpuic_torch.serve.router``), the canary
                               rollout (``python -m
                               tpuic_torch.serve.rollout``), the HTTP
                               front end and the load generator
- ``tpuic_torch.predict``    — ``python -m tpuic_torch.predict``: score an
                               ImageFolder fold to CSV
- ``tpuic_torch.runtime``    — the SIGTERM latch, the process group, the
                               fault points and the supervisors
- ``tpuic_torch.telemetry``  — the event bus, step breakdown, goodput and
                               MFU, memory, SLOs, triggered
                               ``torch.profiler`` windows and their
                               kernel-class waterfall, Prometheus text

Entry points that place tensors take ``device=None``, which means
``"cuda"``; with no CUDA device they raise instead of falling back to the
CPU.  Pass ``device="cpu"`` to run on the CPU (the tests do).

Nothing heavy is imported here: ``import tpuic_torch`` does not load torch.
"""

__version__ = "0.1.0"
