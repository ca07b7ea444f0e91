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
- ``tpuic_torch.models``     — the ResNet and ViT families + the MLP
                               classifier head, with the flax module names
- ``tpuic_torch.checkpoint`` — carry a ``tpuic`` variables tree or optimizer
                               state into the port; initialisation
- ``tpuic_torch.data``       — ImageFolder decode/augment and the Loader
- ``tpuic_torch.train``      — loss, optimizers, schedules, steps, the
                               Trainer and ``python -m tpuic_torch.train``
- ``tpuic_torch.serve``      — the dynamic-batching inference engine

Entry points that place tensors take ``device=None``, which means
``"cuda"``; with no CUDA device they raise instead of falling back to the
CPU.  Pass ``device="cpu"`` to run on the CPU (the tests do).

Nothing heavy is imported here: ``import tpuic_torch`` does not load torch.
"""

__version__ = "0.1.0"
