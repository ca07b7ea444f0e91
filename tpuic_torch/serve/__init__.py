"""tpuic_torch.serve — the dynamic-batching inference engine of the port,
and its CLI, ``python -m tpuic_torch.serve`` (``__main__.py``).

    from tpuic_torch.models import create_model
    from tpuic_torch.serve import InferenceEngine
    model = create_model("resnet50", 1000, dtype="float32",
                         fused_conv_bn=True)
    eng = InferenceEngine(model, variables, image_size=224,
                          input_dtype=np.uint8, normalize=True,
                          buckets=(1, 8, 32))
    eng.warmup()                      # on the card: a CUDA graph per bucket
    fut = eng.submit(images_u8)       # [n,S,S,3] -> Future
    probs, order = fut.result()

Re-exports resolve lazily (PEP 562), so importing the package loads
neither torch nor the model stack until a name is used.
"""

from __future__ import annotations

_LAZY = {
    "DEFAULT_BUCKETS": ("tpuic_torch.serve.engine", "DEFAULT_BUCKETS"),
    "InferenceEngine": ("tpuic_torch.serve.engine", "InferenceEngine"),
    "default_buckets": ("tpuic_torch.serve.engine", "default_buckets"),
    "make_forward": ("tpuic_torch.serve.engine", "make_forward"),
    "ServeStats": ("tpuic_torch.serve.metrics", "ServeStats"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value  # cache: next access skips the import
        return value
    raise AttributeError(f"module 'tpuic_torch.serve' has no attribute "
                         f"'{name}'")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
