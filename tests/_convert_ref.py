"""Reference-layout torch checkpoints for the converter's tests
(``tests/test_torch_port_convert_*.py``): a bare replica's
``{'epoch', 'best_score', 'state_dict'}`` with DDP's ``module.encoder.``
keys, and the JSON records a converter CLI prints."""

import json

import torch

CLASSES = 5


def reference_file(build, arch: str, size: int, path, seed: int = 0,
                   mlp_head: bool = True) -> str:
    """A reference checkpoint of ``build``'s replica of ``arch``, its BN
    statistics and affine drawn away from 0/1 so their mapping shows."""
    torch.manual_seed(seed)
    m = build(arch, CLASSES, mlp_head=mlp_head, image_size=size)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                mod.weight.copy_(torch.rand(c, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(c, generator=g) * 0.1)
    torch.save({"epoch": 4, "best_score": 61.5,
                "state_dict": {"module.encoder." + k: v
                               for k, v in m.state_dict().items()}},
               str(path))
    return str(path)


def records(main, argv, capsys) -> tuple:
    """``main(argv)``'s exit code and the JSON records it printed."""
    rc = main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return rc, lines
