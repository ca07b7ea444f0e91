"""The converter's ``--verify`` on the port
(``python -m tpuic_torch.checkpoint.torch_convert``) against ``tpuic``'s
CLI, on reference-layout files built from ``tpuic``'s ``torch_ref``
replicas (resnet18 and efficientnet-b0 at 64 px, vit-tiny at 32 px): the
port's records equal ``tpuic``'s on the same file (the same leaves
mapped, the same replica keys), and both deltas are below the CLI's
1e-3.  The export direction is ``test_torch_port_convert_export.py``.

Everything runs on the CPU; the card's run of ``--verify`` (ResNet-50 on
the fused conv+BN+ReLU kernel, ViT-B/16 on flash attention) is
chip_smoke's ``[convert]``.
"""

import pytest
import torch

from _convert_ref import records as _records
from _convert_ref import reference_file as _reference_file
from _torch_threads import TORCH_THREADS

from tpuic.checkpoint import torch_convert as jconv
from tpuic.checkpoint import torch_ref as jref
from tpuic_torch.checkpoint import torch_convert as pconv
from tpuic_torch.checkpoint import torch_ref as pref

torch.set_num_threads(TORCH_THREADS)

VERIFY_CASES = (("resnet18", 64), ("efficientnet-b0", 64), ("vit-tiny", 32))


@pytest.fixture
def whole_program_flax(monkeypatch):
    """``tpuic``'s CLI with its flax ``init`` and ``apply`` each compiled
    as one program (``jax.jit``) instead of op by op: the same record in
    less than half the CPU time (op by op, most of efficientnet-b0's cost
    is compiling each eager op of ``init``)."""
    import flax.linen as nn
    import jax

    init, apply = nn.Module.init, nn.Module.apply

    def jit_init(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, **kw))(rngs, *args)

    def jit_apply(self, variables, *args, **kw):
        return jax.jit(lambda v, *a: apply(self, v, *a, **kw))(
            variables, *args)

    monkeypatch.setattr(nn.Module, "init", jit_init)
    monkeypatch.setattr(nn.Module, "apply", jit_apply)


@pytest.mark.parametrize("arch,size", VERIFY_CASES,
                         ids=[a for a, _ in VERIFY_CASES])
def test_verify_record_matches_tpuic_cli(arch, size, tmp_path, capsys,
                                         whole_program_flax):
    path = _reference_file(jref.build_reference_model, arch, size,
                           tmp_path / f"{arch}.pth")
    argv = [path, "--verify", "--image-size", str(size)]
    rc_j, (info_j, ver_j) = _records(jconv.main, argv, capsys)
    rc_p, (info_p, ver_p) = _records(pconv.main, argv + ["--device", "cpu"],
                                     capsys)
    assert rc_j == 0 and rc_p == 0
    assert info_p == info_j
    assert ver_j["verify"] == ver_p["verify"] == "ok"
    for key in ("params_mapped", "batch_stats_mapped",
                "replica_missing_keys", "replica_unexpected_keys"):
        assert ver_p[key] == ver_j[key], key
    n, total = ver_p["params_mapped"].split("/")
    assert n == total and int(total) == info_p["param_leaves"]
    assert ver_p["max_logits_delta"] < 1e-3
    assert ver_j["max_logits_delta"] < 1e-3


def test_verify_tol_is_the_gate(tmp_path, capsys):
    """``--tol`` decides the verdict, not only the mapped counts: the
    same file, every leaf mapped, fails (exit 1, ``FAIL``) under
    ``--tol 0``."""
    path = _reference_file(pref.build_reference_model, "resnet18", 32,
                           tmp_path / "r.pth")
    good, (_, ver) = _records(pconv.main, [path, "--verify", "--image-size",
                                            "32", "--device", "cpu"], capsys)
    assert good == 0 and ver["verify"] == "ok"
    bad, (_, ver) = _records(pconv.main, [path, "--verify", "--image-size",
                                           "32", "--device", "cpu", "--tol",
                                           "0"], capsys)
    assert bad == 1 and ver["verify"] == "FAIL"
