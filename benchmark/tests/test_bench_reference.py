"""The plain reference against the program on the CPU at tiny sizes, and
its imports."""
from __future__ import annotations

import ast

import pytest
import torch

from bench_tiny import BENCH, TINY_SWIN, TINY_VIT
from harness import check, models, specs


def _program_logits(spec, ip, codes, resident):
    from diffvit_tpu_torch import engine
    from diffvit_tpu_torch.config import QuantConfig
    from diffvit_tpu_torch.models.swin import SwinSpec
    from diffvit_tpu_torch.models.vit import ViTSpec

    cls = SwinSpec if isinstance(spec, specs.Swin) else ViTSpec
    model = engine.IntModel(ip, cls(**spec.program_fields()),
                            QuantConfig.from_dict(spec.quant.as_dict()),
                            "cpu", resident=resident)
    return model(torch.from_numpy(codes)).float()


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
@pytest.mark.parametrize("config,resident", [
    (TINY_VIT, False), (TINY_VIT, True), (TINY_SWIN, False)],
    ids=["vit.kernels", "vit.resident", "swin.kernels"])
def test_reference_equals_program(config, resident, seed):
    torch.set_num_threads(2)
    spec = specs.from_config(config)
    rm, rp, _, _ = models.streams(seed)
    ip = models.int_model(spec, rm)
    codes = models.codes_pool(spec, ip, 5, rp)
    got = _program_logits(spec, ip, codes, resident)
    want = check.reference_logits(spec, ip, codes, "cpu")
    assert torch.equal(got, want)
    ctrl = check.reference_logits(spec, ip, codes, "cpu", control=True)
    n = check.numbers(spec, ip, ctrl, want)
    assert n["gap_steps"] >= 1 and n["mismatch_pct"] >= 1


def test_code_table_is_the_programs():
    from diffvit_tpu_torch.data.imagenet import input_code_lut

    spec = specs.from_config(TINY_VIT)
    ip = models.int_model(spec, models.streams(3)[0])
    s = ip["qact_input"]["scale"]
    assert (models.code_table(spec, ip)
            == input_code_lut(s, ip["qact_input"]["zp"])).all()


def test_reference_refuses_what_it_does_not_follow():
    spec = specs.from_config(dict(TINY_VIT, quant=dict(TINY_VIT["quant"],
                                                       smoothquant=False)))
    ip = models.int_model(spec, models.streams(0)[0])
    codes = models.codes_pool(spec, ip, 1, models.streams(0)[1])
    with pytest.raises(ValueError):
        check.reference_logits(spec, ip, codes, "cpu")


@pytest.mark.parametrize("name", ["reference.py", "check.py", "models.py",
                                  "counts.py", "specs.py"])
def test_yardstick_imports_torch_and_numpy_only(name):
    tree = ast.parse((BENCH / "harness" / name).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "dataclasses", "numpy", "torch"}
