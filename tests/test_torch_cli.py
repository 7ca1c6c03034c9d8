"""The port's serving entry points against the JAX package's, on the CPU:
``IntModel(microbatch=)`` (bit-equal to the unchunked forward on both
routes, and held to JAX's ``IntModel(microbatch=)`` by the JAX suite's
rule between two integer paths, tests/test_pallas_attention.py::
_assert_paths_agree), and the CLI ``python3 -m diffvit_tpu_torch.cli``:
``--load-int`` of a TINY artifact saved by JAX, over a fake ImageFolder,
prints the report that JAX's ``engine.validate`` prints over JAX's
``DataLoader`` (the same loss, Prec@1 and Prec@5 lines, the times aside),
on each wire and route; ``--quant --mode 1 --int-path --save-int`` writes
an artifact JAX serves; ``--mode 2`` calibrates on exactly the batch that
``generate_data`` returns for the seed (run at 2 iterations an epoch), and
``--prior-checkpoint`` hands a local ``.pth`` to it as the prior; every
flag whose machinery is not ported exits naming its ROADMAP item; each ``--mixed`` flag's value reaches the search
(the search's machinery replaced by recorders; the search itself:
tests/test_torch_mixed.py); each recovery flag's value reaches
``adaround``, ``qat`` or ``bias_correct``, after calibration and before
``--save-int``, and under ``--mixed`` at the searched best (the passes
replaced by recorders; the passes themselves: tests/test_torch_recovery*.py)."""
import re

import jax
import numpy as np
import pytest
import torch

from diffvit_tpu.config import QuantConfig
from diffvit_tpu.data import imagenet as jimagenet
from diffvit_tpu.engine import QuantizedViT as JaxQuantizedViT
from diffvit_tpu.engine import load_int_model as jax_load_int_model
from diffvit_tpu.engine import validate as jax_validate
from diffvit_tpu.models import vit

from diffvit_tpu_torch import cli, engine
from diffvit_tpu_torch.analysis import datagen, hessian
from diffvit_tpu_torch.analysis.datagen import generate_data
from diffvit_tpu_torch.analysis import mixed_precision as mp
from diffvit_tpu_torch.data.synthetic import make_fake_imagefolder
from diffvit_tpu_torch.models import registry
from diffvit_tpu_torch.models.registry import preprocessing_for
from diffvit_tpu_torch.models.swin import SWIN_SPECS, SwinSpec
from diffvit_tpu_torch.models.vit import VIT_SPECS, ViTSpec

from test_torch_calibrate import one_torch_thread  # noqa: F401

TINY_KW = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
TINY = vit.ViTSpec("test_tiny", **TINY_KW)
TINY_T = ViTSpec("test_tiny", **TINY_KW)
SWIN_TEST = SwinSpec("swin_test", embed_dim=32, depths=(2, 1),
                     num_heads=(2, 4), num_classes=10)  # 224 px


def _assert_paths_agree(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.mean(got == ref) > 0.995, np.mean(got == ref)
    np.testing.assert_allclose(got, ref, atol=0.05)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A TINY int-model calibrated and saved by JAX, and a fake ImageFolder
    (3 classes of 2 images) under ``<root>/val``."""
    root = tmp_path_factory.mktemp("cli")
    params = vit.init_params(TINY, jax.random.PRNGKey(0))
    m = JaxQuantizedViT(TINY, QuantConfig(), params=params)
    m.calibrate(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                             (2, 3, 224, 224))))
    path = str(root / "tiny.npz")
    m.save_int_model(path)
    make_fake_imagefolder(str(root / "val"), num_classes=3, per_class=2,
                          size=(80, 60), seed=3)
    return path, root


@pytest.mark.parametrize("resident", [False, True], ids=["K1+K2", "K6"])
def test_microbatch_is_bit_equal_and_agrees_with_jax(artifact, resident):
    """b = 7 in chunks of 3 (the last zero-padded): the unchunked logits,
    bit for bit; JAX's IntModel(microbatch=3) by _assert_paths_agree."""
    path, _ = artifact
    x = np.random.default_rng(0).integers(0, 256, (7, 3, 224, 224),
                                          dtype=np.uint8)
    whole = engine.load_int_model(path, "cpu", resident=resident)
    chunked = engine.load_int_model(path, "cpu", resident=resident,
                                    microbatch=3)
    got = chunked(x).numpy()
    assert got.shape == (7, 10)
    np.testing.assert_array_equal(got, whole(x).numpy())
    want = jax_load_int_model(path, resident=resident, microbatch=3)(x)
    _assert_paths_agree(got, np.asarray(want))
    with pytest.raises(ValueError, match="microbatch"):
        engine.load_int_model(path, "cpu", microbatch=0)


def _report(lines):
    """The report lines with their times taken out."""
    return [re.sub(r"Time \S+( \(\S+\))?", "Time", ln) for ln in lines
            if "Prec@1" in ln]


@pytest.fixture(scope="module")
def jax_report(artifact):
    path, root = artifact
    pp = preprocessing_for("deit_tiny")
    ds = jimagenet.ImageFolder(str(root / "val"), jimagenet.build_transform(
        mean=pp.mean, std=pp.std, crop_pct=pp.crop_pct))
    lines = []
    res = jax_validate(jax_load_int_model(path),
                       jimagenet.DataLoader(ds, 4, num_workers=2),
                       print_freq=1, log=lines.append)
    return res, _report(lines)


@pytest.mark.parametrize("flags", [
    ["--wire", "f32"], ["--wire", "u8"], ["--wire", "u8", "--resident"],
    ["--wire", "f32", "--device-prefetch", "0"]],
    ids=["f32", "u8-codes", "u8-codes-resident", "f32-no-prefetch"])
def test_cli_load_int_prints_jax_report(artifact, jax_report, capsys,
                                        flags):
    """The port CLI serving JAX's artifact prints JAX's report: the same
    loss, Prec@1 and Prec@5 on every batch line and the summary."""
    path, root = artifact
    res = cli.main(["deit_tiny", str(root), "--load-int", path, "--device",
                    "cpu", "--val-batchsize", "4", "--num-workers", "2",
                    "--print-freq", "1", *flags])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Model: deit_tiny"
    assert out[1].startswith(f"Serving int artifact: {path} (test_tiny)")
    assert out[2] == "None"  # no --quant: the reference prints bit_config
    want_res, want_lines = jax_report
    assert _report(out) == want_lines and len(want_lines) == 3
    assert res == pytest.approx(want_res, abs=5e-5)


def test_cli_calibrates_bakes_and_saves(artifact, tmp_path, capsys,
                                        monkeypatch):
    """--quant --mode 1 --int-path --save-int on a registered TINY DeiT:
    Gaussian calibration, validation through the baked integer model on
    the codes wire, and an artifact that JAX's engine serves with the
    port's logits (_assert_paths_agree)."""
    _, root = artifact
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY_T)
    out_path = str(tmp_path / "baked.npz")
    loss, top1, top5 = cli.main([
        "deit_test", str(root), "--quant", "--mode", "1", "--int-path",
        "--calib-batchsize", "2", "--save-int", out_path, "--device", "cpu",
        "--val-batchsize", "6", "--num-workers", "2", "--wire", "u8"])
    out = capsys.readouterr().out.splitlines()
    assert out[:4] == ["Model: deit_test", "Calibrating with Gaussian noise...",
                       f"Saved int artifact: {out_path}",
                       str([4] * vit.num_bit_slots(TINY))]
    assert out[-1].startswith(" * Prec@1") and np.isfinite(loss)
    x = np.random.default_rng(1).integers(0, 256, (2, 3, 224, 224),
                                          dtype=np.uint8)
    _assert_paths_agree(engine.load_int_model(out_path, "cpu")(x).numpy(),
                        np.asarray(jax_load_int_model(out_path)(x)))


@pytest.mark.parametrize("flags", [[], ["--int-path", "--save-int"]],
                         ids=["fake_quant", "int_path"])
def test_cli_calibrates_a_swin(artifact, tmp_path, capsys, monkeypatch,
                               flags):
    """--quant --mode 1 on a registered TINY Swin (224 px, a shifted
    block): Gaussian calibration, the uniform bit printed as the reference
    prints a Swin's, validation through the fake-quant forward or the
    baked integer model, and (--save-int) an artifact served as a Swin."""
    _, root = artifact
    monkeypatch.setitem(SWIN_SPECS, "swin_test", SWIN_TEST)
    out_path = str(tmp_path / "swin.npz")
    if flags:
        flags = flags + [out_path]
    loss, top1, top5 = cli.main([
        "swin_test", str(root), "--quant", "--mode", "1",
        "--calib-batchsize", "2", "--device", "cpu", "--val-batchsize", "6",
        "--num-workers", "2", "--wire", "u8", *flags])
    out = capsys.readouterr().out.splitlines()
    saved = [f"Saved int artifact: {out_path}"] if flags else []
    assert out[:3 + len(saved)] == ["Model: swin_test",
                                    "Calibrating with Gaussian noise...",
                                    *saved, "4"]
    assert out[-1].startswith(" * Prec@1") and np.isfinite(loss)
    assert 0 <= top1 <= 100 and 0 <= top5 <= 100
    if flags:
        served = engine.load_int_model(out_path, "cpu")
        assert served.is_swin and served.spec.name == "swin_test"


def _given(dest):
    """The flag of ``dest`` on a command line, at its default value (or
    its first choice; 1 where the default is None)."""
    a = next(a for a in cli.build_parser()._actions if a.dest == dest)
    if a.nargs == 0:
        return [a.option_strings[0]]
    value = a.choices[0] if a.choices else a.default
    return [a.option_strings[0], str(1 if value is None else value)]


REFUSED = [(_given(d), item) for d, item in cli.NOT_PORTED.items()]


@pytest.mark.parametrize("flags,item", REFUSED, ids=[f[0][0] for f in REFUSED])
def test_unported_flags_exit_naming_their_roadmap_item(flags, item):
    """Given on the command line (even at its default value), each flag
    whose machinery is not ported exits before any work, naming its item."""
    with pytest.raises(SystemExit, match=rf"ROADMAP Queue 1, item {item}:"):
        cli.main(["deit_tiny", "/nonexistent", "--quant", *flags])


def _generate_in_two_steps(calls):
    """``datagen.generate_data`` at 2 iterations an epoch (the CLI's 500
    take minutes on the CPU), recording each call's arguments."""
    def generate(params, spec, **kw):
        calls.append((params, spec, kw))
        return generate_data(params, spec, iters_per_epoch=2, **kw)

    return generate


def test_mode_2_calibrates_on_generated_data(artifact, monkeypatch, capsys):
    """--quant --mode 2 --int-path on a registered TINY DeiT: the batch
    generate_data returns for --seed and --calib-batchsize is exactly what
    calibrate receives; the reference's lines, then the report."""
    _, root = artifact
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY_T)
    gen_calls, calib_calls = [], []
    monkeypatch.setattr(datagen, "generate_data",
                        _generate_in_two_steps(gen_calls))
    calibrate = engine.QuantizedViT.calibrate

    def recording(self, batch):
        calib_calls.append(batch)
        return calibrate(self, batch)

    monkeypatch.setattr(engine.QuantizedViT, "calibrate", recording)
    loss, _, _ = cli.main([
        "deit_test", str(root), "--quant", "--mode", "2", "--int-path",
        "--calib-batchsize", "3", "--seed", "5", "--device", "cpu",
        "--val-batchsize", "6", "--num-workers", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == ["Model: deit_test", "Generating data...",
                       "Calibrating with generated data..."]
    assert out[-1].startswith(" * Prec@1") and np.isfinite(loss)
    (params, spec, kw), = gen_calls
    assert spec == TINY_T and kw == dict(batch_size=3, seed=5,
                                         prior_params=None)
    _, seeded = registry.build_params("deit_test", None, 5, device="cpu")
    want = generate_data(seeded, TINY_T, batch_size=3, seed=5,
                         iters_per_epoch=2)
    (got,), = [calib_calls]
    assert torch.equal(got, want) and got.shape == (3, 3, 224, 224)


def test_prior_checkpoint_is_the_generation_prior(artifact, monkeypatch,
                                                  capsys, tmp_path):
    """--mode 2 --prior-checkpoint: the local .pth is loaded as the
    model's family and inverted in place of the model's own params."""
    from test_torch_load import _state_dict

    _, root = artifact
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY_T)
    sd = _state_dict(TINY_T, seed=7)
    pth = str(tmp_path / "prior.pth")
    torch.save({"model": sd}, pth)
    calls = []
    monkeypatch.setattr(datagen, "generate_data",
                        _generate_in_two_steps(calls))
    cli.main(["deit_test", str(root), "--quant", "--mode", "2",
              "--prior-checkpoint", pth, "--calib-batchsize", "3",
              "--device", "cpu", "--val-batchsize", "6", "--num-workers",
              "2", "--val-limit", "6"])
    out = capsys.readouterr().out.splitlines()
    assert out[1:4] == [f"PSAQ prior: {pth}", "Generating data...",
                        "Calibrating with generated data..."]
    (params, spec, kw), = calls
    prior = kw["prior_params"]
    assert torch.equal(prior["head"]["w"], sd["head.weight"])
    assert torch.equal(prior["blocks"][1]["fc2"]["b"],
                       sd["blocks.1.mlp.fc2.bias"])
    assert not torch.equal(params["head"]["w"], prior["head"]["w"])


# what the search receives with no --mixed flag but --mixed given
MIXED_DEFAULTS = dict(batches=1, max_iter=150, joint=False, sample_factor=1.1,
                      columns="committed", pareto=3, pop_size=25, evo_iter=8,
                      mutate_size=10, crossover_size=10, evo_factor=1.1,
                      scorer="validate_bits")
MIXED_FLAGS = {  # dest: (its flag and a value, what the search receives)
    "mixed": ([], {}),
    "hessian_batches": (["--hessian-batches", "2"], dict(batches=2)),
    "hessian_iter": (["--hessian-iter", "7"], dict(max_iter=7)),
    "hessian_estimator": (["--hessian-estimator", "joint"],
                          dict(joint=True)),
    "evo_pop": (["--evo-pop", "3"], dict(pop_size=3)),
    "evo_iter": (["--evo-iter", "2"], dict(evo_iter=2)),
    "evo_mutate": (["--evo-mutate", "4"], dict(mutate_size=4)),
    "evo_crossover": (["--evo-crossover", "5"], dict(crossover_size=5)),
    "pareto_top": (["--pareto-top", "1"], dict(pareto=1)),
    "size_factor": (["--size-factor", "1.7"],
                    dict(sample_factor=1.7, evo_factor=1.7)),
    "omega_columns": (["--omega-columns", "intended"],
                      dict(columns="intended")),
    "search_path": (["--search-path", "int"],
                    dict(scorer="validate_bits_int")),
}


@pytest.fixture(scope="module")
def mixed_root(tmp_path_factory):
    """A fake ImageFolder with train/ (4 images) and val/ (2)."""
    root = tmp_path_factory.mktemp("mixed_flags")
    make_fake_imagefolder(str(root / "train"), num_classes=2, per_class=2,
                          size=(80, 60), seed=4)
    make_fake_imagefolder(str(root / "val"), num_classes=2, per_class=1,
                          size=(80, 60), seed=5)
    return root


@pytest.mark.parametrize("dest", list(MIXED_FLAGS))
def test_mixed_flag_reaches_the_search(mixed_root, monkeypatch, capsys,
                                       dest):
    """Each --mixed flag's value reaches the Hessian, the sampler, the
    omega ranking, the Pareto validations or the evolutionary search, and
    every other one its default (the search's machinery and the
    calibration replaced by recorders)."""
    assert set(MIXED_FLAGS) == {
        "mixed", "hessian_batches", "hessian_iter", "hessian_estimator",
        "evo_pop", "evo_iter", "evo_mutate", "evo_crossover", "pareto_top",
        "size_factor", "omega_columns", "search_path"}
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY_T)
    n = vit.num_bit_slots(TINY)
    got = {"pareto": 0}
    cands = [[8] * n, [8] + [4] * (n - 1), [8, 4] * (n // 2)]

    def sensitivity(params, spec, batches, generator, max_iter, joint):
        got.update(batches=len(batches), max_iter=max_iter, joint=joint)
        assert all(len(b[0]) == 2 for b in batches)  # --calib-batchsize
        return [0.5] * (n - 1)

    def sample(flops, rng, factor, groups):
        got["sample_factor"] = factor
        return cands

    def omega(bit_list, flops, mean_hessian, gd, columns):
        got["columns"] = columns
        return [[c, 0.0] for c in bit_list]

    def validate(*args, **kw):
        got["pareto"] += 1
        return 0.0, 0.0, 0.0

    def search(omega_list, flops, evaluate, *, rng, pop_size, evo_iter,
               mutate_size, crossover_size, factor, evaluate_batch):
        got.update(pop_size=pop_size, evo_iter=evo_iter,
                   mutate_size=mutate_size, crossover_size=crossover_size,
                   evo_factor=factor)
        return [[omega_list[0][0], evaluate_batch([omega_list[0][0]])[0]]]

    def scorer(name):
        def score(model, loader, configs):
            got["scorer"] = name
            return [1.0] * len(configs)
        return score

    monkeypatch.setattr(hessian, "hessian_sensitivity", sensitivity)
    monkeypatch.setattr(mp, "sample_candidates", sample)
    monkeypatch.setattr(mp, "omega_rank", omega)
    monkeypatch.setattr(mp, "evolutionary_search", search)
    monkeypatch.setattr(engine, "validate", validate)
    for name in ("validate_bits", "validate_bits_int"):
        monkeypatch.setattr(engine, name, scorer(name))
    monkeypatch.setattr(engine.QuantizedViT, "calibrate",
                        lambda self, batch: setattr(
                            self, "global_distance", np.ones((n - 1, 4))))
    result = cli.main(["deit_test", str(mixed_root), "--quant", "--mode", "1",
                       "--mixed", "--calib-batchsize", "2", "--device",
                       "cpu", "--num-workers", "2", "--hessian-batches", "1",
                       *MIXED_FLAGS[dest][0]])
    assert got == dict(MIXED_DEFAULTS, **MIXED_FLAGS[dest][1])
    assert result == [[cands[0], 1.0]]
    assert f"best: {result[0]}" in capsys.readouterr().out.splitlines()


RECOVERY_FLAGS = {  # case: (flags, the passes called with what)
    "adaround": (["--adaround"],
                 dict(adaround=dict(steps=1000, seed=0))),
    "adaround_steps": (["--adaround", "--adaround-steps", "7"],
                       dict(adaround=dict(steps=7, seed=0))),
    "adaround_seed": (["--adaround", "--seed", "3"],
                      dict(adaround=dict(steps=1000, seed=3))),
    "qat_steps": (["--qat-steps", "3"],
                  dict(qat=dict(steps=3, lr=1e-5, remat=False))),
    "qat_remat": (["--qat-steps", "2", "--qat-remat"],
                  dict(qat=dict(steps=2, lr=1e-5, remat=True))),
    "qat_lr": (["--qat-steps", "2", "--qat-lr", "0.001"],
               dict(qat=dict(steps=2, lr=1e-3, remat=False))),
    "bias_corr": (["--bias-corr"], dict(bias_correct={})),
    "all_three": (["--adaround", "--adaround-steps", "5", "--qat-steps", "4",
                   "--bias-corr"],
                  dict(adaround=dict(steps=5, seed=0),
                       qat=dict(steps=4, lr=1e-5, remat=False),
                       bias_correct={})),
}
RECOVERY_LINES = {
    "adaround": ["AdaRound reconstruction ({} steps/site, 1 calib "
                 "batch)...", "AdaRound: 2 sites, mean site-MSE reduction "
                 "37.5%"],
    "qat": ["Distillation QAT ({} steps, lr {:g})...",
            "QAT: distill MSE 2.000e+00 -> 5.000e-01"],
    "bias_correct": ["Bias correction (DFQ-style mean-shift fold)...",
                     "Bias correction: 2 sites, mean |shift| 2.000e-01 -> "
                     "1.500e-02"],
}


def _record_passes(monkeypatch, calls):
    """The engine's calibrate, passes and save_int_model replaced by
    recorders that append (name, bit_config, keywords) to ``calls``."""
    def recorder(name, result):
        def fn(self, *args, **kw):
            bits = args[1] if len(args) > 1 else kw.pop("bit_config", None)
            calls.append((name, bits, kw))
            return result
        return fn

    n = vit.num_bit_slots(TINY)
    monkeypatch.setattr(engine.QuantizedViT, "calibrate",
                        lambda self, batch: (calls.append(
                            ("calibrate", None, {})), setattr(
                            self, "global_distance", np.ones((n - 1, 4)))))
    for name, result in (("adaround", {"a": (1.0, 0.5), "b": (0.4, 0.3)}),
                         ("qat", [2.0, 1.0, 0.5]),
                         ("bias_correct", {"a": (0.3, 0.01),
                                           "b": (0.1, 0.02)}),
                         ("save_int_model", None)):
        monkeypatch.setattr(engine.QuantizedViT, name, recorder(name, result))
    monkeypatch.setattr(engine, "validate", lambda *a, **k: (0.0, 0.0, 0.0))


@pytest.mark.parametrize("case", list(RECOVERY_FLAGS))
def test_recovery_flag_reaches_its_pass(mixed_root, monkeypatch, capsys,
                                        tmp_path, case):
    """Each recovery flag's value reaches its pass on the calibration
    batch, after calibrate and before the --save-int bake, in the
    reference's order (AdaRound, QAT, bias correction), with the
    reference's report lines; no other pass runs."""
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY_T)
    calls = []
    _record_passes(monkeypatch, calls)
    flags, want = RECOVERY_FLAGS[case]
    art = str(tmp_path / "r.npz")
    cli.main(["deit_test", str(mixed_root), "--quant", "--mode", "1",
              "--calib-batchsize", "2", "--device", "cpu", "--num-workers",
              "2", "--save-int", art, *flags])
    names = [c[0] for c in calls]
    assert names == ["calibrate", *want, "save_int_model"]
    for name, bits, kw in calls[1:-1]:
        assert bits is None and kw == want[name], name
    assert calls[-1][2] == {} and calls[-1][1] is None
    out = capsys.readouterr().out.splitlines()
    lines = []
    for name in want:
        first, second = RECOVERY_LINES[name]
        if name == "adaround":
            first = first.format(want[name]["steps"])
        if name == "qat":
            first = first.format(want[name]["steps"], want[name]["lr"])
        lines += [first, second]
    i = out.index("Calibrating with Gaussian noise...")
    assert out[i + 1:i + 1 + len(lines)] == lines
    assert out[i + 1 + len(lines)] == f"Saved int artifact: {art}"


def test_mixed_reconstructs_at_the_searched_best(mixed_root, monkeypatch,
                                                 capsys, tmp_path):
    """Under --mixed the passes run after the search, at its best
    configuration, and --save-int bakes that configuration after them."""
    monkeypatch.setitem(VIT_SPECS, "deit_test", TINY_T)
    n = vit.num_bit_slots(TINY)
    best = [8, 4] * (n // 2)
    calls = []
    _record_passes(monkeypatch, calls)
    monkeypatch.setattr(hessian, "hessian_sensitivity",
                        lambda *a, **k: [0.5] * (n - 1))
    monkeypatch.setattr(mp, "sample_candidates", lambda *a, **k: [best])
    monkeypatch.setattr(mp, "omega_rank",
                        lambda bit_list, *a, **k: [[c, 0.0] for c in bit_list])

    def search(omega_list, *a, **k):
        calls.append(("search", None, {}))
        return [[best, 1.0]]

    monkeypatch.setattr(mp, "evolutionary_search", search)
    monkeypatch.setattr(engine, "validate_bits",
                        lambda model, loader, configs: [1.0] * len(configs))
    art = str(tmp_path / "m.npz")
    cli.main(["deit_test", str(mixed_root), "--quant", "--mode", "1",
              "--mixed", "--calib-batchsize", "2", "--device", "cpu",
              "--num-workers", "2", "--hessian-batches", "1", "--adaround",
              "--adaround-steps", "9", "--qat-steps", "2", "--bias-corr",
              "--save-int", art])
    assert [c[0] for c in calls] == ["calibrate", "search", "adaround",
                                     "qat", "bias_correct", "save_int_model"]
    for name, bits, _ in calls[2:]:
        assert tuple(bits) == tuple(best), name
    assert calls[2][2] == dict(steps=9, seed=0)
    out = capsys.readouterr().out.splitlines()
    assert out.index(f"best: {[best, 1.0]}") < out.index(
        "AdaRound reconstruction (9 steps/site, 1 calib batch)...") < \
        out.index(f"Saved int artifact (mixed best): {art}")


def test_load_int_with_mixed_is_refused():
    """--load-int serves one baked configuration: with --mixed it exits
    with the reference's message before any work."""
    with pytest.raises(SystemExit, match="run --mixed with --save-int "
                                         "instead"):
        cli.main(["deit_tiny", "/nonexistent", "--load-int", "a.npz",
                  "--mixed", "--device", "cpu"])


def test_swin_and_flag_combinations_are_refused(monkeypatch):
    """The flag combinations that make no sense exit; a Swin model with
    --quant is no longer refused: it reaches the data (here a missing
    folder) after building its float params (a small registered Swin, to
    keep the CPU's work small)."""
    monkeypatch.setitem(SWIN_SPECS, "swin_test", SWIN_TEST)
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        cli.main(["swin_test", "/nonexistent", "--quant", "--device", "cpu",
                  "--mode", "1"])
    with pytest.raises(SystemExit, match="requires --quant"):
        cli.main(["deit_tiny", "/x", "--save-int", "a.npz"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["deit_tiny", "/x", "--quant", "--save-int", "a.npz",
                  "--load-int", "b.npz"])
    with pytest.raises(SystemExit):  # argparse: cuda or cpu only
        cli.main(["deit_tiny", "/x", "--device", "tpu"])
    args = cli.parse_args(["deit_small", "/d", "--quant"])
    assert (args.model, args.data, args.tp, args.qat_lr) == \
        ("deit_small", "/d", 1, 1e-5)
    assert torch.device(args.device).type == "cuda"
