"""CKA comparison drivers (the port's counterpart of
``diffvit_tpu/analysis/cka_drivers.py``): CKA accumulated over several
passes of shuffled batches, the heatmap pickled in the reference's layout
(``result_name/_heatmap.pkl`` for one model,
``result_name/<basename>_heatmap.pkl`` for two).
"""
from __future__ import annotations

import os
import pickle

import torch

from .activations import get_activations
from .cka import MinibatchAdvCKA, MinibatchCKA
from .pgd import AttackPGD


def _dump(heatmap, result_name, filename):
    os.makedirs(result_name, exist_ok=True)
    with open(os.path.join(result_name, filename), "wb") as f:
        pickle.dump(heatmap, f)


def compute_cka_internal(model, batch_iter_factory, *, cka_iter=10,
                         cka_batch_iter=10, normalize_act=False,
                         result_name="cka_result.pkl", log=print):
    """One model's layer x layer CKA over its float-mode activation set.
    ``batch_iter_factory()`` -> an iterable of (images, labels) shuffled
    batches; each of ``cka_iter`` passes takes ``cka_batch_iter`` + 1 of
    them.  Returns the heatmap (numpy)."""
    sample_images, _ = next(iter(batch_iter_factory()))
    sample_acts = get_activations(model, sample_images, bit_config=None,
                                  normalize_act=normalize_act)
    cka = MinibatchCKA(len(sample_acts))

    for it in range(cka_iter):
        for ci, (images, _) in enumerate(batch_iter_factory()):
            acts = get_activations(model, images, bit_config=None,
                                   normalize_act=normalize_act)
            cka.update_state(acts)
            if ci >= cka_batch_iter:
                break
        log(f"cka iteration {it}")

    heatmap = cka.result().cpu().numpy()
    _dump(heatmap, result_name, "_heatmap.pkl")
    return heatmap


def compute_cka_with_adversarial(model1, model2, batch_iter_factory, *,
                                 model1_bit_config=None,
                                 model2_bit_config=None, cka_iter=10,
                                 cka_batch_iter=10, normalize_act=False,
                                 result_name="cka_result.pkl",
                                 generator=None, pgd_steps=50, log=print):
    """Two models' adversarial-DDV CKA: PGD inputs made against model1 (a
    fresh uniform start for every batch, drawn from ``generator``; None:
    seeded with 0), and MinibatchAdvCKA over the clean and adversarial
    activations of both.  Returns the heatmap (numpy)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    attack = AttackPGD(model1, epsilon=0.06, step_size=0.01,
                       num_steps=pgd_steps, bit_config=model1_bit_config)

    sample_images, _ = next(iter(batch_iter_factory()))
    n1 = len(get_activations(model1, sample_images,
                             bit_config=model1_bit_config,
                             normalize_act=normalize_act))
    n2 = len(get_activations(model2, sample_images,
                             bit_config=model2_bit_config,
                             normalize_act=normalize_act))
    cka = MinibatchAdvCKA(n1, n2)

    for it in range(cka_iter):
        for ci, (images, labels) in enumerate(batch_iter_factory()):
            adv = attack.gen_adv_inputs(images, labels, generator=generator)
            a1 = get_activations(model1, images, model1_bit_config,
                                 normalize_act=normalize_act)
            a1_adv = get_activations(model1, adv, model1_bit_config,
                                     normalize_act=normalize_act)
            a2 = get_activations(model2, images, model2_bit_config,
                                 normalize_act=normalize_act)
            a2_adv = get_activations(model2, adv, model2_bit_config,
                                     normalize_act=normalize_act)
            cka.update_state(a1, a1_adv, a2, a2_adv)
            if ci >= cka_batch_iter:
                break
        log(f"adv-cka iteration {it}")

    heatmap = cka.result().cpu().numpy()
    base = os.path.basename(os.path.normpath(result_name))
    _dump(heatmap, result_name, base + "_heatmap.pkl")
    return heatmap
