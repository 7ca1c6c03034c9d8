"""ModelDiff profiling-input generation (the port's counterpart of
``diffvit_tpu/analysis/modeldiff.py``): a search for inputs on which two
models' outputs diverge and stay diverse.

* ``metrics_output_diversity``: the mean pairwise Euclidean distance of a
  model's outputs;
* the blackbox search: single-element ±epsilon mutations of a copy of the
  inputs, kept when the combined score improves;
* the whitebox search: adversarial candidates (an ``AttackPGD``), the best
  scorer kept.

The distances are an explicit float64 difference, square, sum and square
root in numpy on the host (scipy's ``cdist`` in the JAX package).  The
forwards take a float32 tensor and may return tensors on any device; the
inputs stay on the device they were given on (or ``device``).  The
blackbox draws its mutations from ``np.random.default_rng(seed)`` in the
JAX package's order, so both packages, and the card and the CPU, make the
same draws.
"""
from __future__ import annotations

import numpy as np
import torch


def _host64(out):
    """A model output as a (B, -1) float64 numpy array on the host."""
    if isinstance(out, torch.Tensor):
        out = out.detach().to("cpu", torch.float64).numpy()
    out = np.asarray(out, np.float64)
    return out.reshape(out.shape[0], -1)


def _cdist(a, b):
    """The (len(a), len(b)) Euclidean distances of the rows, float64."""
    d = a[:, None, :] - b[None, :, :]
    return np.sqrt(np.sum(d * d, axis=-1))


def metrics_output_diversity(outputs):
    a = _host64(outputs)
    return float(np.mean(_cdist(a, a)))


def _score(out1, out2, init1, init2):
    m1 = metrics_output_diversity(out1)
    m2 = metrics_output_diversity(out2)
    d1 = float(np.mean(_cdist(_host64(out1), _host64(init1)).diagonal()))
    d2 = float(np.mean(_cdist(_host64(out2), _host64(init2)).diagonal()))
    return d1 * d2 * m1 * m2


def _as_inputs(x, device=None):
    """``x`` as a float32 tensor, on ``device`` where given."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))
    x = x.to(torch.float32)
    return x if device is None else x.to(device)


def gen_profiling_inputs_blackbox(forward1, forward2, seed_inputs, *,
                                  epsilon=0.2, max_iterations=1000, seed=0,
                                  log=None, device=None):
    """``forwardN(x) -> logits``.  The single-element mutation hill climb
    (``dataset_utility.py:209-302``): each iteration draws an element and
    an image, scores the inputs with that element plus and minus
    ``epsilon`` (float32), and keeps the better one if it beats the
    current score.  Returns the final inputs (a tensor)."""
    rng = np.random.default_rng(seed)
    inputs = _as_inputs(seed_inputs, device)
    n_inputs = inputs.shape[0]
    ndims = int(np.prod(inputs.shape[1:]))
    step = torch.tensor(np.float32(epsilon), device=inputs.device)

    init1 = _host64(forward1(inputs))
    init2 = _host64(forward2(inputs))

    def evaluate(x):
        return _score(forward1(x), forward2(x), init1, init2)

    def mutated(img, elem, delta):
        x = inputs.clone()
        x[img].view(-1)[elem] += delta
        return x

    score = evaluate(inputs)
    for i in range(max_iterations):
        elem = int(rng.integers(0, ndims))
        img = int(rng.integers(0, n_inputs))
        right = mutated(img, elem, step)
        right_score = evaluate(right)
        left = mutated(img, elem, -step)
        left_score = evaluate(left)
        if right_score <= score and left_score <= score:
            continue
        if right_score > left_score:
            inputs, score = right, right_score
        else:
            inputs, score = left, left_score
        if log:
            log(f"mutation {i}: score -> {score:.4f}")
    return inputs


def gen_profiling_inputs_whitebox(forward1, forward2, gen_adv, seed_inputs,
                                  seed_labels, *, max_iterations=20,
                                  log=None, device=None):
    """``gen_adv(inputs, labels) -> adversarial inputs`` (an AttackPGD's
    ``gen_adv_inputs``).  Keeps the best-scoring adversarial batch
    (``dataset_utility.py:305-381``); None when none beats the seed
    inputs' score."""
    inputs = _as_inputs(seed_inputs, device)
    init1 = _host64(forward1(inputs))
    init2 = _host64(forward2(inputs))

    def evaluate(x):
        return _score(forward1(x), forward2(x), init1, init2)

    score = evaluate(inputs)
    best = None
    for i in range(max_iterations):
        cand = gen_adv(inputs, seed_labels)
        cand_score = evaluate(cand)
        if cand_score > score:
            best, score = cand, cand_score
            if log:
                log(f"iteration {i}: score -> {score:.4f}")
    return best
