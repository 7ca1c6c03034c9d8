"""Hessian sensitivity by Hutchinson trace estimation (counterpart of
``diffvit_tpu/analysis/hessian.py``, the parts the mixed-precision search
uses; ``top_eigenvalues`` and ``eigenvalue_density`` are not ported yet).

The Hessian-vector product is the reference PyHessian's own form: double
backward.  The loss's gradient with respect to the target weights is taken
once per batch with ``create_graph=True``; each probe is then one more
backward pass through that gradient (``torch.autograd.grad(g, w, v)``).
The forward is the port's ``forward_fp``, whose float products are taken
in float64 and rounded once to float32, and the loss is the mean
cross-entropy of its logits.

* Traces are per-parameter diagonal-block estimates: the probe and the
  HVP of one weight matrix at a time (``hessian_traces``), or joint probes
  over every target weight with a per-leaf ``v . Hv`` (``hessian_traces_
  joint``, ``--hessian-estimator joint``).
* The target weights are, per block, qkv, proj, fc1 and fc2, then (Swin)
  each stage's reduction, then the head (``hessian_target_names``), the
  order of ``global_distance``.
* Rademacher probes, at most ``max_iter`` a trace, and the reference's
  stop rule ``|mean - prev| / (|prev| + 1e-6) < tol``.

The probes come from a ``torch.Generator`` on the model's device, not from
JAX's key stream, so a trace estimates the same quantity as the JAX
package's from other samples.  ``probes`` injects them: a function
``probes(batch, name, sample, like) -> tensor`` called for every probe a
trace draws, so that tests can hand both packages the same ones.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import swin as swin_mod
from ..models import vit as vit_mod

F64 = torch.float64


def _is_swin(spec):
    return isinstance(spec, swin_mod.SwinSpec)


def hessian_target_names(spec) -> list[str]:
    """The reference's parameter order (torch ``named_parameters`` without
    norms, biases, cls_token, pos_embed and patch_embed): per block [qkv,
    proj, fc1, fc2], each Swin stage's downsample reduction after its
    blocks, then the head; ``len(flops_list(spec)) - 1`` names."""
    names = []
    if _is_swin(spec):
        for s in range(spec.num_layers):
            for b in range(spec.depths[s]):
                p = f"layers.{s}.blocks.{b}"
                names += [f"{p}.attn.qkv.weight", f"{p}.attn.proj.weight",
                          f"{p}.mlp.fc1.weight", f"{p}.mlp.fc2.weight"]
            if s < spec.num_layers - 1:
                names.append(f"layers.{s}.downsample.reduction.weight")
        names.append("head.weight")
        return names
    for i in range(spec.depth):
        names += [f"blocks.{i}.attn.qkv.weight", f"blocks.{i}.attn.proj.weight",
                  f"blocks.{i}.mlp.fc1.weight", f"blocks.{i}.mlp.fc2.weight"]
    names.append("head.weight")
    return names


_SUB = {"attn": {"qkv": "qkv", "proj": "proj"},
        "mlp": {"fc1": "fc1", "fc2": "fc2"}}


def _leaf_path(name):
    """The keys from the params' root to the weight ``name``'s dict."""
    if name == "head.weight":
        return ("head",)
    parts = name.split(".")
    if parts[0] == "layers":  # swin
        s = int(parts[1])
        if parts[2] == "downsample":
            return ("layers", s, "downsample", "reduction")
        return ("layers", s, "blocks", int(parts[3]),
                _SUB[parts[4]][parts[5]])
    _, idx, mod, sub, _ = parts
    return ("blocks", int(idx), _SUB[mod][sub])


def _get_leaf(params, name):
    node = params
    for k in _leaf_path(name):
        node = node[k]
    return node["w"]


def _set_leaf(params, name, value):
    """``params`` with the weight ``name`` replaced by ``value``: the dicts
    and lists on its path copied, everything else shared."""
    def put(node, path):
        if not path:
            return dict(node, w=value)
        node = dict(node) if isinstance(node, dict) else list(node)
        node[path[0]] = put(node[path[0]], path[1:])
        return node

    return put(params, _leaf_path(name))


def _fp_forward(params, spec, inputs):
    mod = swin_mod if _is_swin(spec) else vit_mod
    return mod.forward_fp(params, spec, inputs)


def _ce_loss(logits, targets):
    """Mean cross-entropy of float32 ``logits``, taken in float64."""
    logp = torch.log_softmax(logits.to(F64), dim=-1)
    return -logp.gather(1, targets[:, None]).mean()


def _autograd_safe(params):
    """``params`` with every inference tensor (made under
    ``torch.inference_mode``, which autograd cannot save) cloned."""
    if isinstance(params, dict):
        return {k: _autograd_safe(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_autograd_safe(v) for v in params]
    if isinstance(params, torch.Tensor) and params.is_inference():
        return params.clone()
    return params


def _as_tensors(params, inputs, targets):
    """The batch (numpy or tensors) on the params' device."""
    dev = _get_leaf(params, "head.weight").device
    return (torch.as_tensor(inputs, dtype=torch.float32, device=dev),
            torch.as_tensor(targets, dtype=torch.int64, device=dev))


class BatchGrads:
    """The loss of one batch and its gradient with respect to the weights
    ``names``, kept with its graph (``create_graph=True``), so that each
    HVP is one more backward pass.  ``hvp(name, v)`` is the diagonal
    block's product ``H_ww v``; ``joint_hvp(vs)`` the full product over
    every weight of ``names``."""

    def __init__(self, params, spec, inputs, targets, names):
        self.names = list(names)
        x, t = _as_tensors(params, inputs, targets)
        with torch.inference_mode(False), torch.enable_grad():
            params = _autograd_safe(params)
            self.ws = {n: _get_leaf(params, n).detach().clone()
                       .requires_grad_(True) for n in self.names}
            for n, w in self.ws.items():
                params = _set_leaf(params, n, w)
            loss = _ce_loss(_fp_forward(params, spec, x), t)
            grads = torch.autograd.grad(loss, list(self.ws.values()),
                                        create_graph=True)
        self.grads = dict(zip(self.names, grads))

    def hvp(self, name, v):
        with torch.inference_mode(False), torch.enable_grad():
            (hv,) = torch.autograd.grad(self.grads[name], self.ws[name],
                                        grad_outputs=v, retain_graph=True)
        return hv

    def joint_hvp(self, vs):
        with torch.inference_mode(False), torch.enable_grad():
            hvs = torch.autograd.grad(
                [self.grads[n] for n in self.names],
                [self.ws[n] for n in self.names],
                grad_outputs=[vs[n] for n in self.names], retain_graph=True)
        return dict(zip(self.names, hvs))


def make_block_hvp(params, spec, inputs, targets, name):
    """The HVP of the diagonal block of one weight matrix, ``v -> H_w v``
    where ``H_w = d²/dw² CE(forward_fp(params|w), targets)`` at the
    weight's value in ``params`` (the JAX function's ``hvp(w, v)`` at that
    ``w``)."""
    grads = BatchGrads(params, spec, inputs, targets, [name])
    return lambda v: grads.hvp(name, v)


def rademacher(like: torch.Tensor, generator: torch.Generator):
    """A ±1 tensor of ``like``'s shape, dtype and device, from
    ``generator`` (on that device)."""
    bits = torch.randint(0, 2, like.shape, generator=generator,
                         device=like.device)
    return (2 * bits - 1).to(like.dtype)


def _generator_probes(generator):
    return lambda batch, name, sample, like: rademacher(like, generator)


def hutchinson_trace(hvp, w, draw, max_iter=150, tol=5e-3):
    """The reference's stop rule (``hessian.py:178-204``): accumulate
    ``v . Hv`` samples, stop when ``|mean - prev_mean| / (|prev_mean| +
    1e-6) < tol`` and return ``prev_mean`` and the samples taken; else the
    mean after ``max_iter``.  ``draw(sample, w)``: the probe of sample
    ``sample`` (0, 1, ...), a tensor of ``w``'s shape."""
    samples = []
    trace = 0.0
    while len(samples) < max_iter:
        v = draw(len(samples), w)
        samples.append(float(torch.sum(hvp(v) * v)))
        mean = float(np.mean(samples))
        if abs(mean - trace) / (abs(trace) + 1e-6) < tol:
            return trace, len(samples)
        trace = mean
    return trace, max_iter


def hessian_traces(params, spec, inputs, targets, generator=None,
                   max_iter=150, tol=5e-3, names=None, probes=None,
                   batch=0):
    """(names, traces) of the per-leaf (diagonal-block) Hutchinson
    estimates on one batch, one leaf after the other, as the reference's
    committed HVP loop; one forward and backward for all of them.
    ``probes``: see the module docstring (default: Rademacher from
    ``generator``); ``batch`` is passed to it."""
    names = list(names or hessian_target_names(spec))
    probes = probes or _generator_probes(generator)
    grads = BatchGrads(params, spec, inputs, targets, names)
    traces = []
    for name in names:
        t, _ = hutchinson_trace(
            lambda v, name=name: grads.hvp(name, v), grads.ws[name],
            lambda k, w, name=name: probes(batch, name, k, w), max_iter, tol)
        traces.append(t)
    return names, traces


def hessian_traces_joint(params, spec, inputs, targets, generator=None,
                         max_iter=150, tol=5e-3, names=None, probes=None,
                         batch=0):
    """Per-leaf Hutchinson traces from JOINT probes: one HVP over every
    target weight a sample, per-leaf ``v_i . (Hv)_i`` (unbiased for the
    diagonal block: the cross-block terms have zero expectation).  Stops
    when the mean of the per-leaf running means settles (the same tol
    form); returns the per-leaf means over every sample taken."""
    names = list(names or hessian_target_names(spec))
    probes = probes or _generator_probes(generator)
    grads = BatchGrads(params, spec, inputs, targets, names)
    samples = []
    trace = 0.0
    while len(samples) < max_iter:
        k = len(samples)
        vs = {n: probes(batch, n, k, grads.ws[n]) for n in names}
        hvs = grads.joint_hvp(vs)
        samples.append([float(torch.sum(vs[n] * hvs[n])) for n in names])
        means = np.mean(samples, axis=0)
        mean = float(np.mean(means))
        if abs(mean - trace) / (abs(trace) + 1e-6) < tol:
            break
        trace = mean
    return names, np.mean(samples, axis=0).tolist()


def hessian_sensitivity(params, spec, batches, generator=None, max_iter=150,
                        tol=5e-3, log=print, joint=False, names=None,
                        probes=None):
    """The reference's ``test_quant.py:147-191``: per-batch traces
    -> |.| -> min-max normalized -> the mean over batches, a list over
    ``names`` (default every target weight).  ``batches``: (inputs,
    targets) pairs; ``joint``: the joint-probe estimator.  The probes come
    from ``generator`` (a ``torch.Generator`` on the params' device) or
    ``probes``."""
    fn = hessian_traces_joint if joint else hessian_traces
    trace_list = []
    for bi, (inputs, targets) in enumerate(batches):
        _, traces = fn(params, spec, inputs, targets, generator, max_iter,
                       tol, names=names, probes=probes, batch=bi)
        trace_list.append(traces)
        log(f"hessian batch {bi}: done")
    normalized = []
    for traces in trace_list:
        t = np.abs(np.asarray(traces))
        lo, hi = t.min(), t.max()
        normalized.append((t - lo) / (hi - lo))
    return np.stack(normalized).mean(axis=0).tolist()
