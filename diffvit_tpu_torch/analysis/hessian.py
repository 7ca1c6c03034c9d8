"""Hessian sensitivity by Hutchinson trace estimation, and the Hessian's
spectrum (counterpart of ``diffvit_tpu/analysis/hessian.py``): the traces
the mixed-precision search ranks by, ``top_eigenvalues`` (power iteration
with deflation) and ``eigenvalue_density`` (stochastic Lanczos
quadrature).

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
trace draws, so that tests can hand both packages the same ones.  The
spectrum's start vectors come the same way (``starts`` / ``probes``).

The spectrum's arithmetic (``power_iteration``, ``lanczos``) takes any
``hvp`` over dicts of tensors.  Its dot products are taken in float64 and
its vector updates in float64 rounded once to the vectors' dtype (JAX:
float32); JAX's quirks are kept: ``_normalize`` divides by ``sqrt(v . v)
+ 1e-6``, the power loop's stop rule returns the newest value, Lanczos
does not reorthogonalize.
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
    every weight of ``names``.

    The loss is the mean cross-entropy of ``forward_fp``'s logits on
    ``inputs`` against ``targets``, or ``loss_fn(params)`` where given
    (``inputs`` and ``targets`` are then unused).  A weight the loss does
    not reach has a zero HVP."""

    def __init__(self, params, spec, inputs, targets, names, loss_fn=None):
        self.names = list(names)
        if loss_fn is None:
            x, t = _as_tensors(params, inputs, targets)

            def loss_fn(p):
                return _ce_loss(_fp_forward(p, spec, x), t)

        with torch.inference_mode(False), torch.enable_grad():
            params = vit_mod.autograd_safe(params)
            self.ws = {n: _get_leaf(params, n).detach().clone()
                       .requires_grad_(True) for n in self.names}
            for n, w in self.ws.items():
                params = _set_leaf(params, n, w)
            loss = loss_fn(params)
            grads = torch.autograd.grad(
                loss, list(self.ws.values()), create_graph=True,
                allow_unused=True) if loss.requires_grad \
                else [None] * len(self.names)
        self.grads = dict(zip(self.names, grads))

    def _live(self, names):
        """The names whose gradient depends on some weight."""
        return [n for n in names if self.grads[n] is not None
                and self.grads[n].requires_grad]

    def hvp(self, name, v):
        if not self._live([name]):
            return torch.zeros_like(v)
        with torch.inference_mode(False), torch.enable_grad():
            (hv,) = torch.autograd.grad(self.grads[name], self.ws[name],
                                        grad_outputs=v, retain_graph=True,
                                        allow_unused=True)
        return torch.zeros_like(v) if hv is None else hv

    def joint_hvp(self, vs):
        live = self._live(self.names)
        out = {n: torch.zeros_like(vs[n]) for n in self.names}
        if live:
            with torch.inference_mode(False), torch.enable_grad():
                hvs = torch.autograd.grad(
                    [self.grads[n] for n in live],
                    [self.ws[n] for n in self.names],
                    grad_outputs=[vs[n] for n in live], retain_graph=True,
                    allow_unused=True)
            out.update({n: hv for n, hv in zip(self.names, hvs)
                        if hv is not None})
        return out


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


def leaf_traces(grads, names, draw, max_iter, tol):
    """The per-leaf (diagonal-block) Hutchinson traces of ``grads`` (a
    :class:`BatchGrads`), one weight after the other; ``draw(name, sample,
    like)`` gives each probe."""
    traces = []
    for name in names:
        t, _ = hutchinson_trace(
            lambda v, name=name: grads.hvp(name, v), grads.ws[name],
            lambda k, w, name=name: draw(name, k, w), max_iter, tol)
        traces.append(t)
    return traces


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
    return names, leaf_traces(
        grads, names, lambda n, k, w: probes(batch, n, k, w), max_iter, tol)


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


# ---------------------------------------------------------------------------
# The spectrum (``diffvit_tpu/analysis/hessian.py:241-341``)
# ---------------------------------------------------------------------------

def _dot(a, b) -> float:
    """sum over the leaves of a . b, in float64."""
    return float(sum(torch.sum(a[n].to(F64) * b[n].to(F64)) for n in a))


def _lincomb(terms):
    """sum of c * v over the (c, v) ``terms``, leaf by leaf, in float64
    rounded once to the first vector's dtype."""
    first = terms[0][1]
    return {n: sum(c * v[n].to(F64) for c, v in terms).to(first[n].dtype)
            for n in first}


def _scale(v, s):
    """v / s leaf by leaf, in float64 rounded once (a true division: CUDA
    torch divides by a Python number through its reciprocal)."""
    return {n: (x.to(F64) / torch.tensor(s, dtype=F64, device=x.device))
            .to(x.dtype) for n, x in v.items()}


def _normalize(v):
    return _scale(v, float(np.sqrt(_dot(v, v))) + 1e-6)


def power_iteration(hvp, start, top_n=1, max_iter=100, tol=1e-3):
    """The top ``top_n`` eigenvalues of the operator ``hvp`` (a dict of
    tensors -> a dict of tensors) by power iteration with deflation
    (``pyhessian/hessian.py:114-161``).  ``start(i)``: the (unnormalized)
    start dict of eigenvalue ``i``.  Each step deflates against the
    eigenvectors found, normalizes, takes the HVP, reads ``eig = hv . v``
    and sets ``v = normalize(hv)``; it stops when ``|new - eig| / (|eig| +
    1e-6) < tol``, keeping ``new``.  Returns (eigenvalues, eigenvectors,
    HVPs taken for each)."""
    eigenvalues, eigenvectors, steps = [], [], []
    for i in range(top_n):
        v = _normalize(start(i))
        eig = None
        for step in range(1, max_iter + 1):
            for prev in eigenvectors:
                v = _lincomb([(1.0, v), (-_dot(v, prev), prev)])
            v = _normalize(v)
            hv = hvp(v)
            new = _dot(hv, v)
            v = _normalize(hv)
            done = eig is not None and abs(new - eig) / (abs(eig) + 1e-6) \
                < tol
            eig = new
            if done:
                break
        eigenvalues.append(eig)
        eigenvectors.append(v)
        steps.append(step)
    return eigenvalues, eigenvectors, steps


def lanczos(hvp, v0, iters):
    """(alphas, betas) of ``iters`` Lanczos steps of ``hvp`` from ``v0``
    (normalized here), without reorthogonalization; it stops early where
    ``beta < 1e-8``.  There is one beta fewer than alphas."""
    vs = [_normalize(v0)]
    alphas, betas = [], []
    w_prev = None
    for i in range(iters):
        hv = hvp(vs[-1])
        alpha = _dot(hv, vs[-1])
        alphas.append(alpha)
        terms = [(1.0, hv), (-alpha, vs[-1])]
        if w_prev is not None:
            terms.append((-betas[-1], w_prev))
        w = _lincomb(terms)
        beta = float(np.sqrt(_dot(w, w)))
        if beta < 1e-8 or i == iters - 1:
            break
        betas.append(beta)
        w_prev = vs[-1]
        vs.append(_scale(w, beta))
    return alphas, betas


def tridiagonal_ritz(alphas, betas):
    """The Ritz values of the Lanczos tridiagonal and their weights (the
    squared first components of its eigenvectors), as lists."""
    t = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    evals, evecs = np.linalg.eigh(t)
    return evals.tolist(), (evecs[0] ** 2).tolist()


def _spectrum_grads(params, spec, inputs, targets, names):
    names = list(names or hessian_target_names(spec))
    return names, BatchGrads(params, spec, inputs, targets, names)


def _default_generator(grads):
    dev = next(iter(grads.ws.values())).device
    return torch.Generator(dev).manual_seed(0)


def top_eigenvalues(params, spec, inputs, targets, generator=None, top_n=1,
                    max_iter=100, tol=1e-3, names=None, starts=None):
    """The top ``top_n`` eigenvalues of the cross-entropy Hessian with
    respect to the weights ``names`` jointly (default every target
    weight) and their eigenvectors ({name: tensor}), by
    :func:`power_iteration` over ``BatchGrads.joint_hvp``.  Start vectors
    are standard normal from ``generator`` (on the params' device; None:
    seeded with 0), or ``starts(i, name, like)``."""
    names, grads = _spectrum_grads(params, spec, inputs, targets, names)
    if starts is None:
        g = generator or _default_generator(grads)

        def starts(i, name, like):
            return torch.randn(like.shape, generator=g, device=like.device,
                               dtype=like.dtype)

    eigenvalues, eigenvectors, _ = power_iteration(
        grads.joint_hvp, lambda i: {n: starts(i, n, grads.ws[n])
                                    for n in names},
        top_n, max_iter, tol)
    return eigenvalues, eigenvectors


def eigenvalue_density(params, spec, inputs, targets, generator=None,
                       iters=100, n_v=1, names=None, probes=None):
    """Stochastic Lanczos quadrature of the cross-entropy Hessian over the
    weights ``names`` jointly: for each of ``n_v`` Rademacher start
    vectors (from ``generator``, or ``probes(i, name, like)``), the Ritz
    values of ``iters`` Lanczos steps and their weights.  Returns (a list
    of value lists, a list of weight lists)."""
    names, grads = _spectrum_grads(params, spec, inputs, targets, names)
    if probes is None:
        g = generator or _default_generator(grads)

        def probes(i, name, like):
            return rademacher(like, g)

    all_eigs, all_weights = [], []
    for i in range(n_v):
        v0 = {n: probes(i, n, grads.ws[n]) for n in names}
        evals, weights = tridiagonal_ritz(*lanczos(grads.joint_hvp, v0,
                                                   iters))
        all_eigs.append(evals)
        all_weights.append(weights)
    return all_eigs, all_weights
