"""DDV-Hessian sensitivity (the port's counterpart of
``diffvit_tpu/analysis/ddv_hessian.py``): the loss is the summed MSE
between the reference model's clean x adversarial activation Grams
("DDVs", detached constants) and the target model's, and the sensitivity
is the per-weight Hutchinson trace of that loss's Hessian with respect to
the target model's weights (the diagonal block of each).

As in the JAX package, both models run the float forward (``forward_fp``
with taps, in the module-tap order of ``activations._order_for``): the
reference driver never quantizes its "int4_model", and fake-quant rounding
has a zero derivative.  The Grams and the loss are taken in float64.  One
forward and one ``create_graph`` backward (``hessian.BatchGrads`` with the
DDV loss) serve every selected weight; each HVP is one more backward.  The
ViT family only: JAX's ``DDVHessian`` runs ``vit.forward_fp`` for any
spec, and the port raises ``ValueError`` for a Swin.
"""
from __future__ import annotations

import torch

from ..models import swin as swin_mod
from ..models import vit as vit_mod
from .activations import _order_for
from .hessian import (BatchGrads, _default_generator, hessian_target_names,
                      leaf_traces, rademacher)

F64 = torch.float64


def params_up_to(all_names, name_selected):
    """The reference's ``get_params_grad`` (``pyhessian/utils.py:61-99``):
    the target weights in ``named_parameters`` order, stopping AFTER the
    first whose name contains ``name_selected`` (a substring test, so
    'blocks.1.attn' stops at blocks.1: blocks.11 comes later).  If no name
    matches (the patch conv, whose params the target filter skips), it
    warns and keeps them all."""
    out = []
    for n in all_names:
        out.append(n)
        if name_selected in n:
            return out
    print(f"Warning: Target layer {name_selected} not found in model")
    return out


def _taps_for_layer(params, spec, x, layer_indices=None):
    """The float forward's module taps of ``x`` in the reference's order,
    and their names; only the tap ``layer_indices`` where given."""
    taps: list = []
    vit_mod.forward_fp(params, spec, x, taps=taps)
    order = _order_for(spec, module_taps=True)
    d = dict(taps)
    if layer_indices is not None:
        return [d[order[layer_indices]]], [order[layer_indices]]
    return [d[n] for n in order], order


def _ddv_list(params, spec, x, adv_x, layer_indices):
    """The Gram ``a @ b.T`` (float64) of each tap's clean rows ``a`` and
    adversarial rows ``b``, and the taps' names."""
    acts, names = _taps_for_layer(params, spec, x, layer_indices)
    adv_acts, _ = _taps_for_layer(params, spec, adv_x, layer_indices)
    ddvs = []
    for a, b in zip(acts, adv_acts):
        a = a.reshape(a.shape[0], -1).to(F64)
        b = b.reshape(b.shape[0], -1).to(F64)
        ddvs.append(a @ b.T)
    return ddvs, names


class DDVHessian:
    """Per-weight Hutchinson traces of the DDV-MSE loss Hessian.

    ``model``: the reference (float) ``engine.QuantizedViT``, whose DDVs
    are constants; ``q_model``: the target one, whose weights are probed.
    ``data``: (inputs, labels); ``adv_data``: the adversarial inputs, or a
    tuple whose first entry they are.  ``layer_indices``: one tap (its
    index in the module-tap order); the probed weights are then those up
    to and including the first whose name contains the tap's
    (:func:`params_up_to`), else every target weight."""

    def __init__(self, model, q_model, data, adv_data, layer_indices=None,
                 max_iter=100, tol=1e-3):
        if isinstance(q_model.spec, swin_mod.SwinSpec) \
                or isinstance(model.spec, swin_mod.SwinSpec):
            raise ValueError("DDVHessian runs the ViT float forward; a "
                             "Swin spec is not supported")
        self.spec = q_model.spec
        self.q_params = q_model.params
        self.max_iter = max_iter
        self.tol = tol
        self.layer_indices = layer_indices

        inputs, _ = data
        adv_inputs = adv_data[0] if isinstance(adv_data, tuple) else adv_data
        self.inputs = q_model._prep(inputs)
        self.adv_inputs = q_model._prep(adv_inputs)

        with torch.no_grad():
            ref_ddvs, names = _ddv_list(model.params, model.spec,
                                        model._prep(inputs),
                                        model._prep(adv_inputs),
                                        layer_indices)
        self.ref_ddvs = [d.detach() for d in ref_ddvs]
        self.tap_names = names
        if layer_indices is not None:
            # the reference probes the weights up to AND including the
            # first whose name contains the tap's module name
            # (ddv_hessian.py:198, nameSelected = layer_info[0]['name'])
            self.param_names = params_up_to(hessian_target_names(self.spec),
                                            names[0])
        else:
            self.param_names = hessian_target_names(self.spec)

    def loss(self, params):
        """sum over the taps of mean((q_ddv - ref_ddv)^2), float64."""
        q_ddvs, _ = _ddv_list(params, self.spec, self.inputs,
                              self.adv_inputs, self.layer_indices)
        return sum(torch.mean((qd - rd) ** 2)
                   for qd, rd in zip(q_ddvs, self.ref_ddvs))

    def trace(self, generator=None, param_names=None, probes=None):
        """(names, traces): the per-weight diagonal-block Hutchinson traces
        (``ddv_hessian.py:302-359``) of ``param_names`` (default
        ``self.param_names``).  The probes are Rademacher from
        ``generator`` (on the params' device; None: seeded with 0), or
        ``probes(name, sample, like)``."""
        names = list(param_names or self.param_names)
        grads = BatchGrads(self.q_params, self.spec, None, None, names,
                           loss_fn=self.loss)
        if probes is None:
            g = generator or _default_generator(grads)

            def probes(name, k, like):
                return rademacher(like, g)

        return names, leaf_traces(grads, names, probes, self.max_iter,
                                  self.tol)
