"""Layer-restore sweeps (the port's counterpart of
``diffvit_tpu/analysis/restore.py``): evaluate the all-4-bit baseline, then
each combination of bit-config indices restored to 8 bits, appending
result lines to ``restore_<k>_layers.txt`` in the reference's format
(``layerwise_quant_compare.py:137-231``).
"""
from __future__ import annotations

import itertools
import time

from ..engine import validate
from ..models import vit as vit_mod


def int4_baseline_line(prec1, prec5, elapsed):
    return (f"Restore Index: nothing remains int4, "
            f"Prec@1 {prec1:.3f} Prec@5 {prec5:.3f} Time {elapsed:.3f}\n")


def restore_line(indices, prec1, prec5, elapsed):
    return (f"Restore Index: {list(indices)}, "
            f"Prec@1 {prec1:.3f} Prec@5 {prec5:.3f} Time {elapsed:.3f}\n")


def _quiet(*_):
    pass


def run_restore_sweep(model, val_loader, combinations, *, base_bits=4,
                      restore_bits=8, out_path=None, validate_fn=None,
                      log=print):
    """``combinations``: index tuples to restore.  ``validate_fn(bit_config)
    -> (prec1, prec5)``; the default validates ``model`` (an
    ``engine.QuantizedViT``) on ``val_loader`` through its fake-quant
    forward, as the JAX package does; pass ``engine.validate(...,
    use_int=True)`` for the integer path.  Returns [(indices, prec1,
    prec5), ...] and appends the reference's lines to ``out_path`` when
    given."""
    validate_fn = validate_fn or (lambda bc: validate(
        model, val_loader, bc, print_freq=0, log=_quiet)[1:])
    slots = vit_mod.num_bit_slots(model.spec)
    results = []

    def emit(line):
        if out_path:
            with open(out_path, "a") as f:
                f.write(line)
        log(line.strip())

    t0 = time.time()
    base = [base_bits] * slots
    prec1, prec5 = validate_fn(tuple(base))
    emit(int4_baseline_line(prec1, prec5, time.time() - t0))
    results.append(((), prec1, prec5))

    for combo in combinations:
        t0 = time.time()
        bc = list(base)
        for idx in combo:
            bc[idx] = restore_bits
        prec1, prec5 = validate_fn(tuple(bc))
        emit(restore_line(combo, prec1, prec5, time.time() - t0))
        results.append((tuple(combo), prec1, prec5))
    return results


def k_layer_combinations(k, slots=50, limit=None):
    """The first ``limit`` (default all) k-subsets of the bit-config
    indices (the reference enumerates these per sweep file,
    ``layerwise_quant_compare.py:148-172``)."""
    combos = itertools.combinations(range(slots), k)
    if limit is not None:
        combos = itertools.islice(combos, limit)
    return list(combos)
