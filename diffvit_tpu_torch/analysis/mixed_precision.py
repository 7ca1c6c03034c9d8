"""Coarse-to-fine mixed-precision (4/8-bit) assignment: the port's own
copy of ``diffvit_tpu/analysis/mixed_precision.py`` (numpy and ``random``
only), so that the same seed and the same scores give the same candidate
list, omega order and final population in both packages.

The search loops of the reference's ``test_quant.py`` (:253-407):

1. **Candidate sampling under a size constraint** (``:262-283``): random
   4/8 configs, pairs of consecutive layers share a bit, first layer pinned
   to 8; keep configs whose FLOPs-weighted size <= 1.1x the all-4-bit size,
   up to 51 unique candidates.
2. **Omega ranking** (``:287-315``): omega = sum_i hessian_i * distance_i
   where distance_i is the calibrated per-bit weight L2 error
   (global_distance) for the bit chosen at layer i; validate the top 5.
3. **Evolutionary search** (``:336-407``): population 25 seeded from the
   omega ranking, 8 iterations of 10 mutations (p=.5) + 10 crossovers
   (p=.5) under the same size constraint, selection by validated top-1.

The evaluation callback is injected: ``engine.validate_bits`` (the
fake-quant forward) or ``engine.validate_bits_int`` (the integer path,
K1 + K2 on the card) score a generation's candidates.
"""
from __future__ import annotations

import random as _random

import numpy as np

BIT_CHOICE = (4, 8)
# Distance column index per eval bit.  global_distance rows are ordered by
# the calibration bit sweep [uint3, uint4, int4, int8]
# (models/ptq/layers.py:151-170).  The COMMITTED reference indexes the row
# by the *position* of the bit in bit_choice=[4,8]
# (test_quant.py:293-297: ``global_distance[i-1][k]`` with k in {0,1}) —
# i.e. the uint3/uint4 weight-error columns, almost certainly an upstream
# bug (their own commented-out code maps 4->0, 8->2 under a [4,6,8,10]
# sweep, test_quant.py:298-305) but it is the behavior the published
# mixed-precision results ran through, so it is the default here.
# "intended" selects the int4/int8 columns that actually correspond to the
# evaluated bits.
DIST_COLUMNS = {
    "committed": {4: 0, 8: 1},
    "intended": {4: 2, 8: 3},
}


def model_size(flops, bit_config):
    return sum(f * b for f, b in zip(flops, bit_config))


def size_constraint(flops, factor=1.1):
    return factor * sum(f * 4 for f in flops)


def sample_candidates(flops, rng, max_candidates=51, factor=1.1,
                      groups=None):
    """test_quant.py:264-283.  Default layout: [8] + each random bit
    doubled + [random] — consecutive (qkv,proj) / (fc1,fc2) pairs share a
    bit (the ViT slot structure).  ``groups``: explicit slot-index groups
    drawing one bit each (slot 0 stays pinned to 8) — used by the Swin
    extension, whose per-stage reduction slots break the pair doubling."""
    constraint = size_constraint(flops, factor)
    bit_list = []
    for _ in range(2 ** min(len(flops) - 1, 30)):
        if groups is None:
            inner = [rng.choice(BIT_CHOICE)
                     for _ in range(len(flops) // 2 - 1)]
            cand = [max(BIT_CHOICE)] + [b for b in inner for _ in range(2)] \
                + [rng.choice(BIT_CHOICE)]
        else:
            cand = [max(BIT_CHOICE)] * len(flops)
            for g in groups:
                b = rng.choice(BIT_CHOICE)
                for slot in g:
                    cand[slot] = b
        if model_size(flops, cand) <= constraint and cand not in bit_list:
            bit_list.append(cand)
        if len(bit_list) > max_candidates - 1:
            break
    return bit_list


def omega_rank(bit_list, flops, mean_hessian, global_distance,
               columns="committed"):
    """test_quant.py:287-315: score = sum over non-patch layers of
    hessian * selected-bit distance; ascending sort (lower = better).
    global_distance: (len(flops)-1, 4) array from calibrate().

    ``columns`` selects which distance columns a bit choice reads (see
    DIST_COLUMNS): "committed" reproduces the reference's test_quant.py,
    "intended" uses the true int4/int8 error columns."""
    col = DIST_COLUMNS[columns]
    gd = np.asarray(global_distance)
    omega_list = []
    for cand in bit_list:
        omega = 0.0
        for i, bit in enumerate(cand):
            if i == 0:
                continue  # patch conv has no distance entry
            omega += mean_hessian[i - 1] * gd[i - 1, col[bit]]
        omega_list.append([cand, float(omega)])
    omega_list.sort(key=lambda x: x[-1])
    return omega_list


def evolutionary_search(omega_list, flops, evaluate=None, *, pop_size=25,
                        evo_iter=8, mutate_size=10, mutate_prob=0.5,
                        crossover_size=10, crossover_prob=0.5, factor=1.1,
                        rng=None, log=print, evaluate_batch=None):
    """test_quant.py:336-407.  ``evaluate(bit_config) -> top1``; returns the
    final population [[bit_config, top1], ...] best-first.

    ``evaluate_batch(list_of_configs) -> list_of_top1`` enables the
    batched path: every candidate of a generation is scored in ONE
    validation pass over the data instead of sequential epochs —
    the candidate-generation RNG stream is independent of the scores within
    an iteration, so results are identical to the serial loop (including
    the reference's carry-over of the last valid score to size-violating
    children)."""
    rng = rng or _random.Random(0)
    constraint = size_constraint(flops, factor)
    if evaluate_batch is None:
        evaluate_batch = lambda cands: [evaluate(c) for c in cands]

    parents = [omega_list[i][0]
               for i in range(min(pop_size, len(omega_list)))]
    parent_scores = list(evaluate_batch(parents))
    parent_popu = [[c, s] for c, s in zip(parents, parent_scores)]
    # The carry-over score enters the evo loop holding the LAST-evaluated
    # parent's top-1 (the reference's val_prec1 is last assigned in its
    # parent init loop, test_quant.py:348-352) — an invalid first child
    # inherits exactly that value, not the best parent's.
    val_prec1 = parent_scores[-1] if parent_scores else 0.0
    parent_popu.sort(key=lambda x: x[-1], reverse=True)
    for evo in range(evo_iter):
        # -- generate the full generation first (RNG-only, no eval deps) --
        gen = []  # (config, valid)
        mutate_list = []
        while True:
            old = rng.choice(parent_popu)[0]
            new = [b if rng.random() < mutate_prob else rng.choice(BIT_CHOICE)
                   for b in old]
            valid = model_size(flops, new) <= constraint \
                and new not in mutate_list
            mutate_list.append(new)
            gen.append((new, valid))
            if len(mutate_list) > mutate_size:
                break
        crossover_list = []
        while True:
            p1 = rng.choice(parent_popu)[0]
            p2 = rng.choice(parent_popu)[0]
            if p1 == p2:
                continue
            new = [b1 if rng.random() < crossover_prob else b2
                   for b1, b2 in zip(p1, p2)]
            valid = model_size(flops, new) <= constraint \
                and new not in crossover_list
            crossover_list.append(new)
            gen.append((new, valid))
            if len(crossover_list) > crossover_size:
                break

        # -- score every valid candidate in one batched pass --
        valid_cands = [c for c, v in gen if v]
        scores = iter(evaluate_batch(valid_cands))

        # -- assemble children with the reference's carry-over semantics --
        children = []
        for cand, valid in gen:
            if valid:
                val_prec1 = next(scores)
            children.append([cand, val_prec1])

        for child in children:
            if child[1] > parent_popu[-1][1]:
                parent_popu.append(child)
        parent_popu.sort(key=lambda x: x[-1], reverse=True)
        parent_popu = parent_popu[:pop_size]
        log(f"Evolutionary iteration: {evo}")
        log(str(parent_popu))
    return parent_popu
