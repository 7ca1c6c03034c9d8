"""Pipeline parallelism (the ``pp`` mesh axis) for the integer ViT path
(counterpart of ``diffvit_tpu/parallel/pipeline.py``).

Stage ``s`` keeps blocks ``[s*L/pp, (s+1)*L/pp)`` on its device, and the
batch flows through the stages in M microbatches, the GPipe schedule
(Huang et al., NeurIPS 2019).  The JAX package runs one SPMD program, a
``lax.scan`` over M + pp - 1 ticks with a ``ppermute`` a tick; here each
stage is a process that runs eagerly: stage 0 embeds and runs its blocks
on microbatch m, sends the result downstream and goes on to m + 1 while
stage 1 works on m, which is the GPipe overlap without a tick loop and
without bubble work on rows that are thrown away.

The wire between stages is the residual stream's int8 codes (the codes
path's ``hc``: (B/M, N, C)), or, outside the codes path, its float32
values.  Each stage runs ``vit_int._block_int``, the function
``forward_q_int`` loops over, so the pipelined logits equal the
single-process ones bit for bit.  The last stage runs the head and
broadcasts the logits over its pipeline.  pp composes with dp (each dp
slice is a pipeline of its own) and with tp (``_block_int`` on the
stage's blocks cut by ``mesh.shard_int_params``).

Scope, as in JAX: the ViT family (a Swin stage changes resolution
mid-network: refused in ``engine.IntModel``), every site quantized (no -1
site), a depth that pp divides (``prepare_pp`` raises ``ValueError``)."""
from __future__ import annotations

import torch

from ..config import QuantConfig
from ..models import vit_int
from ..models.vit import ViTSpec
from . import comm
from .mesh import Mesh, shard_int_params


def prepare_pp(ip, spec: ViTSpec, cfg: QuantConfig, pp: int) -> dict:
    """A pipeline plan of a converted int model (``int_model_from_numpy``):
    its blocks with their bits and input grid scales, and the flags
    resolved on the host, ``codes_mode`` (the wire carries int8 codes) and
    the per-block LIS gates ``lis_fast`` and ``lis_wide``.  Raises
    ``ValueError`` for a -1 site and for a depth that pp does not divide."""
    blocks = ip["blocks"]
    L = len(blocks)
    if L % pp != 0:
        raise ValueError(f"depth {L} not divisible by pp={pp}")
    bc = tuple(ip["bit_config"])
    if any(b == -1 for b in bc):
        raise ValueError("pipeline parallelism does not support -1 "
                         "(fp32-restored) layers")
    return {
        "blocks": list(blocks),
        "bits": [bc[4 * i + 1: 4 * i + 5] for i in range(L)],
        "in_scales": [ip["qact1"]["scale"] if i == 0
                      else blocks[i - 1]["qact4"]["scale"]
                      for i in range(L)],
        "pp": pp,
        "lps": L // pp,
        "codes_mode": bool(cfg.int_norm and cfg.smoothquant
                           and ip.get("sym_acts", False)),
        "lis_fast": tuple(bool(ib["lis_fast"]) for ib in blocks),
        "lis_wide": tuple(bool(ib["lis_wide"]) for ib in blocks),
    }


def plan_shardings(mesh: Mesh, plan: dict, spec: ViTSpec) -> dict:
    """The plan as this rank's stage runs it: only the stage's blocks (the
    others are dropped), cut over tp by ``mesh.shard_int_params`` where
    the mesh has a tp axis."""
    s, lps = mesh.coords["pp"], plan["lps"]
    part = slice(s * lps, (s + 1) * lps)
    blocks = plan["blocks"][part]
    if mesh.size("tp") > 1:
        blocks = shard_int_params(mesh, {"blocks": blocks}, spec)["blocks"]
    return dict(plan, blocks=blocks, bits=plan["bits"][part],
                in_scales=plan["in_scales"][part])


def forward_q_int_pp(ip, plan, spec: ViTSpec, cfg: QuantConfig, x,
                     mesh: Mesh, *, n_micro: int | None = None):
    """The pipelined integer forward of this rank's dp slice ``x`` (on the
    stage's device; only stage 0 reads it) over ``n_micro`` microbatches
    (default 2 pp).  ``ip`` holds the embed and the head (stage 0 and the
    last stage use them); ``plan`` is ``plan_shardings``'.  Returns the
    slice's (B, num_classes) logits on every stage."""
    pp = mesh.shape["pp"]
    assert pp == plan["pp"], f"plan built for pp={plan['pp']}, mesh has {pp}"
    M = n_micro if n_micro is not None else 2 * pp
    B = x.shape[0]
    assert B % M == 0, f"batch {B} not divisible by n_micro={M}"
    s, group, tp = mesh.coords["pp"], mesh.groups["pp"], mesh.group("tp")
    codes = plan["codes_mode"]
    mb, N, C = B // M, spec.seq_len, spec.embed_dim
    dev = x.device
    if s == 0:
        h = vit_int._embed_front(ip, spec, cfg, x)
        wire = vit_int._codes(h, ip["qact1"]["scale"], cfg.bit_a) \
            if codes else h
        chunks = wire.split(mb)
    outs, sends = [], []
    for m in range(M):
        state = chunks[m] if s == 0 else comm.recv(
            (mb, N, C), torch.int8 if codes else torch.float32, dev, group,
            s - 1)
        h, hc = (None, state) if codes else (state, None)
        for ib, bits4, in_scale in zip(plan["blocks"], plan["bits"],
                                       plan["in_scales"]):
            h, hc = vit_int._block_int(ib, bits4, in_scale, h, hc, spec,
                                       cfg, sym_acts=codes, tp=tp)
        out = hc if codes else h
        if s < pp - 1:
            sends.append(comm.isend(out, group, s + 1))
        else:
            outs.append(out)
    for work in sends:
        work.wait()
    logits = torch.empty((B, spec.num_classes), dtype=torch.float32,
                         device=dev)
    if s == pp - 1:
        last = torch.cat(outs)
        logits = vit_int._head_tail(ip, spec, cfg, None if codes else last,
                                    last if codes else None).contiguous()
    return comm.broadcast(logits, group, pp - 1)
