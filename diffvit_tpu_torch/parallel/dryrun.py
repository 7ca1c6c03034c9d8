"""The port's parallel paths driven end to end on small models, and the rank
function that runs a list of parallel legs.

:func:`dryrun` is the counterpart of ``__graft_entry__.dryrun_multichip``
with its legs and specs: on an n-rank (dp, tp[, sp]) mesh the fake-quant
loss and its input gradient (JAX's, through rounding without the
straight-through estimator, is exactly 0; the ``ste=True`` gradient goes
through every collective's backward), the integer loss of the ViT and of a
Swin under (dp, tp), and the pipeline legs (tp x pp; with 8 ranks also dp
x pp = 4 on a full and a ragged batch), each integer leg bit-equal to the
single-process forward, the fake-quant ones within rtol = atol = 2e-4 with
equal argmax.  On the CPU, four gloo ranks:

    python -m diffvit_tpu_torch.parallel.dryrun --ranks 4 --device cpu

and on the card (ranks sharing it over gloo, or NCCL where each has a
card of its own) without ``--device cpu``.

:func:`run_legs` runs legs on the integer path (``IntModel(mesh=)``) and the
fake-quant path (``QuantizedViT(mesh=)``) of models handed over as numpy,
each against the single-process forward on the rank's device, with the
kernel launches and the bytes a rank sends per forward, its median time
and, on request, every kernel call of rank 0's forward held against its
plain version.  Every rank of the world runs it (``comm.spawn``)."""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import QuantConfig
from ..engine import IntModel, QuantizedViT
from ..models import swin, swin_int, vit, vit_int
from ..models.swin import SwinSpec
from ..models.vit import ViTSpec
from ..ops.kernels import attention, mlp, swin_attention
from . import comm
from . import mesh as mesh_mod

# depth 4: divisible by both pipeline legs (pp=2 and pp=4)
DRY_SPEC = ViTSpec("dryrun", embed_dim=64, depth=4, num_heads=2,
                   num_classes=16)
DRY_SWIN = SwinSpec("dryrun_swin", embed_dim=32, depths=(1, 1),
                    num_heads=(2, 4), img_size=56, num_classes=16)
RTOL = ATOL = 2e-4  # tests/test_parallel.py's, for the fake-quant legs


def _swin_plain(qkv5, bias_q, mask_div, scalars, *, num_heads, n_real,
                n_windows, bits=4, lis=True, lis_wide=False):
    return swin_attention.swin_attention_plain(
        qkv5[:, 0], qkv5[:, 1], qkv5[:, 2], bias_q, mask_div, scalars,
        n_real=n_real, n_windows=n_windows, bits=bits, lis=lis,
        lis_wide=lis_wide)


# the kernels of the served paths: (module whose name the forward calls,
# the wrapper, its plain version)
KERNELS = {
    "fused_qkv_attention_v2": (vit_int, attention.fused_qkv_attention_v2,
                               attention.fused_qkv_attention_v2_plain),
    "fused_int_attention": (vit_int, attention.fused_int_attention,
                            attention.fused_int_attention_plain),
    "fused_int_mlp": (vit_int, mlp.fused_int_mlp, mlp.fused_int_mlp_plain),
    "fused_swin_attention": (swin_int, swin_attention.fused_swin_attention,
                             _swin_plain),
}


def launches() -> dict:
    return {name: k[1].launches for name, k in KERNELS.items()}


def _reset():
    for _, fn, _ in KERNELS.values():
        fn.launches = 0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def held_calls(run, is_swin: bool):
    """Every kernel call ``run()`` makes, each held against its plain
    version on the same inputs: (calls, calls equal bit for bit, kernel
    names)."""
    calls, orig = [], {}
    mlp_mods = (swin_int if is_swin else vit_int,)
    for name, (mod, fn, plain) in KERNELS.items():
        for m in ((mod,) if name != "fused_int_mlp" else mlp_mods):
            orig[(m, name)] = getattr(m, name)

            def call(*args, _name=name, _fn=fn, **kw):
                out = _fn(*args, **kw)
                calls.append((_name, args, kw, out))
                return out
            setattr(m, name, call)
    try:
        run()
    finally:
        for (m, name), fn in orig.items():
            setattr(m, name, fn)
    equal = 0
    for name, args, kw, out in calls:
        want = KERNELS[name][2](*args, **kw)
        equal += bool(torch.equal(out, want))
    return len(calls), equal, sorted({c[0] for c in calls})


def _median_ms(fn, dev, repeat):
    times = []
    for _ in range(repeat):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)) if times else None


def _int_model(models, key, dev, mesh=None):
    kind, ip, spec, cfg = models[key]
    return IntModel(ip, spec, cfg, dev, mesh=mesh)


def _int_leg(world, leg, models, refs):
    mesh = mesh_mod.make_mesh(leg["n"], **leg.get("mesh", {}))
    if not mesh.member:
        return None
    dev, x = mesh.device, leg["x"]
    key = (leg["model"], id(x))
    if key not in refs:  # the single-process forward on this device
        refs[key] = _int_model(models, leg["model"], dev)(x).cpu().numpy()
    model = _int_model(models, leg["model"], dev, mesh)
    if dev.type == "cuda":
        model(x)  # warm-up: kernel plans, K-major copies
        _sync(dev)
    _reset()
    sent = world.bytes_sent
    out = model(x)
    _sync(dev)
    res = dict(name=leg["name"], launches=launches(),
               bytes=world.bytes_sent - sent, backend=mesh.backend,
               host_staged=mesh.host_staged, coords=mesh.coords,
               equal=bool(np.array_equal(out.cpu().numpy(), refs[key])),
               shape=list(out.shape))
    res["ms"] = _median_ms(lambda: model(x), dev, leg.get("repeat", 0))
    if leg.get("hold") and world.rank == 0:
        res["held"] = held_calls(lambda: model(x),
                                 isinstance(models[leg["model"]][2],
                                            SwinSpec))
    elif leg.get("hold"):
        model(x)  # the collectives of rank 0's held forward
    if world.rank == 0:
        res["logits"] = out.cpu().numpy()
    return res


def _fake_model(models, key, dev, mesh=None):
    _, params, qp, spec, cfg = models[key]
    q = QuantizedViT(spec, cfg, params=params, device=dev, mesh=mesh)
    q.qparams = {k: torch.tensor(np.asarray(v), device=q.device)
                 for k, v in qp.items()}
    return q


def _loss_grad(q, x, labels, bit_config, ste, mesh=None):
    """The fake-quant cross-entropy of ``x`` and its input gradient, on the
    mesh (this rank's dp slice, the logits gathered with autograd) or on
    one device."""
    qp = vit.autograd_safe(q.qparams)
    xt = torch.tensor(x, device=q.device)
    kw, params, part = {}, q.params, None
    if mesh is not None:
        part = mesh_mod.batch_sharding(mesh)(xt)
        xt = part.local
        kw, params = q._mesh_kw(), q._q_params()
    xt = xt.clone().requires_grad_(True)
    logits = vit.forward_q(params, qp, q.spec, q.cfg, xt, bit_config,
                           ste=ste, **kw)
    if mesh is not None and mesh.size("dp") > 1:
        logits = comm.gather(logits, mesh.groups["dp"], 0, replicated=True)
    if part is not None:
        logits = logits[:part.batch]
    lab = torch.as_tensor(labels, device=q.device)
    loss = -torch.log_softmax(logits.double(), -1)[
        torch.arange(len(lab)), lab].mean()
    grad, = torch.autograd.grad(loss, xt)
    if mesh is not None and mesh.size("dp") > 1:
        grad = comm.all_gather(grad, mesh.groups["dp"], 0)
    if part is not None:
        grad = grad[:part.batch]
    return float(loss.detach()), logits.detach().cpu().numpy(), \
        grad.cpu().numpy()


def agreement(got, want) -> dict:
    """The fake-quant legs' comparison: the share of equal elements, the
    largest |diff|, and whether every element is within rtol = atol =
    2e-4 (and, for logits, the argmax equal)."""
    got, want = np.asarray(got), np.asarray(want)
    out = dict(equal_share=float(np.mean(got == want)),
               max_abs_diff=float(np.abs(got - want).max()),
               within=bool(np.allclose(got, want, rtol=RTOL, atol=ATOL)))
    if got.ndim == 2:
        out["argmax_equal"] = bool((got.argmax(1) == want.argmax(1)).all())
    return out


def _fake_leg(world, leg, models, refs):
    mesh = mesh_mod.make_mesh(leg["n"], **leg.get("mesh", {}))
    if not mesh.member:
        return None
    dev, x = mesh.device, leg["x"]
    if leg["model"] not in refs:
        refs[leg["model"]] = _fake_model(models, leg["model"], dev)
    single = refs[leg["model"]]
    q = _fake_model(models, leg["model"], dev, mesh)
    with torch.inference_mode():
        want = single(x).cpu().numpy()
        _reset()
        sent = world.bytes_sent
        got = q(x).cpu().numpy()
    res = dict(name=leg["name"], bytes=world.bytes_sent - sent,
               launches=launches(), backend=mesh.backend,
               host_staged=mesh.host_staged, logits=agreement(got, want))
    if leg.get("grad"):
        labels = np.arange(len(x)) % q.spec.num_classes
        _, lg, g = _loss_grad(q, x, labels, None, True, mesh)
        _, lw, w = _loss_grad(single, x, labels, None, True)
        res["grad"] = agreement(g, w)
        res["grad_logits"] = agreement(lg, lw)
        if world.rank == 0:
            res["grad_array"] = g
    res["ms"] = _median_ms(lambda: q(x), dev, leg.get("repeat", 0))
    if world.rank == 0:
        res["logits_array"] = got
    return res


def _shards_leg(world, leg, models, refs):
    """The layout of the rank's tp shard of block 0 of an int model: the
    shapes of qkv's weight and multiplier, proj's, fc1's and fc2's, and of
    the MLP's gathered weights; whether qkv holds the rank's heads of the
    whole weight and the gathered weights are the whole ones."""
    mesh = mesh_mod.make_mesh(leg["n"], **leg.get("mesh", {}))
    if not mesh.member:
        return None
    _, ip, spec, cfg = models[leg["model"]]
    full = IntModel(ip, spec, cfg, mesh.device).ip["blocks"][0]
    ib = IntModel(ip, spec, cfg, mesh.device, mesh=mesh).ip["blocks"][0]
    rows = mesh_mod.head_rows(spec.num_heads, spec.head_dim,
                              mesh.size("tp"), mesh.coords["tp"])
    with torch.inference_mode():
        gathered = [g().clone() for g in ib["mlp_tp"]]
    return dict(
        qkv=list(ib["qkv"]["w_int"].shape), mult=list(ib["qkv"]["mult"].shape),
        qkv_heads=bool(torch.equal(ib["qkv"]["w_int"],
                                   full["qkv"]["w_int"][:, rows])),
        proj=list(ib["proj"]["w_int"].shape),
        fc1=list(ib["fc1"]["w_int"].shape), fc2=list(ib["fc2"]["w_int"].shape),
        gathered=[list(g.shape) for g in gathered],
        gathered_equal=all(torch.equal(g, full[s]["w_int"]) for g, s in
                           zip(gathered, ("fc1", "fc2"))))


def _engine_leg(world, leg, models, refs):
    """``QuantizedViT(mesh=)`` against one process: calibration on the
    whole batch (qparams equal), bias correction (params equal), the
    fake-quant logits, and ``forward_bits`` with the candidates cut over
    dp."""
    mesh = mesh_mod.make_mesh(leg["n"], **leg.get("mesh", {}))
    if not mesh.member:
        return None
    _, params, _, spec, cfg = models[leg["model"]]
    x, dev = leg["x"], mesh.device
    out = {}
    qs = [QuantizedViT(spec, cfg, params=params, device=dev, mesh=m)
          for m in (None, mesh)]
    with torch.inference_mode():
        for q in qs:
            q.calibrate(x)
    out["qparams_equal"] = all(torch.equal(qs[0].qparams[k], qs[1].qparams[k])
                               for k in qs[0].qparams)
    for q in qs:
        q.bias_correct(x)
    out["params_equal"] = all(
        torch.equal(a, b) for a, b in zip(*(
            [t for _, t in mesh_mod._leaves(q.params)] for q in qs)))
    bits = np.asarray(leg["bits"])
    got, want = (q.forward_bits(x, bits).cpu().numpy() for q in qs[::-1])
    out["bits"] = agreement(got.reshape(-1, got.shape[-1]),
                            want.reshape(-1, want.shape[-1]))
    out["bits_shape"] = list(got.shape)
    with torch.inference_mode():
        out["logits"] = agreement(qs[1](x).cpu().numpy(),
                                  qs[0](x).cpu().numpy())
    return out


def run_legs(world, legs, models):
    """Every leg of ``legs`` on this rank, in order (each builds its mesh on
    every rank; a rank outside it returns None for the leg).  ``models``:
    {key: ("int", ip, spec, cfg) | ("fake", params, qparams, spec, cfg)}
    as numpy.  A leg: {"name", "kind": "int" | "fake" | "shards" |
    "engine" | "dryrun" (:func:`_shards_leg`, :func:`_engine_leg`,
    :func:`dryrun`), "n":
    ranks, "mesh": make_mesh's dims, "model": key, "x": the batch,
    "repeat": forwards timed (median), "hold": rank 0 holds its kernel
    calls, "grad": the fake-quant input gradient with the STE}.  Returns
    this rank's result of each leg: launches by kernel and bytes sent in
    one forward, the backend, the single-process comparison, ms; rank 0's
    also the logits."""
    out, refs = [], {}
    kinds = {"int": _int_leg, "fake": _fake_leg, "shards": _shards_leg,
             "engine": _engine_leg}
    for leg in legs:
        if leg["kind"] == "dryrun":
            out.append(dryrun(world, leg.get("n")))
        else:
            out.append(kinds[leg["kind"]](world, leg, models, refs))
    return out


def _bake(params, qp, spec, cfg):
    mod = swin_int if isinstance(spec, SwinSpec) else vit_int
    return mod.prepare_int(params, qp, spec, cfg)


def dryrun(world, n_devices=None) -> dict:
    """``__graft_entry__.dryrun_multichip``'s legs on ``n_devices`` ranks
    of the world (default: all): raises on a failed leg; returns the
    losses, the comparisons and the pipeline legs run, and on rank 0 the
    fake-quant logits and the STE input gradient."""
    n = world.size if n_devices is None else n_devices
    sp = 2 if n % 8 == 0 else 1
    tp = 2 if n % 2 == 0 else 1
    mesh = mesh_mod.make_mesh(n, tp=tp, sp=sp)
    dev, cfg, spec = world.device, QuantConfig(), DRY_SPEC
    dp = mesh.size("dp")
    params = vit.init_params(spec, torch.Generator().manual_seed(0), dev)
    x = np.random.default_rng(0).standard_normal(
        (2 * dp, 3, 224, 224)).astype(np.float32)
    labels = np.arange(x.shape[0]) % spec.num_classes
    bit_config = (4,) * vit.num_bit_slots(spec)
    out = {"mesh": dict(mesh.shape), "backend": mesh.backend,
           "host_staged": mesh.host_staged, "pp_legs": []}

    single = QuantizedViT(spec, cfg, params=params, device=dev)
    with torch.inference_mode():
        single.calibrate(x)
    qp_np = {k: v.cpu().numpy() for k, v in single.qparams.items()}
    params_np = vit_int._host(params)
    if mesh.member:
        q = QuantizedViT(spec, cfg, params=params_np, device=dev, mesh=mesh)
        q.qparams = {k: torch.tensor(v, device=dev) for k, v in qp_np.items()}
        q.qparams = mesh_mod.shard_replicated(mesh, q.qparams)
        for ste in (False, True):
            loss, logits, grad = _loss_grad(q, x, labels, bit_config, ste,
                                            mesh)
            loss1, logits1, grad1 = _loss_grad(single, x, labels,
                                               bit_config, ste)
            if not np.isfinite(loss) or grad.shape != x.shape:
                raise RuntimeError("dryrun loss not finite")
            tag = "ste" if ste else "round"
            out[f"loss_{tag}"] = loss
            out[f"logits_{tag}"] = agreement(logits, logits1)
            out[f"grad_{tag}"] = agreement(grad, grad1)
            if not (out[f"logits_{tag}"]["within"]
                    and out[f"logits_{tag}"]["argmax_equal"]
                    and out[f"grad_{tag}"]["within"]):
                raise RuntimeError(f"dryrun fake-quant ({tag}) departs from "
                                   f"the single process: {out}")
            if world.rank == 0:
                out[f"logits_{tag}_array"] = logits
                out[f"grad_{tag}_array"] = grad

        # the integer path under the same mesh, ViT and Swin
        ip = _bake(params_np, qp_np, spec, cfg)
        got = IntModel(ip, spec, cfg, dev, mesh=mesh)(x).cpu().numpy()
        want = IntModel(ip, spec, cfg, dev)(x).cpu().numpy()
        if not np.array_equal(got, want):
            raise RuntimeError("dryrun int path departs from the single "
                               "process")
        lg = torch.log_softmax(torch.tensor(got, dtype=torch.float64), -1)
        out["int_loss"] = float(-lg[np.arange(len(labels)), labels].mean())

    sspec = DRY_SWIN
    sparams = swin.init_swin_params(sspec, torch.Generator().manual_seed(1),
                                    dev)
    sx = np.random.default_rng(1).standard_normal(
        (2 * dp, 3, 56, 56)).astype(np.float32)
    with torch.inference_mode():
        sqp, _ = swin.calibrate(sparams, sspec, cfg,
                                torch.tensor(sx[:2], device=dev))
    sip = _bake(sparams, sqp, sspec, cfg)
    if mesh.member:
        got = IntModel(sip, sspec, cfg, dev, mesh=mesh)(sx).cpu().numpy()
        want = IntModel(sip, sspec, cfg, dev)(sx).cpu().numpy()
        if not np.array_equal(got, want):
            raise RuntimeError("dryrun Swin int path departs from the "
                               "single process")
        out["swin_int"] = float(torch.logsumexp(torch.tensor(got), -1)
                                .mean())

    # the pipeline legs: tp x pp (and with 8 ranks dp x pp=4, full and
    # ragged), each bit-equal to the single-process integer forward
    ip = _bake(params_np, qp_np, spec, cfg)
    ref = IntModel(ip, spec, cfg, dev)(x).cpu().numpy()
    legs = [dict(tp=2 if n % 4 == 0 else 1, sp=1, pp=2 if n % 2 == 0
                 else 1)]
    if n % 8 == 0:
        legs.append(dict(tp=1, sp=1, pp=4))
    for leg in legs:
        pp_mesh = mesh_mod.make_mesh(n, **leg)
        pp = pp_mesh.size("pp")
        if pp == 1 or not pp_mesh.member:
            continue
        model = IntModel(ip, spec, cfg, dev, mesh=pp_mesh)
        for b in ([x.shape[0]] if pp == 2 else [x.shape[0],
                                                 x.shape[0] - 1]):
            got = model(x[:b]).cpu().numpy()
            if not np.array_equal(got, ref[:b]):
                raise RuntimeError(f"pp={pp} dp={pp_mesh.size('dp')} b={b}: "
                                   "the pipeline departs from the single "
                                   "process")
            out["pp_legs"].append(
                f"pp={pp},dp={pp_mesh.size('dp')},tp={pp_mesh.size('tp')},"
                f"b={b},pad={mesh_mod.batch_pad(pp_mesh, b)}")
    return out


def _summary(res: dict) -> dict:
    return {k: v for k, v in res.items() if not k.endswith("_array")}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    res = comm.spawn(dryrun, args.ranks, args.device, threads=1)[0]
    print("dryrun ok: " + json.dumps(_summary(res)))
    return res


if __name__ == "__main__":
    main()
