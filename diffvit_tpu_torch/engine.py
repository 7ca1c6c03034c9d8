"""The engine (counterpart of ``diffvit_tpu/engine.py``): ``QuantizedViT``
(a float ViT/DeiT or Swin that calibrates, runs the recovery passes
(AdaRound, distillation QAT, bias correction), runs the fake-quant and
float forwards, scores mixed-precision candidates and bakes itself into an
int-model), and the serving half for the integer ViT and Swin:
``IntModel``, ``save_int_model``, ``load_int_model`` and ``validate`` with
the reference's Prec@1/Prec@5 report; ``validate_bits`` and
``validate_bits_int`` score many {4, 8} configurations in one pass over
the data.  While a recording of ``utils/tracing.py`` is on, an
``IntModel`` call records ``dvt.call`` (its images and kernel launches)
over ``dvt.call.input`` and the forward's spans, and ``validate`` records
``dvt.validate.readback`` and ``dvt.validate.score`` a batch."""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from .config import QuantConfig
from .data.imagenet import (IMAGENET_MEAN, IMAGENET_STD, device_normalize,
                            input_code_lut, normalize_lut)
from .models import swin, swin_int, vit, vit_int
from .models.convert import int_model_from_numpy, swin_int_model_from_numpy
from .models.registry import build_params, get_spec
from .models.swin import SwinSpec
from .models.vit import ViTSpec
from .parallel import mesh as mesh_mod
from .utils.metrics import AverageMeter, accuracy, cross_entropy
from .utils import tracing
from .utils.serialize import ArtifactError, load_pytree, save_pytree


class IntModel:
    """A deployed integer ViT or Swin (by the spec's type): the baked
    int-model on one device plus its spec and QuantConfig.

    ``__call__`` takes a (B, 3, H, W) batch as numpy or torch: int8 input
    codes, uint8 pixels, or float32 normalized pixels.  It returns float32
    logits on the model's device.  uint8 pixels are encoded host-side with
    ``input_lut`` into codes, the same codes the reference derives on its
    device.  Where the codes wire would not carry the float32 wire's values
    there is no ``input_lut``: a model with ``input_quant=False``, or one
    whose float patch site sees a qact_input with a nonzero zero-point (the
    int8 code clips ``q - zp``, the float patch takes it unclipped).  Then
    uint8 pixels are normalized on the model's device
    (``data.imagenet.device_normalize``) and take the float32 wire, as
    every uint8 batch does in the reference, and int8 codes raise
    ``ValueError``.  ``input_norm``: the (mean, std) of both.

    ``resident=True`` (ViT family): the encoder runs on the resident kernel
    K6 (``vit_int.forward_q_int_serve``), packed once here, in the fewest
    near-equal launches whose scratch stays within
    ``vit_int.K6_SCRATCH_BYTES``; on a CUDA device it runs K6 or raises.

    ``microbatch=m``: the forward runs over chunks of m images, the last
    one zero-padded, and the logits are sliced back to the batch
    (``_microbatched``, ``diffvit_tpu/engine.py:524``); every row's logits
    are the unchunked forward's, bit for bit.

    ``mesh`` (``parallel.mesh.make_mesh``; the model lives on the mesh's
    device, and every rank of the mesh makes it): each call takes the whole
    batch, or this rank's ``mesh.DPBatch``, runs this rank's dp slice
    (padded with zero rows, ``mesh.batch_pad``) on its tp shard of the
    weights (``mesh.shard_int_params``), or under pp on its pipeline stage
    (``parallel/pipeline.py``, ``mesh.n_micro_for`` microbatches), and
    returns the whole batch's logits on every rank.  As in JAX, pp refuses
    a Swin, ``resident`` and ``microbatch``, and any mesh refuses
    ``resident`` and ``microbatch``."""

    def __init__(self, ip, spec: ViTSpec | SwinSpec, cfg: QuantConfig,
                 device="cuda", resident=False,
                 input_norm=(IMAGENET_MEAN, IMAGENET_STD), microbatch=None,
                 mesh=None):
        if microbatch is not None and int(microbatch) < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        self.spec, self.cfg = spec, cfg
        self.microbatch = None if microbatch is None else int(microbatch)
        self.input_norm = tuple(input_norm)
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.device)
        self.is_swin = isinstance(spec, SwinSpec)
        self.packed = None
        self._plan = None
        pp = 1 if mesh is None else mesh.size("pp")
        if pp > 1 and (self.is_swin or resident):
            raise ValueError("pipeline parallelism supports the ViT family, "
                             "per-kernel path")
        if pp > 1 and mesh.size("sp") > 1:
            # sp cuts the fake-quant residual stream; the integer pipeline
            # never takes it, so an sp axis would only replicate work
            raise ValueError("pp composes with dp/tp, not sp (sp is a "
                             "fake-quant-path axis)")
        if mesh is not None and microbatch:
            raise ValueError("microbatch is a single-chip serving knob")
        if resident and (self.is_swin or mesh is not None):
            raise ValueError("resident serving kernel supports the ViT "
                             "family on a single chip")
        if self.is_swin:
            self.ip = swin_int_model_from_numpy(ip, spec, self.device, cfg)
            self._forward = swin_int.forward_q_int
            qp = ip["qp"]
            scale, zp = qp.get("qact_input.scale"), qp.get("qact_input.zp")
        else:
            self.ip = int_model_from_numpy(ip, spec, self.device, cfg)
            self._forward = vit_int.forward_q_int
            if resident:
                self.packed = vit_int.prepare_resident(self.ip, spec, cfg)
                self._forward = functools.partial(
                    vit_int.forward_q_int_serve, packed=self.packed)
            site = ip.get("qact_input", {})
            scale, zp = site.get("scale"), site.get("zp")
        if pp > 1:
            from .parallel import pipeline

            self._plan = pipeline.plan_shardings(
                mesh, pipeline.prepare_pp(self.ip, spec, cfg, pp), spec)
            # the stages hold the blocks: keep the embed and the head
            self.ip = dict(self.ip,
                           blocks=[{"qact4": self.ip["blocks"][-1]["qact4"]}])
        elif mesh is not None:
            self.ip = mesh_mod.shard_int_params(mesh, self.ip, spec)
        # Swin's integer path has no float sites beside input_quant=False
        float_patch = not self.is_swin and ip["patch"]["fp"]
        # (3, 256) float32 table on the device: uint8 pixel -> normalized
        self._norm_lut = torch.tensor(normalize_lut(*self.input_norm),
                                      device=self.device)
        # (3, 256) int8 table: uint8 pixel -> qact_input code per channel
        self.input_lut = None
        if not spec.input_quant:
            self._no_codes = "the codes wire requires input_quant=True"
        elif float_patch and np.any(np.asarray(zp) != 0):
            self._no_codes = (
                "the codes wire cannot carry a nonzero qact_input zero-point "
                "into a float patch site (the int8 code clips q - zp); send "
                "uint8 or float32 pixels")
        else:
            bt = cfg.bit_a
            mean, std = self.input_norm
            self.input_lut = input_code_lut(
                np.asarray(scale), np.asarray(zp), mean=mean, std=std,
                qmin=bt.lower_bound, qmax=bt.upper_bound)

    def encode(self, x) -> np.ndarray:
        """uint8 NCHW batch -> int8 input codes (host-side numpy)."""
        x = np.asarray(x)
        if x.dtype != np.uint8:
            raise TypeError(f"encode expects uint8 pixels, got {x.dtype}")
        if self.input_lut is None:
            raise ValueError(self._no_codes)
        return np.stack([self.input_lut[c][x[:, c]] for c in range(3)], 1)

    def _chunked(self, x):
        """The forward over ``microbatch``-image chunks (zero-padded)."""
        m, b = self.microbatch, x.shape[0]
        pad = (-b) % m
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        out = torch.cat([self._forward(self.ip, self.spec, self.cfg, chunk)
                         for chunk in x.split(m)])
        return out[:b]

    def __call__(self, x, bit_config=None, quant=True, use_int=True):
        """Logits of the batch ``x``.  ``bit_config``, ``quant`` and
        ``use_int`` are accepted and ignored (the bit configuration is
        baked), so that ``validate`` drives an IntModel as it drives a
        QuantizedViT."""
        del bit_config, quant, use_int
        with tracing.span("dvt.call", launches=True) as call:
            with tracing.span("dvt.call.input"):
                x, b = self._device_input(x)
            if call is not None:
                call.counters["images"] = b
            with torch.inference_mode():
                if self.mesh is not None:
                    return self._mesh_forward(x, b)
                if self.microbatch is not None:
                    return self._chunked(x)
                return self._forward(self.ip, self.spec, self.cfg, x)

    def _device_input(self, x):
        """(the batch, or this rank's dp slice of it, on the device as int8
        codes or float32 pixels; the batch's images)."""
        part = None
        if self.mesh is not None:
            part = mesh_mod.batch_sharding(self.mesh)(x)
            x = part.local
        if self.input_lut is not None:  # uint8 -> codes on the host
            if isinstance(x, torch.Tensor) and x.dtype == torch.uint8:
                x = x.cpu().numpy()
            if isinstance(x, np.ndarray) and x.dtype == np.uint8:
                x = self.encode(x)
        x = device_normalize(torch.as_tensor(x, device=self.device),
                             lut=self._norm_lut)
        if x.dtype not in (torch.int8, torch.float32):
            raise TypeError(f"IntModel takes int8 codes, uint8 or float32 "
                            f"pixels, got {x.dtype}")
        if x.dtype == torch.int8 and self.input_lut is None:
            raise ValueError(self._no_codes)
        return x, x.shape[0] if part is None else part.batch

    def _mesh_forward(self, x, b):
        """This rank's dp slice ``x`` of a batch of ``b``: its logits, then
        the whole batch's."""
        mesh = self.mesh
        if self._plan is not None:
            from .parallel import pipeline

            out = pipeline.forward_q_int_pp(
                self.ip, self._plan, self.spec, self.cfg, x, mesh,
                n_micro=mesh_mod.n_micro_for(mesh, b))
        else:
            out = self._forward(self.ip, self.spec, self.cfg, x,
                                tp=mesh.group("tp"))
        return mesh_mod.gather_batch(mesh, out, b)


class QuantizedViT:
    """A calibratable ViT/DeiT or Swin on one device (the counterpart of
    ``diffvit_tpu.engine.QuantizedViT``): its float params, the
    calibration's qparams, the fake-quant and float forwards, and the bake
    into an ``IntModel`` or an int-model artifact.

    ``name_or_spec``: a model name (params loaded from ``checkpoint``, a
    ``.pth`` or ``.npz`` file, or drawn from ``seed``, unless ``params`` is
    given: ``registry.build_params``) or a ``ViTSpec``/``SwinSpec`` with
    ``params``.  ``params``: a float pytree of tensors or numpy arrays in
    the reference's layout (``vit.params_from_numpy``).  uint8 batches are
    normalized on the device with ``input_norm``
    (``data.imagenet.device_normalize``), as the reference's ``_prep``
    does; float32 batches pass through.  A Swin's bit configuration is its
    uniform weight bit or a per-slot sequence
    (``swin.normalize_bit_config``).

    ``mesh`` (``parallel.mesh.make_mesh``; the model lives on the mesh's
    device, and every rank of the mesh makes it): every rank keeps the
    whole float params and calibrates on the whole batch (the qparams are
    then broadcast from mesh rank 0, ``mesh.shard_replicated``), and the
    recovery passes run on the whole params on every rank, so that each
    rank holds the single process's result.  A call takes the whole batch
    or this rank's ``mesh.DPBatch`` and returns the whole batch's logits:
    the fake-quant forward of a ViT runs its dp slice on the rank's tp
    shards (``mesh.shard_params``, ``mesh.tensor_parallel``) with its
    tokens cut over sp (``mesh.act_constraint``); a Swin's fake-quant and
    every float forward run the dp slice whole; the integer path is
    ``IntModel(mesh=)``'s.  ``forward_bits`` puts the candidates on dp;
    ``forward_bits_int`` refuses a mesh, as in JAX."""

    def __init__(self, name_or_spec, cfg: QuantConfig | None = None,
                 params=None, checkpoint=None, seed: int = 0, device="cuda",
                 input_norm=(IMAGENET_MEAN, IMAGENET_STD), mesh=None):
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device)
        spec = get_spec(name_or_spec) if isinstance(name_or_spec, str) \
            else name_or_spec
        if params is None:
            if not isinstance(name_or_spec, str):
                raise ValueError("a spec needs its params")
            spec, params = build_params(name_or_spec, checkpoint, seed=seed,
                                        device=self.device)
        self.spec, self.cfg = spec, cfg or QuantConfig()
        self.is_swin = isinstance(spec, SwinSpec)
        self._mod = swin if self.is_swin else vit
        self.params = vit.params_from_numpy(params, self.device)
        # the float params: the recovery passes anchor their float targets
        # here after self.params has been replaced by reconstructed ones
        self.fp_params = self.params
        self.qparams = None
        self.global_distance = None
        self.input_norm = tuple(input_norm)
        self._norm_lut = torch.tensor(normalize_lut(*self.input_norm),
                                      device=self.device)
        self._int_models = {}
        self._int_bits = None
        self._shards = None

    def _mesh_kw(self):
        """The fake-quant forward's sharding keywords under the mesh."""
        if self.mesh is None or self.is_swin:
            return {}
        return {"act_constraint": mesh_mod.act_constraint(self.mesh),
                "tp": mesh_mod.tensor_parallel(self.mesh, self.spec)}

    def _q_params(self):
        """The params the fake-quant forward takes: under a tp mesh (ViT
        family) the rank's shards, cut once a set of params; else the
        whole."""
        if self.mesh is None or self.is_swin or self.mesh.size("tp") == 1:
            return self.params
        if self._shards is None:
            self._shards = mesh_mod.shard_params(self.mesh, self.params,
                                                 self.spec)
        return self._shards

    def _prep(self, x) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        x = device_normalize(x.to(self.device), lut=self._norm_lut)
        if x.dtype != torch.float32:
            raise TypeError(f"QuantizedViT takes uint8 or float32 pixels, "
                            f"got {x.dtype}")
        return x

    def calibrate(self, batch):
        """Calibration on one batch, or (a list of batches) the multi-batch
        protocol: statistics observed on all but the last, the scales
        finalized on the last.  Returns the qparams."""
        with torch.inference_mode():
            if isinstance(batch, (list, tuple)):
                qp, dist = self._mod.calibrate_batches(
                    self.params, self.spec, self.cfg,
                    [self._prep(b) for b in batch])
            else:
                qp, dist = self._mod.calibrate(self.params, self.spec,
                                               self.cfg, self._prep(batch))
        if self.mesh is not None:
            qp = mesh_mod.shard_replicated(self.mesh, qp)
        self.qparams = qp
        self.global_distance = dist.cpu().numpy()
        self._int_models, self._int_bits = {}, None
        return qp

    def _calibrated(self):
        if self.qparams is None:
            raise RuntimeError("model not calibrated; call .calibrate() "
                               "first")
        return self.qparams

    def save_calibration(self, path):
        """The qparams and the weight distances as the reference's .npz
        (``qp::<path>`` arrays and ``__global_distance__``)."""
        arrays = {f"qp::{k}": v.cpu().numpy()
                  for k, v in self._calibrated().items()}
        arrays["__global_distance__"] = np.asarray(self.global_distance)
        np.savez(path, **arrays)

    def load_calibration(self, path):
        with np.load(path) as z:
            self.qparams = {k[4:]: torch.tensor(z[k], device=self.device)
                            for k in z.files if k.startswith("qp::")}
            self.global_distance = np.asarray(z["__global_distance__"])
        if self.mesh is not None:
            self.qparams = mesh_mod.shard_replicated(self.mesh, self.qparams)
        self._int_models, self._int_bits = {}, None
        return self.qparams

    def _recon_input(self, batch, max_images):
        """The reconstruction input of ``adaround`` / ``bias_correct``: one
        calibration batch as it is, or a list of them concatenated, capped
        at ``max_images`` images taken evenly across the batches (the
        passes hold every site's input of every image at once, and
        AdaRound subsamples each site to ``max_rows`` rows anyway)."""
        if not isinstance(batch, (list, tuple)):
            return self._prep(batch)
        bs = [self._prep(b) for b in batch]
        if max_images is not None:
            total = sum(b.shape[0] for b in bs)
            if total > max_images:
                quota = -(-max_images // len(bs))
                bs = [b[:quota] for b in bs]
        x = torch.cat(bs)
        return x[:max_images] if max_images is not None else x

    def _replace_params(self, params):
        """The passes' result becomes ``self.params``; every bake of the
        old params is dropped (``prepare_int`` and the search's two bakes
        would serve the old weights)."""
        self.params = params
        self._int_models, self._int_bits = {}, None
        self._shards = None

    def adaround(self, batch, bit_config=None, *, steps=1000, max_rows=2048,
                 seed=0, max_images=256):
        """AdaRound (``calib/adaround.py``) at ``bit_config``: every
        quantized weight replaced by its learned codes times its scale, so
        that every consumer (``forward_q``, ``prepare_int``, the artifact)
        re-rounds it to them.  ``batch``: a calibration batch or a list of
        them (capped at ``max_images``, :meth:`_recon_input`).  Returns the
        report {site: (mse with nearest rounding, learned)}."""
        from .calib.adaround import adaround_swin, adaround_vit

        qp = self._calibrated()
        fn = adaround_swin if self.is_swin else adaround_vit
        params, report = fn(self.params, qp, self.spec, self.cfg,
                            self._recon_input(batch, max_images),
                            self._bit_config(bit_config), steps=steps,
                            max_rows=max_rows, seed=seed,
                            fp_params=self.fp_params)
        self._replace_params(params)
        return report

    def qat(self, batch, bit_config=None, *, steps=200, lr=1e-5,
            remat=False):
        """Distillation QAT (``calib/qat.py``) of the latent weights toward
        the float teacher (``fp_params``), on one batch or a list (cycled).
        ``remat``: the ViT family's blocks recomputed in the backward pass.
        Returns the per-step losses."""
        from .calib.qat import qat_distill

        qp = self._calibrated()
        batches = batch if isinstance(batch, (list, tuple)) else [batch]
        params, losses = qat_distill(
            self.params, qp, self.spec, self.cfg,
            [self._prep(b) for b in batches], self._bit_config(bit_config),
            steps=steps, lr=lr, fp_params=self.fp_params, remat=remat)
        self._replace_params(params)
        return losses

    def bias_correct(self, batch, bit_config=None, *, max_images=256):
        """Bias correction (``calib/biascorr.py``) toward the float model
        (``fp_params``); composes with ``adaround`` and ``qat`` (run
        those first).  Returns the report {site: (mean |shift| before,
        after)}."""
        from .calib.biascorr import bias_correct

        qp = self._calibrated()
        params, report = bias_correct(
            self.params, qp, self.spec, self.cfg,
            self._recon_input(batch, max_images),
            self._bit_config(bit_config), fp_params=self.fp_params)
        self._replace_params(params)
        return report

    def _bit_config(self, bit_config):
        """``bit_config`` as the bake and the forwards take it: a ViT's as
        a tuple (None: every slot ``cfg.bit_w``); a Swin's as the
        reference's engine gives it (None: ``cfg.bit_w``'s bit; an int, or
        a one-entry sequence, the uniform bit; else a per-slot tuple)."""
        if not self.is_swin:
            return None if bit_config is None else \
                tuple(int(b) for b in bit_config)
        if bit_config is None:
            return self.cfg.bit_w.bits
        if isinstance(bit_config, (int, np.integer)):
            return int(bit_config)
        bit_config = tuple(int(b) for b in bit_config)
        return bit_config[0] if len(bit_config) == 1 else bit_config

    def _bake(self, bit_config):
        int_mod = swin_int if self.is_swin else vit_int
        return int_mod.prepare_int(self.params, self._calibrated(),
                                   self.spec, self.cfg,
                                   self._bit_config(bit_config))

    def prepare_int(self, bit_config=None, resident=False) -> IntModel:
        """The calibrated model baked for ``bit_config`` (default: every
        slot ``cfg.bit_w``) as an ``IntModel`` on this device (``resident``:
        served through K6, the ViT family only: a Swin raises
        ``ValueError``).  Kept for the default configuration and for the
        latest other one: a mixed-precision search that validates each
        candidate on the integer path bakes one at a time, and the device
        holds at most two configurations' models."""
        if resident and self.is_swin:
            raise ValueError("resident serving kernel supports the ViT "
                             "family only")
        if self.is_swin and self.mesh is not None \
                and self.mesh.size("pp") > 1:
            raise ValueError("pipeline parallelism supports the ViT family "
                             "(a Swin stage changes resolution mid-network, "
                             "so its depth axis is not uniform)")
        bit_config = self._bit_config(bit_config)
        key = (bit_config, bool(resident))
        if key not in self._int_models:
            default = self._bit_config(None)
            for k in [k for k in self._int_models
                      if k[0] not in (default, bit_config)]:
                del self._int_models[k]
            self._int_models[key] = IntModel(
                self._bake(bit_config), self.spec, self.cfg, self.device,
                resident=resident, input_norm=self.input_norm,
                mesh=self.mesh)
        return self._int_models[key]

    def save_int_model(self, path, bit_config=None):
        """Bake for ``bit_config`` and write the int-model artifact that
        ``load_int_model`` of either package reads."""
        save_int_model(path, self._bake(bit_config), self.spec, self.cfg)

    def __call__(self, x, bit_config=None, quant=True, use_int=False):
        """Logits of the fake-quant forward (``quant``) at ``bit_config``,
        or of the float forward, on this device; ``use_int`` with ``quant``:
        of the integer path, the model baked for ``bit_config``
        (:meth:`prepare_int`)."""
        if use_int and quant:
            return self.prepare_int(bit_config)(x)
        part = None
        if self.mesh is not None:
            part = mesh_mod.batch_sharding(self.mesh)(x)
            x = part.local
        x = self._prep(x)
        with torch.inference_mode():
            if quant:
                out = self._mod.forward_q(
                    self._q_params(), self._calibrated(), self.spec,
                    self.cfg, x, self._bit_config(bit_config),
                    **self._mesh_kw())
            else:
                out = self._mod.forward_fp(self.params, self.spec, x)
            if part is not None:
                out = mesh_mod.gather_batch(self.mesh, out, part.batch)
            return out

    def forward_fn(self, quant: bool, bit_config=None):
        """``fwd(x) -> logits`` with autograd on (the counterpart of the
        JAX engine's ``_forward_fn``; PGD differentiates it with respect
        to ``x``): ``_prep``, then the fake-quant forward at
        ``bit_config`` (a Swin's ``bit``: None, an int or a per-slot
        sequence) or the float forward.  The fake-quant forward rounds
        without the STE, as JAX's does, so its gradient is exactly 0."""
        if not quant:
            return lambda x: self._mod.forward_fp(self.params, self.spec,
                                                  self._prep(x))
        qp = vit.autograd_safe(self._calibrated())
        if self.is_swin:
            return lambda x: swin.forward_q(self.params, qp, self.spec,
                                            self.cfg, self._prep(x),
                                            bit=bit_config)
        return lambda x: vit.forward_q(self.params, qp, self.spec, self.cfg,
                                       self._prep(x), bit_config)

    # -- mixed-precision candidates -----------------------------------------
    def forward_bits(self, x, bits_batch) -> torch.Tensor:
        """(ncand, B, classes) logits of the fake-quant forward at each
        {4, 8} configuration of ``bits_batch`` (ncand, slots), one
        candidate after the other on one device-resident batch (the JAX
        package vmaps them; ``diffvit_tpu/engine.py:372``).  Under a mesh
        the candidates are cut over dp (the last one repeated to the dp
        multiple), each rank scores its own on the whole batch (a
        ``mesh.DPBatch`` is gathered first), and every rank gets them
        all."""
        qp = self._calibrated()
        if isinstance(x, mesh_mod.DPBatch):  # the whole batch on every rank
            x = mesh_mod.gather_batch(self.mesh, self._prep(x.local),
                                      x.batch)
        x = self._prep(x)
        bits = np.asarray(bits_batch).tolist()
        n = len(bits)
        mine = bits
        if self.mesh is not None:
            dp = self.mesh.size("dp")
            bits = bits + bits[-1:] * ((-n) % dp)
            per = len(bits) // dp
            mine = bits[self.mesh.coords["dp"] * per:][:per]
        with torch.inference_mode():
            out = torch.stack([
                self._mod.forward_q_bits(self._q_params(), qp, self.spec,
                                         self.cfg, x, b, **self._mesh_kw())
                for b in mine])
            if self.mesh is not None:
                out = mesh_mod.gather_batch(self.mesh, out, n)
            return out

    def forward_bits_int(self, x, bits) -> torch.Tensor:
        """(B, classes) logits of the {4, 8} configuration ``bits`` on the
        integer path (``diffvit_tpu/engine.py:416``): the uniform 4- and
        8-bit bakes are made and moved to the device once
        (``vit_int.prepare_int_bits``), and each candidate selects its
        sites from them (``select_int_bits``), so its logits equal
        ``prepare_int(bits)``'s bit for bit and the kernels' K-major weight
        copies are made once.  On a CUDA device it runs K1 + K2 (K5 + K2
        with SmoothQuant off) or raises.  The ViT family only."""
        qp = self._calibrated()
        if self.is_swin:
            raise NotImplementedError(
                "int-path search eval is wired for the ViT family; Swin "
                "searches use the fake-path forward_bits")
        if self.mesh is not None:
            raise NotImplementedError(
                "int-path search eval is single-chip; under a mesh the "
                "fake-path forward_bits dp-shards the candidate axis")
        if self._int_bits is None:
            self._int_bits = vit_int.prepare_int_bits(
                self.params, qp, self.spec, self.cfg, self.device)
        ip = vit_int.select_int_bits(self._int_bits, bits, self.spec,
                                     self.cfg)
        x = self._prep(x)
        with torch.inference_mode():
            return vit_int.forward_q_int(ip, self.spec, self.cfg, x)

    @property
    def flops(self):
        return self._mod.flops_list(self.spec)


def save_int_model(path, ip, spec: ViTSpec | SwinSpec,
                   cfg: QuantConfig) -> None:
    """Write a numpy int-model pytree as the deployment artifact that
    ``diffvit_tpu``'s ``QuantizedViT.save_int_model`` writes (same .npz
    schema and metadata), so either engine can load it."""
    save_pytree(path, ip, meta={"model": spec.name,
                                "spec": dataclasses.asdict(spec),
                                "cfg": cfg.to_dict(),
                                "is_swin": isinstance(spec, SwinSpec)})


def load_int_model(path, device="cuda", resident=False,
                   input_norm=(IMAGENET_MEAN, IMAGENET_STD),
                   microbatch=None, mesh=None) -> IntModel:
    """Load a ``save_int_model`` artifact (a ``save_pytree`` .npz) onto
    ``device``, served per kernel or (``resident``) through K6, over
    ``microbatch``-image chunks where given, or over ``mesh``
    (``IntModel``).  The spec is rebuilt from the embedded dataclass
    fields."""
    ip, meta = load_pytree(path)
    if not all(k in meta for k in ("model", "spec", "cfg", "is_swin")):
        raise ArtifactError(
            f"{path}: a save_pytree artifact, but not an int-model export "
            f"(meta keys {sorted(meta)}; expected model/spec/cfg/is_swin)")
    sd = dict(meta["spec"])
    if meta["is_swin"]:
        for k in ("depths", "num_heads"):  # JSON turns tuples into lists
            sd[k] = tuple(sd[k])
        spec = SwinSpec(**sd)
    else:
        spec = ViTSpec(**sd)
    return IntModel(ip, spec, QuantConfig.from_dict(meta["cfg"]), device,
                    resident=resident, input_norm=input_norm,
                    microbatch=microbatch, mesh=mesh)


def validate(model, loader, bit_config=None, quant=True, print_freq=100,
             log=print, use_int=False):
    """Full validation epoch with the reference's progress/report format
    (``diffvit_tpu/engine.py:751-798``): ``model(data, bit_config=,
    quant=, use_int=)`` for every batch.  Returns (loss_avg, prec1_avg,
    prec5_avg).  Batch i+1 is issued before batch i's logits are read, so
    the host work overlaps the device's."""
    batch_time, losses = AverageMeter(), AverageMeter()
    top1, top5 = AverageMeter(), AverageMeter()
    val_start = end = time.time()
    n_batches = len(loader) if hasattr(loader, "__len__") else None

    def score(i, output_dev, target):
        nonlocal end
        with tracing.span("dvt.validate.readback", i):
            output = output_dev.float().cpu().numpy()  # waits for the device
        with tracing.span("dvt.validate.score", i):
            target = np.asarray(target)
            loss = cross_entropy(output, target)
            prec1, prec5 = accuracy(output, target, topk=(1, 5))
            n = len(target)
            losses.update(loss, n)
            top1.update(prec1, n)
            top5.update(prec5, n)
            batch_time.update(time.time() - end)
            end = time.time()
            if print_freq and i % print_freq == 0:
                log("Test: [{0}/{1}]\t"
                    "Time {bt.val:.3f} ({bt.avg:.3f})\t"
                    "Loss {loss.val:.4f} ({loss.avg:.4f})\t"
                    "Prec@1 {top1.val:.3f} ({top1.avg:.3f})\t"
                    "Prec@5 {top5.val:.3f} ({top5.avg:.3f})".format(
                        i, n_batches if n_batches is not None else "?",
                        bt=batch_time, loss=losses, top1=top1, top5=top5))

    pending = None  # (index, device output, target)
    for i, (data, target) in enumerate(loader):
        output_dev = model(data, bit_config=bit_config, quant=quant,
                           use_int=use_int)
        if pending is not None:
            score(*pending)
        pending = (i, output_dev, target)
    if pending is not None:
        score(*pending)
    log(" * Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f} Time {t:.3f}".format(
        top1=top1, top5=top5, t=time.time() - val_start))
    return losses.avg, top1.avg, top5.avg


def _count_top1(correct, ci, logits_dev, target):
    """Add candidate ``ci``'s correct top-1 predictions to ``correct``."""
    pred = logits_dev.argmax(-1).cpu().numpy()  # waits for the device
    correct[ci] += int((pred == np.asarray(target)).sum())


def validate_bits(model: QuantizedViT, loader, configs, log=print):
    """One pass over ``loader`` scoring every {4, 8} configuration of
    ``configs`` through the fake-quant forward
    (:meth:`QuantizedViT.forward_bits`; ``diffvit_tpu/engine.py:689``):
    the top-1 precision of each, in the order given.  Batch i+1 is issued
    before batch i's logits are read."""
    configs = [list(c) for c in configs]
    if not configs:
        return []
    correct = np.zeros(len(configs), np.int64)
    total = 0
    pending = None
    for data, target in loader:
        logits_dev = model.forward_bits(data, configs)
        if pending is not None:
            for ci in range(len(configs)):
                _count_top1(correct, ci, pending[0][ci], pending[1])
        pending = (logits_dev, target)
        total += len(target)
    if pending is not None:
        for ci in range(len(configs)):
            _count_top1(correct, ci, pending[0][ci], pending[1])
    log(f"validate_bits: {len(configs)} configs x {total} images")
    return [float(p) for p in 100.0 * correct / max(total, 1)]


def validate_bits_int(model: QuantizedViT, loader, configs, log=print):
    """:func:`validate_bits` on the integer path
    (:meth:`QuantizedViT.forward_bits_int`; ``diffvit_tpu/engine.py:718``):
    each batch is sent to the device once and serves every candidate in
    order; a candidate's logits are read one forward behind.  The ViT
    family only."""
    configs = [list(c) for c in configs]
    if not configs:
        return []
    correct = np.zeros(len(configs), np.int64)
    total = 0
    pending = None  # (candidate, device logits, target)
    for data, target in loader:
        xd = model._prep(data)
        total += len(target)
        for ci, bits in enumerate(configs):
            logits_dev = model.forward_bits_int(xd, bits)
            if pending is not None:
                _count_top1(correct, *pending)
            pending = (ci, logits_dev, target)
    if pending is not None:
        _count_top1(correct, *pending)
    log(f"validate_bits_int: {len(configs)} configs x {total} images")
    return [float(p) for p in 100.0 * correct / max(total, 1)]
