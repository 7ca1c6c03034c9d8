"""The engine (counterpart of ``diffvit_tpu/engine.py``): ``QuantizedViT``
(a float ViT/DeiT that calibrates, runs the fake-quant and float forwards
and bakes itself into an int-model), and the serving half for the integer
ViT and Swin: ``IntModel``, ``save_int_model``, ``load_int_model`` and
``validate`` with the reference's Prec@1/Prec@5 report."""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from .config import QuantConfig
from .data.imagenet import (IMAGENET_MEAN, IMAGENET_STD, device_normalize,
                            input_code_lut, normalize_lut)
from .models import swin_int, vit, vit_int
from .models.convert import int_model_from_numpy, swin_int_model_from_numpy
from .models.registry import build_params, get_spec
from .models.swin import SwinSpec
from .models.vit import ViTSpec
from .utils.metrics import AverageMeter, accuracy, cross_entropy
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

    ``resident=True`` (ViT family): the encoder runs as one launch of the
    resident kernel K6 (``vit_int.forward_q_int_serve``), packed once here;
    on a CUDA device it runs K6 or raises."""

    def __init__(self, ip, spec: ViTSpec | SwinSpec, cfg: QuantConfig,
                 device="cuda", resident=False,
                 input_norm=(IMAGENET_MEAN, IMAGENET_STD)):
        self.spec, self.cfg = spec, cfg
        self.input_norm = tuple(input_norm)
        self.device = torch.device(device)
        self.is_swin = isinstance(spec, SwinSpec)
        self.packed = None
        if resident and self.is_swin:
            raise ValueError("resident serving kernel supports the ViT "
                             "family only")
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

    def __call__(self, x):
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
        with torch.inference_mode():
            return self._forward(self.ip, self.spec, self.cfg, x)


class QuantizedViT:
    """A calibratable ViT/DeiT on one device (the ViT family of
    ``diffvit_tpu.engine.QuantizedViT``): its float params, the
    calibration's qparams, the fake-quant and float forwards, and the bake
    into an ``IntModel`` or an int-model artifact.

    ``name_or_spec``: a model name (params drawn from ``seed`` unless
    ``params`` is given) or a ``ViTSpec`` with ``params``.  ``params``: a
    float pytree of tensors or numpy arrays in the reference's layout
    (``vit.params_from_numpy``).  uint8 batches are normalized on the
    device with ``input_norm`` (``data.imagenet.device_normalize``), as
    the reference's ``_prep`` does; float32 batches pass through.  A Swin
    spec raises ``NotImplementedError`` (ROADMAP Queue 1, item 4)."""

    def __init__(self, name_or_spec, cfg: QuantConfig | None = None,
                 params=None, seed: int = 0, device="cuda",
                 input_norm=(IMAGENET_MEAN, IMAGENET_STD)):
        self.device = torch.device(device)
        spec = get_spec(name_or_spec) if isinstance(name_or_spec, str) \
            else name_or_spec
        if isinstance(spec, SwinSpec):
            raise NotImplementedError(
                f"{spec.name}: Swin calibration is not ported yet (ROADMAP "
                "Queue 1, item 4)")
        if params is None:
            if not isinstance(name_or_spec, str):
                raise ValueError("a ViTSpec needs its params")
            spec, params = build_params(name_or_spec, seed=seed,
                                        device=self.device)
        self.spec, self.cfg = spec, cfg or QuantConfig()
        self.params = vit.params_from_numpy(params, self.device)
        self.qparams = None
        self.global_distance = None
        self.input_norm = tuple(input_norm)
        self._norm_lut = torch.tensor(normalize_lut(*self.input_norm),
                                      device=self.device)
        self._int_models = {}

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
                qp, dist = vit.calibrate_batches(
                    self.params, self.spec, self.cfg,
                    [self._prep(b) for b in batch])
            else:
                qp, dist = vit.calibrate(self.params, self.spec, self.cfg,
                                         self._prep(batch))
        self.qparams = qp
        self.global_distance = dist.cpu().numpy()
        self._int_models = {}
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
        self._int_models = {}
        return self.qparams

    def _bake(self, bit_config):
        return vit_int.prepare_int(self.params, self._calibrated(),
                                   self.spec, self.cfg, bit_config)

    def prepare_int(self, bit_config=None, resident=False) -> IntModel:
        """The calibrated model baked for ``bit_config`` (default: every
        slot ``cfg.bit_w``) as an ``IntModel`` on this device (``resident``:
        served through K6); kept per configuration."""
        if bit_config is not None:
            bit_config = tuple(int(b) for b in bit_config)
        key = (bit_config, bool(resident))
        if key not in self._int_models:
            self._int_models[key] = IntModel(
                self._bake(bit_config), self.spec, self.cfg, self.device,
                resident=resident, input_norm=self.input_norm)
        return self._int_models[key]

    def save_int_model(self, path, bit_config=None):
        """Bake for ``bit_config`` and write the int-model artifact that
        ``load_int_model`` of either package reads."""
        save_int_model(path, self._bake(bit_config), self.spec, self.cfg)

    def __call__(self, x, bit_config=None, quant=True):
        """Logits of the fake-quant forward (``quant``) at ``bit_config``,
        or of the float forward, on this device."""
        x = self._prep(x)
        with torch.inference_mode():
            if quant:
                return vit.forward_q(self.params, self._calibrated(),
                                     self.spec, self.cfg, x, bit_config)
            return vit.forward_fp(self.params, self.spec, x)

    @property
    def flops(self):
        return vit.flops_list(self.spec)


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
                   input_norm=(IMAGENET_MEAN, IMAGENET_STD)) -> IntModel:
    """Load a ``save_int_model`` artifact (a ``save_pytree`` .npz) onto
    ``device``, served per kernel or (``resident``) through K6.  The spec
    is rebuilt from the embedded dataclass fields."""
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
                    resident=resident, input_norm=input_norm)


def validate(model, loader, print_freq=100, log=print):
    """Full validation epoch with the reference's progress/report format
    (``diffvit_tpu/engine.py:751-798``).  Returns (loss_avg, prec1_avg,
    prec5_avg).  Batch i+1 is issued before batch i's logits are read, so
    the host work overlaps the device's."""
    batch_time, losses = AverageMeter(), AverageMeter()
    top1, top5 = AverageMeter(), AverageMeter()
    val_start = end = time.time()
    n_batches = len(loader) if hasattr(loader, "__len__") else None

    def score(i, output_dev, target):
        nonlocal end
        output = output_dev.float().cpu().numpy()  # waits for the device
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
        output_dev = model(data)
        if pending is not None:
            score(*pending)
        pending = (i, output_dev, target)
    if pending is not None:
        score(*pending)
    log(" * Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f} Time {t:.3f}".format(
        top1=top1, top5=top5, t=time.time() - val_start))
    return losses.avg, top1.avg, top5.avg
