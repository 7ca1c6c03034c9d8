"""diffvit_tpu_torch — the PyTorch/CUDA port of diffvit_tpu for NVIDIA Hopper.

The JAX package ``diffvit_tpu`` stays the reference.  This package mirrors
its module names (``models/vit_int.py`` ↔ ``diffvit_tpu/models/vit_int.py``,
``ops/kernels/attention.py`` ↔ ``diffvit_tpu/ops/pallas/attention.py``, ...)
and imports neither ``jax`` nor ``diffvit_tpu``: it keeps its own copies of
the framework-neutral modules it needs (``config``, ``ops.bit_types``,
``utils.serialize``, ``utils.metrics``, and the input-code table of
``data.imagenet``), so an artifact written by either package loads in both.

Ported so far: the served integer ViT forward, every branch of the
reference's ``forward_q_int`` (``models.vit_int``), the served integer Swin
forward (``models.swin_int``), their hand-written CUDA kernels
(``ops.kernels``, sources in ``csrc/``), ViT calibration
(``calib.observers``, ``models.vit``), checkpoint loading
(``models.load``, ``models.registry``), the data pipeline
(``data.imagenet``: transform, ImageFolder, DataLoader, the codes wire,
DevicePrefetcher), the engine (``engine.QuantizedViT``, ``IntModel``,
``load_int_model``, ``validate``), the command line
(``python3 -m diffvit_tpu_torch.cli``, the port's ``test_quant.py``), the
calibration recovery passes (``calib``), the analysis toolkit
(``analysis``) and its drivers (``drivers``, the root analysis scripts).
"""
from .config import QuantConfig

__all__ = ["QuantConfig"]
