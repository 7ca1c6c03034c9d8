"""diffvit_tpu_torch — the PyTorch/CUDA port of diffvit_tpu for NVIDIA Hopper.

The JAX package ``diffvit_tpu`` stays the reference.  This package mirrors
its module names (``models/vit_int.py`` ↔ ``diffvit_tpu/models/vit_int.py``,
``ops/kernels/attention.py`` ↔ ``diffvit_tpu/ops/pallas/attention.py``, ...)
and never imports ``jax``: the framework-neutral modules of ``diffvit_tpu``
(``config``, ``ops.bit_types``, ``utils.serialize``, ``utils.metrics``,
``data.imagenet``) are imported, not copied.

Ported so far: the served integer ViT forward on the int8-codes residual
path (``models.vit_int.forward_q_int``), its two hand-written CUDA kernels
(``ops.kernels``, sources in ``csrc/``) and the serving engine
(``engine.IntModel`` / ``load_int_model`` / ``validate``).
"""
from diffvit_tpu.config import QuantConfig

__all__ = ["QuantConfig"]
