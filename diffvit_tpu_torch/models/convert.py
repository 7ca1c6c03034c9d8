"""The JAX int-model pytree -> the port's form, on one device.

The pytree is ``diffvit_tpu.models.vit_int.prepare_int``'s: loaded from a
``save_int_model`` artifact with ``utils.serialize.load_pytree``, or taken
from JAX directly with ``jax.device_get``.  This is where weights and state
cross from JAX to the port."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.attention import LIS_MIN_SCALE, lis_fast_ok
from .vit import ViTSpec


def _to_torch(node, device):
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_torch(v, device) for v in node]
    if isinstance(node, (bool, tuple)):
        return node  # fp / sym_acts flags, bit_config
    a = np.asarray(node)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def attn_constants(ib, spec: ViTSpec, block: int):
    """The per-block host-side constants of the reference forward
    (``vit_int.py:407-419``): the kernel scalars [s_a, c1, 1/s1, s1/s2] in
    float32, and the fast-LIS gate."""
    f32 = np.float32
    s1 = f32(np.asarray(ib["attn.qact1"]["scale"]).reshape(()))
    s_a = f32(np.asarray(ib["attn.qact_attn1"]["scale"]).reshape(()))
    s2 = f32(np.asarray(ib["attn.qact2"]["scale"]).reshape(()))
    if s_a < LIS_MIN_SCALE:
        raise ValueError(
            f"block {block}: softmax scale s_a={float(s_a)} < 2^-10; the "
            "exact int64 row sum of the LIS exponentials would overflow")
    c1 = s1 * s1 * f32(spec.attn_scale) / s_a
    scalars = np.asarray([s_a, c1, f32(1.0) / s1, s1 / s2], np.float32)
    return scalars, lis_fast_ok(float(s_a))


def int_model_from_numpy(ip, spec: ViTSpec, device) -> dict:
    """Copy every array of ``ip`` to ``device`` as a torch tensor (floats as
    float32, int8 codes as int8) and add, per block, ``attn_scalars`` (the
    attention kernel's (4,) float32 scalars) and ``lis_fast``."""
    out = _to_torch(ip, device)
    for i, (ib_np, ib) in enumerate(zip(ip["blocks"], out["blocks"])):
        scalars, fast = attn_constants(ib_np, spec, i)
        ib["attn_scalars"] = torch.tensor(scalars, device=device)
        ib["lis_fast"] = fast
    return out
