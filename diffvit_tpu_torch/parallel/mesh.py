"""The device mesh of the port (counterpart of ``diffvit_tpu/parallel/
mesh.py``), over ``torch.distributed`` (``parallel/comm.py``).

* **dp**: the batch is cut into one slice a rank, and the logits are
  gathered back (:func:`batch_sharding`, :func:`gather_batch`).
* **tp**: the weights are cut by the megatron rules (:func:`param_shardings`,
  :func:`int_param_shardings`): qkv and fc1 shard their output channels,
  proj and fc2 their input channels.  qkv's cut is by heads: a rank holds
  its H/tp heads' columns of each of the q, k and v slots (JAX's GSPMD cuts
  the 3C columns contiguously and reshards around the attention; the port
  cuts once, so that K1, K4 and K5 run on the rank's heads unchanged), and
  with them the matching entries of the integer qkv site's ``mult`` and
  ``b`` and of Swin's relative-position bias.  proj then runs row-parallel
  and its partial sums are summed over tp: int32 on the integer path, float64
  on the fake-quant path, each before the one rounding.  The integer MLP
  kernel K2 fuses fc1, GELU, fc2 and fc2's fence, so a rank all-gathers
  its tp group's fc1 and fc2 shards before it (:class:`GatheredWeight`),
  as GSPMD gathers around the Pallas K2; the fake-quant MLP runs fc1
  column- and fc2 row-parallel.
* **sp** (the fake-quant forward only): between blocks each rank holds its
  N/sp tokens of the residual stream (:func:`act_constraint`); LN, the
  products, GELU and the fences run on them, and attention gathers the
  whole K and V.
* **pp**: ``parallel/pipeline.py``.

The axes are ordered (dp, tp, sp, pp), pp innermost, so that neighbouring
stages are neighbouring ranks.  ``Mesh.shape`` has JAX's keys: dp and tp
always, sp and pp where they exceed 1."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import comm

AXES = ("dp", "tp", "sp", "pp")


def mesh_shape(n_devices: int, dp=None, tp=None, sp=None, pp=None) -> dict:
    """The axis sizes of ``make_mesh`` for ``n_devices`` ranks, with JAX's
    defaults (every rank on dp) and its assertion; sp and pp are keys only
    where they exceed 1."""
    sp_ = 1 if sp is None else sp
    pp_ = 1 if pp is None else pp
    if dp is None and tp is None:
        dp, tp = n_devices // (sp_ * pp_), 1
    elif dp is None:
        dp = n_devices // (tp * sp_ * pp_)
    elif tp is None:
        tp = n_devices // (dp * sp_ * pp_)
    assert dp * tp * sp_ * pp_ == n_devices, \
        f"mesh {dp}x{tp}x{sp_}x{pp_} != {n_devices} devices"
    shape = {"dp": dp, "tp": tp}
    if sp_ > 1:
        shape["sp"] = sp_
    if pp_ > 1:
        shape["pp"] = pp_
    return shape


@dataclasses.dataclass
class Mesh:
    """A mesh of ranks: ``shape`` (JAX's keys), this rank's ``coords`` on
    every axis of :data:`AXES` and its ``groups`` (one ``comm.Group`` an
    axis, and ``"all"``, the mesh's ranks); ``member`` is False on a rank
    past the mesh's ``n_devices``, which takes no part in its work."""
    shape: dict
    coords: dict
    groups: dict
    world: comm.World
    member: bool = True

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def backend(self) -> str:
        return self.world.backend

    @property
    def host_staged(self) -> bool:
        return self.world.host_staged

    def group(self, axis: str):
        """The rank's group on ``axis``, or None where the axis is 1."""
        return self.groups[axis] if self.size(axis) > 1 else None


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, sp: int | None = None,
              pp: int | None = None) -> Mesh:
    """A (dp, tp[, sp][, pp]) mesh over the first ``n_devices`` ranks of
    the world (default: all), with ``mesh_shape``'s defaults and
    assertion.  Collective: every rank of the world calls it."""
    world = comm.WORLD
    if world is None:
        raise RuntimeError("make_mesh needs the ranks' process group: run "
                           "under comm.spawn or torchrun (init_parallel)")
    n = world.size if n_devices is None else n_devices
    if n > world.size:
        raise ValueError(f"a mesh of {n} ranks in a world of {world.size}")
    shape = mesh_shape(n, dp, tp, sp, pp)
    dims = [shape.get(a, 1) for a in AXES]
    grid = np.arange(n).reshape(dims)
    groups = {}
    for ax in range(len(AXES)):
        moved = np.moveaxis(grid, ax, -1).reshape(-1, dims[ax])
        mine = comm.new_groups([tuple(int(r) for r in row) for row in moved])
        if mine:
            groups[AXES[ax]] = mine[0]
    mine = comm.new_groups([tuple(range(n))])
    member = world.rank < n
    coords = {}
    if member:
        groups["all"] = mine[0]
        idx = np.unravel_index(world.rank, dims)
        coords = {a: int(i) for a, i in zip(AXES, idx)}
    return Mesh(shape, coords, groups, world, member)


# ---- the megatron rules -----------------------------------------------------

def _path_str(path) -> str:
    return ".".join(str(p) for p in path)


def _leaves(tree, path=()):
    """(path, leaf) of every tensor or array in a nested dict/list."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not (
            tree and isinstance(tree[0], (int, float))):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif hasattr(tree, "shape") and hasattr(tree, "dtype"):
        yield path, tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return fn(_path_str(path), tree)
    return tree


def _param_pspec(path: str, arr) -> tuple:
    """JAX's rules for the float params ((out, in) weights): qkv/fc1 shard
    the out dim, proj/fc2 the in dim; everything else is replicated."""
    if path.endswith("qkv.w") or path.endswith("fc1.w"):
        return ("tp", None)
    if path.endswith("proj.w") or path.endswith("fc2.w"):
        return (None, "tp")
    if path.endswith("qkv.b") or path.endswith("fc1.b"):
        return ("tp",)
    return ()


def _divisible(spec: tuple, arr, tp: int) -> tuple:
    """``spec``, or () where tp does not divide a sharded dim (JAX's
    guard)."""
    return () if any(name == "tp" and arr.shape[d] % tp
                     for d, name in enumerate(spec)) else spec


# the leaves of a block's attention: cut by heads, or (where tp does not
# divide the block's heads) all replicated
_ATTN = ("qkv.w", "qkv.b", "qkv.w_int", "qkv.mult", "proj.w", "proj.w_int",
         "bias_q", "_h")


def _attn_whole(path: str, spec, tp: int) -> bool:
    """Whether ``path`` is an attention leaf of a block whose head count tp
    does not divide (``spec`` None: no block is)."""
    return spec is not None and path.endswith(_ATTN) \
        and _heads_of(spec, path) % tp != 0


def param_shardings(mesh: Mesh, params, spec=None):
    """The sharding of every float param leaf under ``mesh``: a tuple with
    "tp" at the sharded dim (``()``: replicated), JAX's
    ``param_shardings``.  The patch conv is excluded.  With ``spec``, a
    block's attention (qkv and proj) is replicated where tp does not
    divide its heads (JAX cuts such a qkv along its 3C columns; the port
    runs attention on whole heads)."""
    tp = mesh.size("tp")

    def rule(path, arr):
        if "patch_embed" in path or _attn_whole(path, spec, tp):
            return ()
        return _divisible(_param_pspec(path, arr), arr, tp)

    return _map(rule, params)


def int_param_shardings(mesh: Mesh, ip, spec=None):
    """The sharding of every leaf of a converted int model
    (``int_model_from_numpy`` / ``swin_int_model_from_numpy``), ViT or
    Swin: JAX's ``int_param_shardings`` ((Cin, Cout) weights: qkv/fc1 shard
    Cout, proj/fc2 shard Cin; the per-head ``*_h`` qkv layouts shard
    heads), and the port's own cuts beside them: the integer qkv site's
    ``mult`` and ``b`` (3C entries, by heads, as its weight's columns) and
    Swin's ``bias_q`` (H, n, n) by heads.  With ``spec``, a block's
    attention is replicated where tp does not divide its heads (Swin-T's
    first stage has 3), as in :func:`param_shardings`."""
    tp = mesh.size("tp")

    def rule(path, arr):
        if _attn_whole(path, spec, tp):
            return ()
        p = ()
        if path.endswith("qkv.w_int") or path.endswith("fc1.w_int"):
            p = (None, "tp")
        elif path.endswith("proj.w_int") or path.endswith("fc2.w_int"):
            p = ("tp", None)
        elif path.endswith("_h") and arr.ndim == 3 and "qkv" in path:
            p = ("tp", None, None) if not path.endswith(("mult_h",
                                                         "bias_h")) \
                else (None, "tp", None)
        elif (path.endswith("qkv.mult") or path.endswith("qkv.b")) \
                and arr.ndim == 1 and arr.shape[0] > 1:
            p = ("tp",)
        elif path.endswith("bias_q"):
            p = ("tp", None, None)
        return _divisible(p, arr, tp)

    return _map(rule, ip)


_HEAD_CUT = ("qkv.w", "qkv.b", "qkv.w_int", "qkv.mult")


def head_rows(num_heads: int, head_dim: int, tp: int, index: int):
    """The indices, along a qkv dim of 3 * num_heads * head_dim entries
    ordered [slot, head, d], of the heads of tp rank ``index``: its
    num_heads / tp heads in each of the q, k and v slots."""
    hl = num_heads // tp
    return np.arange(3 * num_heads * head_dim).reshape(
        3, num_heads, head_dim)[:, index * hl:(index + 1) * hl].reshape(-1)


def _heads_of(spec, path: str) -> int:
    if isinstance(spec.num_heads, int):
        return spec.num_heads
    return spec.num_heads[int(path.split(".")[1])]  # layers.<stage>...


def cut(path: str, arr, spec_dims: tuple, tp: int, index: int, spec):
    """Rank ``index``'s slice of ``arr`` under ``spec_dims``: an even cut
    of the "tp" dim, by heads along a qkv dim of [slot, head, d] entries.
    A new contiguous tensor (or array)."""
    if "tp" not in spec_dims:
        return arr
    d = spec_dims.index("tp")
    n = arr.shape[d]
    if path.endswith(_HEAD_CUT):
        heads = _heads_of(spec, path)
        idx = head_rows(heads, n // (3 * heads), tp, index)
    else:
        idx = np.arange(index * n // tp, (index + 1) * n // tp)
    if isinstance(arr, np.ndarray):
        return np.ascontiguousarray(np.take(arr, idx, axis=d))
    return arr.index_select(d, torch.as_tensor(idx, device=arr.device)) \
        .contiguous()


def _cutter(mesh: Mesh, spec):
    tp, index = mesh.size("tp"), mesh.coords["tp"]
    return lambda path, arr, dims: cut(path, arr, dims, tp, index, spec)


def shard_params(mesh: Mesh, params, spec):
    """This rank's slices of the float ``params`` (``param_shardings``;
    qkv by heads of ``spec``)."""
    return _map_with(_cutter(mesh, spec), params,
                     param_shardings(mesh, params, spec))


def _map_with(fn, tree, shardings, path=()):
    if isinstance(tree, dict):
        return {k: _map_with(fn, v, shardings[k], path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with(fn, v, shardings[i], path + (i,))
                for i, v in enumerate(tree)]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return fn(_path_str(path), tree, shardings)
    return tree


class GatheredWeight:
    """A (K, N) int8 weight that a rank holds a megatron shard of (cut along
    ``dim``), gathered whole from its tp group before a kernel that needs
    all of it: K2 fuses fc1, GELU, fc2 and fc2's fence, so fc2's int32
    accumulator never leaves it and the MLP cannot run column- and
    row-parallel.  Each call gathers into the tensor that the route reads
    and that lives across calls: on the CPU the (K, N) weight, which the
    plain version reads; on the card its K-major copy (``gemm.kmajor``),
    which K2 reads, so no copy is made after the first call (the (K, N)
    tensor itself is written once, by the first gather)."""

    def __init__(self, shard: torch.Tensor, dim: int, group: comm.Group):
        self.shard, self.dim, self.group = shard, dim, group
        shape = list(shard.shape)
        shape[dim] *= group.size
        self.full = torch.empty(shape, dtype=shard.dtype,
                                device=shard.device)
        self._kmajor = None

    def __call__(self) -> torch.Tensor:
        with torch.inference_mode():
            return self._gather()

    def _gather(self) -> torch.Tensor:
        if self.shard.device.type != "cuda" or self._kmajor is None:
            comm.gather_into(self.full, self.shard, self.group, self.dim)
            if self.shard.device.type == "cuda":
                from ..ops.kernels.gemm import kmajor

                self._kmajor = kmajor(self.full)
            return self.full
        from ..ops.kernels.gemm import kmajor

        # K-major: (N, Kp); the shard's K-major dim is the other one
        k = self.shard.shape[0]
        piece = kmajor(self.shard)[:, :k]
        if self.dim == 1:   # fc1: Cout cut -> K-major rows
            comm.gather_into(self._kmajor, kmajor(self.shard), self.group, 0)
        else:               # fc2: Cin cut -> K-major columns
            comm.gather_into(self._kmajor[:, :k * self.group.size], piece,
                             self.group, 1)
        return self.full


def shard_int_params(mesh: Mesh, ip, spec):
    """This rank's slices of a converted int model
    (``int_param_shardings``), with a :class:`GatheredWeight` for fc1 and
    fc2 of every block whose MLP is cut (``ib["mlp_tp"]``).  Raises
    ``ValueError`` for a block with a float (-1) site."""
    tp = mesh.size("tp")
    if tp == 1:
        return ip
    out = _map_with(_cutter(mesh, spec), ip,
                    int_param_shardings(mesh, ip, spec))
    group = mesh.groups["tp"]
    for ib in _blocks(out):
        if any(ib[s].get("fp", False) for s in ("qkv", "proj", "fc1",
                                                "fc2")):
            raise ValueError("tensor parallelism takes integer qkv, proj, "
                             "fc1 and fc2 sites (a -1 site is float)")
    for ib, whole in zip(_blocks(out), _blocks(ip)):
        w1, w2 = ib["fc1"]["w_int"], ib["fc2"]["w_int"]
        if w1.shape != whole["fc1"]["w_int"].shape:  # cut (tp divides it)
            ib["mlp_tp"] = (GatheredWeight(w1, 1, group),
                            GatheredWeight(w2, 0, group))
    return out


def _blocks(ip):
    """The blocks of a ViT or Swin int model, in order."""
    return ip["blocks"] if "blocks" in ip else [
        ib for st in ip["layers"] for ib in st["blocks"]]


def shard_replicated(mesh: Mesh, tree):
    """``tree`` (a dict of tensors) as mesh rank 0 holds it, on every rank:
    each tensor broadcast over the mesh."""
    group = mesh.groups["all"]
    if group.size == 1:
        return tree
    with torch.inference_mode():
        for _, t in sorted(_leaves(tree), key=lambda pt: _path_str(pt[0])):
            comm.broadcast(t, group, 0)
    return tree


# ---- the batch over dp ------------------------------------------------------

def n_micro_for(mesh: Mesh, b: int) -> int:
    """The pipeline's microbatch count for a batch of ``b``
    (``engine._pp_int_forward``): 2 pp where the batch fills 2 pp dp rows,
    else pp."""
    pp, dp = mesh.size("pp"), mesh.size("dp")
    return 2 * pp if b >= 2 * pp * dp else pp


def batch_pad(mesh: Mesh, b: int) -> int:
    """The zero rows that make a batch of ``b`` split evenly: over dp, and
    under pp into ``n_micro_for`` microbatches of each dp slice."""
    gran = mesh.size("dp")
    if mesh.size("pp") > 1:
        gran *= n_micro_for(mesh, b)
    return (-b) % gran


@dataclasses.dataclass
class DPBatch:
    """This rank's dp slice ``local`` of a batch of ``batch`` images, padded
    with zero rows to ``batch_pad``."""
    local: object
    batch: int


class BatchSharding:
    """Cuts a batch into this rank's dp slice (``batch_sharding``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, x) -> DPBatch:
        if isinstance(x, DPBatch):
            return x
        b = x.shape[0]
        pad = batch_pad(self.mesh, b)
        n = (b + pad) // self.mesh.size("dp")
        lo = self.mesh.coords["dp"] * n
        if isinstance(x, torch.Tensor):
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            return DPBatch(x[lo:lo + n], b)
        x = np.asarray(x)
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return DPBatch(x[lo:lo + n], b)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh)


def gather_batch(mesh: Mesh, out: torch.Tensor, b: int) -> torch.Tensor:
    """The dp slices' ``out`` gathered in batch order, without the pad
    rows: the whole batch's, on every rank."""
    group = mesh.group("dp")
    if group is not None:
        out = comm.all_gather(out, group, 0)
    return out[:b]


# ---- the forwards' parallel contexts ---------------------------------------

class TensorParallel:
    """The fake-quant forward's tp context (``vit.forward_q(tp=)``): the
    rank's heads and the rows of the column-parallel sites' per-channel
    weight scales, and the two collectives."""

    def __init__(self, group: comm.Group, spec):
        self.group = group
        tp, r = group.size, group.index
        # the attention runs on the rank's heads where tp divides them,
        # else whole on every rank (param_shardings replicates it)
        self.attn = spec.num_heads % tp == 0
        self.heads = spec.num_heads // tp if self.attn else spec.num_heads
        hid = spec.hidden_dim
        if hid % tp:
            raise ValueError(f"tp={tp} does not divide the hidden width "
                             f"{hid}")
        self._rows = {
            "qkv": torch.as_tensor(head_rows(spec.num_heads, spec.head_dim,
                                             tp, r)),
            "fc1": torch.arange(r * hid // tp, (r + 1) * hid // tp)}

    def rows(self, site: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's entries of a column-parallel site's per-channel
        vector ``t`` (a scalar passes)."""
        idx = self._rows[site]
        if t.dim() == 0 or t.shape[-1] == 1:
            return t
        return t.index_select(-1, idx.to(t.device))

    def enter(self, x):
        return comm.enter_parallel(x, self.group)

    def reduce(self, x):
        return comm.reduce_parallel(x, self.group)


def tensor_parallel(mesh: Mesh | None, spec):
    """The fake-quant forward's tp context, or None without a tp axis."""
    if mesh is None or mesh.size("tp") == 1:
        return None
    return TensorParallel(mesh.groups["tp"], spec)


class SequenceParallel:
    """``vit.forward_q``'s ``act_constraint`` under an sp axis: the
    residual stream's tokens cut over sp between blocks (the token count
    padded to the sp multiple with copies of the last token, as XLA pads a
    shard, so that every pad row stays finite), and gathered back."""

    def __init__(self, group: comm.Group):
        self.group = group

    def shard(self, h):
        """(B, N, C) replicated -> this rank's (B, N_pad / sp, C)."""
        pad = (-h.shape[1]) % self.group.size
        if pad:
            h = torch.cat([h, h[:, -1:].expand(-1, pad, -1)], 1)
        return comm.split(h, self.group, 1)

    def gather_kv(self, kv, n: int):
        """Every rank's tokens of ``kv`` (B, n_loc, ...) -> (B, n, ...):
        each rank's queries consume them (a reduce-scatter backward)."""
        return comm.gather(kv, self.group, 1, replicated=False)[:, :n]

    def gather(self, h, n: int):
        """The residual stream's tokens, whole, on every rank."""
        return comm.gather(h, self.group, 1, replicated=True)[:, :n]


def act_constraint(mesh: Mesh | None):
    """The sequence-parallel context of ``vit.forward_q``'s
    ``act_constraint``, or None where the mesh has no sp axis (or sp ==
    1), as in JAX."""
    if mesh is None or mesh.size("sp") == 1:
        return None
    return SequenceParallel(mesh.groups["sp"])
