"""Nested-pytree <-> npz serialization for deployment artifacts (the port's
copy of ``diffvit_tpu/utils/serialize.py``; the ``.npz`` schema is the same
byte for byte, so an artifact written by either package loads in both).

The integer-model pytree is a nested structure of dicts, lists and tuples
whose leaves are arrays (int8 weight codes, f32 requant multipliers),
Python scalars (bits, ``fp`` flags) and the occasional ``None`` (absent
bias).  It is flattened into a flat ``{path: ndarray}`` mapping plus a JSON
manifest describing the container structure and scalar leaves, so the whole
artifact round-trips through a single ``.npz`` file — no pickle.

Path grammar: components joined with ``'/'``; dict keys are escaped
(``%`` -> ``%25``, ``/`` -> ``%2F``) so arbitrary string keys survive.
"""
from __future__ import annotations

import json
import os

import numpy as np


def _esc(key: str) -> str:
    return key.replace("%", "%25").replace("/", "%2F")


def _unesc(key: str) -> str:
    return key.replace("%2F", "/").replace("%25", "%")


def _flatten(prefix, obj, arrays, manifest):
    if isinstance(obj, dict):
        manifest[prefix] = {"kind": "dict",
                            "keys": [_esc(str(k)) for k in obj]}
        for k, v in obj.items():
            _flatten(f"{prefix}/{_esc(str(k))}", v, arrays, manifest)
    elif isinstance(obj, (list, tuple)):
        manifest[prefix] = {"kind": type(obj).__name__, "len": len(obj)}
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/{i}", v, arrays, manifest)
    elif obj is None:
        manifest[prefix] = {"kind": "none"}
    elif isinstance(obj, (bool, int, float, str)):
        manifest[prefix] = {"kind": "scalar", "value": obj,
                            "type": type(obj).__name__}
    else:  # array leaf
        manifest[prefix] = {"kind": "array"}
        arrays[prefix] = np.asarray(obj)


def _unflatten(prefix, arrays, manifest):
    node = manifest[prefix]
    kind = node["kind"]
    if kind == "dict":
        return {_unesc(k): _unflatten(f"{prefix}/{k}", arrays, manifest)
                for k in node["keys"]}
    if kind in ("list", "tuple"):
        items = [_unflatten(f"{prefix}/{i}", arrays, manifest)
                 for i in range(node["len"])]
        return tuple(items) if kind == "tuple" else items
    if kind == "none":
        return None
    if kind == "scalar":
        return {"bool": bool, "int": int, "float": float,
                "str": str}[node["type"]](node["value"])
    return arrays[prefix]


def _npz_path(path, *, saving):
    """np.savez appends '.npz' to str/PathLike targets that lack it; mirror
    that on load (preferring an exactly-named existing file)."""
    p = os.fspath(path) if isinstance(path, (str, os.PathLike)) else path
    if isinstance(p, str) and not p.endswith(".npz") \
            and (saving or not os.path.exists(p)):
        p += ".npz"
    return p


# Artifact schema version; load_pytree refuses any other.
FORMAT_VERSION = 1


class ArtifactError(ValueError):
    """A deployment artifact is corrupt, truncated, or from an
    incompatible format version."""


def save_pytree(path, tree, meta: dict | None = None):
    """Write ``tree`` (+ an optional JSON-able ``meta`` dict) to ``path``
    as one .npz."""
    arrays, manifest = {}, {}
    _flatten("root", tree, arrays, manifest)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"version": FORMAT_VERSION, "tree": manifest,
                    "meta": meta or {}}).encode(),
        dtype=np.uint8)
    np.savez(_npz_path(path, saving=True), **arrays)


def load_pytree(path):
    """Inverse of save_pytree: returns ``(tree, meta)``.  Raises
    :class:`ArtifactError` on anything that is not a well-formed
    save_pytree artifact of the current FORMAT_VERSION."""
    p = _npz_path(path, saving=False)
    try:
        z = np.load(p)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise ArtifactError(f"{p}: not a readable .npz artifact "
                            f"(truncated or wrong file type): {e}") from e
    with z:
        if "__manifest__" not in z.files:
            raise ArtifactError(
                f"{p}: no __manifest__ entry — not a save_pytree artifact")
        try:
            blob = json.loads(bytes(z["__manifest__"].tobytes()).decode())
        except Exception as e:
            raise ArtifactError(f"{p}: corrupt manifest JSON: {e}") from e
        version = blob.get("version")
        if version != FORMAT_VERSION:
            raise ArtifactError(
                f"{p}: artifact format version {version!r}, this build "
                f"reads version {FORMAT_VERSION}")
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    missing = [k for k, node in blob["tree"].items()
               if node.get("kind") == "array" and k not in arrays]
    if missing:
        raise ArtifactError(
            f"{p}: {len(missing)} arrays named by the manifest are missing "
            f"(truncated write?): {missing[:3]}...")
    return _unflatten("root", arrays, blob["tree"]), blob["meta"]
