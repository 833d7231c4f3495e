"""JAX parameter pytree (numpy) -> the port's torch tensors.

Inverts the layout map of ``mimic3_tpu/runtime/convert.py::convert_tensor``:

- conv weights ``[K, Cin/g, Cout]`` -> torch ``[Cout, Cin/g, K]``,
- transposed convs (``ups.*``) ``[K, Cin, Cout]`` -> torch ``[Cin, Cout, K]``,
- ``m`` / ``logs`` stay ``[C]``; embeddings, norms and biases unchanged.

Weight-norm pairs (``weight_g`` / ``weight_v``, as the synthetic test voice
stores them) are folded once here with the JAX formula
``g * v / ||v||``, the norm over axes (0, 1) of ``[K, Cin, Cout]`` — i.e.
per output channel for convs *and* transposed convs.

The npz helpers (``flatten_pytree``, ``unflatten_pytree``,
``save_pytree_npz``, ``load_pytree_npz``) and ``_TRANSPOSED_RE`` are port
copies of those in ``mimic3_tpu/runtime/convert.py``.
"""

from __future__ import annotations

import re
import typing
from pathlib import Path

import numpy as np
import torch

Pytree = typing.Dict[str, typing.Any]

# torch module paths whose 3-D "weight"/"weight_v" is a ConvTranspose1d
_TRANSPOSED_RE = re.compile(r"(^|\.)(ups)\.\d+($|\.)")


def _assign(tree: Pytree, path: typing.Sequence[str], value: np.ndarray):
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def flatten_pytree(
    tree: Pytree, prefix: str = ""
) -> typing.Dict[str, np.ndarray]:
    flat: typing.Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(flatten_pytree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_pytree(
    flat: typing.Mapping[str, np.ndarray],
) -> Pytree:
    tree: Pytree = {}
    for name, value in flat.items():
        _assign(tree, name.split("."), np.asarray(value))
    return tree


def save_pytree_npz(path: typing.Union[str, Path], tree: Pytree) -> None:
    np.savez(path, **flatten_pytree(tree))


def load_pytree_npz(path: typing.Union[str, Path]) -> Pytree:
    with np.load(path) as data:
        return unflatten_pytree({k: data[k] for k in data.files})


def fold_weight_norm(weight_g: np.ndarray, weight_v: np.ndarray) -> np.ndarray:
    """``g * v / ||v||`` in the JAX ``[K, Cin, Cout]`` layout."""
    v = np.asarray(weight_v, np.float32)
    norm = np.sqrt(np.sum(np.square(v), axis=(0, 1), keepdims=True))
    return np.asarray(weight_g, np.float32) * v / norm


def convert_leaf(name: str, arr: np.ndarray) -> np.ndarray:
    """One JAX-layout array (dotted module path ``name``) -> torch layout."""
    arr = np.asarray(arr, np.float32)
    if name.split(".")[-1] == "weight" and arr.ndim == 3:
        if _TRANSPOSED_RE.search(name):
            return arr.transpose(1, 2, 0)  # [K,Cin,Cout] -> [Cin,Cout,K]
        return arr.transpose(2, 1, 0)  # [K,Cin,Cout] -> [Cout,Cin,K]
    return arr


def to_torch_params(
    tree: Pytree,
    device: typing.Union[str, torch.device, None] = None,
    prefix: str = "",
) -> Pytree:
    """Convert a nested JAX parameter dict into torch tensors on ``device``."""
    out: Pytree = {}
    if "weight_g" in tree and "weight_v" in tree:
        tree = {
            **{k: v for k, v in tree.items() if k not in ("weight_g", "weight_v")},
            "weight": fold_weight_norm(tree["weight_g"], tree["weight_v"]),
        }
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out[key] = to_torch_params(value, device, path)
        else:
            out[key] = torch.tensor(
                convert_leaf(path, value), device=device
            )
    return out
