"""JAX parameter pytree (numpy) -> the port's torch tensors.

Inverts the layout map of ``mimic3_tpu/runtime/convert.py::convert_tensor``:

- conv weights ``[K, Cin/g, Cout]`` -> torch ``[Cout, Cin/g, K]``,
- transposed convs (``ups.*``) ``[K, Cin, Cout]`` -> torch ``[Cin, Cout, K]``,
- ``m`` / ``logs`` stay ``[C]``; embeddings, norms and biases unchanged.

Weight-norm pairs (``weight_g`` / ``weight_v``, as the synthetic test voice
stores them) are folded once here with the JAX formula
``g * v / ||v||``, the norm over axes (0, 1) of ``[K, Cin, Cout]`` — i.e.
per output channel for convs *and* transposed convs.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from mimic3_tpu.runtime.convert import _TRANSPOSED_RE

Pytree = typing.Dict[str, typing.Any]


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
