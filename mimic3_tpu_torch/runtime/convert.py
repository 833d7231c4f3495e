"""Checkpoint conversion: ONNX / torch VITS weights -> parameter pytree,
and that pytree -> the port's torch tensors.

The ONNX half is a port copy of ``mimic3_tpu/runtime/convert.py``: the
reference executes a black-box ``generator.onnx``
(reference: mimic3_tts/voice.py:403-405); here that file is just a weight
container.  Its tensors are mapped by their VITS module names (recovered
from the graph where a real ``torch.onnx.export`` anonymized them) into a
nested dict in the JAX package's layout, weight norm folded:

- conv weights  torch ``[Cout, Cin/g, K]``   -> ``[K, Cin/g, Cout]``
- transposed conv  torch ``[Cin, Cout, K]``  -> ``[K, Cin, Cout]``
- ``ElementwiseAffine`` m/logs ``[C, 1]``      -> ``[C]``
- embeddings/norms/biases unchanged.

:func:`convert_voice_directory` writes that dict as ``generator.npz``, the
same file the reference converter writes, so a voice converted by either
package loads in both.  The one difference: the shapes expected of each
parameter, and the values of the parameters a traced inference graph
omits, come from the port's own
:func:`~mimic3_tpu_torch.models.vits.model.init_params` instead of the
JAX initializer.  ``python -m mimic3_tpu_torch.runtime.convert
<voice_dir>`` (``mimic3-torch-convert``) is the CLI.

:func:`to_torch_params` then inverts the layout map for the session
(:func:`to_torch_train_params` for training keeps weight norm unfolded;
:func:`to_jax_layout` maps port tensors back):

- conv weights ``[K, Cin/g, Cout]`` -> torch ``[Cout, Cin/g, K]``,
- transposed convs (``ups.*``) ``[K, Cin, Cout]`` -> torch ``[Cin, Cout, K]``,
- ``m`` / ``logs`` stay ``[C]``; embeddings, norms and biases unchanged.

Weight-norm pairs (``weight_g`` / ``weight_v``, as the synthetic test voice
stores them) are folded once there with the JAX formula
``g * v / ||v||``, the norm over axes (0, 1) of ``[K, Cin, Cout]`` — i.e.
per output channel for convs *and* transposed convs.
"""

from __future__ import annotations

import json
import logging
import re
import typing
from pathlib import Path

import numpy as np
import torch

_LOGGER = logging.getLogger(__name__)

Pytree = typing.Dict[str, typing.Any]

# torch module paths whose 3-D "weight"/"weight_v" is a ConvTranspose1d
_TRANSPOSED_RE = re.compile(r"(^|\.)(ups)\.\d+($|\.)")

# parameters that are [C, 1] column vectors in torch but [C] here
_SQUEEZE_KEYS = ("m", "logs")


def _assign(tree: Pytree, path: typing.Sequence[str], value: np.ndarray):
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def convert_tensor(name: str, tensor: np.ndarray) -> np.ndarray:
    """Convert a single named torch tensor into our layout."""
    parts = name.split(".")
    leaf = parts[-1]
    arr = np.asarray(tensor, dtype=np.float32)

    if leaf == "weight" and arr.ndim == 3:
        if _TRANSPOSED_RE.search(name):
            return arr.transpose(2, 0, 1)  # [Cin,Cout,K] -> [K,Cin,Cout]
        return arr.transpose(2, 1, 0)  # [Cout,Cin,K] -> [K,Cin,Cout]
    if leaf in _SQUEEZE_KEYS and arr.ndim == 2 and arr.shape[1] == 1:
        return arr[:, 0]
    return arr


def _fold_weight_norm_flat(
    flat: typing.Dict[str, np.ndarray],
) -> typing.Dict[str, np.ndarray]:
    """Fold torch weight-norm pairs (still in torch layout).

    torch's ``weight_norm`` (dim=0) norms over all axes except axis 0, so
    folding here — before any transposition — is correct for both Conv1d
    ([Cout, Cin, K]) and ConvTranspose1d ([Cin, Cout, K]).
    """
    out: typing.Dict[str, np.ndarray] = {}
    for name, arr in flat.items():
        if name.endswith(".weight_g"):
            base = name[: -len(".weight_g")]
            v = np.asarray(flat[base + ".weight_v"], np.float32)
            g = np.asarray(arr, np.float32)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
            out[base + ".weight"] = g * v / norm
        elif name.endswith(".weight_v"):
            continue
        else:
            out[name] = arr
    return out


def normalize_param_name(name: str) -> typing.Optional[str]:
    """Normalize a torch state-dict key.

    Handles new-style parametrized weight norm
    (``...parametrizations.weight.original0/1`` -> ``weight_g``/``weight_v``)
    and drops buffers that have no meaning here.
    """
    name = name.replace(".parametrizations.weight.original0", ".weight_g")
    name = name.replace(".parametrizations.weight.original1", ".weight_v")
    if name.endswith("num_batches_tracked"):
        return None
    return name


def state_dict_to_pytree(
    state_dict: typing.Mapping[str, np.ndarray],
    *,
    strip_prefixes: typing.Sequence[str] = ("model.", "generator."),
) -> Pytree:
    """Convert a flat name->tensor mapping into the nested JAX pytree.

    Weight-norm pairs are folded (inference checkpoints don't train), so
    the resulting pytree always carries plain ``weight`` tensors.
    """
    flat: typing.Dict[str, np.ndarray] = {}
    for raw_name, tensor in state_dict.items():
        name = normalize_param_name(raw_name)
        if name is None:
            continue
        for prefix in strip_prefixes:
            if name.startswith(prefix):
                name = name[len(prefix):]
                break
        flat[name] = np.asarray(tensor)

    flat = _fold_weight_norm_flat(flat)

    tree: Pytree = {}
    for name, arr in flat.items():
        _assign(tree, name.split("."), convert_tensor(name, arr))
    return tree


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


def _layout_axes(name: str, ndim: int) -> typing.Optional[typing.Tuple[int, ...]]:
    """The permutation that takes a conv weight (``weight``, or a
    weight-norm ``weight_v``/``weight_g``) at dotted path ``name`` from the
    JAX layout to torch's; None for any other leaf."""
    if name.split(".")[-1] not in ("weight", "weight_v", "weight_g"):
        return None
    if ndim == 3:
        if _TRANSPOSED_RE.search(name):
            return (1, 2, 0)  # [K,Cin,Cout] -> [Cin,Cout,K]
        return (2, 1, 0)  # [K,Cin,Cout] -> [Cout,Cin,K]
    if ndim == 4:
        return (3, 2, 0, 1)  # HWIO [kh,kw,Cin,Cout] -> [Cout,Cin,kh,kw]
    return None


def convert_leaf(name: str, arr: np.ndarray) -> np.ndarray:
    """One JAX-layout array (dotted module path ``name``) -> torch layout."""
    arr = np.asarray(arr, np.float32)
    axes = _layout_axes(name, arr.ndim)
    # C order: torch.tensor keeps a transposed array's strides, and a
    # strided weight costs every convolution a copy
    return arr if axes is None else np.ascontiguousarray(arr.transpose(axes))


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


def to_torch_train_params(
    tree: Pytree,
    device: typing.Union[str, torch.device, None] = None,
    prefix: str = "",
) -> Pytree:
    """Training variant of :func:`to_torch_params`: weight norm stays
    unfolded, because the optimizer updates ``v`` and ``g``, not ``W``.

    ``weight_v`` takes the layout of ``weight``; ``weight_g`` the same
    permutation (``[1, 1, Cout]`` -> ``[Cout, 1, 1]``, transposed convs
    ``[1, Cout, 1]``; a 2-D conv's ``[1, 1, 1, Cout]`` -> ``[Cout, 1, 1,
    1]``).  Leaves may be numpy arrays or CPU tensors.
    """
    out: Pytree = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out[key] = to_torch_train_params(value, device, path)
        else:
            out[key] = torch.tensor(
                convert_leaf(path, np.asarray(value)), device=device
            )
    return out


def to_jax_layout(tree: Pytree, prefix: str = "") -> Pytree:
    """Inverse of :func:`to_torch_train_params` (and, for folded weights,
    of :func:`to_torch_params`): port tensors -> numpy arrays in the JAX
    package's layout, as ``generator.npz`` and the reference store them."""
    out: Pytree = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out[key] = to_jax_layout(value, path)
            continue
        arr = value.detach().float().cpu().numpy()
        axes = _layout_axes(path, arr.ndim)
        # a copy: a CPU tensor's numpy view would follow later updates
        out[key] = np.array(
            arr if axes is None else arr.transpose(np.argsort(axes)),
            order="C",
        )
    return out


# ---------------------------------------------------------------------------
# Name recovery for real torch.onnx.export artifacts
# ---------------------------------------------------------------------------
#
# Real exports (reference: mimic3_tts/voice.py:403-405 runs such a file)
# constant-fold the weight-norm parametrizations, which ANONYMIZES those
# initializers ("onnx::Conv_123"-style names).  Recovery uses, in order:
#   1. dotted names that suffix-match the expected parameter set,
#   2. the consuming node's scoped name ("/dec/ups.0/ConvTranspose",
#      torch >= 1.13 exports),
#   3. shape + execution-order matching against the expected inference
#      execution order (older exports with bare "Conv_123" node names).
# ElementwiseAffine constants are folded as (m, exp(-logs)) Sub/Mul
# constants and are inverted back.

# ops whose initializer inputs are parameters: input position -> leaf
_PARAM_POSITIONS: typing.Dict[str, typing.Dict[int, str]] = {
    "Conv": {1: "weight", 2: "bias"},
    "ConvTranspose": {1: "weight", 2: "bias"},
    "Gemm": {1: "weight", 2: "bias"},
    "Gather": {0: "weight"},
    "LayerNormalization": {1: "gamma", 2: "beta"},
}

# At opset < 17 torch decomposes LayerNorm into primitives; gamma/beta
# then appear as Mul/Add constants whose partner input descends from
# the normalization's Div (pattern verified stable across opsets 11-15
# for torchscript exports).  Position-independent: either input slot.
_NORM_DECOMPOSED_LEAVES: typing.Dict[str, str] = {
    "Mul": "gamma",
    "Add": "beta",
}


class ConversionError(RuntimeError):
    """A live parameter could not be recovered from the ONNX graph.

    Raised (in strict mode) instead of silently substituting random
    initialization — converted audio would be wrong, not degraded.
    """

# VITS structural constants (arXiv 2106.06103; reference config.py:113-143
# exposes no knobs for these)
_N_COUPLING_FLOWS = 4
_COUPLING_WN_LAYERS = 4
_N_DP_FLOWS = 4
_DDS_LAYERS = 3


def _torch_shape(
    name: str, shape: typing.Sequence[int]
) -> typing.Tuple[int, ...]:
    """Our-layout parameter shape -> the torch/ONNX layout shape."""
    leaf = name.split(".")[-1]
    if leaf == "weight" and len(shape) == 3:
        k, cin, cout = shape
        if _TRANSPOSED_RE.search(name):
            return (cin, cout, k)
        return (cout, cin, k)
    if leaf in _SQUEEZE_KEYS and len(shape) == 1:
        return (shape[0], 1)
    return tuple(shape)


# the expected parameter set (shapes + dead-param fill values) is needed
# twice per conversion (shape expectations + dead-param filling), so
# memoize per config
_INIT_FLAT_CACHE: typing.Dict[str, typing.Dict[str, np.ndarray]] = {}


def _init_flat_cached(model_config) -> typing.Dict[str, np.ndarray]:
    """Flat ``init_params(0, model_config)`` as numpy: the reference's key
    names and shapes (weight norm unfolded), values drawn by the port."""
    key = repr(model_config)
    cached = _INIT_FLAT_CACHE.get(key)
    if cached is None:
        from ..models.vits.model import init_params

        cached = flatten_pytree(init_params(0, model_config))
        _INIT_FLAT_CACHE.clear()  # keep at most one entry resident
        _INIT_FLAT_CACHE[key] = cached
    return cached



def expected_params_from_config(
    model_config,
) -> typing.Dict[str, typing.Tuple[int, ...]]:
    """Expected {dotted_name: torch_layout_shape}, weight-norm folded."""
    flat = _init_flat_cached(model_config)
    out: typing.Dict[str, typing.Tuple[int, ...]] = {}
    for name, arr in flat.items():
        if name.endswith(".weight_g"):
            continue
        if name.endswith(".weight_v"):
            name = name[: -len(".weight_v")] + ".weight"
        out[name] = _torch_shape(name, arr.shape)
    return out


def _dds_order(base: str) -> typing.List[str]:
    out = []
    for i in range(_DDS_LAYERS):
        out += [
            f"{base}.convs_sep.{i}",
            f"{base}.norms_1.{i}",
            f"{base}.convs_1x1.{i}",
            f"{base}.norms_2.{i}",
        ]
    return out


def expected_execution_order(model_config) -> typing.List[str]:
    """Module paths in INFERENCE execution order.

    This is the order a traced ``torch.onnx.export`` of the synthesis
    graph lays its nodes out in; flow stacks run in reverse module order
    at synthesis, and the first ConvFlow of the duration predictor is
    dead (``flows[:-2] + [flows[-1]]``) so it never appears.
    """
    cfg = model_config
    ms = bool(getattr(cfg, "is_multispeaker", False))
    order: typing.List[str] = []
    if ms:
        order.append("emb_g")
    order.append("enc_p.emb")
    for i in range(cfg.n_layers):
        a = f"enc_p.attn_layers.{i}"
        order += [
            f"{a}.conv_q",
            f"{a}.conv_k",
            f"{a}.conv_v",
            f"{a}.emb_rel_k",
            f"{a}.emb_rel_v",
            f"{a}.conv_o",
            f"enc_p.norm_layers_1.{i}",
            f"enc_p.ffn_layers.{i}.conv_1",
            f"enc_p.ffn_layers.{i}.conv_2",
            f"enc_p.norm_layers_2.{i}",
        ]
    order.append("enc_p.proj")

    if not getattr(cfg, "use_sdp", True):
        # deterministic duration predictor (use_sdp=False voices):
        # optional cond, then conv-norm x2 + projection
        if ms:
            order.append("dp.cond")
        order += [
            "dp.conv_1", "dp.norm_1",
            "dp.conv_2", "dp.norm_2",
            "dp.proj",
        ]
    else:
        # stochastic duration predictor, reverse pass
        order.append("dp.pre")
        if ms:
            order.append("dp.cond")
        order += _dds_order("dp.convs")
        order.append("dp.proj")
        conv_flows = [1 + 2 * k for k in range(_N_DP_FLOWS)]
        for f in list(reversed(conv_flows))[:-1]:  # first ConvFlow dead
            order += (
                [f"dp.flows.{f}.pre"]
                + _dds_order(f"dp.flows.{f}.convs")
                + [f"dp.flows.{f}.proj"]
            )
        order.append("dp.flows.0")  # ElementwiseAffine

    # residual coupling flow, reverse order
    for f in reversed(range(0, 2 * _N_COUPLING_FLOWS, 2)):
        base = f"flow.flows.{f}"
        order.append(f"{base}.pre")
        if ms:
            order.append(f"{base}.enc.cond_layer")
        for j in range(_COUPLING_WN_LAYERS):
            order += [
                f"{base}.enc.in_layers.{j}",
                f"{base}.enc.res_skip_layers.{j}",
            ]
        order.append(f"{base}.post")

    # HiFi-GAN decoder
    order.append("dec.conv_pre")
    if ms:
        order.append("dec.cond")
    nk = len(cfg.resblock_kernel_sizes)
    resblock2 = getattr(cfg, "resblock", "1") == "2"
    for i in range(len(cfg.upsample_rates)):
        order.append(f"dec.ups.{i}")
        for j in range(nk):
            rb = i * nk + j
            for layer in range(len(cfg.resblock_dilation_sizes[j])):
                if resblock2:
                    # ResBlock2: one dilated conv per step ("convs")
                    order.append(f"dec.resblocks.{rb}.convs.{layer}")
                else:
                    order += [
                        f"dec.resblocks.{rb}.convs1.{layer}",
                        f"dec.resblocks.{rb}.convs2.{layer}",
                    ]
    order.append("dec.conv_post")
    return order


def _suffix_match(
    name: str, expected: typing.Mapping[str, typing.Any]
) -> typing.Optional[str]:
    """Match a (possibly prefixed) dotted name into the expected set.

    Tries stripping leading segments ("net.enc_p.emb.weight" ->
    "enc_p.emb.weight"); failing that, accepts the name as a UNIQUE tail
    of an expected name — traced method calls (dp.reverse) lose their
    owner's scope, so "/flows.7/pre/Conv" means "dp.flows.7.pre".
    """
    parts = name.split(".")
    for i in range(len(parts)):
        cand = ".".join(parts[i:])
        if cand in expected:
            return cand
    tails = [e for e in expected if e.endswith("." + name)]
    if len(tails) == 1:
        return tails[0]
    return None


def _scope_to_path(node_name: str) -> typing.Optional[str]:
    """Scoped node name '/dec/ups.0/ConvTranspose' -> 'dec.ups.0'."""
    parts = [p for p in node_name.split("/") if p]
    if len(parts) < 2:
        return None
    return ".".join(parts[:-1])


def recover_initializer_names(
    initializers: typing.Mapping[str, np.ndarray],
    nodes: typing.Sequence[typing.Any],
    model_config,
    strict: bool = False,
) -> typing.Dict[str, np.ndarray]:
    """Map a real export's initializers onto expected parameter names.

    Returns {expected_dotted_name (or weight_g/v form): tensor},
    dropping graph constants that are not parameters.

    With ``strict=True``, raises :class:`ConversionError` when any
    parameter that is live at inference cannot be recovered — an
    unknown graph layout must fail loudly, not produce wrong audio.
    """
    expected = expected_params_from_config(model_config)
    result: typing.Dict[str, np.ndarray] = {}
    claimed: typing.Set[str] = set()  # expected names already assigned
    used: typing.Set[str] = set()  # initializer names already consumed

    def claim(exp_name: str, init_name: str, arr: np.ndarray) -> bool:
        if exp_name in claimed:
            return False
        if tuple(arr.shape) != expected[exp_name]:
            return False
        result[exp_name] = arr
        claimed.add(exp_name)
        used.add(init_name)
        return True

    # Identity nodes forward deduplicated initializers to their other
    # consumers — resolve the aliases first.  Exporters deduplicate
    # bitwise-identical tensors (all-zero flow `post` weights, all-one
    # layer-norm gammas of equal width...), keeping ONE initializer and
    # re-deriving the rest through Identity nodes whose OUTPUT names
    # still carry the original dotted parameter names.
    alias: typing.Dict[str, str] = {}
    for node in nodes:
        if (
            node.op_type == "Identity"
            and node.inputs
            and node.outputs
        ):
            src = alias.get(node.inputs[0], node.inputs[0])
            if src in initializers:
                alias[node.outputs[0]] = src

    # pass 1: direct / prefixed dotted names (incl. unfolded weight
    # norm), over real initializers AND Identity-alias output names
    named_entries = list(initializers.items()) + [
        (out_name, initializers[src])
        for out_name, src in alias.items()
        if out_name not in initializers
    ]
    for name, arr in named_entries:
        norm = normalize_param_name(name)
        if norm is None or "." not in norm:
            continue
        if norm.endswith((".weight_g", ".weight_v")):
            base, suffix = norm.rsplit(".", 1)
            exp = _suffix_match(base + ".weight", expected)
            if exp is not None:
                result[exp[: -len(".weight")] + "." + suffix] = (
                    np.asarray(arr)
                )
                used.add(name)
                if suffix == "weight_v":  # the shape-bearing half
                    claimed.add(exp)
            continue
        exp = _suffix_match(norm, expected)
        if exp is not None:
            claim(exp, name, np.asarray(arr))

    # consumers: initializer -> [(node_idx, input_pos, node)]
    consumers: typing.Dict[
        str, typing.List[typing.Tuple[int, int, typing.Any]]
    ] = {}
    for idx, node in enumerate(nodes):
        if node.op_type == "Identity":
            continue
        for pos, inp in enumerate(node.inputs):
            inp = alias.get(inp, inp)
            if inp in initializers:
                consumers.setdefault(inp, []).append((idx, pos, node))

    # producers: tensor name -> node that outputs it (for structural
    # pattern checks on decomposed ops)
    producer: typing.Dict[str, typing.Any] = {}
    for node in nodes:
        for out in node.outputs:
            producer[out] = node

    def _is_norm_site(node, pos) -> bool:
        """True when (node, init-position) is a decomposed layer-norm
        gamma (Mul whose partner descends from Div) or beta (Add whose
        partner is such a Mul) site."""
        others = [
            inp for p, inp in enumerate(node.inputs) if p != pos
        ]
        if len(others) != 1:
            return False
        src = producer.get(others[0])
        if node.op_type == "Mul":
            return src is not None and src.op_type == "Div"
        if node.op_type == "Add":
            if src is None or src.op_type != "Mul":
                return False
            return any(
                producer.get(i) is not None
                and producer[i].op_type == "Div"
                for i in src.inputs
            )
        return False

    # pass 2: recover from scoped consumer-node names (torch >= 1.13).
    # One initializer may be consumed by several nodes — exporters
    # deduplicate bitwise-identical tensors — so claim per CONSUMER.
    for name, arr in initializers.items():
        for _idx, pos, node in consumers.get(name, ()):
            leaf = _PARAM_POSITIONS.get(node.op_type, {}).get(pos)
            if leaf is None:
                # opset < 17: LayerNorm decomposed into Mul/Add sites
                if node.op_type in _NORM_DECOMPOSED_LEAVES and (
                    _is_norm_site(node, pos)
                ):
                    leaf = _NORM_DECOMPOSED_LEAVES[node.op_type]
                else:
                    continue
            scope = _scope_to_path(node.name or "")
            if not scope:
                continue
            exp = _suffix_match(f"{scope}.{leaf}", expected)
            if exp is not None:
                claim(exp, name, np.asarray(arr))

    # pass 3: ElementwiseAffine (folded as z' = (z - m) * exp(-logs))
    ea_bases = sorted(
        {
            n.rsplit(".", 1)[0]
            for n in expected
            if n.endswith((".m", ".logs")) and n not in claimed
        }
    )
    def _scope_covers(scope: typing.Optional[str], base: str) -> bool:
        """True when the node has no usable scope (legacy export), or
        the scope path and the expected module path agree on their
        common tail (method-call tracing truncates owner scopes)."""
        if not scope:
            return True
        s, b = scope.split("."), base.split(".")
        n = min(len(s), len(b))
        return s[-n:] == b[-n:]

    for base in ea_bases:
        m_name, logs_name = f"{base}.m", f"{base}.logs"
        shape = expected[m_name]
        sub_c, exp_c, mul_c, neg_c = None, None, None, None
        for name, arr in initializers.items():
            if tuple(np.shape(arr)) != shape:
                continue
            for _idx, pos, node in consumers.get(name, ()):
                scope = _scope_to_path(node.name or "")
                if not _scope_covers(scope, base):
                    continue
                if node.op_type == "Sub" and pos == 1:
                    sub_c = name
                elif node.op_type == "Exp":
                    # torch folded Neg(logs): the initializer IS -logs
                    exp_c = name
                elif node.op_type == "Neg":
                    # unfolded export: initializer -> Neg -> Exp, the
                    # initializer IS logs (positive sign)
                    nxt = [
                        n
                        for n in nodes
                        if node.outputs
                        and node.outputs[0] in n.inputs
                    ]
                    if any(n.op_type == "Exp" for n in nxt):
                        neg_c = name
                elif node.op_type == "Mul":
                    mul_c = name
        if sub_c is not None:
            claim(m_name, sub_c, np.asarray(initializers[sub_c]))
        if logs_name not in claimed and neg_c is not None:
            claim(
                logs_name,
                neg_c,
                np.asarray(initializers[neg_c], np.float32),
            )
        if logs_name not in claimed and exp_c is not None:
            claim(
                logs_name,
                exp_c,
                -np.asarray(initializers[exp_c], np.float32),
            )
        if logs_name not in claimed and mul_c is not None:
            # fully folded exp(-logs) constant
            scale = np.asarray(initializers[mul_c], np.float32)
            with np.errstate(divide="ignore"):
                logs = -np.log(np.maximum(scale, 1e-20))
            claim(logs_name, mul_c, logs)

    # pass 4: shape + execution-order fallback (legacy exports without
    # scoped node names)
    remaining_order = [
        f"{path}.weight"
        for path in expected_execution_order(model_config)
        if f"{path}.weight" in expected
        and f"{path}.weight" not in claimed
    ]
    conv_nodes = [
        (idx, node)
        for idx, node in enumerate(nodes)
        if node.op_type in ("Conv", "ConvTranspose", "Gemm", "Gather")
    ]
    for _idx, node in conv_nodes:
        pos_map = _PARAM_POSITIONS[node.op_type]
        w_pos = 1 if node.op_type != "Gather" else 0
        if len(node.inputs) <= w_pos:
            continue
        w_name = alias.get(node.inputs[w_pos], node.inputs[w_pos])
        if w_name not in initializers or w_name in used:
            continue
        arr = np.asarray(initializers[w_name])
        for exp in remaining_order:
            if exp in claimed:
                continue
            if tuple(arr.shape) == expected[exp]:
                if claim(exp, w_name, arr):
                    # the conv's bias input belongs to the same module
                    b_exp = exp[: -len(".weight")] + ".bias"
                    b_pos = next(
                        (p for p, l in pos_map.items() if l == "bias"),
                        None,
                    )
                    if (
                        b_exp in expected
                        and b_exp not in claimed
                        and b_pos is not None
                        and len(node.inputs) > b_pos
                    ):
                        b_name = alias.get(
                            node.inputs[b_pos], node.inputs[b_pos]
                        )
                        if b_name in initializers and b_name not in used:
                            claim(
                                b_exp,
                                b_name,
                                np.asarray(initializers[b_name]),
                            )
                break

    # pass 4b: decomposed layer norms in legacy exports without scoped
    # node names — gamma/beta sites are identified STRUCTURALLY (Mul
    # partnered with Div / the following Add) and matched against the
    # unclaimed norm modules in execution order, shape-gated.
    norm_sites: typing.List[
        typing.Tuple[str, str, typing.Optional[str], typing.Optional[str]]
    ] = []
    for idx, node in enumerate(nodes):
        if node.op_type != "Mul":
            continue
        g_pos = None
        for pos, inp in enumerate(node.inputs):
            if alias.get(inp, inp) in initializers and _is_norm_site(
                node, pos
            ):
                g_pos = pos
                break
        if g_pos is None:
            continue
        g_name = alias.get(node.inputs[g_pos], node.inputs[g_pos])
        b_name = None
        if node.outputs:
            for nxt in nodes[idx:]:
                if (
                    nxt.op_type == "Add"
                    and node.outputs[0] in nxt.inputs
                ):
                    for inp in nxt.inputs:
                        cand = alias.get(inp, inp)
                        if cand in initializers:
                            b_name = cand
                    break
        norm_sites.append((g_name, b_name))
    if norm_sites:
        norm_order = [
            path
            for path in expected_execution_order(model_config)
            if f"{path}.gamma" in expected
            and f"{path}.gamma" not in claimed
        ]
        for g_name, b_name in norm_sites:
            g_arr = np.asarray(initializers[g_name])
            for path in norm_order:
                g_exp = f"{path}.gamma"
                if g_exp in claimed:
                    continue
                if tuple(g_arr.shape) == expected[g_exp]:
                    if claim(g_exp, g_name, g_arr):
                        b_exp = f"{path}.beta"
                        if (
                            b_name is not None
                            and b_exp in expected
                            and b_exp not in claimed
                        ):
                            claim(
                                b_exp,
                                b_name,
                                np.asarray(initializers[b_name]),
                            )
                    break

    # pass 5: deduplicated initializers without scoped names — a tensor
    # consumed at k param positions stands for k (bitwise-identical)
    # parameters; spread it over the unclaimed expected names of the
    # same leaf + shape in execution order
    exec_pos = {
        p: i
        for i, p in enumerate(expected_execution_order(model_config))
    }

    def _exec_rank(exp_name: str) -> int:
        # entries like "...emb_rel_k" appear verbatim in the order
        # list; everything else by its owning module path
        if exp_name in exec_pos:
            return exec_pos[exp_name]
        return exec_pos.get(exp_name.rsplit(".", 1)[0], 1 << 30)

    def _use_leaf(node, pos) -> typing.Optional[str]:
        leaf = _PARAM_POSITIONS.get(node.op_type, {}).get(pos)
        if leaf is None and node.op_type in _NORM_DECOMPOSED_LEAVES:
            if _is_norm_site(node, pos):
                leaf = _NORM_DECOMPOSED_LEAVES[node.op_type]
        return leaf

    for name, arr in initializers.items():
        param_uses = [
            (idx, pos, node)
            for idx, pos, node in consumers.get(name, ())
            if _use_leaf(node, pos)
        ]
        if len(param_uses) < 2:
            continue
        arr = np.asarray(arr)
        for _idx, pos, node in param_uses:
            leaf = _use_leaf(node, pos)
            cands = sorted(
                (
                    e
                    for e in expected
                    if e not in claimed
                    and e.rsplit(".", 1)[-1] == leaf
                    and expected[e] == tuple(arr.shape)
                ),
                key=_exec_rank,
            )
            if cands:
                claim(cands[0], name, arr)

    # pass 6: anything still unclaimed whose tensor is consumed outside
    # the op table (e.g. relative-position embeddings feeding
    # MatMul/Slice chains).  Group leftover initializers and leftover
    # expected names by shape; within a group, order initializers by
    # their first consumer's node index (= trace/execution order) and
    # expected names by execution rank, and pair them 1:1.  Only exact
    # count matches are paired (count mismatches fall through to the
    # strict error); multi-element groups are order-inferred and
    # WARN-logged so an untested exporter's reordering is reviewable.
    leftover_exp: typing.Dict[
        typing.Tuple[int, ...], typing.List[str]
    ] = {}
    for exp_name, shape in expected.items():
        if exp_name not in claimed:
            leftover_exp.setdefault(shape, []).append(exp_name)
    leftover_init: typing.Dict[
        typing.Tuple[int, ...],
        typing.List[typing.Tuple[int, str]],
    ] = {}
    for name, arr in initializers.items():
        if name in used or not consumers.get(name):
            continue
        if np.asarray(arr).dtype.kind != "f":
            continue  # shape/index constants are never parameters
        first_use = min(idx for idx, _pos, _n in consumers[name])
        leftover_init.setdefault(tuple(np.shape(arr)), []).append(
            (first_use, name)
        )
    for shape, exp_names in leftover_exp.items():
        inits_here = sorted(leftover_init.get(shape, []))
        live = [
            e for e in exp_names if not _is_dead_at_inference(e)
        ]
        if not live or len(inits_here) != len(live):
            continue
        live.sort(key=_exec_rank)
        if len(live) > 1:
            # count-matched but ORDER-inferred: pairing relies on the
            # exporter tracing same-shape tensors in module execution
            # order (holds for every torch exporter in the opset 11-17
            # test matrix, incl. the rel-pos embedding pair).  Loud so
            # an unknown exporter's swap is reviewable, not silent.
            _LOGGER.warning(
                "Order-inferred pairing of %d same-shape params %s "
                "<- first-consumer order of %s; verify audio parity "
                "if this export came from an untested toolchain",
                len(live), live, [n for _fu, n in inits_here],
            )
        for (_fu, init_name), exp_name in zip(inits_here, live):
            claim(
                exp_name,
                init_name,
                np.asarray(initializers[init_name]),
            )

    missing = sorted(set(expected) - claimed)
    if missing:
        # only a KNOWN set of parameters is legitimately absent from a
        # traced inference graph (the SDP posterior branch and the one
        # flow the inference path drops).  Anything else unclaimed is a
        # recovery FAILURE — the caller would silently substitute
        # random init for a live weight — so it warns loudly.
        dead = [n for n in missing if _is_dead_at_inference(n)]
        unrecovered = [
            n for n in missing if not _is_dead_at_inference(n)
        ]
        if dead:
            _LOGGER.info(
                "%d expected parameters absent from the ONNX graph "
                "(dead at inference; filled from init): %s",
                len(dead),
                ", ".join(dead[:8]) + ("..." if len(dead) > 8 else ""),
            )
        if unrecovered:
            detail = ", ".join(unrecovered[:16]) + (
                "..." if len(unrecovered) > 16 else ""
            )
            if strict:
                raise ConversionError(
                    f"{len(unrecovered)} live parameters could not be "
                    f"recovered from the ONNX graph (unknown export "
                    f"layout or wrong config.json?): {detail}"
                )
            _LOGGER.warning(
                "%d LIVE parameters could not be recovered from the "
                "ONNX graph and will be filled with random init — "
                "converted audio will be wrong: %s",
                len(unrecovered),
                detail,
            )
    return result


# parameters a traced VITS inference graph legitimately omits: the
# stochastic duration predictor's posterior branch (training only) and
# the flow the inference path drops (reference semantics mirrored in
# models/vits/duration.py), plus its standalone logs leaf
_DEAD_AT_INFERENCE_PREFIXES = ("dp.post_", "dp.flows.1.", "enc_q.")


def _is_dead_at_inference(name: str) -> bool:
    return (
        name.startswith(_DEAD_AT_INFERENCE_PREFIXES)
        or name == "dp.flows.0.logs"
    )


def complete_params(tree: Pytree, model_config) -> Pytree:
    """Fill parameters missing from an inference-only export with
    initialization values (they are dead at synthesis — e.g. the first
    ConvFlow of the duration predictor and the posterior/training-only
    modules never appear in a traced inference graph)."""
    init_flat = _init_flat_cached(model_config)
    flat = flatten_pytree(tree)
    for name, arr in init_flat.items():
        folded = name
        if name.endswith((".weight_g", ".weight_v")):
            folded = name.rsplit(".", 1)[0] + ".weight"
        if name not in flat and folded not in flat:
            flat[name] = np.asarray(arr)
    return unflatten_pytree(flat)


# ---------------------------------------------------------------------------
# ONNX entry point
# ---------------------------------------------------------------------------


def onnx_to_pytree(
    onnx_path: typing.Union[str, Path],
    model_config=None,
    strict: bool = True,
) -> Pytree:
    """Read ``generator.onnx`` initializers into a parameter pytree.

    Works without the ``onnx`` package — the protobuf wire format is
    parsed directly (see :mod:`mimic3_tpu_torch.runtime.onnx_reader`).

    With ``model_config`` (a :class:`~mimic3_tpu_torch.config.ModelConfig`),
    anonymized initializer names from real ``torch.onnx.export``
    artifacts are recovered (see :func:`recover_initializer_names`) and
    inference-dead parameters are filled from initialization.  By
    default an unrecoverable live parameter raises
    :class:`ConversionError` (``strict=False`` downgrades to a warning
    and fills from random init).
    """
    from .onnx_reader import read_onnx_graph

    initializers, nodes = read_onnx_graph(onnx_path)
    if model_config is not None:
        named = recover_initializer_names(
            initializers, nodes, model_config, strict=strict
        )
        tree = state_dict_to_pytree(named)
        return complete_params(tree, model_config)
    return state_dict_to_pytree(initializers)


def convert_voice_directory(
    voice_dir: typing.Union[str, Path],
    force: bool = False,
    strict: bool = True,
) -> Path:
    """Convert ``<voice_dir>/generator.onnx`` to ``generator.npz``.

    The npz (plus ``config.json``/``phonemes.txt`` already in the
    directory) is everything either package's runtime needs.  Returns
    the npz path.
    """
    voice_dir = Path(voice_dir)
    npz_path = voice_dir / "generator.npz"
    onnx_path = voice_dir / "generator.onnx"
    if npz_path.is_file() and not force:
        return npz_path
    if not onnx_path.is_file():
        raise FileNotFoundError(f"No generator.onnx in {voice_dir}")

    # the voice's config.json (when present) enables name recovery for
    # anonymized torch.onnx.export initializers
    model_config = None
    config_path = voice_dir / "config.json"
    if config_path.is_file():
        from ..config import TrainingConfig

        try:
            model_config = TrainingConfig.load_path(config_path).model
        except Exception as err:
            _LOGGER.warning(
                "Could not parse %s (%s); converting by names only",
                config_path,
                err,
            )
    tree = onnx_to_pytree(
        onnx_path, model_config=model_config, strict=strict
    )
    save_pytree_npz(npz_path, tree)
    return npz_path


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    """``mimic3-torch-convert <voice_dir> [...]`` CLI."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="mimic3-torch-convert",
        description="Convert a Mimic 3 voice's generator.onnx into the "
        "native generator.npz weight file",
    )
    parser.add_argument("voice_dir", nargs="+")
    parser.add_argument(
        "--force", action="store_true", help="Overwrite existing npz"
    )
    parser.add_argument(
        "--allow-missing",
        action="store_true",
        help="Fill unrecoverable live parameters from random init "
        "instead of failing (audio WILL be wrong; debugging only)",
    )
    args = parser.parse_args(argv)
    for voice_dir in args.voice_dir:
        npz = convert_voice_directory(
            voice_dir, force=args.force, strict=not args.allow_missing
        )
        flat = flatten_pytree(load_pytree_npz(npz))
        n_params = int(sum(int(np.prod(v.shape)) for v in flat.values()))
        print(
            json.dumps(
                {
                    "voice_dir": str(voice_dir),
                    "npz": str(npz),
                    "tensors": len(flat),
                    "parameters": n_params,
                }
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
