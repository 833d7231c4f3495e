"""Fused HiFi-GAN stage: the port's plain version against the JAX kernel.

``hifigan_stage_plain`` is held against the Pallas kernel
``mimic3_tpu.ops.stage.hifigan_stage_fused`` run in interpret mode, the way
tests/test_stage_kernel.py runs it, at ``atol=2e-4, rtol=1e-3``.  The CUDA
kernel itself is compared with the plain version on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mimic3_tpu.ops.stage import hifigan_stage_fused as jax_stage
from mimic3_tpu_torch.ops import stage as tstage
from mimic3_tpu_torch.runtime.convert import to_torch_params

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
TOL = dict(atol=2e-4, rtol=1e-3)
REPO = Path(__file__).resolve().parents[1]


def _stage_tree(rng, c, c_in=None, post=False):
    """JAX-layout params of one stage (+ optional ups / post)."""
    tree = {"resblocks": {}}
    for r, k in enumerate(KERNELS):
        tree["resblocks"][str(r)] = {
            key: {
                str(j): {
                    "weight": rng.randn(k, c, c).astype(np.float32) * 0.1,
                    "bias": rng.randn(c).astype(np.float32) * 0.1,
                }
                for j in range(3)
            }
            for key in ("convs1", "convs2")
        }
    if c_in is not None:
        tree["ups"] = {
            "0": {
                "weight": rng.randn(4, c_in, c).astype(np.float32) * 0.1,
                "bias": rng.randn(c).astype(np.float32) * 0.1,
            }
        }
    if post:
        tree["conv_post"] = {
            "weight": rng.randn(7, c, 1).astype(np.float32) * 0.1
        }
    return tree


def _both(tree):
    """(JAX kwargs, port kwargs) of the stage's parameters."""
    port = to_torch_params(tree)
    jx = {
        "resblock_params": [
            {k: {j: {n: jnp.asarray(a) for n, a in p.items()}
                 for j, p in d.items()} for k, d in rp.items()}
            for _, rp in sorted(tree["resblocks"].items())
        ]
    }
    pt = {"resblock_params": [port["resblocks"][str(r)] for r in range(3)]}
    if "ups" in tree:
        jx["ups_params"] = {n: jnp.asarray(a) for n, a in tree["ups"]["0"].items()}
        pt["ups_params"] = port["ups"]["0"]
        jx.update(ups_stride=2, ups_padding=1)
        pt.update(ups_stride=2, ups_padding=1)
    if "conv_post" in tree:
        jx["post_params"] = {"weight": jnp.asarray(tree["conv_post"]["weight"])}
        pt["post_params"] = port["conv_post"]
    return jx, pt


@pytest.mark.parametrize(
    "case",
    ["c32", "c64", "multi_tile", "ups", "post", "ups_post"],
)
def test_stage_plain_matches_jax_kernel(case):
    rng = np.random.RandomState(len(case))
    c = 64 if case == "c64" else 32
    c_in = 64 if case.startswith("ups") else None
    t = {"multi_tile": 512, "ups": 128, "ups_post": 128}.get(case, 256)
    tree = _stage_tree(rng, c, c_in, post=case.endswith("post"))
    jx, pt = _both(tree)
    x = rng.randn(2, t, c_in or c).astype(np.float32)

    extra = {"max_tile": 64} if case == "multi_tile" else {}
    jx_rb = jx.pop("resblock_params")
    ref = np.asarray(
        jax_stage(jx_rb, jnp.asarray(x), KERNELS, DILATIONS,
                  interpret=True, **jx, **extra)
    )
    pt_rb = pt.pop("resblock_params")
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    got = tstage.hifigan_stage_plain(pt_rb, xt, KERNELS, DILATIONS, **pt)
    # the wrapper takes the plain version for a CPU tensor
    via_wrapper = tstage.hifigan_stage_fused(pt_rb, xt, KERNELS, DILATIONS, **pt)
    torch.testing.assert_close(via_wrapper, got, atol=0, rtol=0)

    got = got.numpy() if got.dim() == 2 else got.transpose(1, 2).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_pack_stage_weights_layout():
    """The kernel's weight pack: [Cin, K, Cout] per conv in launch order,
    halo = receptive half-width (+ conv_post), plan offsets consistent."""
    rng = np.random.RandomState(1)
    _, pt = _both(_stage_tree(rng, 32, 64, post=True))
    w = tstage.pack_stage_weights(
        pt["resblock_params"], KERNELS, DILATIONS,
        ups_params=pt["ups_params"], ups_stride=2, ups_padding=1,
        post_params=pt["post_params"],
    )
    assert w.halo == 5 * (1 + 3 + 5) + 5 * 3 + 3 == 63
    assert (w.channels, w.in_channels, w.n_res, w.n_steps) == (32, 64, 3, 3)
    assert (w.ups_kernel, w.ups_stride, w.ups_padding) == (4, 2, 1)
    plan = w.plan.numpy()
    assert plan.shape == (1 + 18 + 1, 4)
    assert plan[0].tolist() == [0, 0, 4, 1]
    # ups weight [Cin, Cout, K] -> [Cin, K, Cout]
    ups = w.w[: 64 * 4 * 32].reshape(64, 4, 32)
    torch.testing.assert_close(ups, pt["ups_params"]["weight"].permute(0, 2, 1))
    # convs2 of the k=7 resblock, step 1 (dilation 1)
    row = plan[1 + 2 * 3 + 2 * 1 + 1]
    assert row[2:].tolist() == [7, 1]
    conv = w.w[row[0] : row[0] + 32 * 7 * 32].reshape(32, 7, 32)
    torch.testing.assert_close(
        conv, pt["resblock_params"][1]["convs2"]["1"]["weight"].permute(1, 2, 0)
    )
    assert plan[-1][2] == 7 and float(w.b[plan[-1][1]]) == 0.0  # no post bias
    # C=32 runs on tensor cores in both dtypes, and a pack carries the
    # fragments of the dtype it is packed for: bf16 by default, TF32 hi/lo
    # for float32 (4 bytes per weight and K chunk of 16 against 16), with
    # the same f32 weights and plan, and an f32 plan that fits one block
    assert tstage.uses_mma(32, torch.float32)
    assert tstage.uses_mma(32, torch.bfloat16)
    w32 = tstage.pack_stage_weights(
        pt["resblock_params"], KERNELS, DILATIONS,
        ups_params=pt["ups_params"], ups_stride=2, ups_padding=1,
        post_params=pt["post_params"], dtype=torch.float32,
    )
    assert (w.dtype, w32.dtype) == (torch.bfloat16, torch.float32)
    assert w32.fragments.numel() == 4 * w.fragments.numel()
    torch.testing.assert_close(w32.w, w.w, atol=0, rtol=0)
    assert torch.equal(w32.plan, w.plan)
    rows = tstage._pick_mma_rows(w32, 128 * 256, 1, torch.float32)
    assert tstage.mma_smem_bytes(w32, rows, torch.float32) <= 232448
    # C=8 stays on FFMA: the tile of its four f32 buffers
    _, pt8 = _both(_stage_tree(rng, 8))
    w8 = tstage.pack_stage_weights(pt8["resblock_params"], KERNELS, DILATIONS,
                                   dtype=torch.float32)
    assert w8.fragments is None and not tstage.uses_mma(8, torch.float32)
    assert tstage._pick_tile(w8) == 256


def test_wrapper_raises_off_cpu_without_fallback():
    """A non-CPU tensor launches the kernel or raises — never the plain
    version."""
    rng = np.random.RandomState(2)
    _, pt = _both(_stage_tree(rng, 32))
    x = torch.empty(1, 32, 64, device="meta")
    before = tstage.launches
    with pytest.raises(ValueError):
        tstage.hifigan_stage_fused(pt["resblock_params"], x, KERNELS, DILATIONS)
    assert tstage.launches == before


def test_import_builds_nothing_and_build_needs_nvcc(tmp_path):
    """Importing the port runs no compiler; building without nvcc raises."""
    code = (
        "import subprocess\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('compiler run at import')\n"
        "subprocess.run = subprocess.Popen = boom\n"
        "import mimic3_tpu_torch.ops.stage as s\n"
        "import mimic3_tpu_torch.models.vits.model\n"
        "assert s._LIB is None and s.launches == 0\n"
        "subprocess.run = subprocess.Popen = None\n"
        "s.BUILD_DIR = s.Path(%r)\n"
        "try:\n"
        "    s.build_library()\n"
        "except RuntimeError as err:\n"
        "    assert 'nvcc' in str(err), err\n"
        "else:\n"
        "    raise AssertionError('built without nvcc')\n"
        "print('ok')\n" % str(tmp_path / "build")
    )
    env = dict(
        os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
        PYTHONPATH=str(REPO),
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert not (tmp_path / "build").exists()
