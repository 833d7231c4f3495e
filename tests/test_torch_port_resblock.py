"""Fused resblock step: the port's plain version against the JAX kernel.

``mimic3_tpu_torch.ops.resblock.fused_resblock_subblock`` on CPU tensors
runs its plain version; it is held against the Pallas kernel
``mimic3_tpu.ops.resblock.fused_resblock_subblock`` in interpret mode, the
way tests/test_pallas_ops.py runs it, on the same numpy inputs
(``[B, T, C]`` / ``[K, Cin, Cout]`` there, ``[B, C, T]`` / ``[Cout, Cin,
K]`` here).  Bars: float32 ``atol=2e-5`` (that test's); bfloat16
correlation > 0.999.  The CUDA kernel itself is compared with the plain
version on the card by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mimic3_tpu.models.vits.hifigan import resblock1 as jax_resblock1
from mimic3_tpu.ops.resblock import fused_resblock_subblock as jax_subblock
from mimic3_tpu_torch.ops import mma
from mimic3_tpu_torch.ops import resblock as tres

REPO = Path(__file__).resolve().parents[1]


def _inputs(seed, b, t, c, k, bias=True):
    """numpy x [B, T, C], weights [K, Cin, Cout], biases [C] (or None)."""
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(c * k)
    x = rng.randn(b, t, c).astype(np.float32)
    w1, w2 = (rng.uniform(-bound, bound, (k, c, c)).astype(np.float32)
              for _ in range(2))
    b1, b2 = (
        (rng.uniform(-bound, bound, (c,)).astype(np.float32) for _ in range(2))
        if bias else (None, None)
    )
    return x, w1, b1, w2, b2


def _port(x, w1, b1, w2, b2, dtype=torch.float32, **kw):
    """The port's wrapper on CPU tensors, back in the JAX layout."""
    def weight(w):
        return torch.from_numpy(w.transpose(2, 1, 0).copy())

    def bias(v):
        return None if v is None else torch.from_numpy(v)

    xt = torch.from_numpy(x).transpose(1, 2).contiguous().to(dtype)
    out = tres.fused_resblock_subblock(
        xt, weight(w1), bias(b1), weight(w2), bias(b2), **kw
    )
    assert out.dtype == dtype and out.shape == xt.shape
    return out.float().transpose(1, 2).numpy()


def _jax(x, w1, b1, w2, b2, dtype=jnp.float32, **kw):
    def arr(v):
        return None if v is None else jnp.asarray(v)

    return np.asarray(
        jax_subblock(jnp.asarray(x, dtype), arr(w1), arr(b1), arr(w2),
                     arr(b2), interpret=True, **kw).astype(jnp.float32)
    )


@pytest.mark.parametrize(
    "c,t,b,k,d,tile",
    [
        (8, 64, 1, 3, 1, 64),
        (16, 256, 2, 3, 5, 128),
        (32, 256, 1, 11, 5, 128),
        (16, 128, 2, 7, 3, 64),
    ],
)
def test_matches_jax_kernel(c, t, b, k, d, tile):
    """The four cases of tests/test_pallas_ops.py, float32."""
    args = _inputs(c + t + k, b, t, c, k)
    want = _jax(*args, kernel_size=k, dilation=d, tile=tile)
    got = _port(*args, kernel_size=k, dilation=d)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_bias_none_matches_jax_kernel():
    """Bias-free convs: the JAX kernel takes None as zeros."""
    args = _inputs(5, 2, 128, 16, 7, bias=False)
    want = _jax(*args, kernel_size=7, dilation=3, tile=64)
    got = _port(*args, kernel_size=7, dilation=3)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_bf16_matches_jax_kernel():
    """bfloat16 in and out, weights rounded to bf16 on both sides."""
    args = _inputs(6, 2, 256, 32, 3)
    want = _jax(*args, dtype=jnp.bfloat16, kernel_size=3, dilation=5,
                tile=128)
    got = _port(*args, dtype=torch.bfloat16, kernel_size=3, dilation=5)
    assert np.isfinite(got).all()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_ragged_length_matches_jax_resblock():
    """T=100: the TPU kernel refuses it (T must divide into aligned tiles,
    a tiling limit of the TPU: tests/test_pallas_ops.py), the port takes
    any T >= 1.  Held against the JAX package's plain ``resblock1``."""
    x, w1, b1, w2, b2 = _inputs(7, 2, 100, 8, 3)
    with pytest.raises(ValueError):
        _jax(x, w1, b1, w2, b2, kernel_size=3, dilation=1, tile=64)
    params = {"convs1": {"0": {"weight": jnp.asarray(w1),
                               "bias": jnp.asarray(b1)}},
              "convs2": {"0": {"weight": jnp.asarray(w2),
                               "bias": jnp.asarray(b2)}}}
    want = np.asarray(jax_resblock1(params, jnp.asarray(x), 3, [1]))
    got = _port(x, w1, b1, w2, b2, kernel_size=3, dilation=1)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_pack_subblock_weights_layout():
    """FFMA layout (C = 8, under the MMA depth, either dtype): [Cout, Cin,
    K] -> [Cin, K, Cout], rounded to the activation dtype and held as
    float32; a missing bias packs as zeros.  From 16 channels both dtypes
    pack MMA fragments instead: bf16, or TF32 hi/lo for float32, with the
    biases rounded to the dtype (test_torch_port_mma.py,
    test_torch_port_tf32.py)."""
    w = torch.randn(8, 8, 3)
    for dtype in (torch.bfloat16, torch.float32):
        packed = tres.pack_subblock_weights(w, None, w * 2, None, dtype)
        assert packed.w1.dtype == torch.float32 and not packed.mma
        assert packed.w1.shape == (8, 3, 8)
        torch.testing.assert_close(
            packed.w1, w.to(dtype).float().permute(1, 2, 0)
        )
        assert not packed.b1.any() and packed.b2.shape == (8,)
        assert (packed.channels, packed.kernel_size) == (8, 3)
    w = torch.randn(16, 16, 3)
    b = torch.randn(16)
    packed = tres.pack_subblock_weights(w, b, w * 2, None, torch.float32)
    assert packed.mma and packed.w1.shape == (3, 2, 2, 32, 4)
    torch.testing.assert_close(packed.w1, mma.pack_conv_fragments_tf32(w))
    torch.testing.assert_close(packed.b1, b)  # f32 bias, not rounded
    bf = tres.pack_subblock_weights(w, b, w * 2, None, torch.bfloat16)
    assert bf.mma and bf.w1.shape == (3, 1, 1, 32, 4)
    torch.testing.assert_close(bf.b1, b.to(torch.bfloat16).float())
    with pytest.raises(ValueError):
        tres.pack_subblock_weights(w, None, torch.randn(16, 16, 5), None,
                                   torch.float32)


def test_pick_tile_fits_shared_memory():
    """FFMA (C = 8): two blocks per SM where a tile of 64 allows it, else
    one, short sequences short tiles.  From 16 channels f32 takes the
    tensor-core plan, whose f32 buffers (twice the bf16 bytes) still fit
    one block at the widest full-width case (C=256, K=11, d=5) and give
    two blocks an SM at the profiling shape."""
    def smem(c, k, d, tile):
        h1, h2 = d * (k - 1) // 2, (k - 1) // 2
        return 4 * c * ((tile + 2 * h2 + 2 * h1) + (tile + 2 * h2))

    assert tres.pick_tile(8, 3, 5, 65536) == 256
    assert smem(8, 3, 5, 256) <= tres._HALF_SMEM_BYTES
    tile = tres.pick_tile(8, 11, 5, 2048)
    assert tile == 256 and smem(8, 11, 5, tile) <= tres._MAX_SMEM_BYTES
    assert tres.pick_tile(8, 3, 1, 5) == 8  # short sequences, short tiles
    for c, k, d, t, b, two_per_sm in ((256, 11, 5, 2048, 1, False),
                                      (128, 3, 5, 65536, 16, True)):
        rows, groups = tres.pick_mma_config(c, k, d, t, b, torch.float32)
        used = tres.mma_smem_bytes(c, k, d, rows, groups, torch.float32)
        assert used <= tres._MAX_SMEM_BYTES
        assert (used <= tres._HALF_SMEM_BYTES) == two_per_sm
        # f32 rows and h take twice the bf16 bytes
        assert used > tres.mma_smem_bytes(c, k, d, rows, groups)


def test_wrapper_raises_off_cpu_without_fallback():
    """A non-CPU tensor launches the kernel or raises — never the plain
    version; unsupported shapes raise before any build."""
    w = torch.randn(8, 8, 3)
    before = tres.launches
    with pytest.raises(ValueError):
        tres.fused_resblock_subblock(
            torch.empty(1, 8, 64, device="meta"), w, None, w, None,
            kernel_size=3, dilation=1,
        )
    assert tres.launches == before


def test_import_builds_nothing_and_build_needs_nvcc(tmp_path):
    """Importing the module runs no compiler; building without nvcc
    raises."""
    code = (
        "import subprocess\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('compiler run at import')\n"
        "subprocess.run = subprocess.Popen = boom\n"
        "import mimic3_tpu_torch.ops.resblock as r\n"
        "import mimic3_tpu_torch.scripts.profile_resblock\n"
        "assert r._LIB is None and r.launches == 0\n"
        "subprocess.run = subprocess.Popen = None\n"
        "r.BUILD_DIR = r.build.Path(%r)\n"
        "try:\n"
        "    r.build_library()\n"
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


def test_profile_entry_point_needs_a_card():
    """The profiling entry point measures on a card or raises: no CPU
    timing is ever reported under its name."""
    from mimic3_tpu_torch.scripts import profile_resblock

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_resblock.main(["--loops", "1"])
