"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: every test skips without an NVIDIA card, since the kernels
have no CPU mode.  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py

Bars: float32 ``atol=2e-4, rtol=1e-3`` with TF32 off on the plain side
(the kernels' float32 path runs three TF32 passes on tensor cores and
must hold this bar); bfloat16 correlation > 0.999 (the plain side rounds
every conv output to bf16, the kernel keeps f32 inside).
"""

import numpy as np
import pytest
import torch

from mimic3_tpu_torch.ops import stage as tstage
from mimic3_tpu_torch.runtime.convert import to_torch_params

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stage(rng, c, c_in, post, device):
    """Port-layout stage kwargs (resblocks, optional ups / post)."""
    tree = {
        "resblocks": {
            str(r): {
                key: {
                    str(j): {
                        "weight": rng.randn(k, c, c).astype(np.float32) * 0.1,
                        "bias": rng.randn(c).astype(np.float32) * 0.1,
                    }
                    for j in range(3)
                }
                for key in ("convs1", "convs2")
            }
            for r, k in enumerate(KERNELS)
        }
    }
    if c_in:
        tree["ups"] = {"0": {
            "weight": rng.randn(4, c_in, c).astype(np.float32) * 0.1,
            "bias": rng.randn(c).astype(np.float32) * 0.1,
        }}
    if post:
        tree["conv_post"] = {
            "weight": rng.randn(7, c, 1).astype(np.float32) * 0.1
        }
    port = to_torch_params(tree, device)
    kw = {"resblock_params": [port["resblocks"][str(r)] for r in range(3)]}
    if c_in:
        kw.update(ups_params=port["ups"]["0"], ups_stride=2, ups_padding=1)
    if post:
        kw["post_params"] = port["conv_post"]
    return kw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "c,c_in,post,batch,t",
    [
        (32, 64, True, 2, 1000),  # last decoder stage, ragged tail
        (32, 64, False, 1, 300),  # ups only
        (32, None, True, 2, 513),  # post only
        (64, None, False, 2, 777),  # C=64 stage alone, multi-tile
        (16, 32, False, 3, 129),
        (8, 16, True, 1, 5),  # shorter than the halo
    ],
)
def test_kernel_matches_plain(cuda, dtype, c, c_in, post, batch, t):
    rng = np.random.RandomState(c + t)
    kw = _stage(rng, c, c_in, post, cuda)
    rb = kw.pop("resblock_params")
    x = torch.from_numpy(
        rng.randn(batch, c_in or c, t).astype(np.float32)
    ).to(cuda, getattr(torch, dtype))
    ref = tstage.hifigan_stage_plain(rb, x, KERNELS, DILATIONS, **kw)
    before = tstage.launches
    got = tstage.hifigan_stage_fused(rb, x, KERNELS, DILATIONS, **kw)
    torch.cuda.synchronize()
    assert tstage.launches == before + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    else:
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


@pytest.mark.gpu
def test_kernel_rejects_unsupported_input(cuda):
    rng = np.random.RandomState(0)
    kw = _stage(rng, 32, None, False, cuda)
    rb = kw.pop("resblock_params")
    x = torch.zeros(1, 32, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        tstage.hifigan_stage_fused(rb, x, KERNELS, DILATIONS)
    x = torch.zeros(1, 64, 32, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        tstage.hifigan_stage_fused(rb, x, KERNELS, DILATIONS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "c,t,b,k,d,bias",
    [
        (8, 64, 1, 3, 1, True),  # the cases of tests/test_pallas_ops.py
        (16, 256, 2, 3, 5, True),
        (32, 256, 1, 11, 5, True),
        (16, 128, 2, 7, 3, True),
        (32, 1000, 2, 7, 3, True),  # ragged T across tiles
        (64, 300, 1, 3, 3, False),  # no bias
        (256, 777, 1, 11, 5, True),  # widest C, largest halo
        (128, 5, 2, 3, 5, True),  # shorter than the halo
    ],
)
def test_resblock_kernel_matches_plain(cuda, dtype, c, t, b, k, d, bias):
    from mimic3_tpu_torch.ops import resblock as tres

    rng = np.random.RandomState(c + t + k)
    bound = 1.0 / np.sqrt(c * k)

    def uniform(*shape):
        return torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32)
        ).to(cuda)

    w1, w2 = uniform(c, c, k), uniform(c, c, k)
    b1, b2 = (uniform(c), uniform(c)) if bias else (None, None)
    x = torch.from_numpy(rng.randn(b, c, t).astype(np.float32)).to(
        cuda, getattr(torch, dtype)
    )
    kw = dict(kernel_size=k, dilation=d)
    ref = tres.resblock_subblock_plain(x, w1, b1, w2, b2, **kw)
    before = tres.launches
    got = tres.fused_resblock_subblock(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert tres.launches == before + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    else:
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


@pytest.mark.gpu
def test_resblock_kernel_rejects_unsupported_input(cuda):
    from mimic3_tpu_torch.ops import resblock as tres

    w = torch.zeros(12, 12, 3, device=cuda)
    x = torch.zeros(1, 12, 64, device=cuda)  # C not a multiple of 8
    with pytest.raises(ValueError):
        tres.fused_resblock_subblock(x, w, None, w, None, kernel_size=3,
                                     dilation=1)
    w = torch.zeros(8, 8, 3, device=cuda)
    x = torch.zeros(1, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        tres.fused_resblock_subblock(x, w, None, w, None, kernel_size=3,
                                     dilation=1)


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "c,c_in,post,batch,t_in",
    [
        (32, 64, True, 1, 128 * 128),  # last stage, 128-frame bucket
        (32, 64, True, 4, 256 * 128),  # last stage, 256-frame bucket
        (64, 128, False, 4, 256 * 64),  # C=64 stage with ups 128->64
        (64, None, False, 1, 256 * 128),  # C=64 stage alone
    ],
)
def test_stage_tensor_cores_at_table_shapes(cuda, dtype, c, c_in, post,
                                            batch, t_in):
    """The tensor-core paths at the decoder's shapes: bf16 correlation
    > 0.999 with the plain bf16 path, f32 (three TF32 passes) within
    ``atol=2e-4, rtol=1e-3`` of the plain f32 path."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(c + batch)
    kw = _stage(rng, c, c_in, post, cuda)
    rb = kw.pop("resblock_params")
    weights = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, device=cuda,
                                        dtype=dt, **kw)
    assert weights.fragments is not None and tstage.uses_mma(c, dt)
    x = torch.from_numpy(
        rng.randn(batch, c_in or c, t_in).astype(np.float32)
    ).to(cuda, dt)
    ref = tstage.hifigan_stage_plain(rb, x, KERNELS, DILATIONS, **kw)
    got = tstage.hifigan_stage_fused(rb, x, KERNELS, DILATIONS,
                                     weights=weights, **kw)
    torch.cuda.synchronize()
    ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    else:
        assert _corr(got, ref) > 0.999
    # a pack for the other dtype carries the other fragments: refused
    other = torch.bfloat16 if dt == torch.float32 else torch.float32
    wrong = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, device=cuda,
                                      dtype=other, **kw)
    with pytest.raises(ValueError):
        tstage.hifigan_stage_fused(rb, x, KERNELS, DILATIONS, weights=wrong,
                                   **kw)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "c,c_in,post,batch,t_in",
    [
        (64, 128, False, 16, 1024 * 64),  # the synth cells' C=64 stage
        (32, 64, True, 16, 1024 * 128),  # and last stage, 16 x 1024 frames
        (32, 64, True, 1, 128 * 128),  # the kernel table's shape
        (32, 64, True, 3, 12345),  # ragged: 24690 samples, no 64-row tile
        (64, None, False, 2, 1001),
    ],
)
def test_wgmma_stage_matches_plain(cuda, c, c_in, post, batch, t_in):
    """The bf16 stage on the warpgroup MMA at the synth cells' decode, the
    kernel table's shape and ragged lengths, held to the plain bf16 path
    at ``chip_smoke.py``'s bar (correlation > 0.999), one launch each."""
    rng = np.random.RandomState(c + t_in)
    kw = _stage(rng, c, c_in, post, cuda)
    rb = kw.pop("resblock_params")
    weights = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, device=cuda,
                                        dtype=torch.bfloat16, **kw)
    x = torch.from_numpy(
        rng.randn(batch, c_in or c, t_in).astype(np.float32)
    ).to(cuda, torch.bfloat16)
    ref = tstage.hifigan_stage_plain(rb, x, KERNELS, DILATIONS, **kw)
    rows = tstage._pick_wgmma_rows(weights, ref.shape[-1], batch)
    before = tstage.launches
    got = tstage.hifigan_stage_fused(rb, x, KERNELS, DILATIONS,
                                     weights=weights, **kw)
    torch.cuda.synchronize()
    assert tstage.launches == before + 1
    ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _corr(got, ref) > 0.999, rows


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "c,t,b,k,d",
    [
        (32, 65536, 1, 11, 5),  # the decoder's stage lengths, 256 frames
        (64, 32768, 1, 11, 5),
        (128, 16384, 1, 11, 5),
        (256, 2048, 1, 11, 5),
        (128, 65536, 16, 3, 5),  # the profiling shape
        (24, 999, 2, 7, 3),  # C padded to the MMA depth, two groups
    ],
)
def test_resblock_tensor_cores_at_table_shapes(cuda, dtype, c, t, b, k, d):
    """The tensor-core paths: bf16 correlation > 0.999 on the output and
    > 0.9999 on the branch out - x against the plain bf16 path; f32 (three
    TF32 passes) within ``atol=2e-4, rtol=1e-3`` of the plain f32 path."""
    from mimic3_tpu_torch.ops import resblock as tres

    rng = np.random.RandomState(c + k)
    bound = 1.0 / np.sqrt(c * k)

    def uniform(*shape):
        return torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32)
        ).to(cuda)

    w1, w2, b1, b2 = uniform(c, c, k), uniform(c, c, k), uniform(c), uniform(c)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.randn(b, c, t).astype(np.float32)).to(cuda, dt)
    packed = tres.pack_subblock_weights(w1, b1, w2, b2, dt, cuda)
    assert packed.mma
    kw = dict(kernel_size=k, dilation=d)
    ref = tres.resblock_subblock_plain(x, w1, b1, w2, b2, **kw)
    got = tres.fused_resblock_subblock(x, w1, b1, w2, b2, weights=packed,
                                       **kw)
    torch.cuda.synchronize()
    xf = x.float().cpu().numpy()
    ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
        return
    assert _corr(got, ref) > 0.999
    assert _corr(got - xf, ref - xf) > 0.9999
