"""Fused HiFi-GAN stage: the port's plain version against the JAX kernel.

``hifigan_stage_plain`` is held against the Pallas kernel
``mimic3_tpu.ops.stage.hifigan_stage_fused`` run in interpret mode, the way
tests/test_stage_kernel.py runs it, at ``atol=2e-4, rtol=1e-3``.  The CUDA
kernel itself is compared with the plain version on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import os
import typing
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    # weights of the dtype it is packed for: bf16 wgmma blocks by default
    # (the upsampler's 4 taps x 2 K blocks, then the resblock convs' taps),
    # TF32 hi/lo fragments of the resblock convs for float32 (8 bytes per
    # weight against 2), with the same f32 weights and plan, and an f32
    # plan that fits one block
    assert tstage.uses_mma(32, torch.float32)
    assert tstage.uses_mma(32, torch.bfloat16)
    w32 = tstage.pack_stage_weights(
        pt["resblock_params"], KERNELS, DILATIONS,
        ups_params=pt["ups_params"], ups_stride=2, ups_padding=1,
        post_params=pt["post_params"], dtype=torch.float32,
    )
    assert (w.dtype, w32.dtype) == (torch.bfloat16, torch.float32)
    ups_blocks = 4 * 2 * 32 * 32 // 2  # int32 pairs of bf16
    assert w32.fragments.numel() == 4 * (w.fragments.numel() - ups_blocks)
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


# ---------------------------------------------------------------------------
# The bf16 stage on the warpgroup MMA: weight blocks and launch plan
# ---------------------------------------------------------------------------


def _port_stage(rng, c, c_in, post):
    """(resblock params, kwargs) in the port's layout."""
    _, pt = _both(_stage_tree(rng, c, c_in, post))
    return pt.pop("resblock_params"), pt


def _block_matrix(flat: torch.Tensor, c: int) -> torch.Tensor:
    """A packed C x C block read as ``wgmma`` reads a K-major B operand
    without swizzle through the kernel's descriptor (``b_desc``): element
    (k, n) of K chunk k // 16 lies at byte (k // 16) (C/8) 256 (the chunk's
    start) + (n // 8) 256 (stride byte offset) + (k % 16) // 8 128 (leading
    byte offset) + (n % 8) 16 + (k % 8) 2 (a core matrix: 8 rows of 16
    bytes).  Returns float32 ``B[k, n]``."""
    k = torch.arange(c).view(-1, 1)
    n = torch.arange(c).view(1, -1)
    byte = ((k // 16) * (c // 8) * 256 + (n // 8) * 256
            + (k % 16) // 8 * 128 + (n % 8) * 16 + (k % 8) * 2)
    return flat[byte // 2].float()


def _blocks(weights) -> typing.List[torch.Tensor]:
    c = weights.channels
    flat = weights.fragments.view(torch.bfloat16).view(-1, c * c)
    return [_block_matrix(b, c) for b in flat]


@pytest.mark.parametrize("c,c_in", [(16, 32), (32, 64), (64, 128), (32, None)])
def test_wgmma_blocks_unpack_to_the_weights(c, c_in):
    """The bf16 pack is the stream the kernel's producer copies: the
    upsampler's taps by phase (K blocks of C input channels each), then
    every resblock conv's taps in launch order, each block unpacking by the
    wgmma B layout to the bf16-rounded weights."""
    rng = np.random.RandomState(c)
    rb, kw = _port_stage(rng, c, c_in, post=False)
    w = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, **kw)
    assert w.fragments.dtype == torch.int32
    got = iter(_blocks(w))

    def bf16(t):
        return t.to(torch.bfloat16).float()

    if c_in:
        uw = kw["ups_params"]["weight"]  # [Cin, C, K]
        for r in range(2):  # phases of stride 2: taps r, r + 2
            for j in range(r, 4, 2):
                for kb in range(c_in // c):
                    torch.testing.assert_close(
                        next(got), bf16(uw[kb * c:(kb + 1) * c, :, j]),
                        atol=0, rtol=0)
    for r, k in enumerate(KERNELS):
        for j in range(3):
            for key in ("convs1", "convs2"):
                wt = rb[r][key][str(j)]["weight"]  # [Cout, Cin, K]
                for tap in range(k):
                    torch.testing.assert_close(
                        next(got), bf16(wt[:, :, tap].t()), atol=0, rtol=0)
    assert next(got, None) is None
    assert len(tstage.wgmma_passes(w, 256)) == (2 if c_in else 0) + 18


def _emulate(weights, x: torch.Tensor, rows: int) -> torch.Tensor:
    """The bf16 kernel's algorithm in float64 from its packed blocks, tile
    by tile: the upsampler's phase passes (input rows q0 + q - a for the
    taps j = r + 2a), then each resblock conv over the rows the rest of its
    resblock needs, zero outside [0, T), the mean, and conv_post."""
    c, halo = weights.channels, weights.halo
    mats = iter([m.double() for m in _blocks(weights)])
    plan = weights.plan.tolist()
    bias, wv = weights.b.double(), weights.w.double()
    post_pad = tstage._post_pad(weights)
    tile, ylo = rows - 2 * post_pad, halo - post_pad
    length = tile + 2 * halo
    batch, c_in, t_in = x.shape
    s, k_up, pad = weights.ups_stride, weights.ups_kernel, weights.ups_padding
    t_len = (t_in - 1) * s - 2 * pad + k_up if k_up else t_in
    out = []
    blocks = list(mats)
    for row in range(batch):
        pieces = []
        for t0 in range(0, t_len, tile):
            pos0 = t0 - halo
            inside = ((torch.arange(length) + pos0 >= 0)
                      & (torch.arange(length) + pos0 < t_len)).double()[:, None]
            it = iter(blocks)
            conv = 0
            if k_up:
                m_lo = (pos0 + pad - (k_up - 1)) // s
                m_hi = (pos0 + length - 1 + pad) // s
                m = torch.arange(m_lo, m_hi + 1)
                ok = (m >= 0) & (m < t_in)
                xin = torch.zeros(len(m), c_in, dtype=torch.float64)
                xin[ok] = F.leaky_relu(x[row][:, m[ok]].t(), 0.1)
                x0 = torch.zeros(length, c, dtype=torch.float64)
                for r in range(s):
                    i0 = (r - pos0 - pad) % s
                    n = -(-(length - i0) // s)
                    q0 = (pos0 + i0 + pad - r) // s
                    acc = torch.zeros(n, c, dtype=torch.float64)
                    for a, j in enumerate(range(r, k_up, s)):
                        for kb in range(c_in // c):
                            lo = q0 - m_lo - a
                            acc += (xin[lo:lo + n, kb * c:(kb + 1) * c]
                                    @ next(it))
                    x0[i0::s] = acc + bias[plan[0][1]:plan[0][1] + c]
                x0 = x0 * inside
                conv = 1
            else:
                x0 = torch.zeros(length, c, dtype=torch.float64)
                p = torch.arange(length) + pos0
                ok = (p >= 0) & (p < t_len)
                x0[ok] = x[row][:, p[ok]].t()
            y = torch.zeros(rows, c, dtype=torch.float64)
            for r in range(weights.n_res):
                ext = sum(plan[conv + m][3] * (plan[conv + m][2] - 1) // 2
                          for m in range(2 * weights.n_steps))
                st = x0.clone()
                for step in range(weights.n_steps):
                    u = torch.zeros_like(x0)
                    for half in range(2):
                        _, boff, k, dil = plan[conv]
                        conv += 1
                        cpad = dil * (k - 1) // 2
                        ext -= cpad
                        lo, n = ylo - ext, rows + 2 * ext
                        src = F.leaky_relu(st, 0.1) if half == 0 else u
                        acc = sum(src[lo - cpad + tap * dil:
                                      lo - cpad + tap * dil + n] @ next(it)
                                  for tap in range(k))
                        acc = acc + bias[boff:boff + c]
                        ins = inside[lo:lo + n]
                        if half == 0:
                            u = torch.zeros_like(x0)
                            u[lo:lo + n] = F.leaky_relu(acc, 0.1) * ins
                        else:
                            new = (st[lo:lo + n] + acc) * ins
                            st = torch.zeros_like(x0)
                            st[lo:lo + n] = new
                y += st[ylo:ylo + rows]
            y /= weights.n_res
            if weights.has_post:
                woff, boff, k, _ = plan[conv]
                wp = wv[woff:woff + c * k].view(c, k)
                yl = F.leaky_relu(y, 0.1) * inside[ylo:ylo + rows]
                o = torch.stack([
                    (yl[i:i + k] * wp.t()).sum() for i in range(tile)
                ]) + bias[boff]
                pieces.append(torch.tanh(o))
            else:
                pieces.append(y[post_pad:post_pad + tile].t())
        whole = torch.cat(pieces, -1)[..., :t_len]
        out.append(whole)
    return torch.stack(out)


@pytest.mark.parametrize(
    "c,c_in,post,batch,t_in,rows",
    [(16, 32, False, 1, 150, 64), (32, 64, True, 2, 97, 112),
     (16, None, True, 1, 200, 80), (64, 128, False, 1, 70, 64)],
)
def test_wgmma_algorithm_matches_plain(c, c_in, post, batch, t_in, rows):
    """The kernel's passes, emulated in float64 from the packed blocks
    (the polyphase upsampler, each conv's needed rows, the tile seams and
    the sequence edges), equal the plain stage on the bf16-rounded
    weights: the pack order, the phases and the row arithmetic are the
    kernel's."""
    rng = np.random.RandomState(c + t_in)
    rb, kw = _port_stage(rng, c, c_in, post)
    w = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, **kw)

    def rounded(tree, key=None):
        # the blocks hold bf16 weights; biases and conv_post stay float32
        if isinstance(tree, torch.Tensor):
            return (tree.to(torch.bfloat16) if key == "weight" else
                    tree).double()
        if isinstance(tree, dict):
            return {k: rounded(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rounded(v) for v in tree]
        return tree

    x = torch.from_numpy(rng.randn(batch, c_in or c, t_in))
    kw64 = rounded(kw)
    if post:
        kw64["post_params"] = {"weight": kw["post_params"]["weight"].double()}
    ref = tstage.hifigan_stage_plain(rounded(rb), x, KERNELS, DILATIONS,
                                     **kw64)
    got = _emulate(w, x, rows)
    assert got.shape == ref.shape
    # the plain path's conv_post head runs in float32
    tol = 1e-9 if ref.dtype == torch.float64 else 2e-6
    torch.testing.assert_close(got.to(ref.dtype), ref, atol=tol, rtol=tol)


# the fused stages of vits_low_hifigan_bf16 (the synth and serve cells'
# voice): C=64 with its upsampler 128->64, C=32 with its upsampler 64->32
# and conv_post; samples per decoder frame at each
_CELL_STAGES = {"c64_ups": (64, 128, False, 128),
                "c32_ups_post": (32, 64, True, 256)}


@pytest.mark.parametrize("stage_name", sorted(_CELL_STAGES))
@pytest.mark.parametrize(
    "batch,frames",
    [(16, 1024),  # the synth cells' decode
     (1, 128), (2, 256), (3, 1024), (4, 2048), (4, 4096),  # serve batches
     (1, 160), (1, 256)],  # a stream's first and later windows
)
def test_wgmma_plan_fits_and_fills(stage_name, batch, frames):
    """The bf16 launch plan at the shapes the cells and the server
    dispatch: shared memory within the block's 232,448 bytes with the
    weight ring counted, every pass in whole 64-row M tiles that cover its
    rows (the tile and the halo still ahead) within the warpgroups' slots,
    and a full first wave of blocks where the input allows it."""
    c, c_in, post, per_frame = _CELL_STAGES[stage_name]
    rb, kw = _port_stage(np.random.RandomState(3), c, c_in, post)
    w = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, **kw)
    t_out = frames * per_frame
    rows = tstage._pick_wgmma_rows(w, t_out, batch)
    post_pad = 3 if post else 0
    tile = rows - 2 * post_pad
    assert tile >= 1
    smem, room, xin = tstage._wgmma_layout(w, rows)
    ring = tstage.RING_SLOTS[c] * c * c * 2
    length = tile + 2 * w.halo
    assert smem == tstage.mma_smem_bytes(w, rows) <= 232448
    assert smem >= ring + 3 * length * (c + 8) * 2 + rows * (c + 1) * 4
    assert 0 < xin <= room  # the upsampler's staged input
    slots = tstage.WG_SLOTS[c] * tstage.WARPGROUPS
    passes = tstage.wgmma_passes(w, rows)
    assert len(passes) == 2 + 18
    for n, blocks in passes:
        mt = -(-n // 64)
        assert 64 * (mt - 1) < n <= 64 * mt <= 64 * slots and blocks > 0
    # the first conv of the widest resblock covers the tile and its halo
    k_last, d_last = KERNELS[-1], DILATIONS[-1][0]
    first = passes[2 + 12][0]
    assert first + 2 * d_last * (k_last - 1) // 2 == rows + 2 * (
        w.halo - post_pad)
    # a full first wave: at least 95% of the SMs take a block (the model
    # may leave one or two idle rather than start a second wave)
    blocks = -(-t_out // tile) * batch
    if t_out * batch >= tstage._SMS * 256:
        assert blocks >= 0.95 * tstage._SMS
