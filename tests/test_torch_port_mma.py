"""The tensor-core weight packs and launch plans of the port's kernels, on
the CPU (the kernels themselves run only on the card:
``tests/test_torch_port_cuda.py``).

- ``ops/mma.py`` fragments unpack, by the register layout of
  ``mma.sync.m16n8k16``'s B operand as the PTX ISA states it, to the
  original weights; a conv evaluated from the packed tiles as a per-tap
  sum of ``[positions x 16] @ [16 x 8]`` products equals ``F.conv1d``
  within float32 summation order.
- ``pack_subblock_weights`` and ``pack_stage_weights`` carry those
  fragments for bf16; the launch plans fit shared memory and fill the
  card.
- The build key covers every header a kernel source includes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mimic3_tpu_torch.ops import build, mma
from mimic3_tpu_torch.ops import resblock as tres
from mimic3_tpu_torch.ops import stage as tstage
from mimic3_tpu_torch.runtime.convert import to_torch_params

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _unpack(frags: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """int32 fragments ``[K, Cin/16, Cout/16, 32, 4]`` -> float32 weights
    ``[Cout, Cin, K]``, reading each lane's registers as the B operand of
    mma.m16n8k16 holds them: register 2h + r of lane l in N-tile pair np
    is the bf16 pair (k, k + 1) at n = 16 np + 8 h + l // 4 and
    k = 16 kc + 2 (l % 4) + 8 r, the lower k in the low half."""
    k_taps, kcs, nps = frags.shape[:3]
    halves = frags.contiguous().view(torch.bfloat16).float()
    halves = halves.view(k_taps, kcs, nps, 32, 4, 2)
    w = torch.zeros(16 * nps, 16 * kcs, k_taps)
    for lane in range(32):
        for reg in range(4):
            for half in range(2):
                n = 16 * torch.arange(nps) + 8 * (reg // 2) + lane // 4
                k = 16 * torch.arange(kcs) + 2 * (lane % 4) + 8 * (reg % 2)
                k = k + half
                w[n[None, :], k[:, None], :] = halves[
                    :, :, :, lane, reg, half
                ].permute(1, 2, 0)
    return w[:cout, :cin]


def _bf16(w):
    return w.to(torch.bfloat16).float()


@pytest.mark.parametrize(
    "cout,cin,k", [(16, 16, 3), (24, 40, 7), (32, 32, 11), (64, 64, 3),
                   (1, 8, 5)]
)
def test_fragments_unpack_to_the_weights(cout, cin, k):
    w = torch.randn(cout, cin, k)
    frags = mma.pack_conv_fragments(w)
    cin_p, cout_p = mma.padded(cin), mma.padded(cout)
    assert frags.dtype == torch.int32
    assert frags.shape == (k, cin_p // 16, cout_p // 16, 32, 4)
    torch.testing.assert_close(_unpack(frags, cout, cin), _bf16(w),
                               rtol=0, atol=0)
    padded = _unpack(frags, cout_p, cin_p)
    assert not padded[cout:].any() and not padded[:, cin:].any()


@pytest.mark.parametrize("c,k,d,t", [(16, 3, 1, 40), (32, 7, 3, 50),
                                     (48, 11, 5, 70)])
def test_conv_from_packed_tiles_equals_conv1d(c, k, d, t):
    """The kernel's decomposition: for each tap j and 16-deep K chunk,
    [positions, 16] activations (rows shifted by j*d) times the chunk's
    B tiles, summed in float32."""
    rng = np.random.RandomState(c + k)
    w = torch.from_numpy(rng.randn(c, c, k).astype(np.float32)) / c
    x = _bf16(torch.from_numpy(rng.randn(1, c, t).astype(np.float32)))
    pad = d * (k - 1) // 2
    want = F.conv1d(x, _bf16(w), padding=pad, dilation=d)[0].T  # [t, c]

    frags = mma.pack_conv_fragments(w)
    b = _unpack(frags, mma.padded(c), mma.padded(c))  # [Cout, Cin, K]
    act = F.pad(x[0].T, (0, 0, pad, pad))  # [t + 2 pad, Cin], rows = time
    got = torch.zeros(t, c)
    for j in range(k):
        rows = act[j * d:j * d + t]
        for kc in range(mma.padded(c) // 16):
            a_tile = F.pad(rows, (0, mma.padded(c) - c))[
                :, 16 * kc:16 * kc + 16
            ]
            for nt in range(mma.padded(c) // 8):
                b_tile = b[8 * nt:8 * nt + 8, 16 * kc:16 * kc + 16, j].T
                cols = slice(8 * nt, min(8 * nt + 8, c))
                got[:, cols] += (a_tile @ b_tile)[:, :cols.stop - cols.start]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_subblock_pack_for_tensor_cores():
    w1, w2 = torch.randn(24, 24, 7), torch.randn(24, 24, 7)
    b1 = torch.randn(24)
    packed = tres.pack_subblock_weights(w1, b1, w2, None, torch.bfloat16)
    assert packed.mma and packed.channels == 24
    torch.testing.assert_close(_unpack(packed.w1, 24, 24), _bf16(w1))
    torch.testing.assert_close(_unpack(packed.w2, 24, 24), _bf16(w2))
    assert packed.b1.shape == (32,) and packed.b1.dtype == torch.float32
    torch.testing.assert_close(packed.b1[:24], _bf16(b1))
    assert not packed.b1[24:].any() and not packed.b2.any()


def _stage_tree(rng, c, c_in, post):
    tree = {"resblocks": {
        str(r): {key: {str(j): {
            "weight": rng.randn(k, c, c).astype(np.float32),
            "bias": rng.randn(c).astype(np.float32),
        } for j in range(3)} for key in ("convs1", "convs2")}
        for r, k in enumerate(KERNELS)
    }}
    if c_in:
        tree["ups"] = {"0": {
            "weight": rng.randn(4, c_in, c).astype(np.float32),
            "bias": rng.randn(c).astype(np.float32),
        }}
    if post:
        tree["conv_post"] = {"weight": rng.randn(7, c, 1).astype(np.float32)}
    port = to_torch_params(tree, "cpu")
    kw = {}
    if c_in:
        kw.update(ups_params=port["ups"]["0"], ups_stride=2, ups_padding=1)
    if post:
        kw["post_params"] = port["conv_post"]
    return [port["resblocks"][str(r)] for r in range(3)], kw


def _unpack_block(flat: torch.Tensor, c: int) -> torch.Tensor:
    """A bf16 wgmma block ``[C * C]`` (``mma.pack_wgmma_block``: K chunk,
    N group, K half, then a core matrix of 8 output x 8 input channels)
    -> float32 ``B[k, n]``."""
    v = flat.float().view(c // 16, c // 8, 2, 8, 8)  # kc, ng, kh, n, k
    return v.permute(0, 2, 4, 1, 3).reshape(c, c)


def test_stage_pack_carries_fragments_in_launch_order():
    rng = np.random.RandomState(0)
    rb, kw = _stage_tree(rng, 32, 64, True)
    w = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, **kw)
    assert w.convs == tuple(
        (k, dil) for k in KERNELS for d in (1, 3, 5) for dil in (d, 1)
    )
    blocks = w.fragments.view(torch.bfloat16).view(-1, 32 * 32)
    # the upsampler's 4 taps x 2 K blocks of 32 input channels come first
    assert blocks.shape[0] == 4 * 2 + sum(k for k, _ in w.convs)
    off = 8
    for r, k in enumerate(KERNELS):
        for j in range(3):
            for key in ("convs1", "convs2"):
                wt = rb[r][key][str(j)]["weight"]  # [Cout, Cin, K]
                for tap in range(k):
                    torch.testing.assert_close(
                        _unpack_block(blocks[off], 32),
                        _bf16(wt[:, :, tap].t()),
                    )
                    off += 1
    assert off == blocks.shape[0] and w.post_kernel == 7
    # C=8 is under the MMA depth: no fragments, the FFMA path
    rb8, kw8 = _stage_tree(rng, 8, None, False)
    assert tstage.pack_stage_weights(rb8, KERNELS, DILATIONS,
                                     **kw8).fragments is None


@pytest.mark.parametrize(
    "c,k,d,t,batch",
    [(256, 11, 5, 2048, 1), (128, 3, 5, 65536, 16), (128, 11, 5, 16384, 1),
     (32, 11, 5, 65536, 1), (24, 3, 1, 100, 1), (128, 3, 5, 5, 2)],
)
def test_resblock_mma_plan_fits_and_fills(c, k, d, t, batch):
    rows, groups = tres.pick_mma_config(c, k, d, t, batch)
    h2 = (k - 1) // 2
    assert rows % 32 == 0 and rows > 2 * h2
    cp = mma.padded(c)
    assert cp % groups == 0 and (cp // groups) % 16 == 0
    assert tres.mma_smem_bytes(c, k, d, rows, groups) <= tres._MAX_SMEM_BYTES
    blocks = -(-t // (rows - 2 * h2)) * batch * groups
    if t * batch >= 2048:  # enough work: at least half the card's SMs busy
        assert blocks >= tres._SMS // 2


@pytest.mark.parametrize(
    "c,c_in,post,t_out,batch",
    [(32, 64, True, 32768, 1), (32, 64, True, 65536, 4),
     (64, 128, False, 16384, 4), (16, 32, False, 258, 3),
     (32, None, True, 513, 2)],
)
def test_stage_mma_tile_fits(c, c_in, post, t_out, batch):
    rng = np.random.RandomState(1)
    rb, kw = _stage_tree(rng, c, c_in, post)
    w = tstage.pack_stage_weights(rb, KERNELS, DILATIONS, **kw)
    rows = tstage._pick_wgmma_rows(w, t_out, batch)
    post_pad = 3 if post else 0
    assert rows % 16 == 0 and rows - 2 * post_pad >= 1
    assert tstage.mma_smem_bytes(w, rows) <= tstage._MAX_SMEM_BYTES
    # every pass fits the warpgroups' 64-row M-tile slots
    slots = tstage.WG_SLOTS[c] * tstage.WARPGROUPS
    assert all(-(-n // 64) <= slots for n, _ in tstage.wgmma_passes(w, rows))


def test_build_key_covers_included_headers(tmp_path):
    src = tmp_path / "kernel.cu"
    head = tmp_path / "tile.cuh"
    deep = tmp_path / "deep.cuh"
    src.write_text('#include <cuda_bf16.h>\n#include "tile.cuh"\nint x;\n')
    head.write_text('#pragma once\n  #  include "deep.cuh"\nint y;\n')
    deep.write_text("int z;\n")
    assert [p.name for p in build.source_files(src)] == [
        "kernel.cu", "tile.cuh", "deep.cuh"
    ]
    key = build.library_path(src, tmp_path)
    assert key.name.startswith("libkernel_") and key.suffix == ".so"
    assert build.library_path(src, tmp_path) == key
    deep.write_text("int z = 1;\n")  # a header two levels down changes
    changed = build.library_path(src, tmp_path)
    assert changed != key
    head.write_text('#pragma once\nint y;\n')  # drops the include
    assert build.library_path(src, tmp_path) not in (key, changed)
    # the shipped kernels include the shared tile header
    for module in (tres, tstage):
        names = [p.name for p in build.source_files(module.SOURCE)]
        assert names[1:] == ["conv_tile.cuh"]
