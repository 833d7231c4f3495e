"""The float32 tensor-core path of the port's kernels, on the CPU.

Both kernels run float32 convs as three TF32 passes of
``mma.sync.m16n8k8`` (``csrc/conv_tile.cuh``): each operand is split once
into ``hi + lo``, both rounded to TF32, and the tile sums
``a_lo.w_hi + a_hi.w_lo + a_hi.w_hi`` in float32.  The kernels run only
on the card (``tests/test_torch_port_cuda.py``); here:

- ``ops/mma.py``'s ``split_tf32`` rounds as ``cvt.rna.tf32.f32`` does,
  and its TF32 fragments unpack, by the register layout of the m16n8k8 B
  operand as the PTX ISA states it, to ``w_hi`` and ``w_lo``;
- one conv evaluated from the packed tiles with the three products
  equals ``conv1d`` in float64 within 1e-5 (one TF32 pass does not);
- the same emulation over a whole last stage (upsampler, 3 resblocks x 3
  steps x 2 convs, ``conv_post``) stays within the port's float32 bar
  (``atol=2e-4, rtol=1e-3``) of the JAX package's Pallas stage in
  interpret mode, where one pass does not: the parity budget of the
  kernels, shown before the card;
- the float32 launch plans fit one block's shared memory and fill the
  card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from mimic3_tpu.ops.stage import hifigan_stage_fused as jax_stage
from mimic3_tpu_torch.ops import mma
from mimic3_tpu_torch.ops import resblock as tres
from mimic3_tpu_torch.ops import stage as tstage
from mimic3_tpu_torch.runtime.convert import to_torch_params

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
SLOPE = 0.1


def _bar_share(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest share of the float32 bar 2e-4 + 1e-3 |ref| used."""
    return float(np.max(np.abs(got - ref) / (2e-4 + 1e-3 * np.abs(ref))))


def test_split_tf32_rounds_like_cvt_rna():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        (rng.randn(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    )
    hi, lo = mma.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 13 bits zero
    x64, hi64, lo64 = (t.double() for t in (x, hi, lo))
    # hi is x to nearest in 10 mantissa bits, hi + lo x within 2^-21
    assert ((x64 - hi64).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert ((x64 - hi64 - lo64).abs() <= 2.0 ** -21 * x64.abs()).all()
    # ties go away from zero (rna), not to even
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11])
    assert mma.split_tf32(tie)[0].tolist() == [
        1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10
    ]


def _unpack_tf32(frags: torch.Tensor, cout: int, cin: int):
    """int32 fragments ``[K, Cin/8, Cout/8, 32, 4]`` -> (w_hi, w_lo)
    ``[Cout, Cin, K]``, reading each lane's registers as the B operand of
    mma.m16n8k8 (TF32) holds them: b0 is row k = l % 4, b1 row k + 4, of
    column n = l // 4 of the N tile; registers 0-1 the hi pass, 2-3 the lo
    pass."""
    k_taps, kcs, nts = frags.shape[:3]
    vals = frags.contiguous().view(torch.float32)
    parts = torch.zeros(2, 8 * nts, 8 * kcs, k_taps)
    for lane in range(32):
        for reg in range(4):
            n = 8 * torch.arange(nts) + lane // 4
            k = 8 * torch.arange(kcs) + lane % 4 + 4 * (reg % 2)
            parts[reg // 2][n[None, :], k[:, None], :] = vals[
                :, :, :, lane, reg
            ].permute(1, 2, 0)
    return parts[0][:cout, :cin], parts[1][:cout, :cin], parts


@pytest.mark.parametrize(
    "cout,cin,k", [(16, 16, 3), (24, 40, 7), (32, 32, 11), (64, 64, 3),
                   (1, 8, 5)]
)
def test_tf32_fragments_unpack_to_the_weights(cout, cin, k):
    w = torch.randn(cout, cin, k)
    frags = mma.pack_conv_fragments_tf32(w)
    cin_p, cout_p = mma.padded(cin), mma.padded(cout)
    assert frags.dtype == torch.int32
    assert frags.shape == (k, cin_p // 8, cout_p // 8, 32, 4)
    w_hi, w_lo, padded = _unpack_tf32(frags, cout, cin)
    want_hi, want_lo = mma.split_tf32(w)
    torch.testing.assert_close(w_hi, want_hi, rtol=0, atol=0)
    torch.testing.assert_close(w_lo, want_lo, rtol=0, atol=0)
    assert not padded[:, cout:].any() and not padded[:, :, cin:].any()


def _conv_from_tiles(act, frags, cin, cout, k, d, passes=3):
    """The kernel's decomposition of one conv: for each tap j and 8-deep K
    chunk, the [positions, 8] activations (rows shifted by j*d) split into
    TF32 hi/lo times the chunk's unpacked hi/lo B tiles, the three products
    (lo.hi, hi.lo, hi.hi; ``passes=1``: hi.hi only) summed in float32.
    ``act``: ``[t + 2 pad, Cin]`` float32, rows = time."""
    t = act.shape[0] - d * (k - 1)
    w_hi, w_lo, _ = _unpack_tf32(frags, cout, cin)
    a_hi, a_lo = mma.split_tf32(act)
    out = torch.zeros(t, cout)
    for j in range(k):
        rows = slice(j * d, j * d + t)
        for kc in range(-(-cin // 8)):
            ch = slice(8 * kc, min(8 * kc + 8, cin))
            bh, bl = w_hi[:, ch, j].T, w_lo[:, ch, j].T
            ah, al = a_hi[rows, ch], a_lo[rows, ch]
            if passes == 3:
                out += al @ bh
                out += ah @ bl
            out += ah @ bh
    return out


@pytest.mark.parametrize("c,k,d,t", [(16, 3, 1, 40), (32, 7, 3, 50),
                                     (48, 11, 5, 70)])
def test_conv_from_tf32_tiles_equals_conv1d(c, k, d, t):
    """Three passes: within 1e-5 of the float64 conv (the dropped
    a_lo.w_lo and the rounding of the lo parts are below 2^-21 of each
    product); one pass is not."""
    rng = np.random.RandomState(c + k)
    w = torch.from_numpy(rng.randn(c, c, k).astype(np.float32)) / c
    x = torch.from_numpy(rng.randn(1, c, t).astype(np.float32))
    pad = d * (k - 1) // 2
    want = F.conv1d(x.double(), w.double(), padding=pad, dilation=d)[0].T
    act = F.pad(x[0].T, (0, 0, pad, pad))  # [t + 2 pad, Cin]
    frags = mma.pack_conv_fragments_tf32(w)
    got = _conv_from_tiles(act, frags, c, c, k, d)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    one = _conv_from_tiles(act, frags, c, c, k, d, passes=1)
    assert not torch.allclose(one.double(), want, rtol=1e-5, atol=1e-5)


def _lrelu(v):
    return torch.where(v >= 0, v, v * SLOPE)


def _emulated_stage(rb, x, ups, post, passes):
    """The f32 stage kernel's arithmetic on one row ``x`` [C_in, T_in]:
    the upsampler and ``conv_post`` in float32 (FFMA in the kernel), every
    resblock conv from its packed TF32 tiles; the state, the intermediate
    and the sum over resblocks in float32, rounded nowhere else."""
    c = rb[0]["convs1"]["0"]["weight"].shape[0]
    h = F.conv_transpose1d(_lrelu(x)[None], ups["weight"], ups["bias"],
                           stride=2, padding=1)[0].T  # [T, C]
    t = h.shape[0]

    def conv(a, p, k, d):  # a: [T, C] already lrelu'd
        pad = d * (k - 1) // 2
        frags = mma.pack_conv_fragments_tf32(p["weight"])
        return _conv_from_tiles(F.pad(a, (0, 0, pad, pad)), frags, c, c, k,
                                d, passes) + p["bias"]

    y = None
    for rp, k, ds in zip(rb, KERNELS, DILATIONS):
        s = h
        for j, d in enumerate(ds):
            u = _lrelu(conv(_lrelu(s), rp["convs1"][str(j)], k, d))
            s = s + conv(u, rp["convs2"][str(j)], k, 1)
        y = s if y is None else y + s
    y = y / len(rb)
    out = F.conv1d(_lrelu(y.T)[None], post["weight"], padding=3)[0, 0]
    assert out.shape == (t,)
    return torch.tanh(out)


@pytest.mark.parametrize("c,passes", [(16, 3), (32, 3), (32, 1)])
def test_tf32_stage_emulation_within_f32_bar_of_jax(c, passes):
    """A last stage (ups 2c -> c, the stage, conv_post) on three TF32
    passes stays within the float32 bar of the JAX package's Pallas stage
    (interpret mode); on one pass it does not."""
    rng = np.random.RandomState(c)
    t_in = 128
    tree = {"resblocks": {
        str(r): {key: {str(j): {
            "weight": rng.randn(k, c, c).astype(np.float32) * 0.1,
            "bias": rng.randn(c).astype(np.float32) * 0.1,
        } for j in range(3)} for key in ("convs1", "convs2")}
        for r, k in enumerate(KERNELS)
    }}
    tree["ups"] = {"0": {
        "weight": rng.randn(4, 2 * c, c).astype(np.float32) * 0.1,
        "bias": rng.randn(c).astype(np.float32) * 0.1,
    }}
    tree["conv_post"] = {"weight": rng.randn(7, c, 1).astype(np.float32) * 0.1}
    x = rng.randn(1, t_in, 2 * c).astype(np.float32)

    def jx(d):
        return {n: jnp.asarray(a) for n, a in d.items()}

    ref = np.asarray(jax_stage(
        [{key: {j: jx(p) for j, p in d.items()} for key, d in rp.items()}
         for _, rp in sorted(tree["resblocks"].items())],
        jnp.asarray(x), KERNELS, DILATIONS, interpret=True,
        ups_params=jx(tree["ups"]["0"]), ups_stride=2, ups_padding=1,
        post_params={"weight": jnp.asarray(tree["conv_post"]["weight"])},
    ))[0]
    port = to_torch_params(tree)
    got = _emulated_stage(
        [port["resblocks"][str(r)] for r in range(3)],
        torch.from_numpy(x[0].T.copy()), port["ups"]["0"],
        port["conv_post"], passes,
    ).numpy()
    assert got.shape == ref.shape == (2 * t_in,)
    share = _bar_share(got, ref)
    if passes == 3:
        assert share <= 0.25, share
    else:
        assert share > 1.0, share


@pytest.mark.parametrize(
    "c,c_in,post,t_out,batch",
    [(32, 64, True, 32768, 1), (32, 64, True, 65536, 4),
     (64, 128, False, 16384, 4), (64, None, False, 32768, 1),
     (16, 32, False, 258, 3), (32, None, True, 513, 2)],
)
def test_stage_tf32_plan_fits_and_fills(c, c_in, post, t_out, batch):
    """The f32 block plan fits 232,448 bytes, a conv's rows fit the warps'
    M-tile slots, and the decoder's shapes give every SM a block."""
    rng = np.random.RandomState(1)
    tree = {"resblocks": {str(r): {key: {str(j): {
        "weight": rng.randn(k, c, c).astype(np.float32),
    } for j in range(3)} for key in ("convs1", "convs2")}
        for r, k in enumerate(KERNELS)}}
    kw = {}
    if c_in:
        tree["ups"] = {"0": {
            "weight": rng.randn(4, c_in, c).astype(np.float32)}}
    if post:
        tree["conv_post"] = {"weight": rng.randn(7, c, 1).astype(np.float32)}
    port = to_torch_params(tree)
    if c_in:
        kw.update(ups_params=port["ups"]["0"], ups_stride=2, ups_padding=1)
    if post:
        kw["post_params"] = port["conv_post"]
    w = tstage.pack_stage_weights(
        [port["resblocks"][str(r)] for r in range(3)], KERNELS, DILATIONS,
        dtype=torch.float32, **kw)
    assert tstage.uses_mma(c, torch.float32)
    rows = tstage._pick_mma_rows(w, t_out, batch, torch.float32)
    tile = rows - (6 if post else 0)
    assert rows % 16 == 0 and tile >= 1
    assert tstage.mma_smem_bytes(w, rows, torch.float32) <= 232448
    warps = tstage.mma_warps(c, torch.float32)
    assert -(-(tile + 2 * w.halo) // 16) <= tstage.TF32_SLOTS * warps
    if t_out * batch >= 16384:
        assert -(-t_out // tile) * batch >= tstage._SMS


@pytest.mark.parametrize(
    "c,k,d,t,batch",
    [(256, 11, 5, 2048, 1), (128, 3, 5, 65536, 16), (128, 11, 5, 16384, 1),
     (32, 11, 5, 65536, 1), (24, 3, 1, 100, 1), (128, 3, 5, 5, 2)],
)
def test_resblock_tf32_plan_fits_and_fills(c, k, d, t, batch):
    rows, groups = tres.pick_mma_config(c, k, d, t, batch, torch.float32)
    h2 = (k - 1) // 2
    assert rows % 32 == 0 and rows > 2 * h2
    cp = mma.padded(c)
    assert cp % groups == 0 and (cp // groups) % 16 == 0
    assert (tres.mma_smem_bytes(c, k, d, rows, groups, torch.float32)
            <= tres._MAX_SMEM_BYTES)
    blocks = -(-t // (rows - 2 * h2)) * batch * groups
    if t * batch >= 2048:  # enough work: at least half the card's SMs busy
        assert blocks >= tres._SMS // 2


def test_ablation_variants_patch_the_shipped_sources():
    """``scripts/ablate_stage.py`` builds its variants (the f32 flush
    modes and the cp.async ring among them) by text patches of the
    shipped sources, applied in order: each must apply to exactly one
    place, or the script measures nothing."""
    from mimic3_tpu_torch.ops import build
    from mimic3_tpu_torch.scripts import ablate_stage

    shipped = {p.name: p.read_text()
               for p in build.source_files(tstage.SOURCE)}
    for variants in (ablate_stage.BF16_VARIANTS, ablate_stage.F32_VARIANTS):
        for name, variant in variants.items():
            texts = ablate_stage.patched_sources(name, variant)
            assert (texts == shipped) == (not variant.patches), name
    assert "kernel" in ablate_stage.F32_VARIANTS
    assert ablate_stage.F32_VARIANTS["ring"].ring
    # the shipped tile keeps one flush mode and reads its fragments
    # through the read-only cache: the others live in the script alone
    assert "cp_async" not in shipped["stage.cu"]
    assert "kTf32Flush" not in shipped["conv_tile.cuh"]
