"""Monotonic alignment search (MAS) on the device.

Counterpart of ``mimic3_tpu/models/vits/mas.py``.  VITS training aligns
text to spectrogram frames by the monotonic path through the prior
log-likelihood matrix that maximizes the total likelihood.  As in the
reference's ``lax.scan``, a dynamic program steps over spectrogram frames
(vectorized over batch and text), then a backtrack steps back over them;
both stay on the device.  The same inputs give the same path as the
reference bit for bit: the sums are the same float32 additions in the
same order, ties advance (``shifted >= stay``), invalid text rows are
never chosen and frames past an example's length keep its state.

neg_x_ent: [B, T_text, T_spec] log-likelihood of frame t under text j.
Returns a hard path [B, T_text, T_spec] in {0, 1}.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e9


@torch.no_grad()
def monotonic_alignment_search(
    neg_x_ent: torch.Tensor,
    text_lengths: torch.Tensor,
    spec_lengths: torch.Tensor,
) -> torch.Tensor:
    """Batched MAS: the hard alignment [B, T_text, T_spec] (1 where frame
    t is assigned to text j)."""
    b, n_text, n_spec = neg_x_ent.shape
    dev = neg_x_ent.device
    text_idx = torch.arange(n_text, device=dev)
    text_lengths = text_lengths.to(dev).long()
    spec_lengths = spec_lengths.to(dev).long()
    # invalid text rows must never be chosen; frames lead for the loop
    ll = torch.where(
        (text_idx[None, :] < text_lengths[:, None])[:, :, None],
        neg_x_ent.float(),
        torch.full((), _NEG_INF, device=dev),
    ).permute(2, 0, 1).contiguous()  # [T_spec, B, T_text]
    frame_valid = (
        torch.arange(n_spec, device=dev)[:, None] < spec_lengths[None, :]
    )[:, :, None]  # [T_spec, B, 1]

    # forward DP over frames: value[b, j] = best path score ending at j
    value = torch.where(text_idx[None, :] == 0, ll[0], _NEG_INF)
    neg_col = torch.full((b, 1), _NEG_INF, device=dev)
    took_diag = torch.zeros(
        max(n_spec - 1, 0), b, n_text, dtype=torch.bool, device=dev
    )
    for t in range(1, n_spec):
        shifted = torch.cat([neg_col, value[:, :-1]], dim=1)
        valid = frame_valid[t]
        # prefer advancing on ties; frames past the valid length keep the
        # value unchanged and record no step
        took_diag[t - 1] = (shifted >= value) & valid
        value = torch.where(
            valid, torch.maximum(shifted, value) + ll[t], value
        )

    # backtrack from (t_text-1, t_spec-1): j is frame t+1's text index
    rows = torch.arange(b, device=dev)
    j = text_lengths - 1
    path_idx = torch.empty(n_spec, b, dtype=torch.long, device=dev)
    for t in range(n_spec - 2, -1, -1):
        path_idx[t + 1] = j
        # an index below 0 (a path forced off the text's start) wraps as
        # the reference's indexing does
        took = took_diag[t, rows, torch.remainder(j, n_text)]
        j = j - took.long()
    path_idx[0] = j

    # one-hot by comparison (a negative index selects nothing)
    path = (path_idx[:, :, None] == text_idx).float() * frame_valid
    return path.permute(1, 2, 0).contiguous()
