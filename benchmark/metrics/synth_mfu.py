"""The whole call's share of the card's bf16 peak: the benchmark's FLOP
count of the work the window's inputs needed (``counts.utterance`` at
each row's own phonemes and frames) over the traced window's wall
seconds."""

from ..counts import peak_for, utterance


def read(a):
    if not a.utterances or a.device_name == "cpu":
        return None
    flops = sum(utterance(a.model, p, f)["total"] for p, f in a.utterances)
    return 100.0 * flops / a.window_s / peak_for(a.device_name)
