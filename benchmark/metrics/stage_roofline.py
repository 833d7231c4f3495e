"""The fused HiFi-GAN stage kernel's share of its roofline: the least
time the card could take for every launch in the traced window (the
larger of its operations over the bf16 peak and its bytes over the HBM
rate, ``counts.stage_work``), over the traced time of the kernels of that
name (``stage*_kernel<C>`` of ``csrc/stage.cu``).  Launches are counted
from the session's dispatched decode signatures: one launch per fused
stage per decode, at the decode's batch and frame buckets."""

import re

from ..counts import (H100_HBM_BYTES_PER_S, peak_for, stage_of_channels,
                      stage_work)

KERNEL = r"\bstage(?:_mma|_tf32)?_kernel<(\d+)"
DECODE = re.compile(r"^decode:b(\d+):t\d+:f(\d+)$")


def read(a):
    if a.trace is None or a.device_name == "cpu":
        return None
    seconds = a.trace.kernel_seconds(KERNEL)
    if not seconds:
        return None
    peak = peak_for(a.device_name)
    least = 0.0
    for channels in {int(re.search(KERNEL, n).group(1)) for n in seconds}:
        stage = stage_of_channels(a.model, channels)
        for key, count in a.counters.get("hits", {}).items():
            m = DECODE.match(key)
            if m:
                flops, nbytes = stage_work(a.model, stage, int(m.group(1)),
                                           int(m.group(2)))
                least += count * max(flops / peak,
                                     nbytes / H100_HBM_BYTES_PER_S)
    return 100.0 * least / sum(seconds.values())
