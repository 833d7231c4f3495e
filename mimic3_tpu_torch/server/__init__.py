"""The HTTP server on the port's session.

The reference serving tier (``mimic3_tpu/server``: routes, batching
scheduler, WAV cache, streaming) with engines that synthesize on PyTorch
and ``POST /api/profile`` capturing a ``torch.profiler`` trace.

    python -m mimic3_tpu_torch.server --voices-dir D --preload-voice en_US/x --warmup
"""
