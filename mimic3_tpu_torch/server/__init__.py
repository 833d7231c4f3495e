"""The HTTP server on the port's session.

The serving tier (routes, batching scheduler, WAV cache, streaming; port
copies of ``mimic3_tpu/server``) with engines that synthesize on PyTorch
and ``POST /api/profile`` capturing a ``torch.profiler`` trace.

    python -m mimic3_tpu_torch.server --voices-dir D --preload-voice en_US/x --warmup
"""
