"""PyTorch/CUDA port of mimic3-tpu: synthesis, streaming and the server.

The JAX package ``mimic3_tpu`` stays the reference; this package ports only
the code that touches JAX (the VITS model, the synthesis and streaming
session, the voice loader, engine, CLI and server glue, the Pallas kernels
as CUDA kernels) and reuses the JAX-free host modules of ``mimic3_tpu``
(config, text front end, utils, phonemizer voices, the server's routes and
batching scheduler) as they are.

Internally activations use PyTorch's ``[B, C, T]`` layout; the public model
functions (``VitsModel.infer_durations`` / ``decode_frames``) keep the JAX
package's shapes so the two can be compared like for like.
"""

__version__ = "0.1.0"
