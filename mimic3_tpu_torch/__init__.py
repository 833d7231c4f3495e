"""PyTorch/CUDA port of mimic3-tpu: synthesis, streaming and the server.

The JAX package ``mimic3_tpu`` stays the reference; this package stands
alone and imports nothing of it.  It ports the code that touches JAX (the
VITS model, the synthesis and streaming session, the Pallas kernels as
CUDA kernels) and keeps its own copy of each host module it needs (config,
text front end, utils, SSML, voice catalog and downloader, phonemizer
voices, engine, CLI, and the server's routes and batching scheduler), each
naming its reference file.

Internally activations use PyTorch's ``[B, C, T]`` layout; the public model
functions (``VitsModel.infer_durations`` / ``decode_frames``) keep the JAX
package's shapes so the two can be compared like for like.
"""

__version__ = "0.1.0"
