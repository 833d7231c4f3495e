"""PyTorch/CUDA port of the mimic3-tpu synthesis path.

The JAX package ``mimic3_tpu`` stays the reference; this package ports only
the code that touches JAX (the VITS model, the synthesis session, the voice
loader, engine and CLI glue) and reuses the JAX-free host modules of
``mimic3_tpu`` (config, text front end, utils, phonemizer voices) as they are.

Internally activations use PyTorch's ``[B, C, T]`` layout; the public model
functions (``VitsModel.infer_durations`` / ``decode_frames``) keep the JAX
package's shapes so the two can be compared like for like.
"""

__version__ = "0.1.0"
