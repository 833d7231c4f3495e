"""Plain PyTorch reference of VITS inference, the yardstick of ``correct``.

Written from the published model (VITS, arXiv 2106.06103, and its
``jaywalnut310/vits`` code; MB-iSTFT-VITS, arXiv 2210.15975) in float32
with TF32 off, one utterance at a time, no kernels, no buckets, no
batching.  It reads the voice directory the benchmark wrote (the
``generator.npz`` voice-file layout, ``phonemes.txt``, ``config.json``)
and works out again everything the program derives from it: the layout
change and the weight-norm fold (:mod:`.params`), the phoneme ids
(:mod:`.text`) and the position-indexed noise (:mod:`.noise`).

It imports nothing of the program, nothing of the JAX package and no JAX.

Departures from the published description, each also in ``PERF.md``:

- the leaky ReLU before the decoder's ``conv_post`` has slope 0.1, as the
  program defines the model; VITS and HiFi-GAN use ``F.leaky_relu``'s
  default of 0.01 there;
- the MB-iSTFT head is the program's variant: a log-magnitude clipped to
  [-12, 6] and a raw phase per sub-band bin, an iSTFT that keeps
  ``frames * hop`` samples from offset ``(n_fft - hop) / 2``, and a
  62-tap Kaiser pseudo-QMF bank (cutoff 0.142, beta 9).
"""
