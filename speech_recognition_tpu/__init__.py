"""speech_recognition_tpu — a JAX/XLA end-to-end ASR framework for NVIDIA GPUs.

Capabilities mirror cosmoquester/speech-recognition: LAS and DeepSpeech2 model families, an on-device audio
feature frontend (STFT / log-mel / MFCC / SpecAugment / delta-accelerate),
sentencepiece tokenization, greedy/beam decoding, WER/CER evaluation,
TFRecord preprocessing, and four CLI entry points (train / evaluate /
inference / make_tfrecord).

The architecture is XLA-first: pure-functional models with lax.scan
recurrences, static shapes, and NamedSharding data+tensor parallelism over a
jax.sharding.Mesh.  The package name is historical (README.md); it runs on
NVIDIA GPUs and on the CPU.
"""

__version__ = "0.1.0"
