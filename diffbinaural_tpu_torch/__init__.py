"""diffbinaural_tpu_torch — the PyTorch/CUDA port of ``diffbinaural_tpu``.

The same two-stage mono→binaural pipeline, written for one NVIDIA Hopper
card: plain tensor code is PyTorch, and every kernel the JAX package wrote
in Pallas is a CUDA C++ kernel under ``ops/csrc/`` built with ``nvcc`` at
first use.  This package imports ``torch`` and ``numpy`` only — never
``jax``/``flax`` and nothing of ``diffbinaural_tpu`` (it keeps its own copy
of the framework-free pieces it needs).

Ported so far: the whole-clip inference path
(``infer.pipeline.BinauralPipeline``: windows → DDIM over the stage-1 UNet
→ stitch → BigVGAN vocoder) with its three forward kernels
(``ops.flash_d32``, ``ops.alias_free_act``, ``ops.snake_conv``), and the
stage-1 training step (``train.stage1.make_stage1_train_step``) with the
attention's training forward and backward kernels, the mel frontend
(``signal.stft``) and wav IO (``data.audio_io``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
