"""PyTorch/CUDA port of the blocked direct-convolution stack (``repro``).

The JAX/Pallas package ``repro`` is the reference; this package computes the
same functions on the same blocked layouts with PyTorch around hand-written
CUDA kernels for an NVIDIA H100.  It imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro`` — so module names mirror the
reference (``core.layout``, ``kernels.direct_conv2d``, ``nn.conv``, ...)
but every module is the port's own copy.

Entry points (``nn.conv.BlockedCNN``, ``configs.cnn.vgg16_blocked``,
``launch.conv_serve.ConvServer``, ``nn.models.build_model`` for the
language models, ``serve.scheduler.ContinuousBatcher`` over one,
``convert.params_from_jax``) default to ``device="cuda"`` and raise when no GPU is visible; the CPU runs only when
the caller passes ``device="cpu"``, where each kernel wrapper computes its
plain PyTorch version instead of launching.
"""
