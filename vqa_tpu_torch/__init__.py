"""vqa_tpu_torch — the PyTorch/CUDA port of vqa_tpu for NVIDIA Hopper.

The JAX package ``vqa_tpu`` is the reference; this package keeps its module
layout and names (``config``, ``text``, ``vocab``,
``models.{layers,vgg,coattention,convert}``,
``ops.{conv_stage1,conv_hpack,conv_stem}``,
``train.{state,steps,checkpoint,calibrate,logging,profiling,preemption}``,
``data.{images,dataset,pipeline}``, ``serve``, ``main``) so each module's
counterpart is easy to find. It imports ``torch``, never ``jax`` and nothing
of ``vqa_tpu``. Every TPU kernel on the serving and training paths of the
``attention`` model is a hand-written CUDA kernel for ``sm_90a`` (``csrc/``,
built by nvcc at first use); each has a plain PyTorch version in the same
module that runs for CPU tensors.
"""

__version__ = "0.1.0"
