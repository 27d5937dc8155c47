"""vqa_tpu_torch — the PyTorch/CUDA port of vqa_tpu for NVIDIA Hopper.

The JAX package ``vqa_tpu`` is the reference; this package keeps its module
layout and names (``config``, ``text``, ``vocab``, ``datahelper``,
``prepare_data``, ``native.jpeg``,
``models.{base,layers,vgg,coattention,baseline,bert,convert}``,
``ops.{conv_stage1,conv_hpack,conv_stem,quant}``,
``train.{state,steps,checkpoint,calibrate,logging,profiling,preemption,scaling}``,
``data.{images,dataset,pipeline,feature_cache,_decode_worker}``,
``parallel.{distributed,mesh,sharding}``, ``serve``, ``export``, ``utils``,
``main``, and ``multichip`` for ``__graft_entry__.dryrun_multichip``) so
each module's counterpart is easy to
find. It imports ``torch``, never ``jax`` and nothing of ``vqa_tpu``. Every
TPU kernel on the serving and training paths of the three model families is
a hand-written CUDA kernel for ``sm_90a`` (``csrc/``, built by nvcc at first
use), reached through a registered PyTorch operator (``ops.library``), so
``torch.export`` keeps it in an exported program; each has a plain PyTorch
version in the same module that runs for CPU tensors. The
host's JPEG decoder is C++ (``native/``, built by g++ at first use). This
module and ``data`` import nothing heavy: the ``native_mp`` decode workers
import ``data.images`` without torch.
"""

__version__ = "0.1.0"
