"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The port is a package of its own: it imports ``torch``, numpy and the
standard library, never ``jax`` and nothing of ``paddle_tpu``.  Its layout
mirrors the JAX package so that every module has an obvious counterpart:

* ``models/gpt.py`` and ``models/generation.py``: the GPT decoder, its
  training step, the dense KV-cache decoder (the engine's oracle) and
  beam search;
* ``kernels/``: hand-written CUDA kernels for Hopper (``csrc/*.cu``), each
  beside its plain PyTorch version;
* ``serving/``: the paged, continuous-batching serving engine and its
  streaming HTTP front end (``serving/frontend.py``);
* ``distributed/``: ``paddle.distributed`` over ``torch.distributed``
  (the collective API, the ``(dp, pp, sharding, mp)`` mesh, ``spawn``,
  ``fleet`` and its tensor-parallel layers), which the train step, TP
  decoding and ``kernels/ring.py`` (ring attention) run over;
* ``framework/``: the seed chain of explicit ``torch.Generator``s and the
  flags the profiler reads; ``profiler.py``: host spans, their table and
  ``torch.profiler`` traces;
* ``examples/serve_gpt.py``: the serve CLI
  (``python -m paddle_tpu_torch.examples.serve_gpt``);
* ``weights.py``: lifts a JAX parameter tree (as numpy) into the port.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(see :mod:`paddle_tpu_torch.device`).
"""

from .device import default_device, default_dtype, resolve_device

__all__ = ["default_device", "default_dtype", "resolve_device"]
