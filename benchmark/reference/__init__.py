"""The plain reference: float32 PyTorch, NCHW, no kernel, cache or batching
of the port, and nothing imported from ``unet_zoo_tpu_torch``, ``jax`` or
``unet_zoo_tpu``. One module a model family (``<family>.py``, named by a
configuration's ``family``) beside the shared ``ops``, ``augment``,
``optim`` and ``metrics``.

Parameters are a flat dict keyed by the module paths that the port and the
JAX package share (``posterior.down0.convs.conv0.conv.weight``, ...), so one
set of weights, drawn by the benchmark, loads into both.
"""
