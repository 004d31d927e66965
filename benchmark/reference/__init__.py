"""The plain reference: float32 PyTorch, NCHW, no kernel, cache or batching
of the port, and nothing imported from ``unet_zoo_tpu_torch``, ``jax`` or
``unet_zoo_tpu``. One module a model family (``<family>.py``, named by a
configuration's ``family``) beside the shared ``ops``, ``augment``,
``optim`` and ``metrics``.

Parameters are a flat dict keyed by the module paths that the port and the
JAX package share (``posterior.down0.convs.conv0.conv.weight``, ...), so one
set of weights, drawn by the benchmark, loads into both.

What a family module gives, and who calls it (the harness names no family;
``harness/common.py`` imports the module by the configuration's name):

* ``TINY``: the experiment's fields that ``tiny.cut`` overrides to run the
  family's cells on the CPU in the benchmark's tests (widths, levels, image
  size; the batch and the workload's cuts are ``tiny.py``'s own).
* ``build(experiment, overrides)``: the ``Model`` of a configuration's
  ``experiment`` block (``common.reference_model``). The model gives:

  - ``specs()``: (path, shape, init) of every parameter and buffer, from
    which ``inputs.weights`` draws the weights and ``flops`` counts;
  - ``image_size``, ``in_channels``, ``C`` (classes): ``flops``, ``train``,
    ``evaluate``;
  - ``step_loss(params, buffers, x, mask, z_eps=None, train=True)``: the
    loss terms ``loss``, ``kl`` and ``recon`` of a batch (``train`` for the
    compared steps, ``evaluate`` for the eval-mode loss and its BatchNorm
    statistics, ``flops``);
  - ``sample(params, buffers, x, n, eps=None)``: the logits of ``n``
    samples of one image (``evaluate``, ``flops``);
  - the noise, stated in the program's layout and drawn by ``inputs`` in
    one call, in order: ``noise_shapes(batch)``, a train step's ``z_eps``
    (``inputs.step_draws``; empty where the model has none, and then none
    is drawn); for a family with an evaluation cell
    ``image_noise_shapes(samples, n_loss)``, an evaluated image's
    (``eps``, ``loss_eps``) (``inputs.image_draws``). A shape is a tuple
    of ints, given alone (one tensor, such as a (B, latent_dim) vector an
    image) or in lists and tuples, and each is drawn in that nesting.
    Where any noise is drawn, ``to_reference(eps)`` turns it into the
    layout that ``step_loss`` and ``sample`` take (``train``,
    ``evaluate``);
  - optionally ``blocks()`` and ``block_sizes()``: the conv-chain kernel's
    stages, for its roofline (``flops.chain_stages``, the reader
    ``metrics/conv3x3_f32_3xtf32_wgmma_roofline.py``).

A configuration of a new family comes as new files only: its
``configs/<config>.json`` (with ``family``), ``reference/<family>.py``,
``workloads/<cell>.json``, the readers ``metrics/<name>.py`` of any new
per-layer metric, and its entries in ``BENCHMARK.json``.
"""
