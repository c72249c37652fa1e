"""PyTorch / CUDA port of theia_tpu for NVIDIA Hopper (H100).

The package mirrors theia_tpu's module names so each counterpart is easy to
find; theia_tpu stays the numerical reference. Importing this package (or any
of its modules) loads neither JAX nor Triton, and compiles nothing: the CUDA
kernels under ``csrc/`` are built by ``kernels/build.py`` the first time a
CUDA tensor reaches them.

Serving path: ``models.hub.build_theia`` -> ``serving.Predictor`` ->
``models.rvfm.Theia`` -> ``models.vit.ViTBackbone`` (attention through the
hand-written kernel in ``csrc/mha_fwd.cu``) and the lconv translator heads.
Training path: ``train.step.make_train_step`` over the same ``Theia``, with
``models.losses`` and ``train.optim``; attention's backward is
``csrc/mha_bwd.cu`` and the head ladders' LayerNorm backward
``csrc/ln_bwd.cu``. Training runtime: ``scripts/train_rvfm.py`` ->
``train.loop.train_from_config`` over ``config.py`` (the port's own
``configs/``), ``data/`` (webdataset shards, the batched loader) and
``train/checkpoint.py``.
"""
