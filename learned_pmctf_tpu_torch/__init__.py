"""PyTorch/CUDA port of learned_pmctf_tpu for one NVIDIA H100.

The JAX package ``learned_pmctf_tpu`` is the reference: every module
here has a counterpart of the same name there and is held against it by
``tests/test_torch_port_*.py``. This package imports nothing of it.

Entry points (``models.pmctf.build_pmctf``, ``gop.code_gop``,
``gop.stream_gop``, ``codec.video_codec.PMCTFCodec``,
``codec.image_codec.PWaveCodec`` and the eval CLI
``python -m learned_pmctf_tpu_torch.cli.flex``) run on CUDA unless the
caller passes ``device="cpu"`` (``--device cpu``).
"""
