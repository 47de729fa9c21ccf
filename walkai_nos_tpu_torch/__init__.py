"""walkai-nos compute runtime on PyTorch and CUDA (NVIDIA Hopper).

The port of `walkai_nos_tpu`'s serving path: the paged continuous
batcher (`models/serve.py`), the decoder LM it runs (`models/lm.py`) and
the two hand-written CUDA kernels under it (`csrc/`, bound in
`ops/decode_attention.py`). It imports torch and numpy, never jax and
nothing of `walkai_nos_tpu`; the JAX package is the reference the tests
hold it against.

Entry points run on `cuda` unless the caller passes `device="cpu"`;
without a GPU they raise instead of falling back to the CPU.
"""
