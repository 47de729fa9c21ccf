"""walkai-nos compute runtime on PyTorch and CUDA (NVIDIA Hopper).

The port of `walkai_nos_tpu`'s compute runtime, slice by slice: the
paged continuous batcher (`models/serve.py`) and the decoder LM it runs
(`models/lm.py`) on two hand-written CUDA kernels (`csrc/`, bound in
`ops/decode_attention.py`); and the ViT detector (`models/vit.py`),
served by a micro-batcher (`models/vit_serving.py`) and trained
(`models/train.py`, `trainer.py`, `checkpoint.py`, `data.py`) on four
more (bound in `ops/attention.py`). It imports torch and numpy, never jax
and nothing of `walkai_nos_tpu`; the JAX package is the reference the
tests hold it against.

Entry points run on `cuda` unless the caller passes `device="cpu"`;
without a GPU they raise instead of falling back to the CPU.
"""
