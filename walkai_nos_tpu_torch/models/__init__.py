"""The port's models: the decoder LM, its sampling, the paged continuous
batcher and its host-side block books; the ViT detector, its
micro-batcher and its training loop."""
