"""The serving path's models: the decoder LM, its sampling, the paged
continuous batcher and its host-side block books."""
