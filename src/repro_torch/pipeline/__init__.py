from repro_torch.pipeline.vectorized_sampler import \
    sample_blocks_vectorized  # noqa: F401
