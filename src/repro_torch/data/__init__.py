from repro_torch.data.pipeline import SyntheticTokenPipeline, make_batch_specs  # noqa: F401
