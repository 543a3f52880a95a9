from repro_torch.data.pipeline import PipelineConfig, SyntheticTokenPipeline
