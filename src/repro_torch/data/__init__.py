from .pipeline import DataConfig, PipelineState, SyntheticPipeline, host_info

__all__ = ["DataConfig", "PipelineState", "SyntheticPipeline", "host_info"]
