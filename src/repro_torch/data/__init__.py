from repro_torch.data.synthetic import DataState, SyntheticLMPipeline

__all__ = ["DataState", "SyntheticLMPipeline"]
