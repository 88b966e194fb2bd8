"""Data pipelines: synthetic token streams and synthetic video crops
(numpy), and the model-backed crop bank (``data.video``)."""
from repro_torch.data.synthetic import TokenStream, synth_crops

__all__ = ["TokenStream", "synth_crops"]
