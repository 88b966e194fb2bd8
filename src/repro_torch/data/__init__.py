"""Data pipelines: synthetic token streams and synthetic video crops
(numpy), the model-backed crop bank (``data.video``) and the loader that
hands each rank of a mesh its rows (``data.loader``)."""
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import TokenStream, synth_crops

__all__ = ["ShardedLoader", "TokenStream", "synth_crops"]
