"""The four ECCI application patterns (paper §2): ECC processing, ECC
training, ECC inference, hybrid collaboration."""
from repro_torch.core.patterns.processing import (PipelineStage,
                                                  pipeline_topology)
from repro_torch.core.patterns.inference import (CascadePair, PartitionedLM,
                                                 best_partition)
from repro_torch.core.patterns.training import (FedAvgAggregator, FedWorker,
                                                fedavg)
from repro_torch.core.patterns.hybrid import (TeacherComponent,
                                              StudentComponent)

__all__ = ["PipelineStage", "pipeline_topology", "CascadePair",
           "PartitionedLM", "best_partition", "FedAvgAggregator",
           "FedWorker", "fedavg", "TeacherComponent", "StudentComponent"]
