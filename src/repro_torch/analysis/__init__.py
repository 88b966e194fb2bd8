"""Analysis tools of the port: the roofline of a step on the H100."""
from repro_torch.analysis.roofline import (param_counts, roofline_from_record,
                                           roofline_table, step_record)

__all__ = ["param_counts", "roofline_from_record", "roofline_table",
           "step_record"]
