"""Reusable in-app controller (paper §4.4.2): control/workload plane
separation, general control operations, BP/AP policies."""
from repro_torch.core.inapp.controller import (InAppController,
                                               ECController, CCController)
from repro_torch.core.inapp.policies import BasicPolicy, AdvancedPolicy

__all__ = ["InAppController", "ECController", "CCController",
           "BasicPolicy", "AdvancedPolicy"]
