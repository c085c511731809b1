from .executor import (
    ConcurrentExecutor,
    ExecReport,
    ScheduledExecutor,
    SequentialExecutor,
)
from .planner import ConfigPlan, StepDescriptor

__all__ = [
    "ConcurrentExecutor",
    "ConfigPlan",
    "ExecReport",
    "ScheduledExecutor",
    "SequentialExecutor",
    "StepDescriptor",
]
