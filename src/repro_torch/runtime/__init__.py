from .supervisor import StragglerMonitor, TrainSupervisor

__all__ = ["StragglerMonitor", "TrainSupervisor"]
