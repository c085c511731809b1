from .executor import ExecReport, ScheduledExecutor

__all__ = ["ExecReport", "ScheduledExecutor"]
