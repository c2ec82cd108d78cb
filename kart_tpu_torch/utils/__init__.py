from .trace import StageTimers, device_trace, progress_line

__all__ = ["StageTimers", "device_trace", "progress_line"]
